"""Host-side paging: sequences, block allocator, prefix trie, scheduler."""
