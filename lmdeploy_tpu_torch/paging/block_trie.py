"""Prefix cache: token-block hash trie over physical KV blocks.

Reference analog: ``lmdeploy/pytorch/paging/block_trie/trie.py`` (BlockTrie ``:120``,
``match:477``, ``allocate:569``, LRU leaf eviction ``:599``).  Node identity is the
cumulative hash of (parent hash, exact block tokens), so a hash collision cannot alias
different prefixes; multimodal content hashes can be mixed in later exactly as the
reference does with image fingerprints.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple


class Node:
    __slots__ = ('key', 'block', 'tokens', 'parent', 'children', 'access_time')

    def __init__(self, key: Tuple, block: int, tokens: Tuple[int, ...],
                 parent: Optional['Node']):
        self.key = key
        self.block = block
        self.tokens = tokens
        self.parent = parent
        self.children: Dict[Tuple, 'Node'] = {}
        self.access_time = time.time()


class BlockTrie:

    def __init__(self, cache_config, block_manager):
        self.block_size = cache_config.block_size
        self.block_manager = block_manager
        self.root = Node(key=('root',), block=-1, tokens=(), parent=None)
        self._nodes_by_key: Dict[Tuple, Node] = {}
        # seq.seq_id -> number of leading blocks that are shared (trie-owned refs)
        self._seq_shared: Dict[int, int] = {}

    # -- key derivation ----------------------------------------------------------------
    def _child_key(self, parent: Node, tokens: Tuple[int, ...]) -> Tuple:
        return (hash((parent.key, tokens)), tokens)

    def _block_tokens(self, seq, i: int) -> Tuple:
        """Block i's identity tuple: its exact token ids, salted with the
        content digests of any multimodal spans overlapping the block.

        VLM prompts repeat one placeholder id per image token, so raw token
        hashing would alias different images; mixing (digest, relative span
        start) in makes block identity content-exact (reference:
        block_trie/trie.py image fingerprints via multimodal/data_type.py).
        """
        ids = seq.history_ids
        lo, hi = i * self.block_size, (i + 1) * self.block_size
        tokens = tuple(int(t) for t in ids[lo:hi])
        spans = getattr(seq, 'mm_digests', None)
        if not spans:
            return tokens
        salt = tuple((d, s - lo) for s, e, d in spans if s < hi and e > lo)
        return tokens + salt if salt else tokens

    # -- match at admission ------------------------------------------------------------
    def match_prefix(self, seq) -> int:
        """Walk the trie over the prompt's full blocks; adopt matched blocks into the seq.

        Returns the number of matched tokens.  Never matches the entire prompt — at
        least one token must remain uncomputed so prefill produces a logit to sample.
        """
        assert seq.num_computed_tokens == 0 and not seq.logical_blocks
        ids = seq.history_ids
        max_match = (len(ids) - 1) // self.block_size  # leave >=1 token uncomputed
        node = self.root
        matched: List[Node] = []
        for i in range(max_match):
            tokens = self._block_tokens(seq, i)
            key = self._child_key(node, tokens)
            child = node.children.get(key)
            if child is None:
                break
            child.access_time = time.time()
            matched.append(child)
            node = child
        if not matched:
            return 0
        blocks = [n.block for n in matched]
        self.block_manager.add_ref(blocks)
        self.block_manager.touch(blocks)
        seq.logical_blocks = list(blocks)
        seq.num_computed_tokens = len(blocks) * self.block_size
        self._seq_shared[seq.seq_id] = len(blocks)
        return seq.num_computed_tokens

    # -- publish computed blocks -------------------------------------------------------
    def cache_seq_blocks(self, seq):
        """Insert newly completed full blocks of ``seq`` into the trie."""
        num_full = seq.num_computed_tokens // self.block_size
        shared = self._seq_shared.get(seq.seq_id, 0)
        if num_full <= shared:
            return
        # find the node for the last shared block
        node = self.root
        ids = seq.history_ids
        for i in range(shared):
            tokens = self._block_tokens(seq, i)
            key = self._child_key(node, tokens)
            nxt = node.children.get(key)
            if nxt is None or nxt.block != seq.logical_blocks[i]:
                # seq diverged from trie path (block was evicted); re-anchor lazily
                node = None
                break
            node = nxt
        if node is None:
            return
        for i in range(shared, num_full):
            tokens = self._block_tokens(seq, i)
            key = self._child_key(node, tokens)
            child = node.children.get(key)
            if child is None:
                block = seq.logical_blocks[i]
                child = Node(key=key, block=block, tokens=tokens, parent=node)
                node.children[key] = child
                self._nodes_by_key[key] = child
                self.block_manager.add_ref([block])   # trie's own reference
            child.access_time = time.time()
            node = child
        self._seq_shared[seq.seq_id] = num_full

    # -- release -----------------------------------------------------------------------
    def release_seq(self, seq):
        self._seq_shared.pop(seq.seq_id, None)
        self.block_manager.free_seq(seq)

    # -- eviction ----------------------------------------------------------------------
    def evict(self, need_blocks: int) -> int:
        """LRU-evict cached leaf nodes whose blocks have no other users.

        Returns number of blocks freed back to the allocator.
        """
        freed = 0
        while freed < need_blocks:
            leaves = [n for n in self._nodes_by_key.values()
                      if not n.children and self.block_manager.ref_count[n.block] == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.access_time)
            self._remove_node(victim)
            freed += 1
        return freed

    def _remove_node(self, node: Node):
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        self._nodes_by_key.pop(node.key, None)
        self.block_manager.free([node.block])

    @property
    def num_cached_blocks(self) -> int:
        return len(self._nodes_by_key)
