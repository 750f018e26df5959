"""Physical KV block allocator with ref-counts.

Reference analog: ``lmdeploy/pytorch/paging/block_manager/base_block_manager.py:68``
(LogicalAllocator) — a free-list allocator over device blocks with per-block ref counts
(shared blocks for prefix caching) and access timestamps for LRU eviction.

The "physical" blocks are pages of the one preallocated device cache
``[num_layers, num_blocks, 2, block_size, Hkv*D]``; this class only tracks ids.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np


class BlockManager:

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.ref_count = np.zeros(num_blocks, dtype=np.int64)
        self.access_time = np.zeros(num_blocks, dtype=np.float64)
        # free list as a stack of ids; block 0 is reserved as the padding block so
        # padded block-table entries always point at valid memory.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.ref_count[0] = 1

    # -- queries -----------------------------------------------------------------------
    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    def can_allocate(self, num: int) -> bool:
        return len(self._free) >= num

    # -- alloc/free --------------------------------------------------------------------
    def allocate(self, num: int) -> List[int]:
        assert len(self._free) >= num, \
            f'out of KV blocks: want {num}, have {len(self._free)}'
        blocks = [self._free.pop() for _ in range(num)]
        now = time.time()
        for b in blocks:
            self.ref_count[b] = 1
            self.access_time[b] = now
        return blocks

    def free(self, blocks: List[int]):
        for b in blocks:
            assert self.ref_count[b] > 0, f'double free of block {b}'
            self.ref_count[b] -= 1
            if self.ref_count[b] == 0:
                self._free.append(b)

    def add_ref(self, blocks: List[int]):
        for b in blocks:
            assert self.ref_count[b] > 0, f'ref of free block {b}'
            self.ref_count[b] += 1

    def touch(self, blocks: List[int]):
        now = time.time()
        for b in blocks:
            self.access_time[b] = now

    # -- sequence helpers --------------------------------------------------------------
    def num_required_blocks(self, seq, num_new_tokens: Optional[int] = None) -> int:
        """Blocks needed to hold the sequence's tokens beyond what it already has."""
        total = seq.num_token_ids if num_new_tokens is None \
            else seq.num_computed_tokens + num_new_tokens
        needed = (total + self.block_size - 1) // self.block_size
        return max(0, needed - len(seq.logical_blocks))

    def allocate_for_seq(self, seq, num_new_tokens: Optional[int] = None) -> bool:
        n = self.num_required_blocks(seq, num_new_tokens)
        if n == 0:
            return True
        if not self.can_allocate(n):
            return False
        seq.logical_blocks.extend(self.allocate(n))
        return True

    def free_seq(self, seq):
        live = [b for b in seq.logical_blocks if b > 0]  # skip window pads
        if live:
            self.free(live)
        seq.logical_blocks = []

    def free_leading(self, seq, count: int) -> int:
        """Sliding-window eviction: free the first ``count`` blocks of a
        sequence, leaving pad-block placeholders (0) in their list positions
        so the token-block -> physical-block mapping of the live suffix is
        unchanged (block tables are indexed by token-block position).

        Safe because windowed attention masks by absolute position: a reused
        physical block behind a placeholder contributes nothing to softmax.
        Reference analog: ``lmdeploy/pytorch/paging/block_manager/
        window_block_manager.py`` (frees out-of-window blocks eagerly).
        """
        freed = 0
        for i in range(min(count, len(seq.logical_blocks))):
            b = seq.logical_blocks[i]
            if b > 0:
                self.free([b])
                seq.logical_blocks[i] = 0
                freed += 1
        return freed
