"""SSM / linear-attention state checkpoints for prefix caching.

A copy of ``lmdeploy_tpu/engine/ssm_ckpt.py`` (host only); a snapshot here is a dict of
host tensors (``ModelAgent.snapshot_slot_state``).

Hybrid linear-attention models (qwen3-next gated DeltaNet) carry per-sequence
recurrent state that KV pages alone cannot rebuild, so plain block-trie prefix
reuse would resume with a wrong (zero) state.  The reference snapshots the
recurrent state into the trie at block boundaries
(``lmdeploy/pytorch/paging/block_trie/checkpoint_lifecycle.py``); here the
port keys host-side state snapshots by a digest of the exact
token prefix instead of by trie node:

  * publish: after a prefill chunk that ends on a block boundary, the row's
    slot state (the ``'conv'`` / ``'rec'`` tensors of the dict cache) is
    copied to the host and stored under ``blake2b(tokens[:n])``;
  * match: the scheduler trims a trie match down to the deepest block
    boundary whose prefix digest has a stored snapshot, then attaches the
    snapshot to the sequence (``seq._ssm_restore``) for the model agent to
    scatter into the row's slot before its first prefill chunk runs.

Keying by content digest (not block id) makes the store independent of both
trie implementations and of block eviction/reuse: a stale entry can never be
returned for a different prefix, it simply ages out of the LRU.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _digest(ids, n: int) -> bytes:
    arr = np.ascontiguousarray(np.asarray(ids[:n], dtype=np.int32))
    return hashlib.blake2b(arr.tobytes(), digest_size=16).digest()


class SsmCkptStore:
    """LRU store: token-prefix digest -> per-slot state snapshot (host tensors)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._d: "OrderedDict[bytes, Tuple[int, Dict[str, Any]]]" = \
            OrderedDict()
        self.puts = 0
        self.hits = 0

    def __len__(self):
        return len(self._d)

    def has(self, ids, n: int) -> bool:
        return _digest(ids, n) in self._d

    def put(self, ids, n: int, snap: Dict[str, Any]):
        key = _digest(ids, n)
        if key in self._d:
            self._d.move_to_end(key)
            return
        self._d[key] = (n, snap)
        self.puts += 1
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def longest_prefix(self, ids, num_blocks: int, block_size: int
                       ) -> Tuple[int, Optional[Dict[str, Any]]]:
        """Deepest block count <= num_blocks whose prefix has a snapshot."""
        for i in range(num_blocks, 0, -1):
            key = _digest(ids, i * block_size)
            ent = self._d.get(key)
            if ent is not None:
                self._d.move_to_end(key)
                self.hits += 1
                return i, ent[1]
        return 0, None
