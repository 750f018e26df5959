"""Paged KV-cache allocation in device memory.

Port of ``lmdeploy_tpu/engine/cache_engine.py``.  The cache is ONE tensor
``[num_layers, num_blocks, 2, block_size, Hkv*D]`` (see ``ops/attention.py``; D is
``cache_head_dim``, MLA's one latent kv head of 576 on DeepSeek-V2/V3),
allocated once and written in place by every step.  ``quant_policy`` picks its type
(``ops/kv_quant.py`` has the layouts):
  * 0: the model's dtype;
  * 4 (KV int8): a ``QuantKV`` of int8 pages of that shape plus f32 scales
    ``[num_layers, num_blocks, 2, block_size, Hkv]``;
  * 8 (KV int4): a ``QuantKV4`` of u8 pages ``[..., Hkv*D/2]`` (two codes a byte) plus
    f32 scales and mins of the int8 scales' shape;
  * 16 (KV fp8): the plain layout in ``float8_e4m3fn``;
  * 42 (TurboQuant k4v2): a ``QuantKVTurbo`` of u8 token rows
    ``[num_layers, num_blocks, block_size, 3*Hkv*D/4]`` (K codes, then V codes) plus
    f32 meta ``[num_layers, num_blocks, block_size, 3, Hkv]``.
Block 0 is the reserved padding block (``paging/block_manager.py``).  The block budget
comes from the device's free memory (``torch.cuda.mem_get_info``) times
``cache_max_entry_count``, after the weights are resident; ``block_bytes`` counts
the bytes the chosen layout really takes.  Host swap pools are a later slice.

A hybrid linear-attention model (``models/qwen3_next.py``) has a dict cache ``{'pages',
'conv', 'rec'}`` (reference ``engine/model_agent.py:198-210``): ``pages`` holds only its
``num_cache_layers`` full-attention layers, and its per-slot state (``state_shapes``,
max_batch + 1 slots) is allocated before the block budget is read, so the budget sees
it (Qwen3-Next-80B-A3B's 36 linear layers hold 2 MiB of f32 state a slot each: 18.1 GiB
at max_batch 256).

Under a mesh with context parallelism (cp > 1, plain caches only) the cache is a
``parallel.mesh.StripedKV``: one ``[num_layers, num_blocks, 2, block_size/cp, Hkv*D]``
stripe per 'cp' rank on that rank's device, and the block budget is the smallest any
device allows for the stripes it holds (a card that holds k ranks holds k stripes).
``to_reference_layout`` / ``from_reference_layout`` join or split the stripes on the
slot axis without loss.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import torch

from ..config import CacheConfig, ModelConfig, cp_unported
from ..messages import QuantPolicy
from ..ops.kv_quant import QuantKV, QuantKV4, QuantKVTurbo
from ..parallel.mesh import StripedKV, cache_sharding

CPU_CACHE_BYTES = 256 * 1024 * 1024     # budget when serving on the CPU (tests)


class CacheEngine:

    def __init__(self, model_config: ModelConfig, cache_config: CacheConfig,
                 device: torch.device, mesh=None, state_shapes: Optional[Dict] = None):
        """``state_shapes``: {name: (shape, dtype)} of a hybrid model's per-slot state,
        allocated (zeros) before the block budget is read; the cache is then the dict
        of the pages and these tensors."""
        self.model_config = model_config
        self.cache_config = cache_config
        self.device = device
        cfg = model_config
        self.policy = QuantPolicy(cache_config.quant_policy)
        D = cfg.cache_head_dim
        if self.policy == QuantPolicy.TURBO_QUANT and (D % 4 or D & (D - 1)):
            raise ValueError(f'TurboQuant needs a power-of-two head_dim, got {D}')
        # the 'cp' ranks' devices when the slot axis is striped, else None
        self.cp_devices = None
        if mesh is not None and mesh.shape['cp'] > 1:
            unported = cp_unported(mesh.shape['cp'], self.policy, cache_config.block_size,
                                   model_config)
            if unported:
                raise NotImplementedError(f'not ported yet: {", ".join(unported)}')
            self.cp_devices = mesh.cp_devices
        states = {name: torch.zeros(shape, dtype=dtype, device=device)
                  for name, (shape, dtype) in (state_shapes or {}).items()}
        if cache_config.num_gpu_blocks <= 0:
            cache_config.num_gpu_blocks = self._derive_num_blocks()
        self.num_blocks = cache_config.num_gpu_blocks
        self.row_width = cfg.num_key_value_heads * D
        self.kv_cache = self._alloc()
        if states:
            self.kv_cache = dict(pages=self.kv_cache, **states)

    @property
    def pages(self):
        """The paged KV cache: the dict cache's ``pages``, or the cache itself."""
        return self.kv_cache['pages'] if isinstance(self.kv_cache, dict) else self.kv_cache

    def _alloc(self):
        cfg = self.model_config
        L, NB, BS, hkv = (cfg.cache_layers, self.num_blocks, self.cache_config.block_size,
                          cfg.num_key_value_heads)
        hd = self.row_width

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if self.policy == QuantPolicy.KV_INT8:
            return QuantKV(zeros(L, NB, 2, BS, hd, dtype=torch.int8), zeros(L, NB, 2, BS, hkv))
        if self.policy == QuantPolicy.KV_INT4:
            return QuantKV4(zeros(L, NB, 2, BS, hd // 2, dtype=torch.uint8),
                            zeros(L, NB, 2, BS, hkv), zeros(L, NB, 2, BS, hkv))
        if self.policy == QuantPolicy.TURBO_QUANT:
            return QuantKVTurbo(zeros(L, NB, BS, 3 * hd // 4, dtype=torch.uint8),
                                zeros(L, NB, BS, 3, hkv))
        dtype = torch.float8_e4m3fn if self.policy == QuantPolicy.KV_FP8 else cfg.torch_dtype()
        if self.cp_devices is not None:
            cp = len(self.cp_devices)
            return StripedKV([torch.zeros(L, NB, 2, BS // cp, hd, dtype=dtype, device=d)
                              for d in self.cp_devices])
        return zeros(L, NB, 2, BS, hd, dtype=dtype)

    def to_reference_layout(self):
        """The cache in the unsharded layout ``[L, NB, 2, BS, Hkv*D]`` (a striped
        cache's stripes joined on the slot axis, bit for bit; any other cache as it
        is)."""
        if isinstance(self.kv_cache, StripedKV):
            return self.kv_cache.to_reference_layout()
        return self.pages

    def from_reference_layout(self, cache: torch.Tensor):
        """Overwrite the cache, in place, with the unsharded ``cache`` (split into the
        stripes on the slot axis, bit for bit, when striped)."""
        if isinstance(self.kv_cache, StripedKV):
            spec = cache_sharding(self.model_config.num_key_value_heads, self.kv_cache.cp)
            BS = cache.shape[3]
            for r, stripe in enumerate(self.kv_cache.stripes):
                stripe.copy_(cache[:, :, :, spec.stripe(r, BS)])
        else:
            self.pages.copy_(cache)

    def block_bytes(self) -> int:
        """Device bytes of one block across all layers, in the allocated layout."""
        cfg = self.model_config
        tokens = cfg.cache_layers * self.cache_config.block_size  # token rows per block
        hkv, hd = cfg.num_key_value_heads, cfg.num_key_value_heads * cfg.cache_head_dim
        if self.policy == QuantPolicy.KV_INT8:       # int8 K and V + f32 scales
            return tokens * 2 * (hd + 4 * hkv)
        if self.policy == QuantPolicy.KV_INT4:       # nibble K and V + f32 scales, mins
            return tokens * 2 * (hd // 2 + 8 * hkv)
        if self.policy == QuantPolicy.TURBO_QUANT:   # 4-bit K, 2-bit V + 3 f32 metas
            return tokens * (3 * hd // 4 + 12 * hkv)
        if self.policy == QuantPolicy.KV_FP8:
            return tokens * 2 * hd
        return tokens * 2 * hd * torch.tensor([], dtype=cfg.torch_dtype()).element_size()

    def _derive_num_blocks(self) -> int:
        """Free device memory -> block count (call after the weights are resident).
        Striped, each device holds a stripe (1/cp of a block) for each rank on it, and
        the device with the least room for its stripes sets the count."""
        ranks = collections.Counter(self.cp_devices or [self.device])
        cp = len(self.cp_devices) if self.cp_devices else 1
        counts = []
        for dev, k in ranks.items():
            if dev.type == 'cuda':
                free, _total = torch.cuda.mem_get_info(dev)
            else:
                free = CPU_CACHE_BYTES
            budget = int(free * self.cache_config.cache_max_entry_count)
            counts.append(budget * cp // (k * self.block_bytes()))
        return max(min(counts), 16)
