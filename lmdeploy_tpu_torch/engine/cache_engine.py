"""Paged KV-cache allocation in device memory.

Port of the plain and int8 parts of ``lmdeploy_tpu/engine/cache_engine.py``.  The
cache is ONE tensor ``[num_layers, num_blocks, 2, block_size, Hkv*D]`` (see
``ops/attention.py``), allocated once and written in place by every step; with
``quant_policy=4`` (KV int8) it is a ``QuantKV`` of int8 pages of that shape plus f32
scales ``[num_layers, num_blocks, 2, block_size, Hkv]`` (``ops/kv_quant.py``).  Block 0
is the reserved padding block (``paging/block_manager.py``).  The block budget comes
from the device's free memory (``torch.cuda.mem_get_info``) times
``cache_max_entry_count``, after the weights are resident.  Host swap pools and the
int4, fp8 and TurboQuant caches are later slices.
"""
from __future__ import annotations

import torch

from ..config import CacheConfig, ModelConfig
from ..messages import QuantPolicy
from ..ops.kv_quant import QuantKV

CPU_CACHE_BYTES = 256 * 1024 * 1024     # budget when serving on the CPU (tests)


class CacheEngine:

    def __init__(self, model_config: ModelConfig, cache_config: CacheConfig,
                 device: torch.device):
        if cache_config.quant_policy not in (QuantPolicy.NONE, QuantPolicy.KV_INT8):
            raise NotImplementedError(f'quant_policy={int(cache_config.quant_policy)} '
                                      f'KV caches are not ported yet')
        self.model_config = model_config
        self.cache_config = cache_config
        self.device = device
        if cache_config.num_gpu_blocks <= 0:
            cache_config.num_gpu_blocks = self._derive_num_blocks()
        self.num_blocks = cache_config.num_gpu_blocks
        cfg = model_config
        self.row_width = cfg.num_key_value_heads * cfg.head_dim
        shape = (cfg.num_layers, self.num_blocks, 2, cache_config.block_size,
                 self.row_width)
        if self.quantized:
            self.kv_cache = QuantKV(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:4] + (cfg.num_key_value_heads,), dtype=torch.float32,
                            device=device))
        else:
            self.kv_cache = torch.zeros(shape, dtype=cfg.torch_dtype(), device=device)

    @property
    def quantized(self) -> bool:
        return self.cache_config.quant_policy == QuantPolicy.KV_INT8

    def block_bytes(self) -> int:
        cfg = self.model_config
        itemsize = 1 if self.quantized else torch.tensor(
            [], dtype=cfg.torch_dtype()).element_size()
        per = (cfg.num_layers * 2 * self.cache_config.block_size
               * cfg.num_key_value_heads * cfg.head_dim * itemsize)
        if self.quantized:          # + one f32 scale per (token, head, plane)
            per += (cfg.num_layers * 2 * self.cache_config.block_size
                    * cfg.num_key_value_heads * 4)
        return per

    def _derive_num_blocks(self) -> int:
        """Free device memory -> block count (call after the weights are resident)."""
        if self.device.type == 'cuda':
            free, _total = torch.cuda.mem_get_info(self.device)
        else:
            free = CPU_CACHE_BYTES
        budget = int(free * self.cache_config.cache_max_entry_count)
        return max(budget // self.block_bytes(), 16)
