"""Carry parameters and KV caches across from the JAX package, without loss.

The port keeps the reference's parameter tree (names, ``[L, ...]`` stacking and the
``[in, out]`` weight layout), so parameters convert leaf by leaf.  Its cache drops
the reference's 128-lane row padding: ``[L, NB, 2, BS, Hkv*D]`` here against
``[L, NB, 2, BS, HDp]`` there, with ``HDp`` the row width rounded up to 128.  The
functions take and give numpy arrays on the reference side, so callers need not
import jax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_torch(x, dtype=None, device='cpu') -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == 'V' or a.dtype.name == 'bfloat16':     # ml_dtypes bfloat16
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(params_np: Dict, dtype=None, device='cpu') -> Dict:
    """JAX ``LlamaModel`` parameter tree (numpy leaves, fused or unfused, stacked
    ``[L, ...]``) -> the port's tree of tensors (same names and layout)."""
    return {k: params_from_jax(v, dtype, device) if isinstance(v, dict)
            else _to_torch(v, dtype, device) for k, v in params_np.items()}


def cache_from_reference(cache_np, num_kv_heads: int, head_dim: int,
                         device='cpu') -> torch.Tensor:
    """Reference cache ``[L, NB, 2, BS, HDp]`` -> port cache ``[L, NB, 2, BS, Hkv*D]``."""
    return _to_torch(np.asarray(cache_np)[..., :num_kv_heads * head_dim],
                     device=device).contiguous()


def cache_to_reference(cache: torch.Tensor) -> np.ndarray:
    """Port cache -> reference layout (rows zero-padded to a multiple of 128 lanes),
    as float32 numpy."""
    x = cache.float().cpu().numpy()
    row = x.shape[-1]
    padded = (row + 127) // 128 * 128
    if padded == row:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, padded - row)])
