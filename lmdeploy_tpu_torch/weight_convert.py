"""Carry parameters and KV caches across from the JAX package, without loss.

The port keeps the reference's parameter tree (names, ``[L, ...]`` stacking and the
``[in, out]`` weight layout), so parameters convert leaf by leaf; quantized linears
and expert stacks are dict leaves on both sides (``packed`` / ``scales`` / ``zeros``,
the prepared ``packed`` / ``sb`` / ``corr``, MXFP4 ``nib`` / ``scale``) and convert key
by key.  The cache drops the
reference's 128-lane row padding: ``[L, NB, 2, BS, Hkv*D]`` here against
``[L, NB, 2, BS, HDp]`` there, with ``HDp`` the row width rounded up to 128.  An int8
cache (``QuantKV``) converts its data that way and copies its token-major f32 scales
``[L, NB, 2, BS, Hkv]``, the same on both sides.  The functions take and give numpy
arrays on the reference side, so callers need not import jax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.kv_quant import QuantKV


def _to_torch(x, dtype=None, device='cpu') -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == 'V' or a.dtype.name == 'bfloat16':     # ml_dtypes bfloat16
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


# leaves of a quantized dict (W4A16, MXFP4) keep their own dtypes
_QUANT_KEYS = {'packed', 'scales', 'zeros', 'sb', 'corr', 'nib', 'scale'}


def params_from_jax(params_np: Dict, dtype=None, device='cpu') -> Dict:
    """JAX ``LlamaModel`` parameter tree (numpy leaves, fused or unfused, stacked
    ``[L, ...]``) -> the port's tree of tensors (same names and layout).  ``dtype``
    applies to the dense float leaves; quantized dict leaves (``{'nib', 'scale'}``,
    ``{'packed', ...}``) keep theirs.  The reference's ``layer_window`` leaf is
    dropped: the port's model holds its windows as Python ints (``layer_windows``)."""
    out = {}
    for k, v in params_np.items():
        if isinstance(v, dict) and set(v) <= _QUANT_KEYS:
            out[k] = {k2: _to_torch(v2, device=device) for k2, v2 in v.items()}
        elif isinstance(v, dict):
            out[k] = params_from_jax(v, dtype, device)
        elif k == 'layer_window':
            continue
        else:
            out[k] = _to_torch(v, dtype, device)
    return out


def cache_from_reference(cache_np, num_kv_heads: int, head_dim: int, device='cpu'):
    """Reference cache ``[L, NB, 2, BS, HDp]`` -> port cache ``[L, NB, 2, BS, Hkv*D]``.
    A reference ``QuantKV`` (its ``.data`` and ``.scale`` pages) gives a port
    ``QuantKV``."""
    if hasattr(cache_np, 'scale'):
        return QuantKV(cache_from_reference(cache_np.data, num_kv_heads, head_dim, device),
                       _to_torch(cache_np.scale, device=device).contiguous())
    return _to_torch(np.asarray(cache_np)[..., :num_kv_heads * head_dim],
                     device=device).contiguous()


def cache_to_reference(cache):
    """Port cache -> reference layout (rows zero-padded to a multiple of 128 lanes),
    as float32 numpy; a ``QuantKV`` gives the pair (int8 data, f32 scale)."""
    if isinstance(cache, QuantKV):
        return (_pad_rows(cache.data.cpu().numpy()),
                cache.scale.float().cpu().numpy())
    return _pad_rows(cache.float().cpu().numpy())


def _pad_rows(x: np.ndarray) -> np.ndarray:
    row = x.shape[-1]
    padded = (row + 127) // 128 * 128
    if padded == row:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, padded - row)])
