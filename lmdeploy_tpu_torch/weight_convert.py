"""Carry parameters and KV caches across from the JAX package, without loss.

The port keeps the reference's parameter tree (names, ``[L, ...]`` stacking and the
``[in, out]`` weight layout), so parameters convert leaf by leaf; quantized linears
and expert stacks are dict leaves on both sides (``packed`` / ``scales`` / ``zeros``,
the prepared ``packed`` / ``sb`` / ``corr``, MXFP4 ``nib`` / ``scale``, blocked-fp8
experts ``w8`` / ``gscale``, the 8-bit linears ``w8`` / ``scale`` (W8A8, fp8) and ``w8`` /
``bscale`` (blocked fp8)) and convert key by key; fp8 goes as its e4m3 bytes, int8 as
it is.  Norm biases, ``bo``, ``lm_head_b``, the DeepSeek-MoE ``layers`` /
``moe_layers`` groups, the DSA indexer's leaves, an MTP head's tree (``enorm``,
``hnorm``, ``eh_proj``, ``shead_norm`` and its one-row ``layer`` group) and the hybrid
models' ``blocks`` group are plain leaves and groups.  The caches convert bit for bit
both ways (``ops/kv_quant.py`` has the port's layouts; a hybrid model's dict cache key
by key); the port drops the reference's 128-lane row padding everywhere:
  * plain and fp8: ``[L, NB, 2, BS, Hkv*D]`` here against ``[L, NB, 2, BS, HDp]`` there,
    ``HDp`` the row width rounded up to 128; fp8 goes as its e4m3 bytes (u8);
  * int8 ``QuantKV``: the data that way, the token-major f32 scales
    ``[L, NB, 2, BS, Hkv]`` the same on both sides;
  * int4 ``QuantKV4``: the reference's token-pair bytes ``[L, NB, 2, BS/2, HDp]`` (slot
    2r low nibble, 2r+1 high) against the port's dim-pair bytes, and its head-major
    de-interleaved scales and mins ``[L, NB, 2, Hkv, BS]`` (``deint_scale_pos``) against
    the port's token-major ones;
  * TurboQuant ``QuantKVTurbo``: the reference's planar planes ``[L, NB, 2, BS, ROWt]``
    (K byte j = P[j] | P[j + HD/2] << 4, V byte j = P[j] | P[j + HD/2] << 2 over the
    head-major row P) against the port's token rows, and its meta
    ``[L, NB, 2, 2, Hkv, BS]`` (the never-written V slot 1 is zero) against the port's
    ``[L, NB, BS, 3, Hkv]``.
S-LoRA slot stacks convert as they are (``slora_stacks_from_reference``).
The functions take and give numpy arrays on the reference side, so callers need not
import jax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.kv_quant import (QuantKV, QuantKV4, QuantKVTurbo, deint_scale_pos, pack_2bit,
                            pack_nibbles, unpack_2bit, unpack_nibbles)


def _to_torch(x, dtype=None, device='cpu') -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == 'float8_e4m3fn':                       # ml_dtypes e4m3: its bytes
        t = torch.from_numpy(np.array(a.view(np.uint8))).view(torch.float8_e4m3fn)
    elif a.dtype.kind == 'V' or a.dtype.name == 'bfloat16':   # ml_dtypes bfloat16
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


# leaves of a quantized dict (W4A16, MXFP4, blocked fp8) keep their own dtypes
_QUANT_KEYS = {'packed', 'scales', 'zeros', 'sb', 'corr', 'nib', 'scale', 'w8', 'gscale',
               'bscale'}


def params_from_jax(params_np: Dict, dtype=None, device='cpu') -> Dict:
    """JAX ``LlamaModel`` parameter tree (numpy leaves, fused or unfused, stacked
    ``[L, ...]``) -> the port's tree of tensors (same names and layout).  ``dtype``
    applies to the dense float leaves; quantized dict leaves (``{'nib', 'scale'}``,
    ``{'w8', 'gscale'}``, ``{'packed', ...}`` of any rank, the 4-D expert stacks included, and the prepared
    leaves of every schedule, bf16 ``sb`` / ``corr`` too) and integer leaves (EAGLE-3's
    ``d2t``) keep theirs, bit for bit; a speculative head's flat tree converts the same
    way.  The reference's ``layer_window`` leaf is
    dropped: the port's model holds its windows as Python ints (``layer_windows``)."""
    out = {}
    for k, v in params_np.items():
        if isinstance(v, dict) and set(v) <= _QUANT_KEYS:
            out[k] = {k2: _to_torch(v2, device=device) for k2, v2 in v.items()}
        elif isinstance(v, dict):
            out[k] = params_from_jax(v, dtype, device)
        elif k == 'layer_window':
            continue
        elif np.asarray(v).dtype.kind in 'iu':
            out[k] = _to_torch(v, device=device)     # ids (EAGLE-3's d2t) keep their type
        else:
            out[k] = _to_torch(v, dtype, device)
    return out


def slora_stacks_from_reference(stacks_np: Dict, device='cpu') -> Dict:
    """The reference's S-LoRA slot stacks (``lora.build_slora_stacks``: {target: {'a'
    [L, S, in, rp], 'b' [L, S, rp, out]}} in f32 numpy) -> the port's: the same layout as
    f32 tensors on ``device``, bit for bit (each layer's rows gather ``a[adapter_ids]``,
    ``b[adapter_ids]`` as there)."""
    return {t: {k: _to_torch(np.asarray(v, np.float32), device=device)
                for k, v in ab.items()} for t, ab in stacks_np.items()}


def cache_from_reference(cache_np, num_kv_heads: int, head_dim: int, device='cpu'):
    """Reference cache -> port cache: a plain or fp8 array ``[L, NB, 2, BS, HDp]``, or a
    reference ``QuantKV`` / ``QuantKV4`` / ``QuantKVTurbo`` (their numpy or jax
    leaves), to the port's type of the same name; a hybrid model's dict ``{'pages',
    'conv', 'rec'}`` key by key (the state tensors as they are)."""
    if isinstance(cache_np, dict):
        return {k: cache_from_reference(v, num_kv_heads, head_dim, device) if k == 'pages'
                else _to_torch(v, device=device).contiguous() for k, v in cache_np.items()}
    hd = num_kv_heads * head_dim
    if hasattr(cache_np, 'meta'):
        return _turbo_from_reference(cache_np, hd, device)
    if hasattr(cache_np, 'minv'):
        return _int4_from_reference(cache_np, hd, device)
    if hasattr(cache_np, 'scale'):
        return QuantKV(cache_from_reference(cache_np.data, num_kv_heads, head_dim, device),
                       _to_torch(cache_np.scale, device=device).contiguous())
    a = np.asarray(cache_np)
    if a.dtype.name == 'float8_e4m3fn':
        return torch.from_numpy(np.array(a.view(np.uint8)[..., :hd])).view(
            torch.float8_e4m3fn).to(device)
    return _to_torch(a[..., :hd], device=device).contiguous()


def cache_to_reference(cache, row: int = None):
    """Port cache -> reference layout (rows zero-padded to a multiple of 128 lanes), as
    numpy: a plain cache in float32, an fp8 one as its e4m3 bytes (u8); a quantized
    cache as the tuple of the reference's leaves (``QuantKV``: data, scale;
    ``QuantKV4``: data, scale, minv; ``QuantKVTurbo``: data, meta).  ``row``: the
    reference's row width where it is wider than the port's (the DSA models, whose
    reference cache keeps the checkpoint's kv heads and reads the first; a plain
    cache); a hybrid model's dict cache as a dict of the same keys, its state tensors
    in float32 (bf16 conv state widens without loss)."""
    if isinstance(cache, dict):
        return {k: cache_to_reference(v, row) if k == 'pages' else v.float().cpu().numpy()
                for k, v in cache.items()}
    if isinstance(cache, QuantKVTurbo):
        return _turbo_to_reference(cache)
    if isinstance(cache, QuantKV4):
        return _int4_to_reference(cache)
    if isinstance(cache, QuantKV):
        return (_pad_rows(cache.data.cpu().numpy()),
                cache.scale.float().cpu().numpy())
    if cache.dtype == torch.float8_e4m3fn:
        return _pad_rows(cache.view(torch.uint8).cpu().numpy(), row)
    return _pad_rows(cache.float().cpu().numpy(), row)


def _pad_rows(x: np.ndarray, row: int = None) -> np.ndarray:
    """x's rows zero-padded to ``row`` (default: x's own width) rounded up to 128."""
    row = x.shape[-1] if row is None else row
    padded = (row + 127) // 128 * 128
    if padded == x.shape[-1]:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, padded - x.shape[-1])])


def _u8(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), dtype=np.uint8))


def _int4_from_reference(ref, hd: int, device) -> QuantKV4:
    data = _u8(ref.data)                                  # [L, NB, 2, BS/2, HDp]
    L, NB, _, bs2, _ = data.shape
    # token pairs -> token rows: byte row r holds slot 2r low and slot 2r+1 high
    rows = torch.stack([data & 0xF, data >> 4], dim=4).reshape(L, NB, 2, 2 * bs2, -1)

    def token_major(x):                                   # [L, NB, 2, Hkv, BS] de-interleaved
        x = torch.from_numpy(np.array(np.asarray(x), dtype=np.float32))
        pos = deint_scale_pos(torch.arange(2 * bs2), 2 * bs2)
        return x[..., pos].transpose(-1, -2).contiguous().to(device)
    return QuantKV4(pack_nibbles(rows[..., :hd]).contiguous().to(device),
                    token_major(ref.scale), token_major(ref.minv))


def _int4_to_reference(kv: QuantKV4):
    rows = _pad_rows(unpack_nibbles(kv.data.cpu()).numpy())   # [L, NB, 2, BS, HDp]
    pairs = rows[..., 0::2, :] | (rows[..., 1::2, :] << 4)

    def deint(x):                                         # [L, NB, 2, BS, Hkv] -> ref
        x = np.swapaxes(x.float().cpu().numpy(), -1, -2)
        return np.concatenate([x[..., 0::2], x[..., 1::2]], axis=-1)
    return pairs, deint(kv.scale), deint(kv.minv)


def _turbo_from_reference(ref, hd: int, device) -> QuantKVTurbo:
    data = _u8(ref.data)                                  # [L, NB, 2, BS, ROWt]
    kb, vb = data[:, :, 0, :, :hd // 2], data[:, :, 1, :, :hd // 2]
    kc = torch.cat([kb & 0xF, kb >> 4], dim=-1)           # head-major codes [.., HD]
    vc = torch.cat([vb & 0x3, (vb >> 2) & 0x3], dim=-1)
    meta = torch.from_numpy(np.array(np.asarray(ref.meta), dtype=np.float32))
    meta = torch.stack([meta[:, :, 0, 0], meta[:, :, 0, 1], meta[:, :, 1, 0]], dim=2)
    return QuantKVTurbo(torch.cat([pack_nibbles(kc), pack_2bit(vc)], -1).contiguous().to(device),
                        meta.permute(0, 1, 4, 2, 3).contiguous().to(device))


def _turbo_to_reference(kv: QuantKVTurbo):
    data, meta = kv.data.cpu(), kv.meta.float().cpu()     # [L, NB, BS, row], [.., 3, Hkv]
    hd = data.shape[-1] * 4 // 3
    kc, vc = unpack_nibbles(data[..., :hd // 2]), unpack_2bit(data[..., hd // 2:])
    h2 = hd // 2
    planes = [_pad_rows((x[..., :h2] | (x[..., h2:] << s)).numpy(), h2)
              for x, s in ((kc, 4), (vc, 2))]
    L, NB, BS, _, hkv = meta.shape
    ref_meta = np.zeros((L, NB, 2, 2, hkv, BS), np.float32)
    m = meta.permute(0, 1, 3, 4, 2).numpy()               # [L, NB, 3, Hkv, BS]
    for (plane, comp), i in (((0, 0), 0), ((0, 1), 1), ((1, 0), 2)):
        ref_meta[:, :, plane, comp] = m[:, :, i]
    return np.stack(planes, axis=2), ref_meta
