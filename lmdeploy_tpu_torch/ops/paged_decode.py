"""T=1 attention over the paged KV cache (decode).

Replaces the plain branch of the TPU kernel ``lmdeploy_tpu/ops/pallas/paged_decode.py``
(``paged_decode_attention``, body ``_decode_kernel``).  On a CUDA tensor the wrapper
launches the hand-written Hopper kernel in ``csrc/paged_decode.cu`` (its header says
what bounds it and how it is laid out); on a CPU tensor it runs
``paged_decode_attention_plain``, the same function in plain PyTorch.  There is no
fallback: a CUDA tensor the kernel does not take raises.

Cache layout ``[L, NB, 2, BS, Hkv*D]``: a K plane and a V plane of head-major token
rows per page (``ops/attention.py``).  ``kv_lens`` counts the token just filled; 0
marks an inactive row, whose output is 0.

An int8 cache (``ops/kv_quant.QuantKV``) takes ``paged_decode_attention_int8``, the
port of the same wrapper's int8 branch (body ``_decode_kernel_quant``), whose kernel
is ``csrc/paged_decode_int8.cu``: the per-(token, head) f32 scales apply on the
score side (``s = (q*scale)·k_i8 * ksc``, ``acc += (p*vsc) @ v_i8``).  It has a logit
softcap but no window and no sinks, as the reference never sends those to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .kv_quant import QuantKV

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# paged_decode_bf16(q, cache, tables, kv_lens, sinks, out, B, Hq, Hkv, D, NB, BS, W,
#                   layer, scale, softcap, window, stream)
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_F, _F, _I, _P]
# paged_decode_int8(q, data, scale, tables, kv_lens, out, B, Hq, Hkv, D, NB, BS, W,
#                   layer, scale, softcap, stream)
_ARGTYPES_INT8 = [_P] * 6 + [_I] * 8 + [_F, _F, _P]


def paged_decode_attention_plain(q: torch.Tensor, kv_cache: torch.Tensor,
                                 block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                 layer: int, scale: float, num_kv_heads: int,
                                 logit_softcap: Optional[float] = None,
                                 window: Optional[int] = None,
                                 sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Hq,D] -> [B,Hq,D], f32 softmax with the kernel's masking and sink rules."""
    B, Hq, D = q.shape
    G = Hq // num_kv_heads
    _, NB, _, BS, _ = kv_cache.shape
    W = block_tables.shape[1]
    tables = block_tables.long().clamp(0, NB - 1)
    pages = kv_cache[layer][tables]                          # [B, W, 2, BS, HD]
    k = pages[:, :, 0].reshape(B, W * BS, num_kv_heads, D).float()
    v = pages[:, :, 1].reshape(B, W * BS, num_kv_heads, D).float()
    qg = q.float().reshape(B, num_kv_heads, G, D)
    s = torch.einsum('bhgd,bshd->bhgs', qg, k) * scale
    if logit_softcap is not None and logit_softcap > 0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    lens = kv_lens.long()[:, None]
    pos = torch.arange(W * BS, device=q.device)[None, :]
    valid = pos < lens
    if window is not None and window > 0:
        valid &= pos >= (lens - window).clamp(min=0)
    s = torch.where(valid[:, None, None, :], s, torch.full((), MASK_VALUE, device=q.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(-1)
    if sinks is not None:
        sk = sinks.float().reshape(1, num_kv_heads, G)
        lsum = lsum + torch.where(m > 0.5 * MASK_VALUE, torch.exp(sk - m),
                                  torch.zeros_like(m))
    out = torch.einsum('bhgs,bshd->bhgd', p, v)
    out = out / torch.where(lsum == 0, torch.ones_like(lsum), lsum)[..., None]
    out = torch.where((kv_lens > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, kv_cache: torch.Tensor,
                           block_tables: torch.Tensor, kv_lens: torch.Tensor,
                           layer: int, scale: float, num_kv_heads: int,
                           logit_softcap: Optional[float] = None,
                           window: Optional[int] = None,
                           sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Hq,D]; kv_cache [L,NB,2,BS,Hkv*D] (or a ``QuantKV``); block_tables [B,W]
    i32; kv_lens [B] i32; ``layer`` selects the cache layer; ``window`` None/<=0 = full
    attention; ``sinks`` [Hq] learned sink logits.  Returns [B,Hq,D]."""
    if isinstance(kv_cache, QuantKV):
        if (window is not None and window > 0) or sinks is not None:
            raise ValueError('paged_decode: an int8 cache takes no window and no sinks '
                             '(the dense path serves them)')
        return paged_decode_attention_int8(q, kv_cache, block_tables, kv_lens, layer,
                                           scale, num_kv_heads, logit_softcap)
    if not q.is_cuda:
        return paged_decode_attention_plain(q, kv_cache, block_tables, kv_lens, layer,
                                            scale, num_kv_heads, logit_softcap, window,
                                            sinks)
    B, Hq, D = q.shape
    L, NB, two, BS, HD = kv_cache.shape
    W = block_tables.shape[1]
    if q.dtype != torch.bfloat16 or kv_cache.dtype != torch.bfloat16:
        raise TypeError(f'paged_decode kernel takes bf16 q and cache, got '
                        f'{q.dtype}/{kv_cache.dtype}')
    if D not in (64, 128):
        raise ValueError(f'paged_decode kernel takes head_dim 64 or 128, got {D}')
    if two != 2 or HD != num_kv_heads * D or Hq % num_kv_heads or not 0 <= layer < L:
        raise ValueError(f'paged_decode: bad shapes q {tuple(q.shape)} cache '
                         f'{tuple(kv_cache.shape)} kv heads {num_kv_heads} layer {layer}')
    for name, t, dt in (('block_tables', block_tables, torch.int32),
                        ('kv_lens', kv_lens, torch.int32)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f'paged_decode: {name} must be contiguous {dt} on {q.device}')
    if block_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError('paged_decode: block_tables / kv_lens batch mismatch')
    if not q.is_contiguous() or not kv_cache.is_contiguous() or kv_cache.device != q.device:
        raise ValueError('paged_decode: q and kv_cache must be contiguous on one device')
    sinks_ptr = None
    if sinks is not None:
        sinks = sinks.to(device=q.device, dtype=torch.float32).contiguous()
        if sinks.shape != (Hq,):
            raise ValueError(f'paged_decode: sinks must be [{Hq}], got {tuple(sinks.shape)}')
        sinks_ptr = sinks.data_ptr()
    out = torch.empty_like(q)
    fn = cuda_build.entry('paged_decode', 'paged_decode_bf16', _ARGTYPES)
    rc = fn(q.data_ptr(), kv_cache.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), sinks_ptr, out.data_ptr(),
            B, Hq, num_kv_heads, D, NB, BS, W, layer, scale,
            logit_softcap if logit_softcap else 0.0,
            window if window and window > 0 else 0, cuda_build.stream_handle(q))
    cuda_build.check(rc, 'paged_decode')
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_int8_plain(q: torch.Tensor, kv: QuantKV,
                                      block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                      layer: int, scale: float, num_kv_heads: int,
                                      logit_softcap: Optional[float] = None
                                      ) -> torch.Tensor:
    """q [B,Hq,D] over an int8 cache -> [B,Hq,D]; f32, scales on the score side."""
    B, Hq, D = q.shape
    G = Hq // num_kv_heads
    _, NB, _, BS, _ = kv.data.shape
    W = block_tables.shape[1]
    tables = block_tables.long().clamp(0, NB - 1)
    pages = kv.data[layer][tables]                           # [B, W, 2, BS, HD] i8
    scales = kv.scale[layer][tables]                         # [B, W, 2, BS, Hkv]
    k = pages[:, :, 0].reshape(B, W * BS, num_kv_heads, D).float()
    v = pages[:, :, 1].reshape(B, W * BS, num_kv_heads, D).float()
    ksc = scales[:, :, 0].reshape(B, W * BS, num_kv_heads).permute(0, 2, 1)[:, :, None]
    vsc = scales[:, :, 1].reshape(B, W * BS, num_kv_heads).permute(0, 2, 1)[:, :, None]
    qg = q.float().reshape(B, num_kv_heads, G, D) * scale
    s = torch.einsum('bhgd,bshd->bhgs', qg, k) * ksc
    if logit_softcap is not None and logit_softcap > 0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    valid = torch.arange(W * BS, device=q.device)[None, :] < kv_lens.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full((), MASK_VALUE, device=q.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(-1)
    out = torch.einsum('bhgs,bshd->bhgd', p * vsc, v)
    out = out / torch.where(lsum == 0, torch.ones_like(lsum), lsum)[..., None]
    out = torch.where((kv_lens > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention_int8(q: torch.Tensor, kv: QuantKV, block_tables: torch.Tensor,
                                kv_lens: torch.Tensor, layer: int, scale: float,
                                num_kv_heads: int,
                                logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,Hq,D] bf16; ``kv.data`` int8 [L,NB,2,BS,Hkv*D], ``kv.scale`` f32
    [L,NB,2,BS,Hkv]; block_tables [B,W] i32; kv_lens [B] i32.  Returns [B,Hq,D]."""
    if not q.is_cuda:
        return paged_decode_attention_int8_plain(q, kv, block_tables, kv_lens, layer,
                                                 scale, num_kv_heads, logit_softcap)
    B, Hq, D = q.shape
    data, scales = kv.data, kv.scale
    L, NB, two, BS, HD = data.shape
    W = block_tables.shape[1]
    if q.dtype != torch.bfloat16 or data.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f'paged_decode_int8 kernel takes bf16 q, int8 data and f32 '
                        f'scales, got {q.dtype}/{data.dtype}/{scales.dtype}')
    if D not in (64, 128) or BS % 16:
        raise ValueError(f'paged_decode_int8 kernel takes head_dim 64 or 128 and a '
                         f'block size that is a multiple of 16, got {D} / {BS}')
    if (two != 2 or HD != num_kv_heads * D or Hq % num_kv_heads or not 0 <= layer < L
            or scales.shape != (L, NB, 2, BS, num_kv_heads)):
        raise ValueError(f'paged_decode_int8: bad shapes q {tuple(q.shape)} data '
                         f'{tuple(data.shape)} scale {tuple(scales.shape)} kv heads '
                         f'{num_kv_heads} layer {layer}')
    for name, t, dt in (('block_tables', block_tables, torch.int32),
                        ('kv_lens', kv_lens, torch.int32)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f'paged_decode_int8: {name} must be contiguous {dt} on '
                             f'{q.device}')
    if block_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError('paged_decode_int8: block_tables / kv_lens batch mismatch')
    for t in (q, data, scales):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError('paged_decode_int8: q, data and scale must be contiguous '
                             'on one device')
    out = torch.empty_like(q)
    fn = cuda_build.entry('paged_decode_int8', 'paged_decode_int8', _ARGTYPES_INT8)
    rc = fn(q.data_ptr(), data.data_ptr(), scales.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), B, Hq, num_kv_heads, D, NB, BS, W,
            layer, scale, logit_softcap if logit_softcap else 0.0,
            cuda_build.stream_handle(q))
    cuda_build.check(rc, 'paged_decode_int8')
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0
