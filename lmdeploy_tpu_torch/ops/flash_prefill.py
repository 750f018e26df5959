"""Causal GQA flash attention for fresh prefill chunks.

Replaces the TPU kernel ``lmdeploy_tpu/ops/pallas/flash_prefill.py``
(``flash_prefill_attention``).  On a CUDA tensor the wrapper launches the hand-written
Hopper kernel in ``csrc/flash_prefill.cu`` (its header says what bounds it and how it is
laid out); on a CPU tensor it runs ``flash_prefill_attention_plain``, the same function
in plain PyTorch.  There is no fallback: a CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the head dims the attention kernels are built for: the served families' and MLA's
# latent 576 (kv_lora_rank 512 + rope 64)
HEAD_DIMS = (64, 80, 96, 128, 192, 256, 576)
# q / k / v (and output) dtypes, as the kernels' dtype argument numbers them
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
# flash_prefill(q, k, v, out, dtype, B, T, Hq, Hkv, D, q/k/v token strides, scale, stream)
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, _P]


def flash_prefill_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  scale: float) -> torch.Tensor:
    """q [B,T,Hq,D], k/v [B,T,Hkv,D] -> [B,T,Hq,D]; f32 softmax over causal keys."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum('bthgd,bshd->bhgts', qg, k.float()) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.full((), MASK_VALUE, device=q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    out = torch.einsum('bhgts,bshd->bhgtd', p, v.float())
    out = out / torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def _token_stride(x: torch.Tensor, name: str) -> int:
    B, T, H, D = x.shape
    if x.stride(3) != 1 or x.stride(2) != D or (B > 1 and x.stride(0) != T * x.stride(1)):
        raise ValueError(f'flash_prefill: {name} needs contiguous heads inside a token '
                         f'and batch-major tokens, got strides {x.stride()}')
    if x.data_ptr() % 16 or (T > 1 and x.stride(1) * x.element_size() % 16):
        raise ValueError(f'flash_prefill: {name} rows must be 16-byte aligned '
                         f'(16-byte vector loads), got strides {x.stride()}')
    return x.stride(1)


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """q [B,T,Hq,D], k/v [B,T,Hkv,D] -> [B,T,Hq,D] causal attention over the chunk."""
    if not q.is_cuda:
        return flash_prefill_attention_plain(q, k, v, scale)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'flash_prefill kernel takes one of bf16, f16 and f32 for q, k '
                        f'and v, got {q.dtype}/{k.dtype}/{v.dtype}')
    if k.device != q.device or v.device != q.device:
        raise ValueError('flash_prefill: q, k and v must be on one device')
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f'flash_prefill: bad shapes q {tuple(q.shape)} '
                         f'k {tuple(k.shape)} v {tuple(v.shape)}')
    if D not in HEAD_DIMS:
        raise ValueError(f'flash_prefill kernel is built for head_dim in {HEAD_DIMS}, '
                         f'got {D}')
    strides = [_token_stride(x, n) for x, n in ((q, 'q'), (k, 'k'), (v, 'v'))]
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    fn = cuda_build.entry('flash_prefill', 'flash_prefill', _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), KERNEL_DTYPES[q.dtype],
            B, T, Hq, Hkv, D, *strides, scale, cuda_build.stream_handle(q))
    cuda_build.check(rc, 'flash_prefill')
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
