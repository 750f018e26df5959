"""Expert-batched quantized matmul (the routed experts of a dense-combine MoE step).

Port of ``lmdeploy_tpu/ops/pallas/quant_bmm.py`` for its MXFP4 half, the product
gpt-oss's MXFP4-resident experts run (``mxfp4_bmm``, body ``_mxfp4_kernel``).  On a
CUDA tensor ``mxfp4_bmm`` launches the hand-written Hopper kernel in
``csrc/mxfp4_bmm.cu`` (its header says what bounds it and how it is laid out); on a
CPU tensor it runs ``mxfp4_bmm_plain``, the same function in plain PyTorch (the
reference's ``mxfp4_bmm_reference``).  There is no fallback: a CUDA tensor the kernel
does not take raises.

Layout: e2m1 codes ``nib u8 [E, K/2, N]`` in the "half-split" packing (low nibble =
weight row r, high nibble = row K/2 + r, so both activation halves are contiguous
column slices) and f32 group scales ``scale [E, K/32, N]`` (ue8m0 decoded at load;
the high half takes scale rows K/64 ..).  ``x`` is ``[M, K]`` shared by every expert
(the gate and up products) or ``[E, M, K]``, one slice per expert (the down product).
Both versions round x to bf16 first, as the reference does, whatever x's dtype; the
result is f32 ``[E, M, N]``.

The blocked-fp8 half (``fp8_bmm``, DeepSeek-V3's experts) waits for the MLA slice.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MXFP4_GROUP = 32     # e2m1 values per ue8m0 scale
_P, _I = ctypes.c_void_p, ctypes.c_int
# mxfp4_bmm(x, nib, scale, out, E, M, N, K, x_per_expert, stream)
_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
_FP8_NOT_PORTED = ('fp8_bmm (blocked fp8-e4m3 experts) is not ported yet: ROADMAP.md '
                   'section 2, kernel queue item 7')


def decode_e2m1(codes: torch.Tensor) -> torch.Tensor:
    """e2m1 nibble codes (0..15, any integer dtype) -> f32 {0,.5,1,1.5,2,3,4,6} signed
    (code 8 is -0.0, code 1 the subnormal 0.5)."""
    c = codes.to(torch.int32)
    m = (c & 1).float()
    e = (c >> 1) & 3
    mag = torch.where(e == 0, 0.5 * m,
                      (2.0 + m) * torch.where(e == 1, 0.5, torch.where(e == 2, 1.0, 2.0)))
    return torch.where((c & 8) > 0, -mag, mag)


def widen_mxfp4(nib: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[..., K/2, N] half-split e2m1 + [..., K/32, N] f32 scales -> dense [..., K, N]:
    each value times its group scale in f32, rounded once to ``dtype``."""
    vals = torch.cat([decode_e2m1(nib & 0xF), decode_e2m1(nib >> 4)], dim=-2)
    *lead, K, N = vals.shape
    G = scale.shape[-2]
    w = vals.view(*lead, G, K // G, N) * scale.float().unsqueeze(-2)
    return w.view(*lead, K, N).to(dtype)


def _check(x: torch.Tensor, nib: torch.Tensor, scale: torch.Tensor):
    E, K2, N = nib.shape
    K = 2 * K2
    if (x.shape[-1] != K or x.dim() not in (2, 3) or (x.dim() == 3 and x.shape[0] != E)
            or scale.shape != (E, K // MXFP4_GROUP, N) or K2 % MXFP4_GROUP):
        raise ValueError(f'mxfp4_bmm: bad shapes x {tuple(x.shape)} nib {tuple(nib.shape)} '
                         f'scale {tuple(scale.shape)} (need 32 | K/2)')
    return E, x.shape[-2], N, K


def mxfp4_bmm_plain(x: torch.Tensor, nib: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y[e] = bf16(x(@e)) @ widen_mxfp4(nib[e], scale[e]) with exact products and f32
    sums; returns f32 [E, M, N]."""
    _check(x, nib, scale)
    w = widen_mxfp4(nib, scale, torch.bfloat16).float()
    return torch.matmul(x.to(torch.bfloat16).float(), w)


def mxfp4_bmm(x: torch.Tensor, nib: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [E, M, K]; nib u8 [E, K/2, N]; scale f32 [E, K/32, N] -> f32
    [E, M, N].  The kernel takes K % 64 == 0 and N % 16 == 0."""
    if not x.is_cuda:
        return mxfp4_bmm_plain(x, nib, scale)
    E, M, N, K = _check(x, nib, scale)
    if nib.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f'mxfp4_bmm kernel takes u8 codes and f32 scales, got '
                        f'{nib.dtype}/{scale.dtype}')
    if N % 16 or E > 65535:
        raise ValueError(f'mxfp4_bmm kernel takes N % 16 == 0 and E <= 65535; got N {N} '
                         f'E {E}')
    xb = x.to(torch.bfloat16).contiguous()
    for name, t in (('nib', nib), ('scale', scale)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'mxfp4_bmm: {name} must be contiguous on {x.device}')
    out = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    fn = cuda_build.entry('mxfp4_bmm', 'mxfp4_bmm', _ARGTYPES)
    rc = fn(xb.data_ptr(), nib.data_ptr(), scale.data_ptr(), out.data_ptr(),
            E, M, N, K, int(x.dim() == 3), cuda_build.stream_handle(x))
    cuda_build.check(rc, 'mxfp4_bmm')
    mxfp4_bmm.launches += 1
    return out


mxfp4_bmm.launches = 0


def fp8_bmm(x, w8, gscale):
    raise NotImplementedError(_FP8_NOT_PORTED)


def widen_fp8(w8, gscale, dtype=torch.bfloat16):
    raise NotImplementedError(_FP8_NOT_PORTED)
