"""Expert-batched quantized matmul (the routed experts of a dense-combine MoE step).

Port of ``lmdeploy_tpu/ops/pallas/quant_bmm.py``: the product gpt-oss's MXFP4-resident
experts run (``mxfp4_bmm``, body ``_mxfp4_kernel``) and the one DeepSeek's
blocked-fp8-resident experts run (``fp8_bmm``, body ``_fp8_kernel``).  On a CUDA tensor
each launches its hand-written Hopper kernel (``csrc/mxfp4_bmm.cu``,
``csrc/fp8_bmm.cu``; their headers say what bounds them and how they are laid out); on
a CPU tensor each runs its ``*_plain`` version, the same function in plain PyTorch (the
reference's ``*_reference``).  There is no fallback: a CUDA tensor a kernel does not
take raises.

MXFP4 layout: e2m1 codes ``nib u8 [E, K/2, N]`` in the "half-split" packing (low
nibble = weight row r, high nibble = row K/2 + r, so both activation halves are
contiguous column slices) and f32 group scales ``scale [E, K/32, N]`` (ue8m0 decoded
at load; the high half takes scale rows K/64 ..).

Blocked-fp8 layout: ``w8 float8_e4m3fn [E, K, N]`` and f32 scale rows ``gscale [E, K/g,
N]`` (the checkpoint's 128 x 128 ``weight_scale_inv`` grid transposed and expanded
along N at load); the group g = K / (K/g) is read from the shapes.  A weight is
``bf16(decode(w8) * gscale)``, where ``decode_fp8_e4m3`` is the reference's arithmetic
decode: it reads the e4m3 NaN code 0x7f / 0xff as +-480 (exponent 15, mantissa 7).
``widen_fp8`` is the reference's ``widen_fp8`` (the >= 768-row route), which casts and
so gives NaN there; finite checkpoints never hold that code.

``x`` is ``[M, K]`` shared by every expert (the gate and up products) or ``[E, M,
K]``, one slice per expert (the down product).  Both products round x to bf16 first,
as the reference does, whatever x's dtype; the result is f32 ``[E, M, N]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MXFP4_GROUP = 32     # e2m1 values per ue8m0 scale
# the output columns of one work item of the fp8 kernel (its token tile is
# ``quant_matmul.token_tile``)
FP8_ITEM_COLUMNS = 256
_P, _I = ctypes.c_void_p, ctypes.c_int
# mxfp4_bmm(x, nib, scale, out, E, M, N, K, x_per_expert, stream)
_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
# fp8_bmm(x, w8, gscale, out, E, M, N, K, group, x_per_expert, stream)
_ARGTYPES_FP8 = [_P] * 4 + [_I] * 6 + [_P]


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
    for name, t in (('x', xb), ('nib', nib), ('scale', scale)):
        if not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f'mxfp4_bmm: {name} must be contiguous and 16-byte aligned '
                             f'on {x.device}')
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


# ---------------------------------------------------------------------- blocked fp8 --
def decode_fp8_e4m3(w8: torch.Tensor) -> torch.Tensor:
    """e4m3 weights (``float8_e4m3fn``, or their bytes as u8) -> f32, the reference's
    arithmetic decode (``_decode_fp8_e4m3``): normals (1 + m/8) 2^(e-7) assembled in
    the f32 bit fields, subnormals m 2^-9, and the NaN code 0x7f / 0xff read as +-480."""
    bits = (w8.view(torch.uint8) if w8.dtype == torch.float8_e4m3fn else w8).to(torch.int32)
    e = (bits >> 3) & 0xF
    m = bits & 7
    mag = (((e + 120) << 23) | (m << 20)).view(torch.float32)
    mag = torch.where(e == 0, m.float() * 2.0 ** -9, mag)
    return torch.where(bits >= 128, -mag, mag)


def _group_rows(gscale: torch.Tensor, K: int) -> torch.Tensor:
    """[..., K/g, N] scale rows -> [..., K, N], each row repeated over its group."""
    return gscale.float().repeat_interleave(K // gscale.shape[-2], dim=-2)[..., :K, :]


def widen_fp8(w8: torch.Tensor, gscale: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[..., K, N] e4m3 + [..., K/g, N] f32 scale rows -> dense [..., K, N]: the
    reference's ``widen_fp8`` (a cast, so the NaN code widens to NaN), each value times
    its scale in f32, rounded once to ``dtype``."""
    return (w8.float() * _group_rows(gscale, w8.shape[-2])).to(dtype)


def _check_fp8(x: torch.Tensor, w8: torch.Tensor, gscale: torch.Tensor):
    E, K, N = w8.shape
    G = gscale.shape[-2]
    if (x.shape[-1] != K or x.dim() not in (2, 3) or (x.dim() == 3 and x.shape[0] != E)
            or gscale.shape != (E, G, N) or G == 0 or K % G):
        raise ValueError(f'fp8_bmm: bad shapes x {tuple(x.shape)} w8 {tuple(w8.shape)} '
                         f'gscale {tuple(gscale.shape)} (need K/g scale rows, g | K)')
    return E, x.shape[-2], N, K, K // G


def fp8_bmm_plain(x: torch.Tensor, w8: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """y[e] = bf16(x(@e)) @ bf16(decode_fp8_e4m3(w8[e]) * gscale[e]) with exact products
    and f32 sums (the Pallas kernel's decode, NaN code included); returns f32 [E, M, N]."""
    _check_fp8(x, w8, gscale)
    w = (decode_fp8_e4m3(w8) * _group_rows(gscale, w8.shape[-2])).to(torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).float(), w.float())


def fp8_bmm(x: torch.Tensor, w8: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x [M, K] or [E, M, K]; w8 float8_e4m3fn [E, K, N]; gscale f32 [E, K/g, N] -> f32
    [E, M, N].  The kernel takes K % 32 == 0, g % 16 == 0 and N % 16 == 0."""
    if not x.is_cuda:
        return fp8_bmm_plain(x, w8, gscale)
    E, M, N, K, group = _check_fp8(x, w8, gscale)
    if w8.dtype != torch.float8_e4m3fn or gscale.dtype != torch.float32:
        raise TypeError(f'fp8_bmm kernel takes e4m3 weights and f32 scales, got '
                        f'{w8.dtype}/{gscale.dtype}')
    if K % 32 or group % 16 or N % 16 or E > 65535:
        raise ValueError(f'fp8_bmm kernel takes K % 32 == 0, a group that is a multiple '
                         f'of 16, N % 16 == 0 and E <= 65535; got K {K} group {group} '
                         f'N {N} E {E}')
    xb = x.to(torch.bfloat16).contiguous()
    for name, t in (('w8', w8), ('gscale', gscale)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'fp8_bmm: {name} must be contiguous on {x.device}')
    out = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    fn = cuda_build.entry('fp8_bmm', 'fp8_bmm', _ARGTYPES_FP8)
    rc = fn(xb.data_ptr(), w8.data_ptr(), gscale.data_ptr(), out.data_ptr(),
            E, M, N, K, group, int(x.dim() == 3), cuda_build.stream_handle(x))
    cuda_build.check(rc, 'fp8_bmm')
    fp8_bmm.launches += 1
    return out


fp8_bmm.launches = 0
