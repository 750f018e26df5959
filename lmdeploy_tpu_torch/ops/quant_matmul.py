"""W4A16 GEMM over plane-packed int4 weights (AWQ / GPTQ serving).

Port of ``lmdeploy_tpu/ops/pallas/quant_matmul.py`` for its default schedule, the
group-dot ("gd") body of ``w4a16_matmul_stacked`` (``_w4a16_kernel_stacked_gd``).
On a CUDA tensor ``w4a16_matmul_gd`` launches the hand-written Hopper kernel in
``csrc/w4a16_gemm.cu`` (its header says what bounds it and how it is laid out); on a
CPU tensor it runs ``w4a16_matmul_gd_plain``, the same function in plain PyTorch.
There is no fallback: a CUDA tensor the kernel does not take raises.

Weight layout ("plane-packed"): word ``r`` of ``packed i32[K/8, N]`` holds 8 nibbles;
plane ``j`` (j = 0..3) covers input rows ``[j*K/4, (j+1)*K/4)``, its row ``2r`` sits at
bits ``[4j, 4j+4)`` and its row ``2r+1`` at bits ``[16+4j, 16+4j+4)``.  So
``((w >> 4j) & 0x000F000F) | 0x43004300`` is a bf16 pair holding ``128 + q`` for two
k-adjacent rows, with no convert.  Zero points never enter the product:
``(q - z)*s = (128 + q)*s - (z + 128)*s``, and the second term collapses to per-group
activation sums ``xg`` times ``corr = (z + 128)*s``.

Numerics that must hold (``ROADMAP.md`` section 3, traps 1-3): the correction
``xg @ corr`` runs in full f32 (its magnitude is ~17-30x the signal, so TF32 or bf16
operands there put 6-15% error into the output); ``xg`` sums the same bf16-rounded
activations the main product reads; the output stays f32 until ``corr`` is
subtracted.

Prefill-sized products (more than 256 rows) dequantize to a dense bf16 weight with
torch ops and run one ``torch.matmul`` (``w4a16_dense_szc``), as the reference does in
XLA.  The fast / precise prepared leaves (bf16 ``sb``) are not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
# w4a16_gemm_gd(x, packed, sb, corr, xg, out, ws, counters, M, N, K, group_size,
#               splits, stream)
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_P]
# rows of a tile the kernel computes per block (16 * MT, MT <= 4) and its columns
_TILE_M, _TILE_N = 64, 128
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


# -- weight preparation -----------------------------------------------------------------
def prep_w4(scales: torch.Tensor, zeros: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (scales, zeros) -> (sb, corr) for the group-dot schedule (the reference's
    ``prep_w4(..., mode='gd')``): ``sb = f32(s)``, ``corr = f32((z + 128) * s)``.
    Works on [G, N] or [L, G, N].  The fast and precise modes (bf16 ``sb``) are not
    ported yet."""
    s = scales.float()
    return s, (zeros.float() + 128.0) * s


def _unpack_planes(packed: torch.Tensor) -> torch.Tensor:
    """i32 [K/8, N] -> int32 [K, N] nibble values in K order (plane by plane)."""
    K8, N = packed.shape
    i = torch.arange(8, dtype=torch.int32, device=packed.device)
    shifts = 4 * (i // 2) + 16 * (i % 2)                      # plane j, half h: 4j + 16h
    q = (packed[None] >> shifts[:, None, None]) & 0xF          # [(j, h), K/8, N]
    return q.view(4, 2, K8, N).permute(0, 2, 1, 3).reshape(8 * K8, N)


def dequant_w4(packed: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
               group_size: int = 128, dtype=torch.bfloat16) -> torch.Tensor:
    """Plane-packed i32[K/8, N] + raw f32 scales / zeros [K/gs, N] -> dense [K, N]."""
    q = _unpack_planes(packed).float()
    K, N = q.shape
    w = q.view(K // group_size, group_size, N)
    w.sub_(zeros.float()[:, None]).mul_(scales.float()[:, None])
    return q.to(dtype)


def dequant_w4_szc(packed: torch.Tensor, sb: torch.Tensor, corr: torch.Tensor,
                   group_size: int = 128, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [K, N] weight from prepared gd operands: ``(128 + q) * sb - corr`` in
    f32 (broadcast over [G, gs, N] views, in place), rounded once to ``dtype``."""
    if sb.dtype != torch.float32:
        raise NotImplementedError('w4a16 fast/precise prepared leaves (bf16 sb) are '
                                  'not ported')
    q = _unpack_planes(packed).float()
    K, N = q.shape
    w = q.view(K // group_size, group_size, N)
    w.add_(128.0).mul_(sb[:, None]).sub_(corr.float()[:, None])
    return q.to(dtype)


def w4a16_dense_szc(x2d: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                    corr: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Prefill-sized product over prepared leaves: bf16-rounded x times the dense bf16
    dequantized weight with f32 accumulation.  A bf16 x takes one bf16 GEMM (its f32
    accumulator rounded once); an f32 x multiplies the same bf16 operands in f32.
    Returns x.dtype."""
    xb = x2d.to(torch.bfloat16)
    w = dequant_w4_szc(packed, sb, corr, group_size)
    if x2d.dtype == torch.bfloat16:
        return torch.matmul(xb, w)
    return torch.matmul(xb.to(x2d.dtype), w.to(x2d.dtype))


# -- test and seeded-weight helpers -----------------------------------------------------
def pack_w4(w_q) -> torch.Tensor:
    """int4 values (0..15) [K, N] (numpy or tensor) -> plane-packed i32[K/8, N], on the
    input tensor's device (the CPU for numpy)."""
    q = torch.as_tensor(np.asarray(w_q) if not torch.is_tensor(w_q) else w_q)
    q = q.to(torch.int64)
    K, N = q.shape
    assert K % 8 == 0, K
    Kq = K // 4
    out = torch.zeros((K // 8, N), dtype=torch.int64, device=q.device)
    for j in range(4):
        pj = q[j * Kq:(j + 1) * Kq]
        out |= pj[0::2] << (4 * j)
        out |= pj[1::2] << (16 + 4 * j)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def quantize_w4(w: torch.Tensor, group_size: int = 128):
    """Group-wise asymmetric 4-bit quantization of a dense [K, N] weight (AWQ's
    min/max scheme) -> (packed i32[K/8, N], scales f32[K/gs, N], zeros f32[K/gs, N])."""
    K, N = w.shape
    wg = w.reshape(K // group_size, group_size, N).float()
    w_min = wg.amin(dim=1)
    w_max = wg.amax(dim=1)
    scales = (w_max - w_min) / 15.0
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    zeros = -w_min / scales
    q = torch.clamp(torch.round(wg / scales[:, None] + zeros[:, None]), 0, 15)
    return pack_w4(q.reshape(K, N).to(torch.uint8)), scales, zeros


# -- the group-dot product --------------------------------------------------------------
def _check_gd(x: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
              corr: torch.Tensor, group_size: int):
    M, K = x.shape
    K8, N = packed.shape
    G = K // group_size
    if K8 * 8 != K or K % (4 * group_size) or sb.shape != (G, N) or corr.shape != (G, N):
        raise ValueError(f'w4a16: bad shapes x {tuple(x.shape)} packed '
                         f'{tuple(packed.shape)} sb {tuple(sb.shape)} corr '
                         f'{tuple(corr.shape)} group {group_size}')
    if sb.dtype != torch.float32 or corr.dtype != torch.float32:
        raise NotImplementedError('w4a16: only the gd schedule (f32 sb and corr) is '
                                  'ported')
    return M, K, N, G


def _xg(xb: torch.Tensor, group_size: int) -> torch.Tensor:
    """Per-group sums of the bf16-rounded activations, in f32: [M, K/gs]."""
    M, K = xb.shape
    return xb.float().view(M, K // group_size, group_size).sum(-1)


def w4a16_matmul_gd_plain(x: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                          corr: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """x [M, K], packed i32[K/8, N], sb / corr f32 [K/gs, N] -> [M, N] in x.dtype.

    In f32: sum over planes and groups of (x_g @ (128 + q)_g) * s_g, minus xg @ corr
    with xg summed from the bf16-rounded x.  The correction is an elementwise
    product and sum, so no TF32 setting can touch it."""
    M, K, N, G = _check_gd(x, packed, sb, corr, group_size)
    xb = x.to(torch.bfloat16)
    xr = xb.float().view(M, G, group_size).transpose(0, 1)             # [G, M, gs]
    w = (_unpack_planes(packed).float() + 128.0).view(G, group_size, N)
    part = torch.bmm(xr, w)                                             # [G, M, N]
    acc = (part * sb[:, None, :]).sum(0)
    c = (_xg(xb, group_size)[:, :, None] * corr[None]).sum(1)          # [M, N]
    return (acc - c).to(x.dtype)


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Per-tile arrival counters of the split-K fix-up, zero between launches (the
    kernel resets each one it uses).  One buffer per (device, stream): launches on
    one stream run in order, so they never share a counter while in flight."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _m_tile(M: int) -> int:
    return 16 if M <= 16 else 32 if M <= 32 else _TILE_M


def w4a16_splits(M: int, N: int, G: int, sms: int) -> int:
    """K splits the kernel takes when the (column, row) tiles alone leave SMs idle:
    as many as fill the card once, at most one per 4 groups (one group per plane)."""
    tiles = -(-N // _TILE_N) * -(-M // _m_tile(M))
    return max(1, min(G // 4, sms // tiles))


def w4a16_matmul_gd(x: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                    corr: torch.Tensor, group_size: int = 128,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Decode-regime W4A16 GEMM over one layer's prepared gd leaves.

    x [M, K] (M <= 256; K padded to the leaf's ``packed.shape[0] * 8``), packed
    i32[K/8, N], sb / corr f32[K/gs, N].  ``splits`` (1 .. K/(4*gs)) overrides the
    K-split count ``w4a16_splits`` picks.  Returns [M, N] in x.dtype."""
    if not x.is_cuda:
        return w4a16_matmul_gd_plain(x, packed, sb, corr, group_size)
    M, K, N, G = _check_gd(x, packed, sb, corr, group_size)
    if x.dtype != torch.bfloat16 or packed.dtype != torch.int32:
        raise TypeError(f'w4a16 kernel takes bf16 x and int32 packed, got '
                        f'{x.dtype}/{packed.dtype}')
    if group_size not in (32, 64, 128) or N % 8 or not 0 < M <= 4 * _TILE_M:
        raise ValueError(f'w4a16 kernel takes group 32/64/128, N % 8 == 0 and '
                         f'0 < M <= {4 * _TILE_M}; got gs {group_size} N {N} M {M}')
    for name, t in (('x', x), ('packed', packed), ('sb', sb), ('corr', corr)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'w4a16: {name} must be contiguous on {x.device}')
    if splits is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = w4a16_splits(M, N, G, sms)
    elif not 1 <= splits <= G // 4:
        raise ValueError(f'w4a16: splits must be 1..{G // 4}, got {splits}')
    xg = _xg(x, group_size)
    m_tile = _m_tile(M)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits if splits > 1 else 0, -(-M // m_tile) * m_tile, N),
                     dtype=torch.float32, device=x.device)
    stream = cuda_build.stream_handle(x)
    counters = _counters(x.device, stream, -(-N // _TILE_N) * -(-M // m_tile))
    fn = cuda_build.entry('w4a16_gemm', 'w4a16_gemm_gd', _ARGTYPES)
    rc = fn(x.data_ptr(), packed.data_ptr(), sb.data_ptr(), corr.data_ptr(),
            xg.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            M, N, K, group_size, splits, stream)
    cuda_build.check(rc, 'w4a16_gemm')
    w4a16_matmul_gd.launches += 1
    return out


w4a16_matmul_gd.launches = 0
