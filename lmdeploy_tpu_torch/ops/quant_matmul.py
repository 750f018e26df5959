"""W4A16 GEMMs over plane-packed int4 weights (AWQ / GPTQ serving).

Port of ``lmdeploy_tpu/ops/pallas/quant_matmul.py``: each of its three TPU kernel
bodies becomes a hand-written Hopper kernel, launched by a wrapper here on a CUDA
tensor; on a CPU tensor each wrapper runs its plain PyTorch version.  There is no
fallback: a CUDA tensor a kernel does not take raises.

  * ``w4a16_matmul_gd`` (``csrc/w4a16_gemm.cu``): the group-dot ("gd") body of
    ``w4a16_matmul_stacked`` (``_w4a16_kernel_stacked_gd``), the default schedule, over
    prepared leaves with f32 ``sb`` / ``corr``;
  * ``w4a16_matmul_szc`` (``csrc/w4a16_gemm_szc.cu``): the fast / precise body of the
    same wrapper (``_w4a16_kernel_stacked``) over prepared leaves with bf16 ``sb``:
    fast with an f32 ``corr``, precise with a bf16 one;
  * ``w4a16_matmul`` (``csrc/w4a16_gemm_unprepared.cu``): the unstacked W4A16 GEMM over
    unprepared leaves, raw f32 scales and zeros (``w4a16_matmul``,
    ``_w4a16_kernel_groupdot``).
All three run one body (``csrc/w4a16_gemm.cuh``): a warp-specialised wgmma kernel with
the decoded weights as its register operand and x brought by TMA, one token tile of
``token_tile(M)`` rows, K split ``w4a16_splits`` ways.  The headers say what bounds
the kernels and how they are laid out.

Weight layout ("plane-packed"): word ``r`` of ``packed i32[K/8, N]`` holds 8 nibbles;
plane ``j`` (j = 0..3) covers input rows ``[j*K/4, (j+1)*K/4)``, its row ``2r`` sits at
bits ``[4j, 4j+4)`` and its row ``2r+1`` at bits ``[16+4j, 16+4j+4)``.  So
``((w >> 4j) & 0x000F000F) | 0x43004300`` is a bf16 pair holding ``128 + q`` for two
k-adjacent rows, with no convert.  Zero points never enter the product:
``(q - z)*s = (128 + q)*s - (z + 128)*s``, and the second term collapses to per-group
activation sums ``xg`` times ``corr = (z + 128)*s`` (precise: the weights are
``(q - 7)*sb`` and ``corr = (z - 7)*sb``).

Numerics that must hold (``ROADMAP.md`` section 3, traps 1-3): an f32 ``corr`` enters
``xg @ corr`` in full f32 (the term is ~17-30x the signal, so TF32 or bf16 operands
there put 6-15% error into the output); fast and precise ``corr`` come from the
bf16-rounded scales; ``xg`` sums the same bf16-rounded activations the main product
reads; the output stays f32 until ``corr`` is subtracted.  Fast and precise round each
weight's product with its bf16 scale to bf16 before the dot (``dequant_w4_biased``),
as the TPU kernel does.

Prefill-sized products (more than 256 rows) dequantize to a dense bf16 weight with
torch ops and run one ``torch.matmul``, as the reference does in XLA.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
# w4a16_gemm_<kind>(x, packed, scale_table, corr_table, xg, out, ws, counters, M, N, K,
#                   group_size, splits, stream)
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_P]
# output columns of a W4A16 kernel's block; the token tiles (wgmma N) of the W4A16 and
# fp8 kernels (``token_tile``), and the group sizes
_TILE_N = 128
TOKEN_TILES = (16, 64, 128)
GROUP_SIZES = (32, 64, 128)
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_RETIRED_COUNTERS = []
# rows at or below which the group-dot products run (reference GROUP_DOT_MAX_M); above
# it the product turns compute-bound and one dense GEMM wins
GROUP_DOT_MAX_M = 256
# 128 (decode bias) + 7 (nibble center): precise mode's subtrahend, exact in bf16
C135 = 135.0


# -- weight preparation -----------------------------------------------------------------
def prep_w4(scales: torch.Tensor, zeros: torch.Tensor, precise: bool = False,
            mode: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (scales, zeros) -> the prepared (sb, corr) (reference ``prep_w4``):

      fast:    sb = bf16(s), corr = f32((z + 128) * sb)
      precise: sb = bf16(s), corr = bf16((z - 7) * sb)
      gd:      sb = f32(s),  corr = f32((z + 128) * s)

    ``mode`` None means precise when ``precise`` is set, else fast.  Fast and precise
    build ``corr`` from the bf16-rounded scales: the main term is ``(128 + q) * sb``, so
    a ``corr`` from unrounded scales would leave their rounding on the ~30x bias term.
    The dtypes select the schedule downstream (``schedule_of``).  Works on [G, N] or
    [L, G, N]."""
    if mode is None:
        mode = 'precise' if precise else 'fast'
    z = zeros.float()
    if mode == 'gd':
        s = scales.float()
        return s, (z + 128.0) * s
    if mode not in ('fast', 'precise'):
        raise ValueError(f'unknown w4a16 schedule {mode!r}')
    sb = scales.to(torch.bfloat16)
    s = sb.float()
    if mode == 'precise':
        return sb, ((z - 7.0) * s).to(torch.bfloat16)
    return sb, (z + 128.0) * s


def schedule_of(sb: torch.Tensor, corr: torch.Tensor) -> str:
    """The schedule a prepared leaf's dtypes select: f32 sb 'gd'; else a bf16 corr
    'precise' and an f32 one 'fast' (reference ``w4a16_matmul_stacked``)."""
    if sb.dtype == torch.float32:
        return 'gd'
    return 'precise' if corr.dtype == torch.bfloat16 else 'fast'


# -- dequantization ---------------------------------------------------------------------
def _nibbles_u8(packed: torch.Tensor) -> torch.Tensor:
    """i32 [K/8, N] -> u8 [K, N] nibble values in K order, from the words' bytes: byte
    ``2h + i`` of word r holds plane ``2i`` (low nibble) and plane ``2i + 1`` (high) of
    plane row ``2r + h``.  Two passes over the words, one byte a weight written."""
    K8, N = packed.shape
    b = packed.contiguous().view(torch.uint8).view(K8, N, 2, 2).permute(3, 0, 2, 1)
    q = torch.empty((2, 2, K8, 2, N), dtype=torch.uint8, device=packed.device)
    torch.bitwise_and(b, 15, out=q[:, 0])             # [i, r, h, n]: plane 2i
    torch.bitwise_right_shift(b, 4, out=q[:, 1])      # plane 2i + 1
    return q.view(8 * K8, N)


def dequant_w4(packed: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
               group_size: int = 128, dtype=torch.bfloat16) -> torch.Tensor:
    """Plane-packed i32[..., K/8, N] + raw f32 scales / zeros [..., K/gs, N] -> dense
    [..., K, N] in ``dtype``: (q - z) * s in f32, rounded once (the reference's
    ``dequant_w4``, and its ``jax.vmap`` over an expert stack).  A stack widens one
    [K, N] matrix at a time into the output, so the f32 intermediate stays one
    matrix."""
    *lead, K8, N = packed.shape
    K = 8 * K8
    G = K // group_size
    out = torch.empty((*lead, K, N), dtype=dtype, device=packed.device)
    for idx in np.ndindex(*lead):
        q = _nibbles_u8(packed[idx]).view(G, group_size, N)
        dst = out[idx].view(G, group_size, N)
        s = scales[idx].float()[:, None]
        z = zeros[idx].float()[:, None]
        if dtype == torch.float32:
            torch.sub(q, z, out=dst)
            dst.mul_(s)
        else:
            torch.mul(torch.sub(q, z), s, out=dst)
    return out


def dequant_w4_szc(packed: torch.Tensor, sb: torch.Tensor, corr: torch.Tensor,
                   group_size: int = 128, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [K, N] weight from prepared operands (reference ``dequant_w4_szc``):
    ``(q - bias) * sb - corr`` in f32, rounded once to ``dtype``; the bias is 7 for a
    bf16 ``corr`` (precise) and -128 otherwise (fast, gd)."""
    bias = 7.0 if corr.dtype == torch.bfloat16 else -128.0
    q = _nibbles_u8(packed).float()
    K, N = q.shape
    w = q.view(K // group_size, group_size, N)
    w.sub_(bias).mul_(sb.float()[:, None]).sub_(corr.float()[:, None])
    return q.to(dtype)


def dequant_w4_biased(packed: torch.Tensor, sb: torch.Tensor, group_size: int = 128,
                      subtrahend: float = 0.0) -> torch.Tensor:
    """bf16 ``(128 + q - subtrahend) * sb``, each weight's product rounded to bf16 once:
    the fast (``subtrahend`` 0) and precise (``C135``) kernels' weights (reference
    ``dequant_w4_biased``).  Both factors are bf16, so their f32 product is exact and
    rounds as a bf16 product does."""
    q = _nibbles_u8(packed).float()
    K, N = q.shape
    w = q.view(K // group_size, group_size, N).add_(128.0 - subtrahend)
    out = torch.empty((K, N), dtype=torch.bfloat16, device=packed.device)
    torch.mul(w, sb.to(torch.bfloat16).float()[:, None], out=out.view_as(w))
    return out


# -- dense routes (more than 256 rows) --------------------------------------------------
def _dense_dot(x2d: torch.Tensor, w: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """bf16-rounded x times a dense bf16 weight with f32 sums.  A bf16 x takes one bf16
    GEMM (its f32 accumulator rounded once to bf16) unless ``f32`` asks for the f32
    result; an f32 x, or ``f32``, multiplies the same bf16 values in f32."""
    xb = x2d.to(torch.bfloat16)
    if x2d.dtype == torch.bfloat16 and not f32:
        return torch.matmul(xb, w)
    return torch.matmul(xb.float(), w.float())


def w4a16_dense(x2d: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                zeros: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Unprepared leaf, dense route (reference ``w4a16_matmul_reference``): the bf16
    dequantized weight in one dot.  Returns x.dtype."""
    return _dense_dot(x2d, dequant_w4(packed, scales, zeros, group_size)).to(x2d.dtype)


def w4a16_dense_szc(x2d: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                    corr: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Prepared leaf, dense route, numerics matched to the schedule (reference
    ``w4a16_dense_szc``): gd and precise dequantize in f32 and round each weight once,
    then one dot; fast multiplies the biased weights (``dequant_w4_biased``) with an
    f32 result and subtracts ``xg @ corr`` in f32 (its main term is ~30x the signal,
    so it must not round before the subtraction).  Returns x.dtype."""
    if schedule_of(sb, corr) != 'fast':
        return _dense_dot(x2d, dequant_w4_szc(packed, sb, corr, group_size)).to(x2d.dtype)
    y = _dense_dot(x2d, dequant_w4_biased(packed, sb, group_size), f32=True)
    xg = _xg(x2d.to(torch.bfloat16), group_size)
    return (y - _correction(xg, corr.float())).to(x2d.dtype)


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


# -- the plain versions -----------------------------------------------------------------
def _check(x: torch.Tensor, packed: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           group_size: int):
    M, K = x.shape
    K8, N = packed.shape
    G = K // group_size
    if K8 * 8 != K or K % (4 * group_size) or a.shape != (G, N) or b.shape != (G, N):
        raise ValueError(f'w4a16: bad shapes x {tuple(x.shape)} packed '
                         f'{tuple(packed.shape)} tables {tuple(a.shape)} / '
                         f'{tuple(b.shape)} group {group_size}')
    return M, K, N, G


def _xg(xb: torch.Tensor, group_size: int, dtype=torch.float32) -> torch.Tensor:
    """Per-group sums of the bf16-rounded activations, summed in f32: [M, K/gs] in
    ``dtype`` (one reduction, which widens each value as it reads it and rounds each sum
    once to ``dtype``)."""
    M, K = xb.shape
    return torch.sum(xb.reshape(M, K // group_size, group_size), dim=-1, dtype=dtype)


def _correction(xg: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """xg [M, G] @ corr [G, N] as an f32 elementwise product and sum, which no TF32
    setting can touch."""
    return (xg[:, :, None] * corr[None]).sum(1)


def _group_dot(xb: torch.Tensor, packed: torch.Tensor, s: torch.Tensor,
               group_size: int) -> torch.Tensor:
    """f32 sum over quant groups of (x_g @ (128 + q)_g) * s_g: exact bf16 products,
    the f32 scale on each group's f32 dot output."""
    M, K = xb.shape
    G, N = K // group_size, packed.shape[1]
    xr = xb.float().view(M, G, group_size).transpose(0, 1)              # [G, M, gs]
    w = (_nibbles_u8(packed).float() + 128.0).view(G, group_size, N)
    return (torch.bmm(xr, w) * s.float()[:, None, :]).sum(0)


def w4a16_matmul_gd_plain(x: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                          corr: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """x [M, K], packed i32[K/8, N], sb / corr f32 [K/gs, N] -> [M, N] in x.dtype.

    In f32: sum over planes and groups of (x_g @ (128 + q)_g) * s_g, minus xg @ corr
    with xg summed from the bf16-rounded x."""
    _check(x, packed, sb, corr, group_size)
    xb = x.to(torch.bfloat16)
    acc = _group_dot(xb, packed, sb, group_size)
    return (acc - _correction(_xg(xb, group_size), corr.float())).to(x.dtype)


def w4a16_matmul_szc_plain(x: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                           corr: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """The fast / precise body (reference ``_w4a16_kernel_stacked``): x [M, K], packed
    i32[K/8, N], sb bf16 [K/gs, N], corr f32 (fast) or bf16 (precise) -> [M, N] in
    x.dtype.  Per weight the bf16 product ``(128 + q) * sb`` (precise:
    ``(q - 7) * sb``); bf16 x times those weights with f32 sums; minus ``xg @ corr``,
    with xg summed in f32 from the bf16 x: in f32 (fast), or xg rounded to bf16 and
    exact products of the bf16 operands summed in f32 (precise)."""
    _check(x, packed, sb, corr, group_size)
    precise = schedule_of(sb, corr) == 'precise'
    xb = x.to(torch.bfloat16)
    w = dequant_w4_biased(packed, sb, group_size, C135 if precise else 0.0)
    acc = torch.matmul(xb.float(), w.float())
    xg = _xg(xb, group_size)
    if precise:
        xg = xg.to(torch.bfloat16).float()
    return (acc - _correction(xg, corr.float())).to(x.dtype)


def w4a16_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                       zeros: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """The unprepared product (reference ``w4a16_matmul``): more than 256 rows, or a K
    that breaks the 4-plane group alignment, take the dense route; otherwise in f32,
    sum over planes and groups of (x_g @ (128 + q)_g) * s_g, minus
    xg @ ((z + 128) * s).  Returns [M, N] in x.dtype."""
    if _dense_route(x, group_size):
        return w4a16_dense(x, packed, scales, zeros, group_size)
    _check(x, packed, scales, zeros, group_size)
    xb = x.to(torch.bfloat16)
    s = scales.float()
    acc = _group_dot(xb, packed, s, group_size)
    corr = (zeros.float() + 128.0) * s
    return (acc - _correction(_xg(xb, group_size), corr)).to(x.dtype)


def _dense_route(x: torch.Tensor, group_size: int) -> bool:
    return x.shape[0] > GROUP_DOT_MAX_M or x.shape[1] % (4 * group_size) != 0


# -- the kernels ------------------------------------------------------------------------
def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Per-tile arrival counters of the split-K fix-up, zero between launches (the
    kernel resets each one it uses).  One buffer per (device, stream): launches on
    one stream run in order, so they never share a counter while in flight.  A CUDA
    graph keeps the buffer's address, so a grown buffer keeps the old one alive.  A
    decode run's warm step makes the agent stream's buffer before its capture
    (``engine/graph_runner.py``); one first made inside a capture lives in that graph's
    pool, its zeroing a node of the graph."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED_COUNTERS.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def token_tile(M: int) -> int:
    """The token tile (wgmma N) of the W4A16 and the fp8_bmm kernels for M rows: 16 up
    to 16 rows, 64 up to 64, else 128 (larger M runs several tiles)."""
    return 16 if M <= 16 else 64 if M <= 64 else 128


def w4a16_splits(M: int, N: int, G: int, sms: int) -> int:
    """K splits the W4A16 kernels take, every schedule alike: as many as keep their
    (column, token) tiles in one wave of the card, at most one per group of a plane;
    the swept best on an H100 at llama2-7b's and Mixtral-8x7B's fused projections
    (``chip_smoke.py``'s w4a16 rows)."""
    tiles = -(-N // _TILE_N) * -(-M // token_tile(M))
    return max(1, min(G // 4, sms // tiles))


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _launch(source: str, symbol: str, x: torch.Tensor, packed: torch.Tensor,
            tab_s: torch.Tensor, tab_c: torch.Tensor, xg: torch.Tensor, group_size: int,
            splits: Optional[int]) -> torch.Tensor:
    """Check the operands of one of the three W4A16 kernels and launch it over tiles of
    ``token_tile(M)`` rows with ``splits`` K splits (None: as ``w4a16_splits`` picks)."""
    M, K, N, G = _check(x, packed, tab_s, tab_c, group_size)
    if x.dtype != torch.bfloat16 or packed.dtype != torch.int32:
        raise TypeError(f'{source} kernel takes bf16 x and int32 packed, got '
                        f'{x.dtype}/{packed.dtype}')
    if group_size not in GROUP_SIZES or N % 8 or not 0 < M <= GROUP_DOT_MAX_M:
        raise ValueError(f'{source} kernel takes group 32/64/128, N % 8 == 0 and '
                         f'0 < M <= {GROUP_DOT_MAX_M}; got gs {group_size} N {N} M {M}')
    for name, t in (('x', x), ('packed', packed), ('scale table', tab_s),
                    ('corr table', tab_c)):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{source}: {name} must be contiguous on {x.device}')
    if splits is None:
        splits = w4a16_splits(M, N, G, _sms(x))
    if not 1 <= splits <= G // 4:
        raise ValueError(f'{source}: splits must be 1..{G // 4}, got {splits}')
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # the split-K workspace [splits, N, Mp] (tokens contiguous), Mp = M padded to tiles
    tile = token_tile(M)
    ws = torch.empty((splits if splits > 1 else 0, N, -(-M // tile) * tile),
                     dtype=torch.float32, device=x.device)
    stream = cuda_build.stream_handle(x)
    counters = _counters(x.device, stream, -(-N // _TILE_N) * -(-M // tile))
    fn = cuda_build.entry(source, symbol, _ARGTYPES)
    rc = fn(x.data_ptr(), packed.data_ptr(), tab_s.data_ptr(), tab_c.data_ptr(),
            xg.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            M, N, K, group_size, splits, stream)
    cuda_build.check(rc, source)
    return out


def w4a16_matmul_gd(x: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                    corr: torch.Tensor, group_size: int = 128,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Decode-regime W4A16 GEMM over one layer's prepared gd leaves.

    x [M, K] (M <= 256; K padded to the leaf's ``packed.shape[0] * 8``), packed
    i32[K/8, N], sb / corr f32[K/gs, N].  ``splits`` (1 .. K/(4*gs)) overrides the
    K-split count ``w4a16_splits`` picks.  Returns [M, N] in x.dtype."""
    if not x.is_cuda:
        return w4a16_matmul_gd_plain(x, packed, sb, corr, group_size)
    if sb.dtype != torch.float32 or corr.dtype != torch.float32:
        raise TypeError('w4a16_gemm takes the gd schedule\'s f32 sb and corr')
    out = _launch('w4a16_gemm', 'w4a16_gemm_gd', x, packed, sb, corr,
                  _xg(x, group_size), group_size, splits)
    w4a16_matmul_gd.launches += 1
    return out


def w4a16_matmul_szc(x: torch.Tensor, packed: torch.Tensor, sb: torch.Tensor,
                     corr: torch.Tensor, group_size: int = 128,
                     splits: Optional[int] = None) -> torch.Tensor:
    """Decode-regime W4A16 GEMM over one layer's fast or precise prepared leaves: sb
    bf16 [K/gs, N], corr f32 [K/gs, N] (fast) or bf16 (precise).  Shapes as
    ``w4a16_matmul_gd``; ``splits`` as there.
    Returns [M, N] in x.dtype."""
    if not x.is_cuda:
        return w4a16_matmul_szc_plain(x, packed, sb, corr, group_size)
    sched = schedule_of(sb, corr)
    if sched == 'gd':
        raise TypeError('w4a16_szc takes the fast / precise schedules\' bf16 sb')
    # precise: xg rounded to bf16 by the reduction itself, then widened back
    xg = (_xg(x, group_size, torch.bfloat16).float() if sched == 'precise'
          else _xg(x, group_size))
    out = _launch('w4a16_gemm_szc', f'w4a16_gemm_{sched}', x, packed, sb, corr, xg,
                  group_size, splits)
    w4a16_matmul_szc.launches += 1
    return out


def w4a16_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 zeros: torch.Tensor, group_size: int = 128,
                 splits: Optional[int] = None) -> torch.Tensor:
    """W4A16 GEMM over one unprepared leaf (reference ``w4a16_matmul``): x [M, K],
    packed i32[K/8, N], raw f32 scales / zeros [K/gs, N].  More than 256 rows, or a K
    that breaks the 4-plane group alignment, take the dense route; otherwise the
    kernel reads the raw tables and forms ``(z + 128) * s`` itself.  ``splits`` as
    ``w4a16_matmul_gd``.  Returns [M, N] in x.dtype."""
    if not x.is_cuda:
        return w4a16_matmul_plain(x, packed, scales, zeros, group_size)
    if _dense_route(x, group_size):
        return w4a16_dense(x, packed, scales, zeros, group_size)
    if scales.dtype != torch.float32 or zeros.dtype != torch.float32:
        raise TypeError('w4a16_unprepared takes f32 scales and zeros')
    out = _launch('w4a16_gemm_unprepared', 'w4a16_gemm_unprepared', x, packed, scales,
                  zeros, _xg(x, group_size), group_size, splits)
    w4a16_matmul.launches += 1
    return out


w4a16_matmul_gd.launches = 0
w4a16_matmul_szc.launches = 0
w4a16_matmul.launches = 0
