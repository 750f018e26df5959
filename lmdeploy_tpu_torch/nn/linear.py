"""Linear layers: ``lmdeploy_tpu/nn/linear.py`` (``linear`` :43, ``_w4a16`` :66,
``_w4a16_prepped`` :99, ``_w8a8`` :131, ``_w_fp8`` :148, ``_w_fp8_blocked`` :158).

A dense weight goes to ``torch.matmul``, as the reference left it to XLA.  A W4A16 leaf
takes a W4A16 GEMM of ``ops/quant_matmul.py`` for at most 256 rows and a dequantize-
then-``torch.matmul`` route above that:
  * unprepared ``{'packed', 'scales', 'zeros'}``: ``w4a16_matmul`` (raw f32 tables);
  * prepared ``{'packed', 'sb', 'corr'}`` (``LlamaModel.prep_quant_leaves``): the gd
    kernel for f32 ``sb``; the fast / precise kernel for bf16 ``sb`` where the
    reference's kernel takes the shape (``K % (4 gs) == 0`` and ``(K / 4) % 128 == 0``),
    else ``w4a16_dense_szc``.
``LMDEPLOY_TPU_W4_DENSE_SWITCH=<n>`` sends products of more than n rows to the dense
route, as in the reference.

The 8-bit leaves key on the leaf, as the reference's dispatch does; their products are
library or plain PyTorch calls, as the reference left them to XLA:
  * ``{'w8' int8 [K, N], 'scale' f32 [N]}``: SmoothQuant W8A8 (``_w8a8``): per-token int8
    activations, an exact int32 product by ``torch._int_mm`` (on the card zero rows pad
    M above the 16 rows cuBLASLt refuses; a K or N off a multiple of 8 raises there; the
    engine stores the codes K-major, ``LlamaModel.layout_quant_leaves``), then
    ``acc * a_scale * scale`` in f32;
  * ``{'w8' float8_e4m3fn [K, N], 'scale' f32 [N]}``: fp8 weight-only (``_w_fp8``): the
    weights widened to x's dtype, a product with an f32 result (``torch.mm(...,
    out_dtype=float32)`` on the card for bf16 / f16 x; exact products in f32 on the
    CPU), then the per-column scale in f32 and one cast;
  * ``{'w8' float8_e4m3fn [K, N], 'bscale' f32 [ceil(K/b0), ceil(N/b1)]}``: blocked fp8
    (``_w_fp8_blocked``): the operand ``bf16(w8) * bf16(scale)`` rounded in bf16 and x
    cast to bf16, whatever x's dtype, then an f32-accumulated product.  This is not
    ``ops/quant_bmm.fp8_bmm``'s function (that one multiplies in f32 and rounds once).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.kv_quant import f32_reciprocal
from ..ops.quant_matmul import (GROUP_DOT_MAX_M, schedule_of, w4a16_dense,
                                w4a16_dense_szc, w4a16_matmul, w4a16_matmul_gd,
                                w4a16_matmul_szc)

# rows above which every W4A16 product takes the dense route (reference linear.py:35)
_DENSE_SWITCH = int(os.environ.get('LMDEPLOY_TPU_W4_DENSE_SWITCH', str(1 << 30)))


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ bias). x: [..., K], w: [K, N] or a quantized leaf; returns
    [..., N] in x.dtype.

    bf16 inputs accumulate in f32 inside the GEMM (cuBLAS), as the reference's
    ``preferred_element_type=f32`` does; the bias is added in f32."""
    if isinstance(w, dict):
        if 'packed' in w:
            y = _w4a16(x, w)
        elif 'w8' in w:
            if 'bscale' in w:
                y = _w_fp8_blocked(x, w)
            elif w['w8'].dtype == torch.float8_e4m3fn:
                y = _w_fp8(x, w)
            else:
                y = _w8a8(x, w)
        else:
            raise ValueError(f'unknown quantized weight leaf: {sorted(w)}')
    else:
        y = torch.matmul(x, w)
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    return y


def _w4a16(x: torch.Tensor, w: dict) -> torch.Tensor:
    packed = w['packed']
    lead, K = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, K)
    # K may be padded up to whole quant groups x 4 planes in the leaf
    # (lite/formats.py pad_k4); pad rows are exact zeros in the product
    Kp = packed.shape[-2] * 8
    if Kp > K:
        x2d = F.pad(x2d, (0, Kp - K))
    x2d = x2d.contiguous()
    rows = x2d.shape[0]
    if 'sb' not in w:
        scales, zeros = w['scales'], w['zeros']
        gs = Kp // scales.shape[-2]
        if rows <= _DENSE_SWITCH:
            y = w4a16_matmul(x2d, packed, scales, zeros, gs)
        else:
            y = w4a16_dense(x2d, packed, scales, zeros, gs)
        return y.reshape(*lead, -1).to(x.dtype)
    sb, corr = w['sb'], w['corr']
    gs = Kp // sb.shape[-2]
    small = rows <= min(GROUP_DOT_MAX_M, _DENSE_SWITCH)
    if schedule_of(sb, corr) == 'gd':
        y = (w4a16_matmul_gd(x2d, packed, sb, corr, gs) if small
             else w4a16_dense_szc(x2d, packed, sb, corr, gs))
    elif small and Kp % (4 * gs) == 0 and (Kp // 4) % 128 == 0:
        y = w4a16_matmul_szc(x2d, packed, sb, corr, gs)
    else:
        y = w4a16_dense_szc(x2d, packed, sb, corr, gs)
    return y.reshape(*lead, -1).to(x.dtype)


# cuBLASLt's int8 GEMM (``torch._int_mm`` on the card) takes more than 16 rows
_INT_MM_MIN_ROWS = 17
_INV127 = f32_reciprocal(127.0)


def quantize_rows_int8(x2d: torch.Tensor):
    """Dynamic per-token symmetric int8 (the reference's ``_w8a8``): f32 rows, scale
    ``max(absmax / 127, 1e-8)`` as the jitted reference computes it (``absmax *
    fl(1/127)``: XLA rewrites the division by a constant), codes rounded half to even
    and clamped to +-127.  Returns (codes int8 [M, K], scales f32 [M, 1])."""
    xf = x2d.float()
    amax = xf.abs().amax(-1, keepdim=True)
    a_scale = torch.clamp_min(amax * _INV127, 1e-8)
    xq = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    return xq, a_scale


def int8_matmul(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 codes [M, K] x [K, N] by ``torch._int_mm``.  On the
    card, M is padded with zero rows up to cuBLASLt's minimum and the pad sliced off
    (exact: zero rows give zero sums); a K or N cuBLASLt refuses raises, never a float
    product in its place."""
    M = xq.shape[0]
    if xq.is_cuda and M < _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - M))
    return torch._int_mm(xq.contiguous(), w8)[:M]


def _w8a8(x: torch.Tensor, w: dict) -> torch.Tensor:
    lead = x.shape[:-1]
    xq, a_scale = quantize_rows_int8(x.reshape(-1, x.shape[-1]))
    acc = int8_matmul(xq, w['w8'])
    y = acc.float() * a_scale * w['scale'].float()[None, :]
    return y.reshape(*lead, -1).to(x.dtype)


def f32_out_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N], both of one dtype, with f32 sums and an f32 result (the
    reference's preferred_element_type=f32 dot): one GEMM with an f32 output on the
    card for 2-byte inputs, the exact products in f32 elsewhere (the CPU has no
    ``mm.dtype`` kernel).  Never TF32: the port leaves it off."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _w_fp8(x: torch.Tensor, w: dict) -> torch.Tensor:
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    y = f32_out_mm(x2d, w['w8'].to(x.dtype)) * w['scale'].float()[None, :]
    return y.reshape(*lead, -1).to(x.dtype)


def widen_fp8_blocked(w8: torch.Tensor, bscale: torch.Tensor) -> torch.Tensor:
    """[K, N] e4m3 and its [ceil(K/b0), ceil(N/b1)] scale grid -> the bf16 operand
    ``bf16(w8) * bf16(scale)``, each product rounded once in bf16 (the reference's
    ``_w_fp8_blocked``; a ragged last block takes its grid row / column)."""
    K, N = w8.shape
    Kb, Nb = bscale.shape
    b0, b1 = -(-K // Kb), -(-N // Nb)
    s = bscale.to(torch.bfloat16)
    wb = w8.to(torch.bfloat16)
    if K == Kb * b0 and N == Nb * b1:
        return (wb.view(Kb, b0, Nb, b1) * s[:, None, :, None]).view(K, N)
    s = s.repeat_interleave(b0, dim=0)[:K].repeat_interleave(b1, dim=1)[:, :N]
    return wb * s


def _w_fp8_blocked(x: torch.Tensor, w: dict) -> torch.Tensor:
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    y = f32_out_mm(x2d, widen_fp8_blocked(w['w8'], w['bscale']))
    return y.reshape(*lead, -1).to(x.dtype)
