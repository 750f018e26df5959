"""Linear layers: ``lmdeploy_tpu/nn/linear.py`` (``linear`` :43, ``_w4a16`` :66,
``_w4a16_prepped`` :99).

A dense weight goes to ``torch.matmul``, as the reference left it to XLA.  A W4A16 leaf
takes a W4A16 GEMM of ``ops/quant_matmul.py`` for at most 256 rows and a dequantize-
then-``torch.matmul`` route above that:
  * unprepared ``{'packed', 'scales', 'zeros'}``: ``w4a16_matmul`` (raw f32 tables);
  * prepared ``{'packed', 'sb', 'corr'}`` (``LlamaModel.prep_quant_leaves``): the gd
    kernel for f32 ``sb``; the fast / precise kernel for bf16 ``sb`` where the
    reference's kernel takes the shape (``K % (4 gs) == 0`` and ``(K / 4) % 128 == 0``),
    else ``w4a16_dense_szc``.
``LMDEPLOY_TPU_W4_DENSE_SWITCH=<n>`` sends products of more than n rows to the dense
route, as in the reference.  W8A8 and fp8 leaves are not ported yet and raise.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

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
        if 'packed' not in w:
            raise NotImplementedError(f'quantized weight leaf {sorted(w)} is not ported')
        y = _w4a16(x, w)
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
