"""Linear layers: ``lmdeploy_tpu/nn/linear.py`` (``linear`` :43, ``_w4a16`` :66).

A dense weight goes to ``torch.matmul``, as the reference left it to XLA.  A W4A16
leaf prepared for the group-dot schedule (``{'packed', 'sb', 'corr'}``,
``LlamaModel.prep_quant_leaves``) takes the W4A16 GEMM of ``ops/quant_matmul.py`` for
at most 256 rows and the dequantize-then-``torch.matmul`` route above that.  W8A8,
fp8, unprepared and fast/precise W4A16 leaves are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.quant_matmul import w4a16_dense_szc, w4a16_matmul_gd

# rows at or below which the W4A16 kernel runs (reference linear.py _STACKED_MAX_M);
# above it the product turns compute-bound and one dense GEMM wins
_STACKED_MAX_M = 256


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
    if 'sb' not in w:
        raise NotImplementedError('unprepared w4a16 leaf (raw scales / zeros) is not '
                                  'ported; prepare it with LlamaModel.prep_quant_leaves')
    packed, sb, corr = w['packed'], w['sb'], w['corr']
    lead, K = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, K)
    # K may be padded up to whole quant groups x 4 planes in the leaf
    # (lite/formats.py pad_k4); pad rows are exact zeros in the product
    Kp = packed.shape[-2] * 8
    if Kp > K:
        x2d = F.pad(x2d, (0, Kp - K))
    gs = Kp // sb.shape[-2]
    if x2d.shape[0] <= _STACKED_MAX_M:
        y = w4a16_matmul_gd(x2d.contiguous(), packed, sb, corr, gs)
    else:
        y = w4a16_dense_szc(x2d, packed, sb, corr, gs)
    return y.reshape(*lead, -1).to(x.dtype)
