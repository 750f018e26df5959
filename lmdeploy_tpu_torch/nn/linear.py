"""Linear layers: the dense path of ``lmdeploy_tpu/nn/linear.py`` (``linear`` :43).

Quantized weight leaves (W4A16, W8A8, fp8) come with the quantized-serving slice.
A plain large matrix product goes to ``torch.matmul``, as the reference left it
to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch


def linear(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """y = x @ w (+ bias). x: [..., K], w: [K, N]; returns [..., N] in x.dtype.

    bf16 inputs accumulate in f32 inside the GEMM (cuBLAS), as the reference's
    ``preferred_element_type=f32`` does; the bias is added in f32."""
    if isinstance(w, dict):
        raise NotImplementedError(f'quantized weight leaf {sorted(w)} is not ported')
    y = torch.matmul(x, w)
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    return y
