"""Per-token int8 KV-cache quantization (quant_policy 4).

Port of the int8 part of ``lmdeploy_tpu/ops/kv_quant.py`` (``QuantKV``,
``quantize_rows``, ``dequantize``): each token's K and V vector gets one f32 scale
per kv head, computed online when the cache is filled; there is no calibration.

Layout (that of ``lmdeploy_tpu/engine/cache_engine.py:100-110``, without the
reference's 128-lane row padding; the ``QuantKV`` docstring there is stale):
  * ``data``  int8 ``[L, NB, 2, BS, Hkv*D]``: K and V planes of head-major rows;
  * ``scale`` f32  ``[L, NB, 2, BS, Hkv]``: token-major, index 2 is K (0) or V (1).
"""
from __future__ import annotations

from typing import Tuple

import torch


class QuantKV:
    """An int8 paged cache: ``data`` pages plus per-(token, head) ``scale`` pages.
    ``.shape`` / ``.dtype`` / ``.device`` proxy to the data pages, so cache
    consumers read the page geometry from a quantized cache as from a plain one."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())


def quantize_rows(x: torch.Tensor, eps: float = 1e-8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]): absmax/127 + eps per row, round
    half to even (``torch.round``, as ``jnp.round``), clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + eps
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize(data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [..., D] * f32 [...] -> f32 [..., D]."""
    return data.float() * scale[..., None]
