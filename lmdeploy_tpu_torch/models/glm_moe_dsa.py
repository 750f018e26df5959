"""GLM-MoE-DSA (``GlmMoeDsaForCausalLM``): MLA + DeepSeek-MoE with shared DSA layers.

Port of ``lmdeploy_tpu/models/glm_moe_dsa.py`` (``GlmMoeDsaModel``).  DeepSeek-V3.2's
model (``deepseek_v32.py``) with two of GLM's changes:

  * per-layer indexer types (``indexer_types``): a 'full' layer runs its own lightning
    indexer, a 'shared' layer has no indexer weights and reuses the picks of the last
    full layer before it (the reference carries them through its layer scan and picks
    compute or reuse under ``lax.cond``; here the carry rides the Python layer loop and
    a per-layer flag decides).  Layers past the list count as full (the MTP layer), and
    layer 0 must be full;
  * the indexer's rope in rotate-half order unless ``indexer_rope_interleave``.

The MTP head (``GlmMoeDsaMTP``) is in ``mtp.py``.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig
from ..nn.layers import apply_rope
from .deepseek_v32 import DeepseekV32Model


class GlmMoeDsaModel(DeepseekV32Model):

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        hf = config.hf_config or {}
        types = hf.get('indexer_types') or ['full'] * config.num_layers
        self.idx_full = tuple((types[i] if i < len(types) else 'full') == 'full'
                              for i in range(config.num_layers))
        if not self.idx_full[0]:
            raise ValueError('indexer_types[0] must be \'full\': layer 0 computes the DSA '
                             'picks the shared layers reuse')
        self.idx_rope_interleave = bool(hf.get('indexer_rope_interleave', False))

    def _indexer_rope(self, x: torch.Tensor, cos, sin) -> torch.Tensor:
        if self.idx_rope_interleave:
            return super()._indexer_rope(x, cos, sin)
        return apply_rope(x, x, cos, sin)[0]

    def _dsa_select(self, w, x, qr, cos, sin, hist_k, pos_q, layer: int, carry):
        """A full layer's picks, computed and carried on; a shared layer's, the carry."""
        if self.idx_full[min(max(layer, 0), len(self.idx_full) - 1)]:
            picks, valid, _ = super()._dsa_select(w, x, qr, cos, sin, hist_k, pos_q, layer,
                                                  carry)
            return picks, valid, (picks, valid)
        return carry[0], carry[1], carry
