"""MiniCPM v1 / 2 (``MiniCPMForCausalLM``): llama with muP scalings.

Port of ``lmdeploy_tpu/models/minicpm.py`` (``MiniCPMModel``; MiniCPM3's MLA is not
ported): the embedding times ``scale_emb``, each residual branch's output times
``scale_depth / sqrt(num_layers)`` (each scale rounded to the hidden dtype first), and
the f32 logits times ``dim_model_base / hidden_size`` after the head.
"""
from __future__ import annotations

from ..config import ModelConfig
from .llama import LlamaModel


class MiniCPMModel(LlamaModel):

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        hf = config.hf_config or {}
        self.embed_scale = float(hf.get('scale_emb', 1.0))
        if hf.get('scale_depth'):
            self.residual_scale = float(hf['scale_depth']) / float(config.num_layers) ** 0.5
        self.logit_scale = (float(hf['dim_model_base']) / float(config.hidden_size)
                            if hf.get('dim_model_base') else None)

    def _head(self, params, x):
        logits = super()._head(params, x)
        if self.logit_scale is not None:
            logits = logits * self.logit_scale
        return logits
