"""PhiMoE (Phi-3.5-MoE): Mixtral's experts with LayerNorm, biases and sparsemixer routing.

Port of ``lmdeploy_tpu/models/phimoe.py`` (``PhiMoeModel``, ``sparsemixer_route``).  It
differs from ``MixtralModel`` in:
  * LayerNorm with a bias (``attn_norm_b``, ``mlp_norm_b``, ``final_norm_b``) in place
    of RMSNorm, through ``LlamaModel._norm``;
  * biased q / k / v projections and a biased output projection (``bo``), and with
    ``lm_head_bias`` an lm_head bias (``lm_head_b``) added to the f32 logits;
  * longrope tables (``nn/layers.make_rope_table``, the reference's one table for all
    positions);
  * sparsemixer routing: top-2 where each choice weighs its softmax probability over
    the scores a relative threshold keeps (``(max - s) / max(|logit|, |max|) >
    2 * jitter`` masked out), not a softmax renormalized over the two.  The second
    choice runs on the scores with the first set to -inf, under the mask relative to
    the original scores' magnitudes.  Ties go to the lower expert index, as
    ``jnp.argmax`` (a stable descending sort here).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import ModelConfig
from ..nn.layers import layer_norm
from .mixtral import MixtralModel

NEG_INF = float('-inf')


def _first_max(scores: torch.Tensor) -> torch.Tensor:
    """Index of each row's maximum, the lowest index among ties."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, 0]


def _pick_weight(scores, full_abs, jitter_eps: float, sel) -> torch.Tensor:
    """The sparsemixer weight of choice ``sel`` [N]: its softmax probability over
    ``scores`` with the entries beyond the relative threshold masked to -inf."""
    mx = scores.amax(-1, keepdim=True)
    factor = torch.maximum(full_abs, mx.abs())
    masked = scores.masked_fill(((mx - scores) / factor) > (2 * jitter_eps), NEG_INF)
    return torch.softmax(masked, dim=-1).gather(-1, sel[:, None].long())[:, 0]


def sparsemixer_weights(logits: torch.Tensor, top_idx: torch.Tensor,
                        jitter_eps: float) -> torch.Tensor:
    """The sparsemixer weights [N, 2] of the choices ``top_idx`` [N, 2] from f32 router
    logits [N, E] (the reference's two ``pick`` steps with their selections given)."""
    full_abs = logits.abs()
    m1 = _pick_weight(logits, full_abs, jitter_eps, top_idx[:, 0])
    scores2 = logits.scatter(1, top_idx[:, :1].long(), NEG_INF)
    m2 = _pick_weight(scores2, full_abs, jitter_eps, top_idx[:, 1])
    return torch.stack([m1, m2], dim=-1)


def sparsemixer_route(logits: torch.Tensor, jitter_eps: float):
    """Inference-time sparsemixer: (top_idx int32 [N, 2], top_w f32 [N, 2])."""
    e1 = _first_max(logits)
    e2 = _first_max(logits.scatter(1, e1[:, None], NEG_INF))
    top_idx = torch.stack([e1, e2], dim=-1).int()
    return top_idx, sparsemixer_weights(logits, top_idx, jitter_eps)


class PhiMoeModel(MixtralModel):
    """Phi-3.5-MoE decoder."""

    def __init__(self, config: ModelConfig):
        hf = config.hf_config or {}
        config.attention_bias = bool(hf.get('attention_bias', True))
        super().__init__(config)
        self.jitter = float(hf.get('router_jitter_noise', 0.01))
        self.lm_head_bias = bool(hf.get('lm_head_bias', False))

    def _norm(self, x, weight, bias, eps):
        return layer_norm(x, weight, bias, eps)

    def param_shapes(self) -> Dict:
        cfg = self.config
        shapes = super().param_shapes()
        L, H = cfg.num_layers, cfg.hidden_size
        shapes['layers'].update(attn_norm_b=(L, H), mlp_norm_b=(L, H), bo=(L, H))
        shapes['final_norm_b'] = (H,)
        if self.lm_head_bias:
            shapes['lm_head_b'] = (cfg.vocab_size,)
        return shapes

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        logits = super()._head(params, x)
        if 'lm_head_b' in params:
            logits = logits + params['lm_head_b'].float()
        return logits

    def route(self, w, xf: torch.Tensor):
        """Router logits (f32), the sparsemixer's two choices and their weights."""
        logits = torch.matmul(xf.float(), w['router'].float())
        top_idx, top_w = sparsemixer_route(logits, self.jitter)
        return logits, top_idx, top_w

    def route_weights(self, w, logits: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
        """The sparsemixer weights of given choices (for a run that fixes them)."""
        return sparsemixer_weights(logits, top_idx, self.jitter)

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        plan['model.norm.bias'] = (('final_norm_b',), None)
        if self.lm_head_bias:
            plan['lm_head.bias'] = (('lm_head_b',), None)
        for layer in range(self.config.num_layers):
            p = f'model.layers.{layer}.'
            for hf, leaf in (('input_layernorm.bias', 'attn_norm_b'),
                             ('post_attention_layernorm.bias', 'mlp_norm_b'),
                             ('self_attn.o_proj.bias', 'bo')):
                plan[p + hf] = (('layers', leaf, layer), None)
        return plan
