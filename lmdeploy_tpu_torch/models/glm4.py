"""GLM-4-0414 (``Glm4ForCausalLM``) and GLM-4-9B-hf (``GlmForCausalLM``).

Port of ``lmdeploy_tpu/models/glm4.py`` (``Glm4Model``): llama compute with
  * partial rotary: rope over the first ``rope_dim`` = ``head_dim *
    partial_rotary_factor`` dims of each head, whose pairs are interleaved (dims 2i,
    2i+1): de-interleaved into rotate-half order, rotated by tables built at
    ``rope_dim``, re-interleaved;
  * sandwich norms (``post_self_attn_layernorm`` / ``post_mlp_layernorm``) on
    GLM-4-0414, none on ``GlmForCausalLM`` (the registry turns them off);
  * a fused ``gate_up_proj`` checkpoint tensor, split at load.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import ModelConfig
from ..nn.layers import apply_rope, halves_to_pairs, pairs_to_halves
from .llama import LlamaModel, refuse_quantized, rows, transposed


class Glm4Model(LlamaModel):

    sandwich_norms = True

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        refuse_quantized(self)

    def _apply_rope(self, q, k, cos, sin, layer: int):
        r = self.config.rope_dim
        q_rot, k_rot = apply_rope(pairs_to_halves(q[..., :r]), pairs_to_halves(k[..., :r]),
                                  cos, sin)
        return (torch.cat([halves_to_pairs(q_rot), q[..., r:]], dim=-1),
                torch.cat([halves_to_pairs(k_rot), k[..., r:]], dim=-1))

    def _norm_plan(self, p: str, layer: int) -> Dict:
        plan = {p + 'input_layernorm.weight': (('layers', 'attn_norm', layer), None),
                p + 'post_attention_layernorm.weight': (('layers', 'mlp_norm', layer), None)}
        if self.sandwich_norms:
            plan[p + 'post_self_attn_layernorm.weight'] = (('layers', 'post_attn_norm', layer),
                                                           None)
            plan[p + 'post_mlp_layernorm.weight'] = (('layers', 'post_mlp_norm', layer), None)
        return plan

    def make_assign_plan(self):
        cfg = self.config
        inter = cfg.intermediate_size
        plan: Dict = {'model.embed_tokens.weight': (('embed',), None),
                      'model.norm.weight': (('final_norm',), None)}
        if not cfg.tie_word_embeddings:
            plan['lm_head.weight'] = (('lm_head',), transposed)
        for layer in range(cfg.num_layers):
            p = f'model.layers.{layer}.'
            plan.update(self._norm_plan(p, layer))
            for hf, name in (('q_proj', 'wq'), ('k_proj', 'wk'), ('v_proj', 'wv'),
                             ('o_proj', 'wo')):
                plan[p + f'self_attn.{hf}.weight'] = (('layers', name, layer), transposed)
                if cfg.attention_bias and hf != 'o_proj':
                    plan[p + f'self_attn.{hf}.bias'] = (('layers', 'b' + hf[0], layer), None)
            plan[p + 'mlp.gate_up_proj.weight'] = [
                (('layers', 'w_gate', layer), rows(0, inter)),
                (('layers', 'w_up', layer), rows(inter, 2 * inter))]
            plan[p + 'mlp.down_proj.weight'] = (('layers', 'w_down', layer), transposed)
        return plan

