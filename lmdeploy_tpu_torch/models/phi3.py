"""Phi-3 / Phi-3.5 / Phi-4-mini text (``Phi3ForCausalLM``, ``Phi3SmallForCausalLM``,
``Phi4MMForCausalLM``).

Port of ``lmdeploy_tpu/models/phi3.py`` (``Phi3Model``): llama compute; the checkpoint
fuses q / k / v into ``qkv_proj`` and gate / up into ``gate_up_proj``, which the assign
plan splits at load (one tensor, several leaves).  LongRoPE is the rope table's
(``nn/layers.make_rope_table``).
"""
from __future__ import annotations

from typing import Dict

from ..config import ModelConfig
from .llama import LlamaModel, refuse_quantized, rows, transposed


class Phi3Model(LlamaModel):

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        refuse_quantized(self)

    def make_assign_plan(self):
        cfg = self.config
        qo, ko, inter = self.q_out, self.kv_out, cfg.intermediate_size
        plan: Dict = {'model.embed_tokens.weight': (('embed',), None),
                      'model.norm.weight': (('final_norm',), None)}
        if not cfg.tie_word_embeddings:
            plan['lm_head.weight'] = (('lm_head',), transposed)
        for layer in range(cfg.num_layers):
            p = f'model.layers.{layer}.'
            plan.update({
                p + 'input_layernorm.weight': (('layers', 'attn_norm', layer), None),
                p + 'post_attention_layernorm.weight': (('layers', 'mlp_norm', layer), None),
                p + 'self_attn.qkv_proj.weight': [
                    (('layers', 'wq', layer), rows(0, qo)),
                    (('layers', 'wk', layer), rows(qo, qo + ko)),
                    (('layers', 'wv', layer), rows(qo + ko, qo + 2 * ko))],
                p + 'self_attn.o_proj.weight': (('layers', 'wo', layer), transposed),
                p + 'mlp.gate_up_proj.weight': [
                    (('layers', 'w_gate', layer), rows(0, inter)),
                    (('layers', 'w_up', layer), rows(inter, 2 * inter))],
                p + 'mlp.down_proj.weight': (('layers', 'w_down', layer), transposed),
            })
        return plan
