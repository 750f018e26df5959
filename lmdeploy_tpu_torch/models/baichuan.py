"""Baichuan / Baichuan2-7B (``BaiChuanForCausalLM``, ``BaichuanForCausalLM``) and
InternLM v1 (``InternLMForCausalLM``).

Port of ``lmdeploy_tpu/models/baichuan.py``.  Baichuan is llama with q / k / v fused in
one ``W_pack`` tensor (rows q | k | v), split at load; the 13B geometry, which uses ALiBi
in place of rope, raises in the registry as in the reference.  InternLM v1 is llama
with a bias on every attention projection, the output one (``bo``) included; its
config's ``bias`` defaults to True.
"""
from __future__ import annotations

from ..config import ModelConfig
from .llama import LlamaModel, refuse_quantized, rows


class BaichuanModel(LlamaModel):

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        refuse_quantized(self)

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        qo, ko = self.q_out, self.kv_out
        for layer in range(self.config.num_layers):
            p = f'model.layers.{layer}.self_attn.'
            for name in ('q_proj', 'k_proj', 'v_proj'):
                plan.pop(f'{p}{name}.weight', None)
            plan[p + 'W_pack.weight'] = [(('layers', 'wq', layer), rows(0, qo)),
                                         (('layers', 'wk', layer), rows(qo, qo + ko)),
                                         (('layers', 'wv', layer), rows(qo + ko, qo + 2 * ko))]
        return plan


class InternLMv1Model(LlamaModel):

    def __init__(self, config: ModelConfig):
        config.attention_bias = bool((config.hf_config or {}).get('bias', True))
        super().__init__(config)

    def param_shapes(self):
        shapes = super().param_shapes()
        if self.config.attention_bias:
            shapes['layers']['bo'] = (self.config.num_layers, self.config.hidden_size)
        return shapes

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        if self.config.attention_bias:
            for layer in range(self.config.num_layers):
                plan[f'model.layers.{layer}.self_attn.o_proj.bias'] = (
                    ('layers', 'bo', layer), None)
        return plan
