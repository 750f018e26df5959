"""InternLM2 / InternLM3 (``InternLM2ForCausalLM``, ``InternLM3ForCausalLM``).

Port of ``lmdeploy_tpu/models/internlm2.py`` (``InternLM2Model``): llama compute under
its own checkpoint names.  ``attention.wqkv`` packs q, k and v grouped per kv head,
``[Hkv, G + 2, D, H]`` row-major (the group's G query heads, then its K row, then its V
row), split into ``wq`` / ``wk`` / ``wv`` at load.
"""
from __future__ import annotations

from typing import Dict

from ..config import ModelConfig
from .llama import LlamaModel, refuse_quantized, transposed


class InternLM2Model(LlamaModel):

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        refuse_quantized(self)

    def _wqkv_split(self):
        cfg = self.config
        Hkv, D, H = cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size
        G = cfg.num_attention_heads // Hkv

        def part(sl):
            return lambda t: t.reshape(Hkv, G + 2, D, H)[:, sl].reshape(-1, H).t()
        return [part(slice(0, G)), part(slice(G, G + 1)), part(slice(G + 1, G + 2))]

    def make_assign_plan(self):
        cfg = self.config
        plan: Dict = {'model.tok_embeddings.weight': (('embed',), None),
                      'model.norm.weight': (('final_norm',), None)}
        if not cfg.tie_word_embeddings:
            plan['output.weight'] = (('lm_head',), transposed)
        split_q, split_k, split_v = self._wqkv_split()
        for layer in range(cfg.num_layers):
            p = f'model.layers.{layer}.'
            plan.update({
                p + 'attention_norm.weight': (('layers', 'attn_norm', layer), None),
                p + 'ffn_norm.weight': (('layers', 'mlp_norm', layer), None),
                p + 'attention.wqkv.weight': [(('layers', 'wq', layer), split_q),
                                              (('layers', 'wk', layer), split_k),
                                              (('layers', 'wv', layer), split_v)],
                p + 'attention.wo.weight': (('layers', 'wo', layer), transposed),
                p + 'feed_forward.w1.weight': (('layers', 'w_gate', layer), transposed),
                p + 'feed_forward.w3.weight': (('layers', 'w_up', layer), transposed),
                p + 'feed_forward.w2.weight': (('layers', 'w_down', layer), transposed),
            })
        return plan
