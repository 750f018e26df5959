"""StarCoder2 (``Starcoder2ForCausalLM``): LayerNorm, biased projections, ungated MLP.

Port of ``lmdeploy_tpu/models/starcoder2.py`` (``Starcoder2Model``).  Three hooks of
``LlamaModel`` differ: ``_norm`` is a LayerNorm in f32 with its bias (``attn_norm_b``,
``mlp_norm_b``, ``final_norm_b``), ``_mlp`` is ``c_fc -> gelu (tanh) -> c_proj`` with
biases (``_mlp_shapes``: no gate, so nothing for ``fuse_projections`` to fuse there),
and every projection has a bias (``use_bias``, default True: ``bq`` / ``bk`` / ``bv``,
``bo``, ``c_fc_b``, ``c_proj_b``).
"""
from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.layers import layer_norm
from ..nn.linear import linear
from .llama import LlamaModel, refuse_quantized, transposed


class Starcoder2Model(LlamaModel):

    def __init__(self, config: ModelConfig):
        config.attention_bias = bool((config.hf_config or {}).get('use_bias', True))
        super().__init__(config)
        refuse_quantized(self)

    def _norm(self, x, weight, bias, eps):
        return layer_norm(x, weight, bias, eps)

    def _mlp(self, w, x):
        h = linear(x, w['c_fc'], w.get('c_fc_b'))
        h = F.gelu(h.float(), approximate='tanh')
        return linear(h.to(x.dtype), w['c_proj'], w.get('c_proj_b'))

    def _mlp_shapes(self, L: int, H: int, I: int) -> Dict:
        return {'c_fc': self._linear_shape(L, H, I), 'c_fc_b': (L, I),
                'c_proj': self._linear_shape(L, I, H), 'c_proj_b': (L, H)}

    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        L, H = self.config.num_layers, self.config.hidden_size
        shapes['layers'].update(attn_norm_b=(L, H), mlp_norm_b=(L, H), bo=(L, H))
        shapes['final_norm_b'] = (H,)
        return shapes

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        plan['model.norm.bias'] = (('final_norm_b',), None)
        for layer in range(self.config.num_layers):
            p = f'model.layers.{layer}.'
            for name in ('gate_proj', 'up_proj', 'down_proj'):
                plan.pop(f'{p}mlp.{name}.weight', None)
            plan.update({
                p + 'input_layernorm.bias': (('layers', 'attn_norm_b', layer), None),
                p + 'post_attention_layernorm.bias': (('layers', 'mlp_norm_b', layer), None),
                p + 'self_attn.o_proj.bias': (('layers', 'bo', layer), None),
                p + 'mlp.c_fc.weight': (('layers', 'c_fc', layer), transposed),
                p + 'mlp.c_fc.bias': (('layers', 'c_fc_b', layer), None),
                p + 'mlp.c_proj.weight': (('layers', 'c_proj', layer), transposed),
                p + 'mlp.c_proj.bias': (('layers', 'c_proj_b', layer), None),
            })
        return plan
