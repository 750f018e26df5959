"""Gemma / Gemma-2 / Gemma-3 text causal LMs.

Port of ``lmdeploy_tpu/models/gemma.py`` (``GemmaModel``).  The family's differences
from llama are ``LlamaModel`` hooks:
  * the embedding times sqrt(hidden), rounded to the hidden dtype first; a gelu (tanh)
    MLP with f32 activations; zero-centred RMSNorm weights, ``1 + w`` folded at load in
    f32 (then rounded to the model dtype); tied embeddings (the registry sets them);
  * Gemma-2: sandwich norms (``post_attention_layernorm`` / ``pre_`` and
    ``post_feedforward_layernorm``), an attention and a final logit softcap, the
    attention scale ``query_pre_attn_scalar ** -0.5``, and a window on the even
    layers;
  * Gemma-3: qk-norm, no softcaps, windows from ``layer_types`` (else every layer but
    each ``sliding_window_pattern``-th), and two rope tables: the global layers take
    the config's (its theta and scaling), the local ones an unscaled table of
    ``rope_local_base_freq`` at the same length (``nn/layers.make_rope_table``).
    Which table a layer takes follows its window, a Python int of ``layer_windows``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.layers import apply_rope, make_rope_table
from ..nn.linear import linear
from .llama import LlamaModel

GENERATION = {'gemma': 1, 'gemma2': 2, 'gemma3_text': 3, 'gemma3': 3}


def plus_one(t: torch.Tensor) -> torch.Tensor:
    """A stored ``w - 1`` norm weight -> ``w`` in f32 (rounded to the leaf's dtype when
    it is written)."""
    return t.float() + 1.0


def gemma_layer_windows(gen: int, hf: Dict, window, num_layers: int):
    """Per-layer windows (0: full attention): Gemma-2 slides on the even layers
    (transformers ``Gemma2Attention``), Gemma-3 on its ``sliding_attention`` layers,
    else on every layer but each ``sliding_window_pattern``-th; None without a window."""
    if not window or gen < 2:
        return None
    if gen == 2:
        return [window if i % 2 == 0 else 0 for i in range(num_layers)]
    types = hf.get('layer_types')
    if types:
        return [window if t == 'sliding_attention' else 0 for t in types]
    pattern = hf.get('sliding_window_pattern', 6)
    return [0 if (i + 1) % pattern == 0 else window for i in range(num_layers)]


class GemmaModel(LlamaModel):

    FUSE_GATE_UP = True

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        hf = config.hf_config or {}
        self.gen = GENERATION.get(hf.get('model_type'), 1)
        self.final_logit_softcap = hf.get('final_logit_softcapping')
        self.embed_scale = float(np.sqrt(config.hidden_size))
        if self.gen >= 2:
            self.sandwich_norms = True
            self.attn_logit_softcap = hf.get('attn_logit_softcapping')
            qpas = hf.get('query_pre_attn_scalar')
            if qpas:
                self.attn_scale = float(qpas) ** -0.5
        if self.gen >= 3:
            config.qk_norm = True
            self.local_theta = float(hf.get('rope_local_base_freq', 10000.0))
        self.layer_windows = gemma_layer_windows(self.gen, hf, config.sliding_window,
                                                 config.num_layers)
        self._local_rope = {}

    def _gather_rope(self, rope_cos, rope_sin, pos):
        if self.gen < 3:
            return rope_cos[pos], rope_sin[pos]
        # the local layers' table, built once per length and device (before any decode
        # graph is captured: a prefill step comes first)
        key = (rope_cos.shape[0], str(rope_cos.device))
        if key not in self._local_rope:
            self._local_rope[key] = make_rope_table(self.config.rope_dim, rope_cos.shape[0],
                                                    self.local_theta, device=rope_cos.device)
        lcos, lsin = self._local_rope[key]
        return (rope_cos[pos], lcos[pos]), (rope_sin[pos], lsin[pos])

    def _apply_rope(self, q, k, cos, sin, layer: int):
        if self.gen < 3:
            return apply_rope(q, k, cos, sin)
        local = bool(self.layer_windows and self.layer_windows[layer] > 0)
        return apply_rope(q, k, cos[local], sin[local])

    def _mlp(self, w, x):
        # gelu (tanh) and the product with up in f32, then x's dtype
        gate, up = self._gate_up(w, x)
        act = F.gelu(gate.float(), approximate='tanh') * up.float()
        return linear(act.to(x.dtype), w['w_down'])

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        plan['model.norm.weight'] = (('final_norm',), plus_one)
        names = {'input_layernorm': 'attn_norm'}
        if self.sandwich_norms:
            names.update(post_attention_layernorm='post_attn_norm',
                         pre_feedforward_layernorm='mlp_norm',
                         post_feedforward_layernorm='post_mlp_norm')
        else:
            names['post_attention_layernorm'] = 'mlp_norm'
        if self.config.qk_norm:
            names.update({'self_attn.q_norm': 'q_norm', 'self_attn.k_norm': 'k_norm'})
        for layer in range(self.config.num_layers):
            for hf, leaf in names.items():
                plan[f'model.layers.{layer}.{hf}.weight'] = (('layers', leaf, layer), plus_one)
        return plan
