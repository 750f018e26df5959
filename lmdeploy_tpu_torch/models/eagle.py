"""EAGLE speculative-decoding heads (feature-level autoregression).

Port of ``lmdeploy_tpu/models/eagle.py``.  Parameters keep the reference's tree and
names and its ``[in, out]`` weight layout, so a JAX head's parameters carry over by
name (``weight_convert.params_from_jax``), and a checkpoint loads through the same
loader as a model (``weight_loader.load_params``: ``param_shapes`` and the assign plan).

``EagleHead`` (EAGLE-1, the public ``yuhuili/EAGLE-*`` llama heads): one llama decoder
layer whose input is ``fc([embed(token) ; hidden])``, with no pre-attention norm (the
checkpoints' ``input_layernorm`` is an Identity), and the TARGET's final norm and
lm_head (the tied embedding where it has no lm_head) for the draft logits.

``Eagle3Head`` (EAGLE-3): the layer attends over ``[rmsnorm(embed) ; rmsnorm(hidden)]``
(a 2H-wide q/k/v input, separate input and hidden norms) and adds its output to the
conditioning feature; ``fc`` maps the target's concatenated aux features (three layer
outputs, 3 x target_H) to the draft width once per speculative step (the caller's
``condition``); the head owns its final norm and lm_head over a reduced draft vocabulary,
whose ids ``d2t`` maps to target ids (the checkpoint stores offsets, absolute at load;
they must be unique).  The head embeds with its own table where the checkpoint ships
one (``saw_embed``), else with the target's.

Each head keeps a one-layer paged KV cache of its own (``engine/spec_agent.py``) and
attends through ``ops/attention.py paged_attention`` at T = 1, so on the card every
draft step launches the paged decode kernel once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.layers import apply_rope, rms_norm
from ..ops.attention import compute_slot_mapping, fill_kv_cache, paged_attention
from .llama import Leaf, transposed


def f32_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation and an f32 result (the reference's
    ``preferred_element_type=f32`` dot), as ``LlamaModel._head`` computes it."""
    return torch.matmul(x.float(), w.float())


class _HeadBase:
    """What both heads share: geometry, seeded parameters, the attention block and the
    MLP of the one decoder layer."""

    def __init__(self, config: ModelConfig):
        self.config = config
        self.nh = config.num_attention_heads
        self.nkv = config.num_key_value_heads
        self.D = config.head_dim
        self.scale = 1.0 / math.sqrt(self.D)

    def init_params(self, seed: int = 0, device='cpu', scale: float = 0.02,
                    dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights from one seeded ``torch.Generator`` (norms ones), as
        ``LlamaModel.init_params`` makes them; EAGLE-3's ``d2t`` is the identity."""
        dtype = dtype or self.config.torch_dtype()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        out = {}
        for name, shape in self.param_shapes().items():
            if isinstance(shape, Leaf):
                out[name] = torch.arange(shape.shape[0], dtype=shape.dtype, device=device)
            elif 'norm' in name:
                out[name] = torch.ones(shape, dtype=dtype, device=device)
            else:
                out[name] = (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)
        return out

    def _layer(self, params, x: torch.Tensor, residual: torch.Tensor, token_pos,
               kv_cache, block_tables, q_lens, cos_tab, sin_tab, max_len: int):
        """Attention of the rows ``x`` [B, In] at ``token_pos`` over the head's cache
        (written first), added to ``residual``, then the gated MLP: the pre-norm
        output [B, H]."""
        cfg = self.config
        B = x.shape[0]
        D, nh, nkv = self.D, self.nh, self.nkv
        xt = x[:, None, :]
        pos = token_pos.long().clamp(0, max_len - 1)[:, None]
        cos, sin = cos_tab[pos], sin_tab[pos]
        q = (xt @ params['wq']).reshape(B, 1, nh, D)
        k = (xt @ params['wk']).reshape(B, 1, nkv, D)
        v = (xt @ params['wv']).reshape(B, 1, nkv, D)
        q, k = apply_rope(q, k, cos, sin)
        slots = compute_slot_mapping(block_tables, token_pos, q_lens, 1, kv_cache.shape[3])
        fill_kv_cache(kv_cache, k.reshape(B, nkv, D), v.reshape(B, nkv, D), slots, 0)
        attn = paged_attention(q, kv_cache, block_tables, token_pos, q_lens, self.scale, 0,
                               nkv, chunk_kv=(k, v))
        h = residual + attn.reshape(B, nh * D) @ params['wo']
        y = rms_norm(h, params['mlp_norm'], cfg.rms_norm_eps)
        act = F.silu((y @ params['w_gate']).float()) * (y @ params['w_up']).float()
        return h + act.to(h.dtype) @ params['w_down']


class EagleHead(_HeadBase):
    """Single-layer draft head over the target's feature space (EAGLE-1)."""

    def param_shapes(self) -> Dict:
        cfg = self.config
        H, I = cfg.hidden_size, cfg.intermediate_size
        return {'fc': (2 * H, H), 'wq': (H, self.nh * self.D), 'wk': (H, self.nkv * self.D),
                'wv': (H, self.nkv * self.D), 'wo': (self.nh * self.D, H),
                'mlp_norm': (H,), 'w_gate': (H, I), 'w_up': (H, I), 'w_down': (I, H)}

    def make_assign_plan(self) -> Dict:
        lin = {'fc.weight': 'fc', 'layers.0.self_attn.q_proj.weight': 'wq',
               'layers.0.self_attn.k_proj.weight': 'wk',
               'layers.0.self_attn.v_proj.weight': 'wv',
               'layers.0.self_attn.o_proj.weight': 'wo',
               'layers.0.mlp.gate_proj.weight': 'w_gate',
               'layers.0.mlp.up_proj.weight': 'w_up',
               'layers.0.mlp.down_proj.weight': 'w_down'}
        plan = {hf: ((name,), transposed) for hf, name in lin.items()}
        plan['layers.0.post_attention_layernorm.weight'] = (('mlp_norm',), None)
        return plan

    @torch.no_grad()
    def step(self, params, tparams, h_cond, token, position, kv_cache, block_tables,
             q_lens, cos_tab, sin_tab, max_len: int):
        """One draft step: h_cond [B, H] conditioning features, token [B], position [B]
        (where the token lands in the head's cache).  Returns (f32 logits [B, V],
        the pre-norm feature [B, H])."""
        emb = tparams['embed'][token.long()].to(h_cond.dtype)
        x = torch.cat([emb, h_cond], dim=-1) @ params['fc']
        h_new = self._layer(params, x, x, position, kv_cache, block_tables, q_lens,
                            cos_tab, sin_tab, max_len)
        lm_head = tparams.get('lm_head')
        if lm_head is None:
            lm_head = tparams['embed'].t()
        hn = rms_norm(h_new, tparams['final_norm'], self.config.rms_norm_eps)
        return f32_logits(hn, lm_head), h_new


class Eagle3Head(_HeadBase):
    """EAGLE-3 draft head (reference ``models/llama_eagle3.py`` +
    ``spec_decode/proposers/eagle3.py``)."""

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        hf = config.hf_config or {}
        self.target_hidden = int(hf.get('target_hidden_size') or config.hidden_size)
        self.draft_vocab = int(hf.get('draft_vocab_size') or config.vocab_size)
        # set when the checkpoint ships its own embed_tokens (or by init_params)
        self.saw_embed = False

    def param_shapes(self) -> Dict:
        cfg = self.config
        H, I = cfg.hidden_size, cfg.intermediate_size
        return {'embed': (cfg.vocab_size, H), 'fc': (3 * self.target_hidden, H),
                'input_norm': (H,), 'hidden_norm': (H,),
                'wq': (2 * H, self.nh * self.D), 'wk': (2 * H, self.nkv * self.D),
                'wv': (2 * H, self.nkv * self.D), 'wo': (self.nh * self.D, H),
                'mlp_norm': (H,), 'w_gate': (H, I), 'w_up': (H, I), 'w_down': (I, H),
                'final_norm': (H,), 'lm_head': (H, self.draft_vocab),
                'd2t': Leaf((self.draft_vocab,), torch.int32)}

    def init_params(self, seed: int = 0, device='cpu', scale: float = 0.02,
                    dtype: Optional[torch.dtype] = None) -> Dict:
        self.saw_embed = True
        return super().init_params(seed, device, scale, dtype)

    def make_assign_plan(self) -> Dict:
        def embed(t):
            self.saw_embed = True
            return t

        def d2t(t):
            # the checkpoint stores offsets: absolute id = offset + draft id; the scatter
            # into the target vocabulary (engine/spec_agent.py) needs them unique
            ids = t.long() + torch.arange(self.draft_vocab)
            if np.unique(ids.numpy()).size != ids.numel():
                raise ValueError('EAGLE-3 d2t maps two draft ids to one target id')
            return ids.int()
        lin = {'fc.weight': 'fc', 'midlayer.self_attn.q_proj.weight': 'wq',
               'midlayer.self_attn.k_proj.weight': 'wk',
               'midlayer.self_attn.v_proj.weight': 'wv',
               'midlayer.self_attn.o_proj.weight': 'wo',
               'midlayer.mlp.gate_proj.weight': 'w_gate',
               'midlayer.mlp.up_proj.weight': 'w_up',
               'midlayer.mlp.down_proj.weight': 'w_down', 'lm_head.weight': 'lm_head'}
        plan = {hf: ((name,), transposed) for hf, name in lin.items()}
        plan.update({'embed_tokens.weight': (('embed',), embed),
                     'midlayer.input_layernorm.weight': (('input_norm',), None),
                     'midlayer.hidden_norm.weight': (('hidden_norm',), None),
                     'midlayer.post_attention_layernorm.weight': (('mlp_norm',), None),
                     'norm.weight': (('final_norm',), None),
                     'd2t': (('d2t',), d2t)})
        return plan

    def condition(self, params, aux: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The target's aux features [B, 3*target_H] -> the first draft step's
        conditioning [B, H] (``fc`` in f32, rounded to ``dtype``)."""
        return (aux.float() @ params['fc'].float()).to(dtype)

    @torch.no_grad()
    def step(self, params, emb_table, h_cond, token, position, kv_cache, block_tables,
             q_lens, cos_tab, sin_tab, max_len: int):
        """One draft step: h_cond [B, H] already in the draft width.  Returns (f32
        draft-vocabulary logits [B, draft_V], the pre-norm feature [B, H])."""
        eps = self.config.rms_norm_eps
        emb = emb_table[token.long()].to(h_cond.dtype)
        x = torch.cat([rms_norm(emb, params['input_norm'], eps),
                       rms_norm(h_cond, params['hidden_norm'], eps)], dim=-1)
        prenorm = self._layer(params, x, h_cond, position, kv_cache, block_tables, q_lens,
                              cos_tab, sin_tab, max_len)
        hn = rms_norm(prenorm, params['final_norm'], eps)
        return f32_logits(hn, params['lm_head']), prenorm
