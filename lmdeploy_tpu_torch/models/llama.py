"""Llama-family causal LM: parameters as layer-stacked tensors, a Python loop over layers.

Port of ``lmdeploy_tpu/models/llama.py`` (``LlamaModel``) for the options the
``_llama`` / ``_qwen2`` / ``_qwen3`` registry builders switch on: attention bias,
qk-norm and tied embeddings.  Parameters keep the reference's tree and names
(``embed``, ``layers/{attn_norm, wq|wqkv, ...}`` stacked ``[L, ...]``, ``final_norm``,
``lm_head``) and its ``[in, out]`` weight layout, so a JAX parameter tree carries over
by name (``weight_convert.params_from_jax``).  The reference's ``lax.scan`` over layers
becomes a Python loop; the KV cache is one tensor written in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.layers import apply_rope, rms_norm
from ..nn.linear import linear
from ..ops.attention import compute_slot_mapping, fill_kv_cache, paged_attention


@dataclass
class AttnMeta:
    """Per-step attention metadata (tensors on the model's device)."""

    block_tables: torch.Tensor    # [B, W] int32
    history_lens: torch.Tensor    # [B] int32 -- cached tokens before this chunk
    q_lens: torch.Tensor          # [B] int32 -- valid tokens in this chunk


class LlamaModel:
    """Weights layout + forward for the dense llama family."""

    def __init__(self, config: ModelConfig):
        if config.quantization_config:
            raise NotImplementedError('quantized checkpoints are not ported yet')
        self.config = config
        self.q_out = config.num_attention_heads * config.head_dim
        self.kv_out = config.num_key_value_heads * config.head_dim

    # -- parameters -------------------------------------------------------------------
    def param_shapes(self) -> Dict:
        cfg = self.config
        L, H, I, V = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                      cfg.vocab_size)
        layers = {
            'attn_norm': (L, H),
            'wq': (L, H, self.q_out),
            'wk': (L, H, self.kv_out),
            'wv': (L, H, self.kv_out),
            'wo': (L, self.q_out, H),
            'mlp_norm': (L, H),
            'w_gate': (L, H, I),
            'w_up': (L, H, I),
            'w_down': (L, I, H),
        }
        if cfg.attention_bias:
            layers.update(bq=(L, self.q_out), bk=(L, self.kv_out), bv=(L, self.kv_out))
        if cfg.qk_norm:
            layers.update(q_norm=(L, cfg.head_dim), k_norm=(L, cfg.head_dim))
        shapes = {'embed': (V, H), 'layers': layers, 'final_norm': (H,)}
        if not cfg.tie_word_embeddings:
            shapes['lm_head'] = (H, V)
        return shapes

    def init_params(self, seed: int = 0, device='cpu', scale: float = 0.02,
                    dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights from one seeded ``torch.Generator`` on ``device``
        (norms are ones), in the model dtype unless ``dtype`` is given.  The same
        seed gives the same weights on the same device type."""
        dtype = dtype or self.config.torch_dtype()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def walk(tree):
            out = {}
            for name, shape in tree.items():
                if isinstance(shape, dict):
                    out[name] = walk(shape)
                elif 'norm' in name:
                    out[name] = torch.ones(shape, dtype=dtype, device=device)
                else:
                    w = torch.randn(shape, generator=gen, device=device)
                    out[name] = (w * scale).to(dtype)
            return out
        return walk(self.param_shapes())

    def make_assign_plan(self) -> Dict[str, Tuple]:
        """{hf_name: (path, transpose)}; a layer index inside ``path`` selects the
        stacked row (reference ``make_assign_plan``, dense path)."""
        cfg = self.config
        plan = {'model.embed_tokens.weight': (('embed',), False),
                'model.norm.weight': (('final_norm',), False)}
        if not cfg.tie_word_embeddings:
            plan['lm_head.weight'] = (('lm_head',), True)
        per_layer = [
            ('input_layernorm.weight', 'attn_norm', False),
            ('post_attention_layernorm.weight', 'mlp_norm', False),
            ('self_attn.q_proj.bias', 'bq', False),
            ('self_attn.k_proj.bias', 'bk', False),
            ('self_attn.v_proj.bias', 'bv', False),
            ('self_attn.q_norm.weight', 'q_norm', False),
            ('self_attn.k_norm.weight', 'k_norm', False),
            ('self_attn.q_proj.weight', 'wq', True),
            ('self_attn.k_proj.weight', 'wk', True),
            ('self_attn.v_proj.weight', 'wv', True),
            ('self_attn.o_proj.weight', 'wo', True),
            ('mlp.gate_proj.weight', 'w_gate', True),
            ('mlp.up_proj.weight', 'w_up', True),
            ('mlp.down_proj.weight', 'w_down', True),
        ]
        for layer in range(cfg.num_layers):
            for hf, name, transpose in per_layer:
                plan[f'model.layers.{layer}.{hf}'] = (('layers', name, layer), transpose)
        return plan

    def fuse_projections(self, params: Dict) -> Dict:
        """wq/wk/wv -> wqkv and w_gate/w_up -> w_gateup along the output dim (one
        wide GEMM instead of three narrow ones), biases likewise."""
        lp = dict(params['layers'])
        if 'wq' in lp:
            lp['wqkv'] = torch.cat([lp.pop('wq'), lp.pop('wk'), lp.pop('wv')], dim=-1)
            if 'bq' in lp:
                lp['bqkv'] = torch.cat([lp.pop('bq'), lp.pop('bk'), lp.pop('bv')], dim=-1)
        if 'w_gate' in lp:
            lp['w_gateup'] = torch.cat([lp.pop('w_gate'), lp.pop('w_up')], dim=-1)
        return dict(params, layers=lp)

    def unfuse_projections(self, params: Dict) -> Dict:
        """Inverse of ``fuse_projections`` (per-name views of the fused leaves)."""
        lp = dict(params['layers'])
        qo, ko = self.q_out, self.kv_out
        if 'wqkv' in lp:
            lp['wq'], lp['wk'], lp['wv'] = lp.pop('wqkv').split([qo, ko, ko], dim=-1)
            if 'bqkv' in lp:
                lp['bq'], lp['bk'], lp['bv'] = lp.pop('bqkv').split([qo, ko, ko], dim=-1)
        if 'w_gateup' in lp:
            lp['w_gate'], lp['w_up'] = lp.pop('w_gateup').chunk(2, dim=-1)
        return dict(params, layers=lp)

    # -- pieces -----------------------------------------------------------------------
    def _qkv(self, w, x):
        if 'wqkv' in w:
            qkv = linear(x, w['wqkv'], w.get('bqkv'))
            return qkv.split([self.q_out, self.kv_out, self.kv_out], dim=-1)
        return (linear(x, w['wq'], w.get('bq')), linear(x, w['wk'], w.get('bk')),
                linear(x, w['wv'], w.get('bv')))

    def _mlp(self, w, x):
        # silu in f32 per element; the [*, I] intermediates stay in x.dtype
        if 'w_gateup' in w:
            gate, up = linear(x, w['w_gateup']).chunk(2, dim=-1)
        else:
            gate, up = linear(x, w['w_gate']), linear(x, w['w_up'])
        act = F.silu(gate.float()).to(x.dtype) * up
        return linear(act, w['w_down'])

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Hidden -> f32 logits (f32 accumulation AND f32 result, as the
        reference's preferred_element_type=f32 dot)."""
        lm_head = params.get('lm_head')
        if lm_head is None:
            lm_head = params['embed'].t()
        return torch.matmul(x.float(), lm_head.float())

    # -- forward ----------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                kv_cache: torch.Tensor, meta: AttnMeta,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                return_all_logits: bool = False,
                fresh_prefill: bool = False) -> torch.Tensor:
        """One step over a [B, T] chunk (decode is T == 1); writes the chunk's K/V
        into ``kv_cache`` in place.  Returns f32 logits [B, V] at each row's last
        valid token, or [B, T, V] with ``return_all_logits``."""
        cfg = self.config
        B, T = input_ids.shape
        D = cfg.head_dim
        Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        scale = 1.0 / math.sqrt(D)
        block_size = kv_cache.shape[3]
        embed = params['embed']
        # the reference's gathers clamp out-of-range ids; torch would fault
        ids = input_ids.long().clamp(0, embed.shape[0] - 1)
        hidden = embed[ids].to(cfg.torch_dtype())                      # [B,T,H]
        pos = positions.long().clamp(0, rope_cos.shape[0] - 1)
        cos, sin = rope_cos[pos], rope_sin[pos]                         # [B,T,D/2]
        slot_mapping = compute_slot_mapping(meta.block_tables, meta.history_lens,
                                            meta.q_lens, T, block_size)
        lp = params['layers']
        for layer in range(cfg.num_layers):
            w = {name: t[layer] for name, t in lp.items()}
            x = rms_norm(hidden, w['attn_norm'], cfg.rms_norm_eps)
            q, k, v = self._qkv(w, x)
            q = q.reshape(B, T, Hq, D)
            k = k.reshape(B, T, Hkv, D)
            v = v.reshape(B, T, Hkv, D)
            if 'q_norm' in w:
                q = rms_norm(q, w['q_norm'], cfg.rms_norm_eps)
                k = rms_norm(k, w['k_norm'], cfg.rms_norm_eps)
            q, k = apply_rope(q, k, cos, sin)
            fill_kv_cache(kv_cache, k.reshape(B * T, Hkv, D), v.reshape(B * T, Hkv, D),
                          slot_mapping, layer,
                          page_tables=meta.block_tables if fresh_prefill else None)
            attn = paged_attention(q, kv_cache, meta.block_tables, meta.history_lens,
                                   meta.q_lens, scale, layer, Hkv,
                                   window_size=cfg.sliding_window,
                                   chunk_kv=(k, v), fresh_prefill=fresh_prefill)
            hidden = hidden + linear(attn.reshape(B, T, self.q_out), w['wo'])
            x = rms_norm(hidden, w['mlp_norm'], cfg.rms_norm_eps)
            hidden = hidden + self._mlp(w, x)
        hidden = rms_norm(hidden, params['final_norm'], cfg.rms_norm_eps)
        if return_all_logits:
            return self._head(params, hidden)
        last = (meta.q_lens.long() - 1).clamp(min=0)
        last_hidden = hidden[torch.arange(B, device=hidden.device), last]
        return self._head(params, last_hidden)

