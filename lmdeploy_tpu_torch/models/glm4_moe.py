"""GLM-4.5 / GLM-4.6 MoE (``Glm4MoeForCausalLM``) and DeepSeek-MoE 16B
(``DeepseekForCausalLM``).

Port of ``lmdeploy_tpu/models/glm4_moe.py`` (``Glm4MoeModel``).  The MoE half is
``DeepseekV2Model``'s: the two layer groups (``first_k_dense_replace`` dense layers, then
MoE layers), softmax or sigmoid scores with the correction bias on the choice only,
group-limited top-k, ``norm_topk_prob``, routed scaling and the always-on shared experts.
The attention is GQA in place of MLA: biased q / k / v projections with
``attention_bias``, an optional per-head RMSNorm of q and k (``use_qk_norm``), and rope
on the first ``rope_dim`` dims only (``partial_rotary_factor``), rotate-half, the
tables built at ``rope_dim``.  DeepSeek-MoE 16B is the same model with softmax scores,
no renormalization and full rotary (reference ``models/__init__.py:184-193``).

A native blocked-fp8 checkpoint dequantizes while it streams in (``dequant_on_load``):
the stacked expert layout carries no blocked leaves here, as in the reference.  The
multi-token-prediction head (``Glm4MoeMTP``) is in ``mtp.py``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..config import ModelConfig
from ..nn.layers import apply_rope, rms_norm
from ..nn.linear import linear
from ..ops.attention import fill_kv_cache, paged_attention
from .deepseek import DeepseekV2Model
from .llama import AttnMeta, LlamaModel

# the MLA projections of DeepseekV2Model's plan that a GQA layer does not have
_MLA_NAMES = ('kv_a_proj_with_mqa.weight', 'kv_a_layernorm.weight', 'kv_b_proj.weight')


class Glm4MoeModel(DeepseekV2Model):
    """GQA attention with partial rotary over DeepSeek's MoE layer groups."""

    def __init__(self, config: ModelConfig):
        # LlamaModel's setup, not DeepseekV2Model's MLA one
        LlamaModel.__init__(self, config)
        hf = config.hf_config or {}
        self.fk = config.first_k_dense_replace
        self.qk_norm = bool(hf.get('use_qk_norm', False))
        self.scale = 1.0 / math.sqrt(config.head_dim)
        # DeepseekV2Model's plan reads its MLA dims; with no q_lora_rank it maps q_proj
        # to 'wq', and the other MLA entries are dropped (make_assign_plan)
        self.nh, self.dn, self.dr, self.dv, self.r, self.rq = \
            config.num_attention_heads, 1, 1, 1, 1, None
        self.moe_fp8 = False
        if self.quant_method == 'fp8_blocked':
            self.quant_method = None
            self.dequant_on_load = True
        elif self.quant_method is not None:
            raise NotImplementedError(f'{self.quant_method} checkpoints of '
                                      f'{config.hf_arch} are not ported')

    def _attn_shapes(self, L: int) -> Dict:
        cfg = self.config
        H = cfg.hidden_size
        q_out, kv_out = self.q_out, self.kv_out
        d = {'attn_norm': (L, H), 'mlp_norm': (L, H),
             'wq': (L, H, q_out), 'wk': (L, H, kv_out), 'wv': (L, H, kv_out),
             'wo': (L, q_out, H)}
        if cfg.attention_bias:
            d.update(bq=(L, q_out), bk=(L, kv_out), bv=(L, kv_out))
        if self.qk_norm:
            d.update(q_norm=(L, cfg.head_dim), k_norm=(L, cfg.head_dim))
        return d

    def make_assign_plan(self):
        """DeepseekV2Model's plan with the llama attention names in place of MLA's."""
        cfg = self.config
        plan = super().make_assign_plan()

        def transposed(t):
            return t.t()
        for layer in range(cfg.num_layers):
            grp, i = ('layers', layer) if layer < self.fk else ('moe_layers', layer - self.fk)
            p = f'model.layers.{layer}.self_attn.'
            for name in _MLA_NAMES:
                plan.pop(p + name, None)
            entries = [('k_proj.weight', 'wk', transposed), ('v_proj.weight', 'wv', transposed)]
            if cfg.attention_bias:
                entries += [('q_proj.bias', 'bq', None), ('k_proj.bias', 'bk', None),
                            ('v_proj.bias', 'bv', None)]
            if self.qk_norm:
                entries += [('q_norm.weight', 'q_norm', None), ('k_norm.weight', 'k_norm', None)]
            for hf, leaf, fn in entries:
                plan[p + hf] = ((grp, leaf, i), fn)
        return plan

    def _attn_block(self, w, h: torch.Tensor, layer: int, kv_cache, meta: AttnMeta,
                    cos, sin, slot_mapping, fresh_prefill: bool) -> torch.Tensor:
        cfg = self.config
        B, T = h.shape[:2]
        D = cfg.head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        x = rms_norm(h, w['attn_norm'], cfg.rms_norm_eps)
        q = linear(x, w['wq'], w.get('bq')).reshape(B, T, nh, D)
        k = linear(x, w['wk'], w.get('bk')).reshape(B, T, nkv, D)
        v = linear(x, w['wv'], w.get('bv')).reshape(B, T, nkv, D)
        if self.qk_norm:
            q = rms_norm(q, w['q_norm'], cfg.rms_norm_eps)
            k = rms_norm(k, w['k_norm'], cfg.rms_norm_eps)
        r = cfg.rope_dim
        q_rot, k_rot = apply_rope(q[..., :r], k[..., :r], cos, sin)
        q = torch.cat([q_rot, q[..., r:]], dim=-1)
        k = torch.cat([k_rot, k[..., r:]], dim=-1)
        fill_kv_cache(kv_cache, k.reshape(B * T, nkv, D), v.reshape(B * T, nkv, D),
                      slot_mapping, layer,
                      page_tables=meta.block_tables if fresh_prefill else None)
        attn = paged_attention(q, kv_cache, meta.block_tables, meta.history_lens,
                               meta.q_lens, self.scale, layer, nkv, chunk_kv=(k, v),
                               fresh_prefill=fresh_prefill, cp_mesh=self.cp_mesh)
        return h + linear(attn.reshape(B, T, nh * D), w['wo'])
