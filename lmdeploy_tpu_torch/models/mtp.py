"""Multi-token-prediction (MTP) heads as speculative proposers (``deepseek_mtp``).

Port of ``lmdeploy_tpu/models/deepseek.py DeepseekMTP`` (:485-639),
``glm4_moe.py Glm4MoeMTP`` (:130-259) and ``glm_moe_dsa.py GlmMoeDsaMTP`` (:91-116).
The checkpoint's extra layer ``model.layers.{num_layers}.*`` drafts from the target's
pre-final-norm feature h and the last token: ``x = eh_proj([enorm(embed(tok)) ;
hnorm(h)])``, then ONE decoder block of the target's kind at T = 1 over the head's
one-layer paged cache, then ``shared_head.norm`` and the TARGET's ``lm_head`` (its tied
embedding where it has none) in f32.  The embedding and the lm_head are the target's,
so the head adds one layer of weights.  ``step`` has ``EagleHead.step``'s signature:
the engine drives an MTP head through its EAGLE proposer (``engine/spec_agent.py``).

The three heads share this skeleton (``MTPHead``) over their target's block:
``DeepseekMTP`` the absorbed MLA block (row 2's paged decode at D 576 on the head's
cache), ``Glm4MoeMTP`` GLM-4.5's GQA block (qk-norm, partial rotate-half rope),
``GlmMoeDsaMTP`` the DSA block, which computes its own picks (it runs as layer 0).
The MLP is the target's MoE (routed experts with dense parameter shapes, as the
reference's ``param_shapes``, plus the shared experts) where the model has experts,
else the dense MLP.

A blocked-fp8 checkpoint keeps the routed experts fp8 (``keep_fp8``), the head's too,
but the reference's head has dense expert leaves and no scale entries: its plan casts
the e4m3 codes and drops the ``weight_scale_inv`` grids, so the port refuses such a
checkpoint (ROADMAP.md section 3); ``LMDEPLOY_TPU_FP8_DEQUANT=1`` dequantizes every
weight at load, the head's included, and serves it.  Seeded weights take the
reference's dense shapes.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..nn.layers import rms_norm
from ..ops.attention import compute_slot_mapping
from .deepseek import DeepseekV2Model
from .eagle import f32_logits
from .glm4_moe import Glm4MoeModel
from .glm_moe_dsa import GlmMoeDsaModel
from .llama import AttnMeta, transposed
from .mixtral import ExpertSlice


class MTPHead:
    """The MTP skeleton, mixed in before a target model class whose ``_attn_block``,
    ``_attn_shapes``, ``_moe_mlp`` and ``_mlp`` it runs."""

    def __init__(self, config):
        super().__init__(config)
        self.mtp_index = config.num_layers
        self.moe_mlp = bool(config.num_experts)

    @property
    def cache_width(self) -> int:
        """The row width of the head's one-layer cache: what its block writes."""
        return self.config.num_key_value_heads * self.config.cache_head_dim

    # -- parameters -------------------------------------------------------------------
    def param_shapes(self) -> Dict:
        cfg = self.config
        H = cfg.hidden_size
        layer = self._attn_shapes(1)
        if self.moe_mlp:
            E, ie = cfg.num_experts, cfg.moe_intermediate_size or cfg.intermediate_size
            layer.update(router=(1, H, E), router_bias=(1, E), we_gate=(1, E, H, ie),
                         we_up=(1, E, H, ie), we_down=(1, E, ie, H))
            shared = cfg.num_shared_experts * ie
            if shared:
                layer.update(ws_gate=(1, H, shared), ws_up=(1, H, shared),
                             ws_down=(1, shared, H))
        else:
            inter = cfg.intermediate_size
            layer.update(w_gate=(1, H, inter), w_up=(1, H, inter), w_down=(1, inter, H))
        return {'enorm': (H,), 'hnorm': (H,), 'eh_proj': (2 * H, H), 'shead_norm': (H,),
                'layer': layer}

    def _attn_plan(self, prefix: str) -> Dict:
        """The attention block's HF names under ``prefix + 'self_attn.'``."""
        raise NotImplementedError

    def make_assign_plan(self) -> Dict:
        if getattr(self, 'moe_fp8', False):
            raise NotImplementedError(
                'deepseek_mtp on a blocked-fp8 checkpoint: the reference\'s MTP head '
                'loads its routed experts\' e4m3 codes without their weight_scale_inv '
                'grids (ROADMAP.md section 3); set LMDEPLOY_TPU_FP8_DEQUANT=1 to '
                'dequantize every weight at load')
        p = f'model.layers.{self.mtp_index}.'
        plan = {p + 'enorm.weight': (('enorm',), None),
                p + 'hnorm.weight': (('hnorm',), None),
                p + 'eh_proj.weight': (('eh_proj',), transposed),
                p + 'shared_head.norm.weight': (('shead_norm',), None),
                p + 'input_layernorm.weight': (('layer', 'attn_norm', 0), None),
                p + 'post_attention_layernorm.weight': (('layer', 'mlp_norm', 0), None)}
        plan.update(self._attn_plan(p + 'self_attn.'))
        if not self.moe_mlp:
            for hf, leaf in (('gate_proj', 'w_gate'), ('up_proj', 'w_up'),
                             ('down_proj', 'w_down')):
                plan[f'{p}mlp.{hf}.weight'] = (('layer', leaf, 0), transposed)
            return plan
        plan[p + 'mlp.gate.weight'] = (('layer', 'router', 0), transposed)
        plan[p + 'mlp.gate.e_score_correction_bias'] = (('layer', 'router_bias', 0), None)
        for e in range(self.config.num_experts):
            for hf, leaf in (('gate_proj', 'we_gate'), ('up_proj', 'we_up'),
                             ('down_proj', 'we_down')):
                plan[f'{p}mlp.experts.{e}.{hf}.weight'] = (('layer', leaf, 0), transposed,
                                                           ExpertSlice(e))
        if self.config.num_shared_experts:
            for hf, leaf in (('gate_proj', 'ws_gate'), ('up_proj', 'ws_up'),
                             ('down_proj', 'ws_down')):
                plan[f'{p}mlp.shared_experts.{hf}.weight'] = (('layer', leaf, 0), transposed)
        return plan

    # -- the draft step ---------------------------------------------------------------
    @torch.no_grad()
    def step(self, params, tparams, h_cond, token, position, kv_cache, block_tables,
             q_lens, cos_tab, sin_tab, max_len: int):
        """One draft step: h_cond [B, H] the target's pre-norm features, token [B],
        position [B] (where the token lands in the head's cache).  Returns (f32 logits
        [B, V], the block's pre-norm output [B, H]: the next step's condition)."""
        cfg = self.config
        eps = cfg.rms_norm_eps
        embed = tparams['embed']
        emb = embed[token.long().clamp(0, embed.shape[0] - 1)].to(h_cond.dtype)
        x = torch.cat([rms_norm(emb, params['enorm'], eps),
                       rms_norm(h_cond, params['hnorm'], eps)], dim=-1) @ params['eh_proj']
        pos = position.long().clamp(0, max_len - 1)[:, None]
        cos, sin = cos_tab[pos], sin_tab[pos]
        slots = compute_slot_mapping(block_tables, position, q_lens, 1, kv_cache.shape[3])
        w = {name: {k: a[0] for k, a in t.items()} if isinstance(t, dict) else t[0]
             for name, t in params['layer'].items()}
        meta = AttnMeta(block_tables=block_tables, history_lens=position, q_lens=q_lens)
        h = self._attn_block(w, x[:, None], 0, kv_cache, meta, cos, sin, slots, False)
        y = rms_norm(h, w['mlp_norm'], eps)
        h = (h + (self._moe_mlp(w, y) if self.moe_mlp else self._mlp(w, y)))[:, 0]
        lm_head = tparams.get('lm_head')
        if lm_head is None:
            lm_head = embed.t()
        return f32_logits(rms_norm(h, params['shead_norm'], eps), lm_head), h


def _mla_plan(model, prefix: str) -> Dict:
    """DeepseekV2Model's MLA names of one layer -> the head's layer row 0."""
    nh, dn, dv, r = model.nh, model.dn, model.dv, model.r

    def uk(t):
        return t.reshape(nh, dn + dv, r)[:, :dn, :]

    def uv(t):
        return t.reshape(nh, dn + dv, r)[:, dn:, :].transpose(-1, -2)
    plan = {prefix + 'kv_a_proj_with_mqa.weight': (('layer', 'wdkv', 0), transposed),
            prefix + 'kv_a_layernorm.weight': (('layer', 'kv_norm', 0), None),
            prefix + 'kv_b_proj.weight': [(('layer', 'wuk', 0), uk),
                                          (('layer', 'wuv', 0), uv)],
            prefix + 'o_proj.weight': (('layer', 'wo', 0), transposed)}
    if model.rq:
        plan.update({prefix + 'q_a_proj.weight': (('layer', 'wdq', 0), transposed),
                     prefix + 'q_a_layernorm.weight': (('layer', 'q_norm', 0), None),
                     prefix + 'q_b_proj.weight': (('layer', 'wuq', 0), transposed)})
    else:
        plan[prefix + 'q_proj.weight'] = (('layer', 'wq', 0), transposed)
    return plan


class DeepseekMTP(MTPHead, DeepseekV2Model):
    """DeepSeek-V2 / V3's MTP head: one MLA block.  Over a DeepSeek-V3.2 target (whose
    config carries the indexer's cache sidecar) it is this head too, as the reference
    picks it: it writes and reads 576-wide rows, so its cache is that wide."""

    @property
    def cache_width(self) -> int:
        return self.r + self.dr

    def _attn_plan(self, prefix: str) -> Dict:
        return _mla_plan(self, prefix)


class Glm4MoeMTP(MTPHead, Glm4MoeModel):
    """GLM-4.5 / 4.6's MTP (nextn) head: one GQA block."""

    def _attn_plan(self, prefix: str) -> Dict:
        cfg = self.config
        plan = {prefix + f'{n}_proj.weight': (('layer', f'w{n}', 0), transposed)
                for n in 'qkvo'}
        if cfg.attention_bias:
            plan.update({prefix + f'{n}_proj.bias': (('layer', f'b{n}', 0), None)
                         for n in 'qkv'})
        if self.qk_norm:
            plan.update({prefix + f'{n}_norm.weight': (('layer', f'{n}_norm', 0), None)
                         for n in 'qk'})
        return plan


class GlmMoeDsaMTP(MTPHead, GlmMoeDsaModel):
    """GLM-MoE-DSA's MTP head: one DSA block that computes its own picks."""

    def _attn_plan(self, prefix: str) -> Dict:
        plan = _mla_plan(self, prefix)
        plan.update(self.indexer_plan(prefix + 'indexer.', 'layer', 0))
        return plan
