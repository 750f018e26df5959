"""DeepSeek-V2 / V3: Multi-head Latent Attention (MLA) + DeepSeek-MoE.

Port of ``lmdeploy_tpu/models/deepseek.py`` (``DeepseekV2Model``).  Its distinctives:

  * one cache format for every attention path: the cache holds the compressed latent
    per token, ``[c_kv | k_rope]`` (kv_lora_rank + qk_rope_head_dim = 512 + 64 = 576 on
    V2-Lite and V3), under ONE kv head (``num_key_value_heads = 1``, set by the
    registry), and the V plane holds ``c_kv`` followed by 64 zeros;
  * absorbed attention everywhere: ``q_nope`` goes through ``W_uk`` once, so the scores
    are plain dot products in latent space and the port's flash_prefill and
    paged_decode kernels serve it as Hq query heads grouped over one kv head at D =
    576; the output's latent part goes back through ``W_uv``.  Both absorbed einsums
    run in f32 and round to the model dtype (on the card in full f32: the port never
    enables TF32).  The softmax scale is ``1 / sqrt(qk_nope + qk_rope)``, the
    uncompressed head dim, not the latent one;
  * rope on the rope sub-dimensions only, tables built for ``qk_rope_head_dim``
    (``config.rope_dim``); the checkpoints store those dims interleaved, so q and k
    are de-interleaved first (``_deinterleave``).  The yarn tables carry the reference's
    ``0.1 mscale ln(factor) + 1`` on cos and sin (``nn/layers.py``), and the softmax
    scale has no ``mscale_all_dim`` term: the reference's behaviour, kept (HF's
    DeepSeek-V2 scales the softmax by ``yarn_get_mscale(factor, mscale_all_dim)^2``
    and its cos / sin by ``mscale / mscale_all_dim``);
  * two stacked layer groups, walked back to back with one cache layer counter: the
    first ``first_k_dense_replace`` layers with the llama MLP (``layers``), the rest
    with DeepSeek-MoE (``moe_layers``): softmax (V2) or sigmoid (V3) scores, the
    correction bias on the expert choice only, group-limited top-k (``n_group`` /
    ``topk_group``; a masked group's choices are 0.0 under sigmoid, -inf under
    softmax), ``norm_topk_prob``, ``routed_scaling_factor``, the routed experts through
    ``ops/moe.py``'s ``moe_ffn`` and the always-on shared experts with f32 outputs.
    Ties go to the lower index, in the group and the expert top-k (a stable
    descending sort, as ``jax.lax.top_k``; ``torch.topk`` promises no order on CUDA);
  * native blocked-fp8 checkpoints (``quant_method 'fp8'`` with ``weight_block_size``,
    DeepSeek-V3's release): the routed expert stacks stay fp8-resident as ``{'w8'
    float8_e4m3fn [Lm, E, K, N], 'gscale' f32 [Lm, E, K/128, N]}`` leaves (1 B a
    weight, multiplied by ``ops/quant_bmm.fp8_bmm``), and everything else is
    dequantized while the checkpoint streams in (``dequant_on_load``;
    ``weight_loader._dequant_blocked_fp8``).  ``LMDEPLOY_TPU_FP8_DEQUANT=1``
    dequantizes the experts too.
"""
from __future__ import annotations

import math
import os
from typing import Dict

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.layers import apply_rope, rms_norm
from ..nn.linear import linear
from ..ops.attention import compute_slot_mapping, fill_kv_cache, paged_attention
from ..ops.moe import eplb_remap, moe_ffn
from .llama import AttnMeta, Leaf, LlamaModel
from .mixtral import ExpertSlice


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., d] interleaved rope layout -> half-split layout (HF deepseek)."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def _f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with exact products and an f32 result on every device (the reference's
    preferred_element_type=f32 dot)."""
    return torch.matmul(a.float(), b.float())


def _sorted_desc(x: torch.Tensor) -> torch.Tensor:
    """Indices of a stable descending sort on the last axis: ties to the lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


class DeepseekV2Model(LlamaModel):
    """DeepSeek-V2 / V2-Lite / V3 decoder with MLA + MoE."""

    LINEAR_8BIT = ('fp8_blocked',)
    # the loader's dequantize-on-load switch and the names it keeps fp8
    dequant_on_load = False
    keep_fp8 = None

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        cfg = config
        if not cfg.is_mla:
            raise ValueError('DeepseekV2Model needs an MLA config (kv_lora_rank)')
        self.nh = cfg.num_attention_heads
        self.dn = cfg.qk_nope_head_dim
        self.dr = cfg.qk_rope_head_dim
        self.dv = cfg.v_head_dim
        self.r = cfg.kv_lora_rank
        self.rq = cfg.q_lora_rank
        self.fk = cfg.first_k_dense_replace
        self.scale = 1.0 / math.sqrt(self.dn + self.dr)
        if self.quant_method == 'w4a16':
            raise NotImplementedError('W4A16 DeepSeek checkpoints are not ported yet '
                                      '(ROADMAP.md section 1, item 6)')
        # native blocked fp8 (reference deepseek.py:80-97): the MLA projections
        # dequantize at load, the routed expert stacks stay fp8-resident when their
        # widths are whole scale blocks
        self.moe_fp8 = False
        if self.quant_method == 'fp8_blocked':
            self.quant_method = None
            self.dequant_on_load = True
            bk = self.fp8_block[1]
            ie = self._ie
            if (cfg.num_experts and cfg.hidden_size % bk == 0 and ie % bk == 0
                    and os.environ.get('LMDEPLOY_TPU_FP8_DEQUANT') != '1'):
                self.moe_fp8 = True
                self.moe_fp8_block = bk
                self.keep_fp8 = lambda name: '.mlp.experts.' in name

    @property
    def _ie(self) -> int:
        return self.config.moe_intermediate_size or self.config.intermediate_size

    # -- parameters -------------------------------------------------------------------
    def _attn_shapes(self, L: int) -> Dict:
        H = self.config.hidden_size
        nh, dn, dr, dv, r = self.nh, self.dn, self.dr, self.dv, self.r
        d = {'attn_norm': (L, H), 'mlp_norm': (L, H),
             'wdkv': (L, H, r + dr), 'kv_norm': (L, r),
             'wuk': (L, nh, dn, r),        # kv_b_proj's K half, absorbed into q
             'wuv': (L, nh, r, dv),        # its V half, applied to the attention output
             'wo': (L, nh * dv, H)}
        if self.rq:
            d.update(wdq=(L, H, self.rq), q_norm=(L, self.rq),
                     wuq=(L, self.rq, nh * (dn + dr)))
        else:
            d['wq'] = (L, H, nh * (dn + dr))
        return d

    def param_shapes(self) -> Dict:
        cfg = self.config
        L, H, V, E = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.num_experts
        fk, ie = self.fk, self._ie
        lm = L - fk
        shapes: Dict = {'embed': (V, H), 'final_norm': (H,)}
        if fk:
            dense = self._attn_shapes(fk)
            dense.update(w_gate=(fk, H, cfg.intermediate_size),
                         w_up=(fk, H, cfg.intermediate_size),
                         w_down=(fk, cfg.intermediate_size, H))
            shapes['layers'] = dense
        if lm:
            moe = self._attn_shapes(lm)
            moe.update(router=(lm, H, E), router_bias=(lm, E))
            if self.moe_fp8:
                g = self.moe_fp8_block

                def qleaf(K, N):
                    return {'w8': Leaf((lm, E, K, N), torch.float8_e4m3fn),
                            'gscale': Leaf((lm, E, K // g, N), torch.float32)}
                moe.update(we_gate=qleaf(H, ie), we_up=qleaf(H, ie), we_down=qleaf(ie, H))
            else:
                moe.update(we_gate=(lm, E, H, ie), we_up=(lm, E, H, ie),
                           we_down=(lm, E, ie, H))
            shared = cfg.num_shared_experts * ie
            if shared:
                moe.update(ws_gate=(lm, H, shared), ws_up=(lm, H, shared),
                           ws_down=(lm, shared, H))
            shapes['moe_layers'] = moe
        if not cfg.tie_word_embeddings:
            shapes['lm_head'] = (H, V)
        return shapes

    # -- HF weight mapping ------------------------------------------------------------
    def make_assign_plan(self):
        """HF names -> (path, transform[, expert column]) over the two layer groups
        (reference ``make_assign_plan``): ``kv_b_proj`` fills both ``wuk`` and
        ``wuv``; a blocked-fp8 expert's ``weight_scale_inv`` grid becomes its scale
        rows, transposed and expanded along N."""
        cfg = self.config
        nh, dn, dv, r = self.nh, self.dn, self.dv, self.r
        fk, H, ie = self.fk, cfg.hidden_size, self._ie

        def transposed(t):
            return t.t()

        def uk(t):      # [nh*(dn+dv), r] -> [nh, dn, r]
            return t.reshape(nh, dn + dv, r)[:, :dn, :]

        def uv(t):      # [nh*(dn+dv), r] -> [nh, r, dv]
            return t.reshape(nh, dn + dv, r)[:, dn:, :].transpose(-1, -2)

        def scale_rows(n_out, g):
            # HF scale_inv [ceil(N/g), ceil(K/g)] -> [K/g, N]
            return lambda s: s.float().t().repeat_interleave(g, dim=-1)[..., :n_out]

        plan = {'model.embed_tokens.weight': (('embed',), None),
                'model.norm.weight': (('final_norm',), None)}
        if not cfg.tie_word_embeddings:
            plan['lm_head.weight'] = (('lm_head',), transposed)
        for layer in range(cfg.num_layers):
            grp, i = ('layers', layer) if layer < fk else ('moe_layers', layer - fk)
            p = f'model.layers.{layer}.'

            def put(hf, leaf, fn, col=None):
                plan[p + hf] = ((grp,) + leaf + (i,), fn) + ((col,) if col else ())
            put('input_layernorm.weight', ('attn_norm',), None)
            put('post_attention_layernorm.weight', ('mlp_norm',), None)
            put('self_attn.kv_a_proj_with_mqa.weight', ('wdkv',), transposed)
            put('self_attn.kv_a_layernorm.weight', ('kv_norm',), None)
            plan[p + 'self_attn.kv_b_proj.weight'] = [((grp, 'wuk', i), uk),
                                                      ((grp, 'wuv', i), uv)]
            put('self_attn.o_proj.weight', ('wo',), transposed)
            if self.rq:
                put('self_attn.q_a_proj.weight', ('wdq',), transposed)
                put('self_attn.q_a_layernorm.weight', ('q_norm',), None)
                put('self_attn.q_b_proj.weight', ('wuq',), transposed)
            else:
                put('self_attn.q_proj.weight', ('wq',), transposed)
            if layer < fk:
                put('mlp.gate_proj.weight', ('w_gate',), transposed)
                put('mlp.up_proj.weight', ('w_up',), transposed)
                put('mlp.down_proj.weight', ('w_down',), transposed)
                continue
            put('mlp.gate.weight', ('router',), transposed)
            put('mlp.gate.e_score_correction_bias', ('router_bias',), None)
            for e in range(cfg.num_experts):
                for hf, leaf, n_out in (('gate_proj', 'we_gate', ie), ('up_proj', 'we_up', ie),
                                        ('down_proj', 'we_down', H)):
                    q = f'mlp.experts.{e}.{hf}.'
                    if self.moe_fp8:
                        put(q + 'weight', (leaf, 'w8'), transposed, ExpertSlice(e))
                        put(q + 'weight_scale_inv', (leaf, 'gscale'),
                            scale_rows(n_out, self.moe_fp8_block), ExpertSlice(e))
                    else:
                        put(q + 'weight', (leaf,), transposed, ExpertSlice(e))
            if cfg.num_shared_experts:
                put('mlp.shared_experts.gate_proj.weight', ('ws_gate',), transposed)
                put('mlp.shared_experts.up_proj.weight', ('ws_up',), transposed)
                put('mlp.shared_experts.down_proj.weight', ('ws_down',), transposed)
        return plan

    # -- forward ----------------------------------------------------------------------
    def _mla_qkv(self, w, x: torch.Tensor, cos, sin):
        """(q_eff [B,T,nh,D], k_new [B,T,D], v_new [B,T,D], the query latent [B,T,rq] or
        None without q_lora) of the absorbed attention, D = kv_lora_rank +
        qk_rope_head_dim (reference ``_attn_block`` :319-340)."""
        cfg = self.config
        B, T = x.shape[:2]
        nh, dn, dr, r = self.nh, self.dn, self.dr, self.r
        qr = None
        if self.rq:
            qr = rms_norm(linear(x, w['wdq']), w['q_norm'], cfg.rms_norm_eps)
            q = linear(qr, w['wuq'])
        else:
            q = linear(x, w['wq'])
        q = q.reshape(B, T, nh, dn + dr)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        ckv = linear(x, w['wdkv'])                                   # [B, T, r + dr]
        c = rms_norm(ckv[..., :r], w['kv_norm'], cfg.rms_norm_eps)
        q_pe, k_pe = apply_rope(_deinterleave(q_pe), _deinterleave(ckv[..., r:])[:, :, None],
                                cos, sin)
        # W_uk absorbed into the query: scores live in latent space
        q_c = torch.einsum('btnd,ndr->btnr', q_nope.float(), w['wuk'].float()).to(x.dtype)
        q_eff = torch.cat([q_c, q_pe], dim=-1)
        k_new = torch.cat([c, k_pe[:, :, 0]], dim=-1)
        v_new = torch.cat([c, torch.zeros_like(k_pe[:, :, 0])], dim=-1)
        return q_eff, k_new, v_new, qr

    def _attn_block(self, w, h: torch.Tensor, layer: int, kv_cache, meta: AttnMeta,
                    cos, sin, slot_mapping, fresh_prefill: bool) -> torch.Tensor:
        cfg = self.config
        B, T = h.shape[:2]
        D = self.r + self.dr
        x = rms_norm(h, w['attn_norm'], cfg.rms_norm_eps)
        q_eff, k_new, v_new, _ = self._mla_qkv(w, x, cos, sin)
        fill_kv_cache(kv_cache, k_new.reshape(B * T, 1, D), v_new.reshape(B * T, 1, D),
                      slot_mapping, layer)
        attn = paged_attention(q_eff, kv_cache, meta.block_tables, meta.history_lens,
                               meta.q_lens, self.scale, layer, 1,
                               chunk_kv=(k_new[:, :, None], v_new[:, :, None]),
                               fresh_prefill=fresh_prefill)        # [B, T, nh, D]
        o = torch.einsum('btnr,nrv->btnv', attn[..., :self.r].float(),
                         w['wuv'].float()).to(h.dtype)
        return h + linear(o.reshape(B, T, self.nh * self.dv), w['wo'])

    def route(self, w, xf: torch.Tensor):
        """(router logits f32, expert choices [N, k], their weights f32) (reference
        ``_moe_mlp`` :364-394)."""
        cfg = self.config
        E, k = cfg.num_experts, cfg.num_experts_per_tok
        logits = _f32_dot(xf, w['router'])
        choice = self.choice_scores(w, logits)
        ng, tg = cfg.n_group, cfg.topk_group
        if ng > 1 and 0 < tg < ng:
            gsz = E // ng
            grouped = choice.reshape(-1, ng, gsz)
            if cfg.scoring_func == 'sigmoid':
                top2 = torch.sort(grouped, dim=-1, descending=True).values[..., :min(2, gsz)]
                gscore = top2.sum(-1)
            else:
                gscore = grouped.amax(-1)
            gidx = _sorted_desc(gscore)[:, :tg]
            gmask = torch.zeros_like(gscore, dtype=torch.bool).scatter_(1, gidx, True)
            fill = 0.0 if cfg.scoring_func == 'sigmoid' else float('-inf')
            choice = torch.where(gmask.repeat_interleave(gsz, dim=-1), choice,
                                 torch.full((), fill, device=choice.device))
        top_idx = _sorted_desc(choice)[:, :k]
        return logits, top_idx, self.route_weights(w, logits, top_idx)

    def choice_scores(self, w, logits: torch.Tensor) -> torch.Tensor:
        """The scores the expert choice ranks, before any group limit: sigmoid scores
        plus the correction bias, or softmax scores."""
        if self.config.scoring_func == 'sigmoid':
            return torch.sigmoid(logits) + w['router_bias'].float()[None, :]
        return torch.softmax(logits, dim=-1)

    def route_weights(self, w, logits: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
        """The routed weights of the choices ``top_idx`` from the router logits: their
        scores, renormalized with ``norm_topk_prob``, times the routed scaling."""
        cfg = self.config
        scores = (torch.sigmoid(logits) if cfg.scoring_func == 'sigmoid'
                  else torch.softmax(logits, dim=-1))
        top_w = scores.gather(-1, top_idx)
        if cfg.norm_topk_prob:
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        return top_w * cfg.routed_scaling_factor

    def _moe_mlp(self, w, x: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape
        xf = x.reshape(B * T, H)
        _, top_idx, top_w = self.route(w, xf)
        out = moe_ffn(xf, eplb_remap(w, top_idx), top_w, w['we_gate'], w['we_up'],
                      w['we_down'], x.dtype)
        if 'ws_gate' in w:                       # shared experts, f32 outputs
            s = F.silu(_f32_dot(xf, w['ws_gate'])) * _f32_dot(xf, w['ws_up'])
            out = out + _f32_dot(s.to(x.dtype), w['ws_down'])
        return out.reshape(B, T, H).to(x.dtype)

    # -- the per-layer hooks of the DSA models (deepseek_v32.py, glm_moe_dsa.py) -----------
    def _init_dsa_carry(self):
        """What a layer hands the next through the layer loop (GLM-MoE-DSA's shared
        layers reuse the last full layer's selection): nothing here."""
        return None

    def _attn_block_x(self, w, h: torch.Tensor, layer: int, kv_cache, meta: AttnMeta,
                      cos, sin, slot_mapping, fresh_prefill: bool, carry):
        """``_attn_block`` with the layer loop's carry (reference :397-405)."""
        return (self._attn_block(w, h, layer, kv_cache, meta, cos, sin, slot_mapping,
                                 fresh_prefill), carry)

    @torch.no_grad()
    def forward(self, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                kv_cache, meta: AttnMeta, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                return_all_logits: bool = False, fresh_prefill: bool = False,
                return_hidden: bool = False, return_aux_hidden: bool = False):
        """One step over a [B, T] chunk; the dense group, then the MoE group, one cache
        layer counter over both, and the DSA carry (``_init_dsa_carry``) through every
        layer.  Returns f32 logits as ``LlamaModel.forward``; with ``return_hidden``
        (logits, the pre-final-norm hidden at the same positions), the feature an MTP
        head conditions on (reference :464-480).  EAGLE-3's feature taps are not part
        of the reference's DeepSeek forward, so ``return_aux_hidden`` raises."""
        if return_aux_hidden:
            raise NotImplementedError(
                f'{type(self).__name__} has no EAGLE-3 feature taps (return_aux_hidden): '
                f'the reference\'s DeepSeek forward (lmdeploy_tpu/models/deepseek.py:'
                f'408-483) returns the pre-norm hidden only')
        cfg = self.config
        B, T = input_ids.shape
        block_size = kv_cache.shape[3]
        embed = params['embed']
        ids = input_ids.long().clamp(0, embed.shape[0] - 1)
        hidden = embed[ids].to(cfg.torch_dtype())
        pos = positions.long().clamp(0, rope_cos.shape[0] - 1)
        cos, sin = rope_cos[pos], rope_sin[pos]
        slot_mapping = compute_slot_mapping(meta.block_tables, meta.history_lens,
                                            meta.q_lens, T, block_size)
        layer = 0
        carry = self._init_dsa_carry()
        for group, moe in (('layers', False), ('moe_layers', True)):
            lp = params.get(group)
            if lp is None:
                continue
            for i in range(lp['attn_norm'].shape[0]):
                w = {name: {k: a[i] for k, a in t.items()} if isinstance(t, dict) else t[i]
                     for name, t in lp.items()}
                hidden, carry = self._attn_block_x(w, hidden, layer, kv_cache, meta, cos,
                                                   sin, slot_mapping, fresh_prefill, carry)
                x = rms_norm(hidden, w['mlp_norm'], cfg.rms_norm_eps)
                hidden = hidden + (self._moe_mlp(w, x) if moe else self._mlp(w, x))
                layer += 1
        prenorm = hidden
        hidden = rms_norm(hidden, params['final_norm'], cfg.rms_norm_eps)
        if return_all_logits:
            logits = self._head(params, hidden)
            return (logits, prenorm) if return_hidden else logits
        last = (meta.q_lens.long() - 1).clamp(min=0)
        rows = torch.arange(B, device=hidden.device)
        logits = self._head(params, hidden[rows, last])
        return (logits, prenorm[rows, last]) if return_hidden else logits
