"""DeepSeek-V3.2 (``DeepseekV32ForCausalLM``): DeepSeek Sparse Attention (DSA).

Port of ``lmdeploy_tpu/models/deepseek_v32.py`` (``hadamard_transform``,
``DeepseekV32Model``).  The V3 MLA + MoE stack, where each attention layer first runs a
lightning indexer over the whole history and then attends to the top ``index_topk``
tokens of each query only:

  * the indexer: ``q = wq_b(q_latent)`` (``index_n_heads`` x ``index_head_dim``, 64 x 128
    on V3.2), ``k = LayerNorm(wk(x))`` (one key a token; f32, with bias, eps 1e-6,
    rounded once to the model dtype), rope on the first ``qk_rope_head_dim`` dims of
    both (interleaved pairs, as the MLA rope; GLM-MoE-DSA's rotate-half is a hook), then
    a Hadamard transform of both; per-query head weights ``w = weights_proj(x) *
    nh^-0.5`` (the factor rounded to the model dtype first, as the reference's weak
    scalar); ``score(t, s) = sum_h relu(q_th . k_s) * w_th * Di^-0.5`` in f32, one
    reduction over the heads; causal top-k with ``K = min(index_topk, S)``: a stable
    descending sort, so ties go to the lower index as ``jax.lax.top_k`` gives them
    (``torch.topk`` promises no order on the card);
  * the indexer's key rides the cache's K row after the latent: ``[c | k_pe | idx_k]``
    (``config.cache_extra_dim`` = ``index_head_dim``, one kv head of 576 + 128 = 704 on
    V3.2).  The reference writes a V plane of zeros across the row; the port writes
    zeros too (its V plane is never read: the attention takes the latent from the K
    row), so ``weight_convert.cache_to_reference`` gives the reference's pages.  The
    reference keeps the checkpoint's ``num_key_value_heads`` for the cache's row width
    (128 x 704 on V3.2), of which it reads the first 704; the port's registry sets one
    kv head (ROADMAP.md section 3);
  * the absorbed-MLA attention over the gathered selected rows, f32 scores and
    products, picks past the causal range at -1e30 before the softmax.

DSA never reaches flash_prefill or paged_decode: the K plane is gathered for the
chunk's rows (``gather_layer_kv``) on every path.  Queries are independent, so the
selection and the attention run in query blocks (``dsa_query_block``) that keep the
block's f32 scores, its f32 gather and its f32 probabilities within
``DSA_TILE_BYTES``: a 2,048-token chunk over a 4,224-slot table would otherwise take
2.2 GB of scores and 4.8 GB of bf16 gather a row.  The sum over the indexer heads is
never split.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..nn.layers import apply_rope, layer_norm, rms_norm
from ..nn.linear import linear
from ..ops.attention import fill_kv_cache, gather_layer_kv
from .deepseek import DeepseekV2Model, _deinterleave, _sorted_desc
from .llama import AttnMeta

# the indexer key's LayerNorm epsilon (reference :181)
IDX_NORM_EPS = 1e-6
# a query block's f32 working set: indexer scores, the gathered rows, the probabilities
DSA_TILE_BYTES = 1024 * 1024 * 1024
# the logit of a pick past the causal range (reference :222)
INVALID_PICK = -1e30


def hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform over the last dim (a power of two) in f32, times
    d^-0.5, rounded to x's dtype (reference ``hadamard_transform``: the same butterfly,
    so the same sums in the same order)."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f'the Hadamard transform needs a power-of-two width, got {d}')
    lead = x.shape[:-1]
    h = x.float()
    step = 1
    while step < d:
        h = h.reshape(*lead, d // (2 * step), 2, step)
        a, b = h[..., 0, :], h[..., 1, :]
        h = torch.stack([a + b, a - b], dim=-2).reshape(*lead, d)
        step *= 2
    return (h * d ** -0.5).to(x.dtype)


def dsa_query_bytes(B: int, S: int, K: int, hI: int, nh: int, D: int) -> int:
    """The bytes one query of B rows takes: its indexer scores [hI, S] and row scores
    [S] in f32, its gathered rows [K, D] in the cache's dtype and in f32, its scores and
    probabilities [nh, K] in f32."""
    return B * (4 * (hI * S + S) + 6 * K * D + 8 * nh * K)


def dsa_query_block(B: int, S: int, K: int, hI: int, nh: int, D: int) -> int:
    """Queries a block: as many as ``DSA_TILE_BYTES`` holds, at least one."""
    return max(1, DSA_TILE_BYTES // dsa_query_bytes(B, S, K, hI, nh, D))


class DeepseekV32Model(DeepseekV2Model):
    """V3 MLA + MoE with DSA sparse attention layers."""

    def __init__(self, config: ModelConfig):
        hf = config.hf_config or {}
        self.idx_heads = int(hf.get('index_n_heads', 64))
        self.idx_dim = int(hf.get('index_head_dim', 128))
        self.idx_topk = int(hf.get('index_topk', 2048))
        config.cache_extra_dim = self.idx_dim
        super().__init__(config)
        if not self.rq:
            raise ValueError(f'{config.hf_arch} needs q_lora_rank: the indexer reads the '
                             f'query latent')
        self.idx_scale = self.idx_dim ** -0.5

    # -- parameters -------------------------------------------------------------------
    def _attn_shapes(self, L: int) -> Dict:
        H = self.config.hidden_size
        d = super()._attn_shapes(L)
        d.update(idx_wq_b=(L, self.rq, self.idx_heads * self.idx_dim),
                 idx_wk=(L, H, self.idx_dim), idx_k_norm=(L, self.idx_dim),
                 idx_k_norm_b=(L, self.idx_dim), idx_weights=(L, H, self.idx_heads))
        return d

    def indexer_plan(self, prefix: str, group: str, i: int) -> Dict:
        """The indexer's HF names under ``prefix`` (``...self_attn.indexer.``) -> the
        leaves of row ``i`` of ``group`` (reference :91-105)."""
        def transposed(t):
            return t.t()
        return {prefix + 'wq_b.weight': ((group, 'idx_wq_b', i), transposed),
                prefix + 'wk.weight': ((group, 'idx_wk', i), transposed),
                prefix + 'k_norm.weight': ((group, 'idx_k_norm', i), None),
                prefix + 'k_norm.bias': ((group, 'idx_k_norm_b', i), None),
                prefix + 'weights_proj.weight': ((group, 'idx_weights', i), transposed)}

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        for layer in range(self.config.num_layers):
            grp, i = ('layers', layer) if layer < self.fk else ('moe_layers', layer - self.fk)
            plan.update(self.indexer_plan(f'model.layers.{layer}.self_attn.indexer.', grp, i))
        return plan

    # -- the DSA block ----------------------------------------------------------------
    def _indexer_rope(self, x: torch.Tensor, cos, sin) -> torch.Tensor:
        """Rope on the indexer's rope dims [B, T, H, dr]: interleaved pairs, as
        DeepSeek's checkpoints store them (reference :118-125)."""
        d = _deinterleave(x)
        return apply_rope(d, d, cos, sin)[0]

    def _attn_block(self, w, h: torch.Tensor, layer: int, kv_cache, meta: AttnMeta,
                    cos, sin, slot_mapping, fresh_prefill: bool) -> torch.Tensor:
        """The carry-free entry (an MTP head's step; reference :108-116)."""
        return self._attn_block_x(w, h, layer, kv_cache, meta, cos, sin, slot_mapping,
                                  fresh_prefill, self._init_dsa_carry())[0]

    def _dsa_select(self, w, x: torch.Tensor, qr: torch.Tensor, cos, sin,
                    hist_k: torch.Tensor, pos_q: torch.Tensor, layer: int, carry
                    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[tuple]]:
        """The lightning indexer's causal top-k (reference ``_dsa_select`` :127-153):
        (picks [B, T, K] i64, valid [B, T, K] bool, the carry).  x [B, T, H] the normed
        input, qr [B, T, q_lora] the query latent, hist_k [B, S, Di] the cached
        indexer keys, pos_q [B, T] each query's position."""
        B, T = x.shape[:2]
        S = hist_k.shape[1]
        dr, Di, hI = self.dr, self.idx_dim, self.idx_heads
        iq = linear(qr, w['idx_wq_b']).reshape(B, T, hI, Di)
        iq = hadamard_transform(torch.cat([self._indexer_rope(iq[..., :dr], cos, sin),
                                           iq[..., dr:]], dim=-1))
        iw = self._scaled(linear(x, w['idx_weights']), hI ** -0.5).float() * self.idx_scale
        K = min(self.idx_topk, S)
        kf = hist_k.float()
        pos_k = torch.arange(S, device=x.device)
        tile = dsa_query_block(B, S, K, hI, self.nh, self.r + self.dr)
        picks, valid = [], []
        for t in range(0, T, tile):
            scores = self._dsa_scores(iq[:, t:t + tile], iw[:, t:t + tile], kf,
                                      pos_q[:, t:t + tile], pos_k)
            order = _sorted_desc(scores)[..., :K]
            picks.append(order)
            valid.append(torch.isfinite(torch.gather(scores, -1, order)))
        return torch.cat(picks, 1), torch.cat(valid, 1), carry

    def _dsa_scores(self, iq: torch.Tensor, iw: torch.Tensor, kf: torch.Tensor,
                    pos_q: torch.Tensor, pos_k: torch.Tensor) -> torch.Tensor:
        """A query block's indexer scores [B, Tb, S] f32 (reference :143-149): iq
        [B, Tb, hI, Di] the transformed queries, iw [B, Tb, hI] their head weights,
        kf [B, S, Di] the keys in f32; -inf past each query's causal range."""
        logits = torch.einsum('bthd,bsd->bhts', iq.float(), kf)
        scores = torch.einsum('bhts,bth->bts', logits.clamp_min(0.0), iw)
        return scores.masked_fill(~(pos_k[None, None, :] <= pos_q[:, :, None]),
                                  float('-inf'))

    def _attn_block_x(self, w, h: torch.Tensor, layer: int, kv_cache, meta: AttnMeta,
                      cos, sin, slot_mapping, fresh_prefill: bool, carry):
        """The DSA attention block (reference ``_attn_block_x`` :155-228): returns
        (h + attention output, the carry)."""
        cfg = self.config
        B, T = h.shape[:2]
        nh, dr, dv, r = self.nh, self.dr, self.dv, self.r
        D, Di = r + dr, self.idx_dim
        x = rms_norm(h, w['attn_norm'], cfg.rms_norm_eps)
        q_eff, k_mla, _, qr = self._mla_qkv(w, x, cos, sin)
        # the indexer's key, cached inline after the latent
        ik = layer_norm(linear(x, w['idx_wk']), w['idx_k_norm'], w['idx_k_norm_b'],
                        IDX_NORM_EPS)
        ik = hadamard_transform(torch.cat([self._indexer_rope(ik[:, :, None, :dr], cos,
                                                              sin)[:, :, 0],
                                           ik[..., dr:]], dim=-1))
        k_new = torch.cat([k_mla, ik], dim=-1)                            # [B, T, D + Di]
        fill_kv_cache(kv_cache, k_new.reshape(B * T, 1, D + Di),
                      torch.zeros_like(k_new).reshape(B * T, 1, D + Di), slot_mapping, layer,
                      kv_sim=self.kv_sim)
        keys = gather_layer_kv(kv_cache, layer, meta.block_tables, 1, D + Di)[0][0]
        S = keys.shape[1]                                                 # [B, S, D + Di]
        pos_q = (meta.history_lens.long()[:, None]
                 + torch.arange(T, device=h.device)[None, :])             # [B, T]
        picks, valid, carry = self._dsa_select(w, x, qr, cos, sin, keys[..., D:], pos_q,
                                               layer, carry)
        K = picks.shape[-1]
        rows = torch.arange(B, device=h.device)[:, None, None]
        latent = keys[..., :D]
        wuv = w['wuv'].float()
        tile = dsa_query_block(B, S, K, self.idx_heads, nh, D)
        outs = []
        for t in range(0, T, tile):
            sel = latent[rows, picks[:, t:t + tile]].float()              # [B, Tb, K, D]
            att = torch.einsum('btnd,btkd->bntk', q_eff[:, t:t + tile].float(),
                               sel) * self.scale
            att = att.masked_fill(~valid[:, None, t:t + tile], INVALID_PICK)
            p = torch.softmax(att, dim=-1)
            o = torch.einsum('bntk,btkr->btnr', p, sel[..., :r])
            outs.append(torch.einsum('btnr,nrv->btnv', o, wuv).to(h.dtype))
        o = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
        return h + linear(o.reshape(B, T, nh * dv), w['wo']), carry
