"""Qwen3-Next: hybrid gated-DeltaNet linear attention + gated full attention + sparse MoE.

Port of ``lmdeploy_tpu/models/qwen3_next.py`` (``Qwen3NextModel``).  The network repeats
a block of ``full_attention_interval`` layers: interval - 1 gated-DeltaNet layers, then
one full-attention layer, each with its own MoE mlp.  Parameters keep the reference's
tree (``blocks`` stacked ``[NB, NLpb, ...]`` for the linear layers, ``[NB, IV, ...]``
for the norms and mlps, ``[NB, ...]`` for the attention layer), so a JAX tree converts
leaf by leaf (``weight_convert.params_from_jax``); the reference's ``lax.scan`` over
blocks becomes a Python loop over layers.

The cache is a dict ``{'pages', 'conv', 'rec'}`` (``engine/cache_engine.py``):
  * ``pages``: the paged KV cache of the full-attention layers only
    (``config.num_cache_layers`` = num_layers / interval), written by each block's
    attention layer at cache layer ``blk``;
  * ``conv`` [n_lin, slots, K-1, conv_dim] (model dtype) and ``rec`` [n_lin, slots, Hv,
    dk, dv] (f32): each linear layer's per-sequence state, indexed by batch slot, the
    last slot the garbage row of padding rows (``state_shapes``).
A step gathers each layer's rows at ``meta.slot_rows`` (``arange(B)`` on the decode
path, whose rows are the slots), zeroes the rows ``meta.reset_rows`` names (a sequence's
first chunk), runs the layer and writes the rows back in place with ``index_copy_``, at
the fixed addresses a captured decode graph reads.  A row with no valid token (a
padding row, an inactive decode row, the graph runner's scratch pass) writes to the
garbage row instead of its slot, so its state stays as it was, bit for bit.

The ops (``ops/gated_delta.py``) run as plain PyTorch in f32; the full-attention layers
take the attention kernels (rows 1-2) at Qwen3-Next's Hq 16 / Hkv 2 / D 256, after
q_norm / k_norm and a partial rope over the first ``rope_dim`` dims.  The MoE is a
softmax over all experts, top-k by a stable descending sort, the weights renormalized
with +1e-20, and a sigmoid-gated shared expert whose products keep f32 results.
Checkpoint norms are zero-centred (``w - 1``): the loader adds 1 in f32 and rounds to
the model dtype, but for the gated norm (``linear_attn.norm``), which is plain.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..nn.layers import apply_rope, rms_norm
from ..nn.linear import f32_out_mm
from ..ops.attention import compute_slot_mapping, fill_kv_cache, paged_attention
from ..ops.gated_delta import causal_conv1d, gate_decay, gated_delta_scan
from ..ops.moe import moe_ffn
from .llama import LlamaModel, refuse_quantized, transposed
from .mixtral import ExpertSlice


def _f32_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] (or [K]) with f32 sums and an f32 result (the reference's
    preferred_element_type=f32 dot)."""
    vec = w.dim() == 1
    y = f32_out_mm(x.reshape(-1, x.shape[-1]), w[:, None] if vec else w)
    return y.reshape(*x.shape[:-1], *(() if vec else (w.shape[-1],)))


def layer_interval(hf: Dict) -> int:
    """Layers a block: the position of the first full-attention layer in ``layer_types``
    plus one, else ``full_attention_interval`` (reference models/__init__.py:241-246)."""
    lt = hf.get('layer_types')
    if lt:
        return lt.index('full_attention') + 1
    return hf.get('full_attention_interval', 4)


class Qwen3NextModel(LlamaModel):
    """Hybrid linear / full-attention decoder with sparse-MoE mlps."""

    has_linear_state = True

    def __init__(self, config: ModelConfig):
        super().__init__(config)
        refuse_quantized(self)
        cfg = config
        hf = cfg.hf_config or {}
        interval = layer_interval(hf)
        lt = hf.get('layer_types')
        if lt and lt != (['linear_attention'] * (interval - 1)
                         + ['full_attention']) * (cfg.num_layers // interval):
            raise ValueError('non-uniform layer_types pattern not supported')
        if cfg.num_layers % interval:
            raise ValueError(f'{cfg.num_layers} layers are not whole blocks of {interval}')
        self.interval = interval
        self.n_blocks = cfg.num_layers // interval
        self.n_lin_per_block = interval - 1
        self.n_lin = self.n_blocks * self.n_lin_per_block

        self.lin_hk = hf.get('linear_num_key_heads', 16)
        self.lin_hv = hf.get('linear_num_value_heads', 32)
        self.lin_dk = hf.get('linear_key_head_dim', 128)
        self.lin_dv = hf.get('linear_value_head_dim', 128)
        self.conv_k = hf.get('linear_conv_kernel_dim', 4)
        self.key_dim = self.lin_hk * self.lin_dk
        self.value_dim = self.lin_hv * self.lin_dv
        self.conv_dim = 2 * self.key_dim + self.value_dim
        self.ratio = self.lin_hv // self.lin_hk

        self.n_experts = hf.get('num_experts', 0)
        self.top_k = hf.get('num_experts_per_tok', 0)
        self.moe_inter = hf.get('moe_intermediate_size', cfg.intermediate_size)
        self.shared_inter = hf.get('shared_expert_intermediate_size', 0)
        self.norm_topk = hf.get('norm_topk_prob', True)
        self.conv_bias = bool(hf.get('linear_conv_bias', False))

    # -- state carried with the cache -------------------------------------------------
    def state_shapes(self, num_slots: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (shape, dtype)} of the per-slot state: conv in the model dtype, rec in
        f32 (``num_slots`` = max_batch + 1, the last the garbage row)."""
        return {
            'conv': ((self.n_lin, num_slots, self.conv_k - 1, self.conv_dim),
                     self.config.torch_dtype()),
            'rec': ((self.n_lin, num_slots, self.lin_hv, self.lin_dk, self.lin_dv),
                    torch.float32),
        }

    # -- parameters -------------------------------------------------------------------
    def _lin_in_shapes(self) -> Dict[str, int]:
        """The gated-DeltaNet input projections' widths (Qwen3.5 splits them)."""
        return {'in_qkvz': self.key_dim * 2 + self.value_dim * 2, 'in_ba': 2 * self.lin_hv}

    def _block_mlp_shapes(self, NB: int, IV: int, H: int) -> Dict:
        """Per-layer mlp leaves (reference ``_mlp_shapes``; Qwen3.5's dense variant
        overrides)."""
        E, I, SI = self.n_experts, self.moe_inter, self.shared_inter
        return {
            'router': (NB, IV, H, E),
            'we_gate': (NB, IV, E, H, I),
            'we_up': (NB, IV, E, H, I),
            'we_down': (NB, IV, E, I, H),
            'ws_gate': (NB, IV, H, SI),
            'ws_up': (NB, IV, H, SI),
            'ws_down': (NB, IV, SI, H),
            'ws_out_gate': (NB, IV, H),             # shared_expert_gate [1, H]
        }

    def param_shapes(self) -> Dict:
        cfg = self.config
        NB, NLpb, IV = self.n_blocks, self.n_lin_per_block, self.interval
        H, D = cfg.hidden_size, cfg.head_dim
        lin = {name: (NB, NLpb, H, out) for name, out in self._lin_in_shapes().items()}
        lin.update({
            'conv_w': (NB, NLpb, self.conv_dim, self.conv_k),
            'a_log': (NB, NLpb, self.lin_hv),
            'dt_bias': (NB, NLpb, self.lin_hv),
            'gate_norm': (NB, NLpb, self.lin_dv),
            'out_proj': (NB, NLpb, self.value_dim, H),
        })
        if self.conv_bias:
            lin['conv_b'] = (NB, NLpb, self.conv_dim)
        attn = {
            'wq': (NB, H, cfg.num_attention_heads * 2 * D),     # query | gate per head
            'wk': (NB, H, cfg.num_key_value_heads * D),
            'wv': (NB, H, cfg.num_key_value_heads * D),
            'wo': (NB, cfg.num_attention_heads * D, H),
            'q_norm': (NB, D),
            'k_norm': (NB, D),
        }
        blocks = {
            'attn_norms': (NB, IV, H),
            'mlp_norms': (NB, IV, H),
            **{f'lin_{k}': v for k, v in lin.items()},
            **{f'fa_{k}': v for k, v in attn.items()},
            **self._block_mlp_shapes(NB, IV, H),
        }
        shapes = {'embed': (cfg.vocab_size, H), 'blocks': blocks, 'final_norm': (H,)}
        if not cfg.tie_word_embeddings:
            shapes['lm_head'] = (H, cfg.vocab_size)
        return shapes

    def make_assign_plan(self):
        """{hf_name: (path, transform[, column])}, the reference's plan: norms take +1
        in f32 (zero-centred), the gated norm its plain weight, ``conv1d.weight``
        [C, 1, K] -> [C, K]."""
        cfg = self.config
        IV = self.interval

        def plus1(t):
            return t.float() + 1.0

        def conv_w(t):
            return t[:, 0, :]

        plan = {'model.embed_tokens.weight': (('embed',), None),
                'model.norm.weight': (('final_norm',), plus1)}
        if not cfg.tie_word_embeddings:
            plan['lm_head.weight'] = (('lm_head',), transposed)
        for layer in range(cfg.num_layers):
            blk, j = divmod(layer, IV)
            p = f'model.layers.{layer}.'
            plan[p + 'input_layernorm.weight'] = (('blocks', 'attn_norms', blk, j), plus1)
            plan[p + 'post_attention_layernorm.weight'] = (
                ('blocks', 'mlp_norms', blk, j), plus1)
            if j < self.n_lin_per_block:
                q = p + 'linear_attn.'
                self._plan_lin_in(plan, q, blk, j)
                plan[q + 'conv1d.weight'] = (('blocks', 'lin_conv_w', blk, j), conv_w)
                if self.conv_bias:
                    plan[q + 'conv1d.bias'] = (('blocks', 'lin_conv_b', blk, j), None)
                plan[q + 'A_log'] = (('blocks', 'lin_a_log', blk, j), None)
                plan[q + 'dt_bias'] = (('blocks', 'lin_dt_bias', blk, j), None)
                plan[q + 'norm.weight'] = (('blocks', 'lin_gate_norm', blk, j), None)
                plan[q + 'out_proj.weight'] = (('blocks', 'lin_out_proj', blk, j),
                                               transposed)
            else:
                q = p + 'self_attn.'
                for hf, name in (('q_proj', 'fa_wq'), ('k_proj', 'fa_wk'),
                                 ('v_proj', 'fa_wv'), ('o_proj', 'fa_wo')):
                    plan[f'{q}{hf}.weight'] = (('blocks', name, blk), transposed)
                plan[q + 'q_norm.weight'] = (('blocks', 'fa_q_norm', blk), plus1)
                plan[q + 'k_norm.weight'] = (('blocks', 'fa_k_norm', blk), plus1)
            self._plan_mlp(plan, p + 'mlp.', blk, j)
        return plan

    def _plan_lin_in(self, plan, q: str, blk: int, j: int):
        """One linear layer's input projections: the fused per-key-head
        ``in_proj_qkvz`` and ``in_proj_ba``."""
        plan[q + 'in_proj_qkvz.weight'] = (('blocks', 'lin_in_qkvz', blk, j), transposed)
        plan[q + 'in_proj_ba.weight'] = (('blocks', 'lin_in_ba', blk, j), transposed)

    def _plan_mlp(self, plan, m: str, blk: int, j: int):
        """One layer's MoE mlp: router, per-expert stacks, the shared expert and its
        gate."""
        plan[m + 'gate.weight'] = (('blocks', 'router', blk, j), transposed)
        for e in range(self.n_experts):
            for hf, name in (('gate_proj', 'we_gate'), ('up_proj', 'we_up'),
                             ('down_proj', 'we_down')):
                plan[f'{m}experts.{e}.{hf}.weight'] = (('blocks', name, blk, j),
                                                       transposed, ExpertSlice(e))
        for hf, name in (('gate_proj', 'ws_gate'), ('up_proj', 'ws_up'),
                         ('down_proj', 'ws_down')):
            plan[f'{m}shared_expert.{hf}.weight'] = (('blocks', name, blk, j), transposed)
        plan[m + 'shared_expert_gate.weight'] = (('blocks', 'ws_out_gate', blk, j),
                                                 lambda t: t.reshape(-1))

    # -- sub-layers -------------------------------------------------------------------
    def _delta_proj(self, w, j: int, x: torch.Tensor):
        """One linear layer's input projections: (q [B,T,hk,dk], k, v [B,T,hv,dv], z,
        b [B,T,hv], a).  ``in_proj_qkvz`` is grouped per key head as [q | k | v (r·dv)
        | z (r·dv)], ``in_proj_ba`` as [b (r) | a (r)], r = hv / hk."""
        B, T, _ = x.shape
        hk, hv, dk, dv, r = self.lin_hk, self.lin_hv, self.lin_dk, self.lin_dv, self.ratio
        qkvz = torch.matmul(x, w['lin_in_qkvz'][j]).reshape(B, T, hk, 2 * dk + 2 * r * dv)
        ba = torch.matmul(x, w['lin_in_ba'][j]).reshape(B, T, hk, 2 * r)
        q = qkvz[..., :dk]
        k = qkvz[..., dk:2 * dk]
        v = qkvz[..., 2 * dk:2 * dk + r * dv].reshape(B, T, hv, dv)
        z = qkvz[..., 2 * dk + r * dv:].reshape(B, T, hv, dv)
        b = ba[..., :r].reshape(B, T, hv)
        a = ba[..., r:].reshape(B, T, hv)
        return q, k, v, z, b, a

    def _linear_attn(self, w, j: int, x: torch.Tensor, conv_st, rec_st, meta, valid,
                     reset):
        """One gated-DeltaNet layer over this layer's gathered state rows; returns
        (out, conv_st, rec_st)."""
        cfg = self.config
        B, T, _ = x.shape
        hk, hv, dk, dv, r = self.lin_hk, self.lin_hv, self.lin_dk, self.lin_dv, self.ratio
        q, k, v, z, b, a = self._delta_proj(w, j, x)
        # depthwise causal conv over the [q | k | v] channels, continued from the state
        mixed = torch.cat([q.reshape(B, T, -1), k.reshape(B, T, -1),
                           v.reshape(B, T, -1)], dim=-1)
        if reset is not None:
            conv_st = torch.where(reset[:, None, None], torch.zeros_like(conv_st), conv_st)
        mixed, conv_st = causal_conv1d(mixed, conv_st, w['lin_conv_w'][j],
                                       w['lin_conv_b'][j] if 'lin_conv_b' in w else None,
                                       meta.q_lens)
        kd = self.key_dim
        q = mixed[..., :kd].reshape(B, T, hk, dk)
        k = mixed[..., kd:2 * kd].reshape(B, T, hk, dk)
        v = mixed[..., 2 * kd:].reshape(B, T, hv, dv)
        g, beta = gate_decay(a, b, w['lin_a_log'][j], w['lin_dt_bias'][j])
        q = q.repeat_interleave(r, dim=2)
        k = k.repeat_interleave(r, dim=2)
        if reset is not None:
            rec_st = torch.where(reset[:, None, None, None], torch.zeros_like(rec_st), rec_st)
        out, rec_st = gated_delta_scan(q, k, v, g, beta, rec_st, valid=valid)
        # gated RMSNorm (norm, then the silu gate) and the output projection
        of = out.float()
        of = of * torch.rsqrt((of * of).mean(-1, keepdim=True) + cfg.rms_norm_eps)
        of = of * w['lin_gate_norm'][j].float()
        of = of * F.silu(z.float())
        y = torch.matmul(of.reshape(B, T, hv * dv).to(x.dtype), w['lin_out_proj'][j])
        return y, conv_st, rec_st

    def route(self, w, j: int, xf: torch.Tensor):
        """f32 router logits -> (top_idx [N, k], top_w [N, k]): softmax over all
        experts, top-k by a stable descending sort (ties to the lower index, as
        ``jax.lax.top_k``), renormalized with +1e-20 under ``norm_topk_prob``."""
        probs = torch.softmax(_f32_dot(xf, w['router'][j]), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_w, top_idx = vals[:, :self.top_k], idx[:, :self.top_k]
        if self.norm_topk:
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        return top_idx, top_w

    def _moe(self, w, j: int, x: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape
        xf = x.reshape(B * T, H)
        top_idx, top_w = self.route(w, j, xf)
        out = moe_ffn(xf, top_idx, top_w, w['we_gate'][j], w['we_up'][j], w['we_down'][j],
                      x.dtype)
        s = F.silu(_f32_dot(xf, w['ws_gate'][j])) * _f32_dot(xf, w['ws_up'][j])
        s = _f32_dot(s.to(x.dtype), w['ws_down'][j])
        sg = torch.sigmoid(_f32_dot(xf, w['ws_out_gate'][j]))
        out = out + s * sg[:, None]
        return out.reshape(B, T, H).to(x.dtype)

    def _full_attn(self, w, blk: int, x, pages, meta, cos, sin, slot_mapping,
                   fresh_prefill: bool):
        """One gated full-attention layer at cache layer ``blk``: q_proj's output is
        [q | gate] per head; q_norm / k_norm, then rope over the first ``rope_dim``
        dims; the output times sigmoid(gate) (f32, cast to the attention's dtype)."""
        cfg = self.config
        B, T, _ = x.shape
        D = cfg.head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        qg = torch.matmul(x, w['fa_wq']).reshape(B, T, nh, 2 * D)
        q, gate = qg[..., :D], qg[..., D:]
        k = torch.matmul(x, w['fa_wk']).reshape(B, T, nkv, D)
        v = torch.matmul(x, w['fa_wv']).reshape(B, T, nkv, D)
        q = rms_norm(q, w['fa_q_norm'], cfg.rms_norm_eps)
        k = rms_norm(k, w['fa_k_norm'], cfg.rms_norm_eps)
        rdim = cfg.rope_dim
        q_rot, k_rot = apply_rope(q[..., :rdim], k[..., :rdim], cos, sin)
        q = torch.cat([q_rot, q[..., rdim:]], dim=-1)
        k = torch.cat([k_rot, k[..., rdim:]], dim=-1)
        fill_kv_cache(pages, k.reshape(B * T, nkv, D), v.reshape(B * T, nkv, D),
                      slot_mapping, blk,
                      page_tables=meta.block_tables if fresh_prefill else None)
        attn = paged_attention(q, pages, meta.block_tables, meta.history_lens, meta.q_lens,
                               1.0 / math.sqrt(D), blk, nkv, chunk_kv=(k, v),
                               fresh_prefill=fresh_prefill)
        attn = attn.reshape(B, T, nh * D)
        attn = attn * torch.sigmoid(gate.reshape(B, T, nh * D).float()).to(attn.dtype)
        return torch.matmul(attn, w['fa_wo'])

    # -- forward ----------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                kv_cache: Dict, meta, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                return_all_logits: bool = False, fresh_prefill: bool = False,
                return_hidden: bool = False, return_aux_hidden: bool = False):
        """One step over a [B, T] chunk; writes the pages and the state rows in place.
        Returns f32 logits [B, V] at each row's last valid token, or [B, T, V] with
        ``return_all_logits``.  The speculative proposers' features are not ported for a
        hybrid target (ROADMAP.md item 14)."""
        if return_hidden or return_aux_hidden:
            raise NotImplementedError('speculative features of a hybrid model are not '
                                      'ported (ROADMAP.md item 14)')
        cfg = self.config
        B, T = input_ids.shape
        pages, conv_all, rec_all = kv_cache['pages'], kv_cache['conv'], kv_cache['rec']
        embed = params['embed']
        ids = input_ids.long().clamp(0, embed.shape[0] - 1)
        hidden = embed[ids].to(cfg.torch_dtype())
        pos = positions.long().clamp(0, rope_cos.shape[0] - 1)
        cos, sin = self._gather_rope(rope_cos, rope_sin, pos)
        slot_mapping = compute_slot_mapping(meta.block_tables, meta.history_lens,
                                            meta.q_lens, T, pages.shape[3])
        dev = input_ids.device
        slot_rows = (meta.slot_rows.long() if meta.slot_rows is not None
                     else torch.arange(B, device=dev))
        # rows without a valid token write their state to the garbage row
        garbage = torch.full((), conv_all.shape[1] - 1, dtype=torch.long, device=dev)
        write_rows = torch.where(meta.q_lens > 0, slot_rows, garbage)
        # a one-token step needs no step mask: its invalid rows' state is not kept
        valid = (torch.arange(T, device=dev)[None, :] < meta.q_lens[:, None]
                 if T > 1 else None)
        NLpb = self.n_lin_per_block
        for blk in range(self.n_blocks):
            w = {name: t[blk] for name, t in params['blocks'].items()}
            for j in range(self.interval):
                x = rms_norm(hidden, w['attn_norms'][j], cfg.rms_norm_eps)
                if j < NLpb:
                    li = blk * NLpb + j
                    conv_l, rec_l = conv_all[li], rec_all[li]
                    y, conv_st, rec_st = self._linear_attn(
                        w, j, x, conv_l.index_select(0, slot_rows),
                        rec_l.index_select(0, slot_rows), meta, valid, meta.reset_rows)
                    conv_l.index_copy_(0, write_rows, conv_st)
                    rec_l.index_copy_(0, write_rows, rec_st)
                else:
                    y = self._full_attn(w, blk, x, pages, meta, cos, sin, slot_mapping,
                                        fresh_prefill)
                hidden = hidden + y
                x = rms_norm(hidden, w['mlp_norms'][j], cfg.rms_norm_eps)
                hidden = hidden + self._moe(w, j, x)
        hidden = rms_norm(hidden, params['final_norm'], cfg.rms_norm_eps)
        if return_all_logits:
            return self._head(params, hidden)
        last = (meta.q_lens.long() - 1).clamp(min=0)
        return self._head(params, hidden[torch.arange(B, device=dev), last])
