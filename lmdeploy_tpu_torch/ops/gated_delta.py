"""Gated DeltaNet linear attention (Qwen3-Next, Qwen3.5): the recurrence and the causal
conv.

Port of ``lmdeploy_tpu/ops/gated_delta.py``, which computes all of this in XLA, outside
any Pallas kernel; here it is plain PyTorch on both devices, every product in f32 (the
card's TF32 stays off: PyTorch's default, ``torch.backends.cuda.matmul.allow_tf32``).

Math (transformers' ``torch_recurrent_gated_delta_rule``):
    q, k l2-normalized per head; q *= dk**-0.5
    S_t = S_{t-1} * exp(g_t)
    delta_t = (v_t - k_t^T S_t) * beta_t
    S_t += k_t (x) delta_t
    o_t = q_t^T S_t
with g = -exp(A_log) * softplus(a + dt_bias), beta = sigmoid(b).

``gated_delta_scan`` runs the per-token recurrence, a Python loop over T, below
``CHUNK_MIN_T`` tokens and dispatches to ``gated_delta_chunked`` (chunks of ``CHUNK``
tokens, the unit-lower-triangular solve by repeated squaring, ``_tri_inv_unit_lower``)
from there, at the same T as the reference, so both packages take the same form on the
same chunk.  Padding steps are masked by (g=0, beta=0), as in the reference; the scan
also keeps the state of a masked step as it was, so a padding step leaves it bit for bit
unchanged (the reference's ``S + k (x) 0`` may turn a -0.0 into +0.0).  The
reference's ``return_states`` (per-position snapshots for Qwen3.5's MTP rollback) is
not ported yet (ROADMAP.md item 14).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

CHUNK = 64                 # chunked-prefill block (reference kernels use 64)
CHUNK_MIN_T = 64           # below this the per-token scan runs


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FLA-style l2 normalization over the last dim."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def _prepared(q, k, v, g, beta, valid):
    """f32 operands: q and k normalized (q scaled by dk**-0.5), g and beta zeroed where
    ``valid`` is False."""
    dk = q.shape[-1]
    qf = l2norm(q.float()) * (dk ** -0.5)
    kf = l2norm(k.float())
    gf, bf = g.float(), beta.float()
    if valid is not None:
        gf = torch.where(valid[..., None], gf, torch.zeros((), device=gf.device))
        bf = torch.where(valid[..., None], bf, torch.zeros((), device=bf.device))
    return qf, kf, v.float(), gf, bf


def gated_delta_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, beta: torch.Tensor, state0: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the gated delta recurrence over a token chunk.

    q, k [B, T, Hv, dk] (already repeated to value heads); v [B, T, Hv, dv]; g [B, T, Hv]
    log decay (<= 0); beta [B, T, Hv] write strength; state0 [B, Hv, dk, dv]; valid
    [B, T] bool (False steps leave the state untouched).  Returns (out [B, T, Hv, dv]
    f32, state_T [B, Hv, dk, dv] f32).  From ``CHUNK_MIN_T`` tokens the chunked form
    runs (``LMDEPLOY_TPU_GDN_CHUNKED=0`` keeps the scan, as in the reference)."""
    if (q.shape[1] >= CHUNK_MIN_T
            and os.environ.get('LMDEPLOY_TPU_GDN_CHUNKED', '1') != '0'):
        return gated_delta_chunked(q, k, v, g, beta, state0, valid=valid)
    qf, kf, vf, gf, bf = _prepared(q, k, v, g, beta, valid)
    S = state0.float()
    outs = []
    for t in range(q.shape[1]):
        q_t, k_t, v_t = qf[:, t], kf[:, t], vf[:, t]               # [B, Hv, dk|dv]
        S_new = S * torch.exp(gf[:, t])[..., None, None]
        kv_mem = torch.einsum('bhk,bhkv->bhv', k_t, S_new)
        delta = (v_t - kv_mem) * bf[:, t, :, None]
        S_new = S_new + k_t[..., :, None] * delta[..., None, :]
        if valid is not None:
            S_new = torch.where(valid[:, t, None, None, None], S_new, S)
        S = S_new
        outs.append(torch.einsum('bhk,bhkv->bhv', q_t, S))
    return torch.stack(outs, dim=1), S


def _tri_inv_unit_lower(A: torch.Tensor) -> torch.Tensor:
    """(I + A)^{-1} for strictly-lower-triangular A [..., C, C], by doubling: A is
    nilpotent, so the inverse is (I - A)(I + A^2)(I + A^4)... over log2(C) rounds of
    [C, C] products (the reference's order)."""
    C = A.shape[-1]
    eye = torch.eye(C, dtype=A.dtype, device=A.device)
    inv = eye - A
    P = A @ A
    n = 2
    while n < C:
        inv = inv @ (eye + P)
        P = P @ P
        n *= 2
    return inv


def gated_delta_chunked(q, k, v, g, beta, state0, valid=None, chunk: int = CHUNK):
    """Chunked gated delta rule: the scan's function over T/C sequential steps of
    [C, C] products (reference ``gated_delta_chunked``; per head, S in R^{dk x dv}, G
    the in-chunk cumsum of g):
      within a chunk the deltas solve (I + A) D = B,
        A[t,i] = beta_t exp(G_t - G_i) (k_t . k_i) (i < t),
        B[t] = beta_t (v_t - exp(G_t) (S_0^T k_t));
      o_t = exp(G_t) q_t^T S_0 + sum_{i<=t} exp(G_t - G_i) (q_t . k_i) d_i;
      S_C = exp(G_C) S_0 + sum_i exp(G_C - G_i) k_i (x) d_i.
    Every exponent is <= 0, so nothing overflows."""
    B_, T, Hv, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf, gf, bf = _prepared(q, k, v, g, beta, valid)
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        qf, kf, vf = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qf, kf, vf))
        gf, bf = (F.pad(x, (0, 0, 0, pad)) for x in (gf, bf))
    NC = (T + pad) // C
    dev = qf.device
    tril = torch.ones((C, C), dtype=torch.bool, device=dev).tril(-1)
    tril_inc = torch.ones((C, C), dtype=torch.bool, device=dev).tril()
    neg_inf = torch.full((), float('-inf'), device=dev)
    S = state0.float()
    outs = []
    for c in range(NC):
        sl = slice(c * C, (c + 1) * C)
        qx, kx, vx, gx, bx = qf[:, sl], kf[:, sl], vf[:, sl], gf[:, sl], bf[:, sl]
        G = torch.cumsum(gx, dim=1)                                  # [B, C, Hv]
        eG = torch.exp(G)
        Gd = G[:, :, None, :] - G[:, None, :, :]                     # [B, C, C, Hv]
        D = torch.exp(torch.where(tril_inc[None, :, :, None], Gd, neg_inf))
        kk = torch.einsum('bthk,bihk->btih', kx, kx)                 # [B, C, C, Hv]
        A = torch.where(tril[None, :, :, None], kk * D, 0.0) * bx[:, :, None, :]
        A = A.permute(0, 3, 1, 2)                                    # [B, Hv, C, C]
        inv = _tri_inv_unit_lower(A.reshape(B_ * Hv, C, C)).reshape(B_, Hv, C, C)
        cross = torch.einsum('bthk,bhkv->bthv', kx, S)               # S_0^T k_t
        Bmat = (vx - cross * eG[..., None]) * bx[..., None]
        delta = torch.einsum('bhti,bihv->bthv', inv, Bmat)           # [B, C, Hv, dv]
        qkT = torch.einsum('bthk,bihk->btih', qx, kx) * D
        qkT = torch.where(tril_inc[None, :, :, None], qkT, 0.0)
        outs.append(torch.einsum('bthk,bhkv->bthv', qx, S) * eG[..., None]
                    + torch.einsum('btih,bihv->bthv', qkT, delta))
        decay_end = torch.exp(G[:, -1])                              # [B, Hv]
        wK = torch.exp(G[:, -1][:, None] - G)[..., None] * kx        # [B, C, Hv, dk]
        S = (S * decay_end[..., None, None]
             + torch.einsum('bthk,bthv->bhkv', wK, delta))
    out = torch.cat(outs, dim=1)[:, :T]
    return out.reshape(B_, T, Hv, dv), S


def causal_conv1d(x: torch.Tensor, conv_state: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], lens: torch.Tensor,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over a chunk, continuing from per-row state.

    x [B, T, C] (padding rows arbitrary); conv_state [B, K-1, C], the last K-1 valid
    inputs before this chunk; weight [C, K] (HF ``conv1d.weight[:, 0, :]``); bias [C] or
    None; lens [B] valid tokens in the chunk.  Returns (silu(conv(x)) [B, T, C] in x's
    dtype, the new conv_state: the last K-1 VALID inputs, ``full[len + i]``, in
    conv_state's dtype)."""
    B, T, C = x.shape
    K = weight.shape[-1]
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    wf = weight.float()
    y = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + full[:, j:j + T].float() * wf[:, j]
    if bias is not None:
        y = y + bias.float()
    y = F.silu(y)
    idx = lens.long()[:, None] + torch.arange(K - 1, device=x.device)[None, :]
    new_state = torch.gather(full, 1, idx[:, :, None].expand(B, K - 1, C))
    return y.to(x.dtype), new_state.to(conv_state.dtype)


def gate_decay(a: torch.Tensor, b: torch.Tensor, a_log: torch.Tensor,
               dt_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g, beta) in f32 from the raw (a, b) projections and the per-head parameters."""
    g = -torch.exp(a_log.float()) * F.softplus(a.float() + dt_bias.float())
    return g, torch.sigmoid(b.float())
