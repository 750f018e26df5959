"""Batched rejection sampling for speculative decoding.

Port of ``lmdeploy_tpu/ops/spec_sampling.py``.  The rule is the reference's (Leviathan
et al.): draft token ``d_i`` is accepted when ``u < min(p_t(d_i) / max(p_d(d_i), 1e-20),
1)``; the accepted count is the accepted *prefix*; at the first rejection (position
``min(n_accept, K - 1)``) a token is drawn from the residual ``max(p_t - p_d, 0)``,
renormalized, or from the target itself where that residual's mass is at most 1e-20;
when every draft token is accepted the extra token is drawn from the target's last
position.  Positions past ``num_emitted`` carry the extra token.

Randomness: the reference draws its per-row streams from ``fold_in(key, 0 / 1 / 2)``
(threefry), which torch cannot reproduce.  The port draws them from the counter hash
``ops/sampling.py hash_uniform`` over each row's seed, with salts of its own (one for the
acceptance uniforms, one for the residual draw, one for the bonus draw), as the
full-vocab sampling path does; a draw from a distribution ``p`` is gumbel-max over
``log p`` (``draw``), which never picks a token of zero mass.  Every uniform can be
passed in instead (``uniforms``), so that a test or the card can plant them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .sampling import hash_uniform

# the salts of the port's own streams (the reference's fold_in(key, 0 / 1 / 2) and the
# draft's proposal draws)
ACCEPT_SALT = 0x27D4EB2F
RESIDUAL_SALT = 0x165667B1
BONUS_SALT = 0xD3A2646C
DRAFT_SALT = 0xFD7046C5


def draw(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One token a row from ``probs`` [B, V] given uniforms ``u`` [B, V] in (0, 1]:
    gumbel-max over ``log p`` (a token of zero mass is never drawn; a one-hot row
    gives its token)."""
    return torch.argmax(torch.log(probs) - torch.log(-torch.log(u)), dim=-1).int()


def reject_sample(target_probs: torch.Tensor, draft_probs: torch.Tensor,
                  draft_tokens: torch.Tensor, seeds: Optional[torch.Tensor] = None,
                  uniforms: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """target_probs [B, K+1, V], draft_probs [B, K, V], draft_tokens [B, K] ->
    (out_tokens [B, K+1] i32, num_emitted [B] i32).

    ``seeds`` [B] (u32 values in int64) drive the per-row streams; ``uniforms`` =
    (acceptance [B, K], residual draw [B, V], bonus draw [B, V]), each in (0, 1],
    replace them."""
    B, K1, V = target_probs.shape
    K = K1 - 1
    if uniforms is None:
        uniforms = (hash_uniform(seeds, K, ACCEPT_SALT), hash_uniform(seeds, V, RESIDUAL_SALT),
                    hash_uniform(seeds, V, BONUS_SALT))
    u_accept, u_resid, u_bonus = uniforms
    tok = draft_tokens.long()[..., None]
    p_tgt = torch.gather(target_probs[:, :K], 2, tok)[..., 0]               # [B, K]
    p_drf = torch.gather(draft_probs, 2, tok)[..., 0]
    ratio = p_tgt / p_drf.clamp_min(1e-20)
    accept = u_accept < ratio.clamp_max(1.0)
    # the accepted count is the length of the accepted prefix
    n_accept = torch.cumprod(accept.int(), dim=-1).sum(-1)                   # [B]
    all_accepted = n_accept == K
    first_rej = n_accept.clamp_max(K - 1).long()
    rows = torch.arange(B, device=target_probs.device)
    tgt_at_rej = target_probs[rows, first_rej]                               # [B, V]
    drf_at_rej = draft_probs[rows, first_rej]
    residual = (tgt_at_rej - drf_at_rej).clamp_min(0.0)
    norm = residual.sum(-1, keepdim=True)
    # a degenerate residual (identical distributions) falls back to the target
    residual = torch.where(norm > 1e-20, residual / norm.clamp_min(1e-20), tgt_at_rej)
    resid_tok = draw(residual, u_resid)
    bonus_tok = draw(target_probs[:, K], u_bonus)
    extra = torch.where(all_accepted, bonus_tok, resid_tok)                  # [B]
    pos = torch.arange(K1, device=target_probs.device)[None, :]
    padded = torch.cat([draft_tokens.int(), extra[:, None]], dim=1)
    out = torch.where(pos < n_accept[:, None], padded, extra[:, None])
    return out.int(), (n_accept + 1).int()


def expected_acceptance_rate(target_probs: torch.Tensor,
                             draft_probs: torch.Tensor) -> torch.Tensor:
    """Analytic per-position acceptance rate 1 - TV(p_tgt, p_draft) (diagnostics)."""
    K = draft_probs.shape[1]
    return 1.0 - 0.5 * (target_probs[:, :K] - draft_probs).abs().sum(-1)
