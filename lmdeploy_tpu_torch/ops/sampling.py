"""On-device sampling: penalties, top-k / top-p / min-p, greedy and seeded draws.

Port of ``lmdeploy_tpu/ops/sampling.py``.  Per-row parameters come in as flat
tensors so one code path serves every request mix.

Randomness: the candidate path draws gumbel noise from the reference's counter-based
murmur3 hash over (per-row seed, candidate index), computed here in int64 with
``& 0xFFFFFFFF`` after each multiply, so it reproduces the reference's uint32 bits and
its tokens exactly.  The full-vocab path's reference draw is
``jax.random.categorical`` (threefry), which torch cannot reproduce; the port draws
gumbel-max over the full vocab from the same hash with its own salt, which samples
the same distribution with the same per-request determinism.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = float('-inf')
TOPK_CANDIDATES = 64
_MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_FULL_VOCAB_SALT = 0x5BD1E995


@dataclass
class SamplingInputs:
    """Per-row sampling parameters (numpy on the host, tensors once on a device)."""

    temperature: object        # [B] f32
    top_k: object              # [B] i32 (0 = disabled)
    top_p: object              # [B] f32 (1.0 = disabled)
    min_p: object              # [B] f32 (0.0 = disabled)
    repetition_penalty: object  # [B] f32 (1.0 = disabled)
    frequency_penalty: object  # [B] f32
    presence_penalty: object   # [B] f32
    do_sample: object          # [B] bool
    seeds: object              # [B] u32 values, held in int64
    bad_words_mask: object = None   # [B, V] bool, True = banned
    max_top_logprobs: int = 0  # max logprobs requested in the batch

    @classmethod
    def from_seqs(cls, seqs, vocab_size: int) -> 'SamplingInputs':
        """Pack per-sequence SamplingParams into flat numpy arrays (host side).

        Per-row seeds derive from (random_seed, tokens generated so far), as in
        the reference, so a replayed request reproduces its samples."""
        n = len(seqs)
        temperature = np.ones(n, np.float32)
        top_k = np.zeros(n, np.int32)
        top_p = np.ones(n, np.float32)
        min_p = np.zeros(n, np.float32)
        rep = np.ones(n, np.float32)
        freq = np.zeros(n, np.float32)
        pres = np.zeros(n, np.float32)
        do_sample = np.zeros(n, bool)
        seeds = np.zeros(n, np.int64)
        bad_rows = []
        max_lp = 0
        for i, seq in enumerate(seqs):
            p = seq.sampling_params
            temperature[i] = p.temperature
            top_k[i] = p.top_k
            top_p[i] = p.top_p
            min_p[i] = p.min_p
            rep[i] = p.repetition_penalty
            freq[i] = p.frequency_penalty
            pres[i] = p.presence_penalty
            do_sample[i] = p.do_sample
            n_out = getattr(seq, 'num_output_tokens', 0)
            seeds[i] = ((p.random_seed or 0) + (n_out + 1) * GOLDEN) & _MASK32
            if p.bad_token_ids:
                bad_rows.append((i, p.bad_token_ids))
            max_lp = max(max_lp, p.logprobs if p.logprobs > 0 else 0)
        bad_mask = None
        if bad_rows:
            bad_mask = np.zeros((n, vocab_size), dtype=bool)
            for i, ids in bad_rows:
                bad_mask[i, [t for t in ids if 0 <= t < vocab_size]] = True
        return cls(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
                   repetition_penalty=rep, frequency_penalty=freq,
                   presence_penalty=pres, do_sample=do_sample, seeds=seeds,
                   bad_words_mask=bad_mask, max_top_logprobs=max_lp)

    def to(self, device) -> 'SamplingInputs':
        """Tensors on ``device`` (one small host-to-device copy per field)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v).to(device, non_blocking=True)
            out[f.name] = v
        return SamplingInputs(**out)


def apply_penalties(logits: torch.Tensor, token_counts: torch.Tensor,
                    inputs: SamplingInputs,
                    prompt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Repetition (prompt + generated), frequency and presence (generated only)."""
    counts = token_counts.float()
    generated = counts > 0
    seen = generated if prompt_mask is None else (generated | prompt_mask)
    rep = inputs.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, penalized, logits)
    logits = logits - counts * inputs.frequency_penalty[:, None]
    return logits - generated.float() * inputs.presence_penalty[:, None]


def topk_bucket(max_top_k: int, vocab_size: int) -> int:
    """Candidate-set width for a batch whose largest top_k is ``max_top_k``."""
    k = TOPK_CANDIDATES
    while k < max_top_k and k < vocab_size:
        k *= 2
    return min(k, vocab_size)


def _top_k_p_min_p_mask(logits: torch.Tensor, inputs: SamplingInputs,
                        kmax: int = TOPK_CANDIDATES) -> torch.Tensor:
    """Combined top-k / top-p / min-p keep-mask with per-row parameters."""
    B, V = logits.shape
    kmax = min(kmax, V)
    top_vals = torch.topk(logits, kmax, dim=-1).values               # [B, kmax] desc
    max_logit = top_vals[:, :1]
    k = inputs.top_k.long().clamp(0, kmax)
    kth_val = torch.gather(top_vals, 1, (k[:, None] - 1).clamp(0, kmax - 1))
    kth_val = torch.where((inputs.top_k > 0)[:, None], kth_val,
                          torch.full_like(kth_val, NEG_INF))
    keep = logits >= kth_val
    denom = torch.exp(logits - max_logit).sum(-1, keepdim=True)
    top_probs = torch.exp(top_vals - max_logit) / denom
    cumsum = torch.cumsum(top_probs, dim=-1)
    include = (cumsum - top_probs) < inputs.top_p[:, None]
    last_idx = (include.int().sum(-1) - 1).clamp(min=0)
    p_cut = torch.gather(top_vals, 1, last_idx[:, None])
    covered = cumsum[:, -1:] >= inputs.top_p[:, None]
    active_p = (inputs.top_p < 1.0)[:, None] & covered
    keep &= torch.where(active_p, logits >= p_cut, torch.ones_like(keep))
    minp_thresh = max_logit + torch.log(inputs.min_p.clamp(min=1e-38))[:, None]
    keep &= torch.where((inputs.min_p > 0)[:, None], logits >= minp_thresh,
                        torch.ones_like(keep))
    return keep | (logits >= max_logit)


def hash_uniform(seeds: torch.Tensor, n: int, salt: int = 0) -> torch.Tensor:
    """Uniform (0, 1] noise [B, n] from the murmur3 finalizer over (seed, index).

    Bit-exact with the reference's uint32 arithmetic: every product is taken in
    int64 and cut back to 32 bits."""
    j = torch.arange(n, device=seeds.device, dtype=torch.int64)
    x = ((seeds.long()[:, None] * GOLDEN + j[None, :] * 0x85EBCA6B + salt) & _MASK32)
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _MASK32
    x ^= x >> 16
    return (x >> 8).float() * (1.0 / (1 << 24)) + 1e-12


def _top_logprobs(logprobs: torch.Tensor, n: int):
    if n > 0:
        vals, ids = torch.topk(logprobs, n, dim=-1)
        return vals, ids.int()
    B = logprobs.shape[0]
    return (torch.zeros((B, 1), device=logprobs.device),
            torch.zeros((B, 1), dtype=torch.int32, device=logprobs.device))


def sample_logits(logits: torch.Tensor, inputs: SamplingInputs,
                  token_counts: torch.Tensor,
                  prompt_mask: Optional[torch.Tensor] = None,
                  kmax: int = TOPK_CANDIDATES,
                  full_vocab: bool = False,
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full sampling pipeline on [B, V] logits.

    Returns (next_tokens [B] i32, logprob of the chosen token [B] f32, (top
    logprob values, ids) or zeros when logprobs are off).  The default candidate
    path keeps everything after the penalties on the top-``kmax`` candidates;
    ``full_vocab`` samples over the whole vocabulary (pure-ancestral rows)."""
    logits = logits.float()
    if inputs.bad_words_mask is not None:
        logits = logits.masked_fill(inputs.bad_words_mask, NEG_INF)
    logits = apply_penalties(logits, token_counts, inputs, prompt_mask)
    B, V = logits.shape
    kmax = min(kmax, V)

    if full_vocab:
        greedy = torch.argmax(logits, dim=-1).int()
        scaled = logits / inputs.temperature[:, None]
        keep = _top_k_p_min_p_mask(scaled, inputs, kmax)
        masked = torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))
        u = hash_uniform(inputs.seeds, V, _FULL_VOCAB_SALT)
        sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1).int()
        next_tokens = torch.where(inputs.do_sample, sampled, greedy)
        logprobs_all = torch.log_softmax(logits, dim=-1)
        chosen_lp = torch.gather(logprobs_all, 1, next_tokens.long()[:, None])[:, 0]
        return next_tokens, chosen_lp, _top_logprobs(logprobs_all,
                                                     inputs.max_top_logprobs)

    cand_raw, cand_ids = torch.topk(logits, kmax, dim=-1)             # sorted desc
    greedy = cand_ids[:, 0].int()
    temp = inputs.temperature[:, None]
    cand = cand_raw / temp
    max_s = cand[:, :1]
    denom_s = torch.exp(logits / temp - max_s).sum(-1, keepdim=True)
    cand_probs = torch.exp(cand - max_s) / denom_s
    j = torch.arange(kmax, device=logits.device)[None, :]
    keep = torch.where((inputs.top_k > 0)[:, None], j < inputs.top_k[:, None],
                       torch.ones((B, kmax), dtype=torch.bool, device=logits.device))
    cumsum = torch.cumsum(cand_probs, dim=-1)
    include = (cumsum - cand_probs) < inputs.top_p[:, None]
    covered = cumsum[:, -1:] >= inputs.top_p[:, None]
    active_p = (inputs.top_p < 1.0)[:, None] & covered
    keep &= torch.where(active_p, include, torch.ones_like(include))
    minp_thresh = max_s + torch.log(inputs.min_p.clamp(min=1e-38))[:, None]
    keep &= torch.where((inputs.min_p > 0)[:, None], cand >= minp_thresh,
                        torch.ones_like(keep))
    keep[:, 0] = True

    gumbel = -torch.log(-torch.log(hash_uniform(inputs.seeds, kmax)))
    z = torch.where(keep, cand + gumbel, torch.full_like(cand, NEG_INF))
    sampled = torch.gather(cand_ids, 1, torch.argmax(z, dim=-1, keepdim=True))[:, 0].int()
    next_tokens = torch.where(inputs.do_sample, sampled, greedy)

    max0 = cand_raw[:, :1]
    logz = max0 + torch.log(torch.exp(logits - max0).sum(-1, keepdim=True))
    chosen_lp = (torch.gather(logits, 1, next_tokens.long()[:, None]) - logz)[:, 0]
    if inputs.max_top_logprobs > 0:
        n = min(inputs.max_top_logprobs, kmax)
        top = (cand_raw[:, :n] - logz, cand_ids[:, :n].int())
    else:
        top = _top_logprobs(logits, 0)
    return next_tokens, chosen_lp, top


def update_token_counts(token_counts: torch.Tensor, tokens: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Scatter-add sampled tokens into the per-row seen-token counts (in place)."""
    B = token_counts.shape[0]
    rows = torch.arange(B, device=token_counts.device)
    token_counts.index_put_((rows, tokens.long()), valid.to(token_counts.dtype),
                            accumulate=True)
    return token_counts
