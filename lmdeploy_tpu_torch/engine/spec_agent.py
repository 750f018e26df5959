"""Speculative decoding: propose K tokens, verify them in one target pass.

Port of ``lmdeploy_tpu/engine/spec_agent.py`` (``SpecExtension``) for four proposers:
``draft_model`` (a smaller checkpoint of a registered architecture, or the target
itself), ``eagle`` (``models/eagle.py EagleHead``), ``eagle3`` (``Eagle3Head``) and
``deepseek_mtp`` (the target checkpoint's own MTP layer, ``models/mtp.py``: DeepSeek-V2 /
V3 and V3.2 get ``DeepseekMTP``, GLM-4.5 ``Glm4MoeMTP``, GLM-MoE-DSA ``GlmMoeDsaMTP``,
by the target's class, reference :48-65), over targets that run ``LlamaModel.forward``
or ``DeepseekV2Model.forward``.  An MTP head rides the EAGLE proposer: it conditions on
the target's pre-norm feature, shares the target's config, embedding and lm_head, and
its weights come from the target's checkpoint.  One speculative step over the rows
[0, B) of the decode state (reference ``_get_fn`` / ``_get_fn_eagle`` /
``_get_fn_eagle3``):

  (a) the proposer takes K autoregressive steps over its own paged cache (``n_layers``
      layers: 1 for a head, the draft model's own count), each drawing a token from
      its masked distribution;
  (b) the target runs once over the chunk [last token, d1..dK] and returns the logits
      of all K+1 positions (and, for a head, the features it conditions on);
  (c) ``ops/spec_sampling.py reject_sample`` accepts a prefix and draws the extra token;
  (d) each active row advances by its emitted count (``advance_rows``).

Distributions follow ``ops/sampling.py``'s masking per row (penalties, temperature,
top-k / top-p / min-p); greedy rows take one-hot distributions, so their speculation is
exact-match verification and their tokens are the target's greedy tokens.  As in the
reference: the penalty counts are frozen at the step's start across the K positions;
positions are clipped at ``max_model_len - 1``; the draft's cache is never prefilled, so
at prompt positions it attends to slots nobody wrote (stale or zero), which lowers
acceptance only; the conditioning feature of a row starts from zero (and a reused batch
slot from its previous occupant's last feature); rejected positions leave stale K/V past
each row's length in both caches, never read and overwritten later.  The draft's cache
has the target's block count and block size, shares its block tables, and always holds
the model dtype, whatever the target cache's policy; its rows are as wide as the
proposer writes them (an MTP head's ``cache_width``: DeepseekMTP's 576 under a V3.2
target whose own rows are 704).  Draft seeds are
``seed + (step_no + 1 + i) * 0x9E3779B9`` and verify seeds ``seed + step_no *
0x85EBCA6B``, in u32 arithmetic (int64 with ``& 0xFFFFFFFF``); the draws themselves come
from the port's hash streams (``ops/spec_sampling.py``), not the reference's threefry.

The step is one ``SpecRun`` per ``('spec', method, B)`` in the agent's ``DecodeGraphs``:
on the card it is captured as a CUDA graph at its first use (or by ``warmup``) and
replayed, unless ``eager_mode`` or ``eager_reason`` says otherwise: it counts the
verify's B * (K+1) rows against the target's expert stacks and the draft's B rows
against the proposer's (``draft_ragged``); a wider block table drops it with the
decode graphs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, bucketize
from ..models import build_model
from ..models.deepseek import DeepseekV2Model
from ..models.eagle import Eagle3Head, EagleHead
from ..models.llama import AttnMeta, LlamaModel
from ..nn.layers import make_rope_table
from ..ops.sampling import (GOLDEN, NEG_INF, SamplingInputs, _top_k_p_min_p_mask,
                            apply_penalties, hash_uniform)
from ..ops.spec_sampling import DRAFT_SALT, draw, reject_sample
from .decode_state import DecodeState, make_initial_state
from .graph_runner import GraphRun
from .model_agent import StepOutput, ragged_min_rows

_MASK32 = 0xFFFFFFFF
VERIFY_MIX = 0x85EBCA6B
METHODS = ('draft_model', 'eagle', 'eagle3', 'deepseek_mtp')
# the proposers that condition on the target's pre-norm feature
FEATURE_METHODS = ('eagle', 'deepseek_mtp')
# the reference's MTP proposers still to port, and the ROADMAP items that bring them
MTP_ITEMS = {'qwen3_5_mtp': 'ROADMAP.md item 14 (Qwen3.5 and its MTP layer)'}
# the target forwards a verify runs through
VERIFY_FORWARDS = (LlamaModel.forward, DeepseekV2Model.forward)
# EAGLE-3's draft logits outside its vocabulary (reference :537-538)
UNMAPPED_LOGIT = -1e30
# the seed of a draft's random weights under empty_init (the reference's PRNGKey(1))
DRAFT_INIT_SEED = 1


class SpecRun(GraphRun):
    """One speculative step's static outputs for B rows: the emitted tokens [B, K+1]
    i32 (valid up to ``num_emitted``), ``num_emitted`` [B] i32 (0 for inactive rows)
    and each token's target logprob [B, K+1] f32."""

    def __init__(self, key, K: int, device, body):
        super().__init__(key, body)
        B = key[2]
        self.tokens = torch.zeros((B, K + 1), dtype=torch.int32, device=device)
        self.num_emitted = torch.zeros((B,), dtype=torch.int32, device=device)
        self.logprobs = torch.zeros((B, K + 1), dtype=torch.float32, device=device)


def masked_dist(logits: torch.Tensor, row: Dict[str, torch.Tensor], counts: torch.Tensor,
                pmask: torch.Tensor) -> torch.Tensor:
    """Each row's sampling distribution [B, V] f32 under its own parameters
    (reference ``_masked_dist``): penalties, temperature, the top-k / top-p / min-p mask,
    softmax; greedy rows get the one-hot distribution of the penalized argmax."""
    si = SamplingInputs(temperature=row['temperature'], top_k=row['top_k'],
                        top_p=row['top_p'], min_p=row['min_p'],
                        repetition_penalty=row['repetition_penalty'],
                        frequency_penalty=row['frequency_penalty'],
                        presence_penalty=row['presence_penalty'],
                        do_sample=row['do_sample'], seeds=row['seed'])
    logits = apply_penalties(logits.float(), counts, si, pmask)
    scaled = logits / si.temperature[:, None]
    keep = _top_k_p_min_p_mask(scaled, si)
    dist = torch.softmax(torch.where(keep, scaled, torch.full_like(scaled, NEG_INF)), -1)
    onehot = torch.zeros_like(dist).scatter_(1, torch.argmax(logits, -1, keepdim=True), 1.0)
    return torch.where(si.do_sample[:, None], dist, onehot)


def advance_rows(row: Dict[str, torch.Tensor], counts: torch.Tensor,
                 out_tokens: torch.Tensor, num_emitted: torch.Tensor,
                 hidden: Optional[torch.Tensor] = None,
                 features: Optional[torch.Tensor] = None) -> None:
    """Advance each active row by its emitted count, in place (reference step (d)): the
    last emitted token becomes the row's token, position and step_no grow by the count,
    each emitted token adds one to the row's penalty counts (one position at a time, so
    that no two adds meet at one count: a fixed order), and ``hidden`` [B, F] takes the
    verify's feature at the last emitted position (``features`` [B, K+1, F])."""
    act = row['active']
    K = out_tokens.shape[1] - 1
    rows = torch.arange(out_tokens.shape[0], device=out_tokens.device)
    last = (num_emitted.long() - 1).clamp(0, K)
    row['token'].copy_(torch.where(act, out_tokens[rows, last], row['token']))
    for j in range(K + 1):
        counts.index_put_((rows, out_tokens[:, j].long()),
                          (num_emitted > j).to(counts.dtype), accumulate=True)
    if hidden is not None:
        hidden.copy_(torch.where(act[:, None], features[rows, last].to(hidden.dtype), hidden))
    row['position'].add_(num_emitted)
    row['step_no'].add_(num_emitted)


class SpecExtension:
    """A proposer, its cache and the speculative step, attached to a ``ModelAgent``
    (``agent.spec``)."""

    def __init__(self, agent, draft_model_path: Optional[str],
                 num_speculative_tokens: int = 4, draft_empty_init: bool = False,
                 method: str = 'draft_model'):
        if method in MTP_ITEMS:
            raise NotImplementedError(f'speculative method {method!r} is not ported yet: '
                                      f'{MTP_ITEMS[method]}')
        if method not in METHODS:
            raise ValueError(f'unknown speculative method {method!r}; one of '
                             f'{METHODS + tuple(MTP_ITEMS)}')
        if agent.mesh is not None:
            raise NotImplementedError('speculative decoding under context parallelism is '
                                      'not ported yet (ROADMAP.md item 16)')
        if type(agent.model).forward not in VERIFY_FORWARDS:
            raise NotImplementedError(
                f'speculative decoding verifies through LlamaModel.forward or '
                f'DeepseekV2Model.forward; {type(agent.model).__name__} runs its own')
        if num_speculative_tokens < 1:
            raise ValueError('num_speculative_tokens must be at least 1')
        self.agent = agent
        self.k = num_speculative_tokens
        self.method = method
        tcfg = agent.model_config
        dev = agent.device
        self.hidden = None          # the conditioning feature of each decode-state row
        if method == 'deepseek_mtp':
            # the head is the checkpoint's extra layer: the target's config and weights
            self.draft_config = dc = tcfg
            self.draft_model = _mtp_head(agent.model)
            width = tcfg.hidden_size
        else:
            self.draft_config = dc = ModelConfig.from_pretrained(draft_model_path,
                                                                 dtype=tcfg.dtype)
        if method == 'eagle3':
            self.draft_model = Eagle3Head(dc)
            # the target's feature taps: layer OUTPUTS 1, L/2 - 1, L - 4, clipped
            # (reference :86-90; its own llama.py picks the inputs 2, L/2, L - 3)
            L = tcfg.num_layers
            if agent.model.aux_hidden_layers is None:
                agent.model.aux_hidden_layers = (max(0, min(1, L - 1)),
                                                 max(0, min(L // 2 - 1, L - 1)),
                                                 max(0, min(L - 4, L - 1)))
            width = 3 * self.draft_model.target_hidden
        elif method == 'eagle':
            self.draft_model = EagleHead(dc)
            width = tcfg.hidden_size
        elif method == 'draft_model':
            self.draft_model = build_model(dc)
            if dc.vocab_size != tcfg.vocab_size:
                raise ValueError(f'the draft model\'s vocabulary ({dc.vocab_size}) is not '
                                 f'the target\'s ({tcfg.vocab_size})')
        if method != 'draft_model':
            self.hidden = torch.zeros((agent.max_batch, width), dtype=tcfg.torch_dtype(),
                                      device=dev)
        if draft_empty_init or draft_model_path is None:
            params = self.draft_model.init_params(DRAFT_INIT_SEED, device=dev)
        else:
            from ..weight_loader import load_params
            params = load_params(self.draft_model, draft_model_path, dev)
        self.draft_params = (agent.prepare_params(self.draft_model, params)
                             if method == 'draft_model' else params)
        # the rows from which the proposer's expert stacks take the grouped GEMM
        self.draft_ragged = ragged_min_rows(self.draft_params)
        self.d2t = None
        if method == 'eagle3':
            self.d2t = self.draft_params['d2t'].long()
            if torch.unique(self.d2t).numel() != self.d2t.numel():
                raise ValueError('EAGLE-3 d2t maps two draft ids to one target id')
        # the draft's cache: the target's blocks and block size, the model dtype
        self.n_layers = 1 if method != 'draft_model' else dc.num_layers
        row = getattr(self.draft_model, 'cache_width', dc.num_key_value_heads * dc.cache_head_dim)
        shape = (self.n_layers, agent.num_blocks, 2, agent.cache_config.block_size, row)
        self.draft_kv = torch.zeros(shape, dtype=tcfg.torch_dtype(), device=dev)
        self.draft_cos, self.draft_sin = make_rope_table(
            dc.rope_dim, agent.max_model_len, dc.rope_theta, dc.rope_scaling, device=dev)
        agent.spec = self

    # -- the step ---------------------------------------------------------------------
    def key(self, B: int) -> Tuple[str, str, int]:
        return ('spec', self.method, B)

    def _make_run(self, key) -> SpecRun:
        return SpecRun(key, self.k, self.agent.token_counts.device, self._body)

    def _propose(self, i, tok, dpos, h, row, q1):
        """Draft step i: (f32 logits over the target vocabulary [B, V], the next
        conditioning feature or None)."""
        agent = self.agent
        max_len = agent.max_model_len
        pos = dpos.clamp(0, max_len - 1)
        tables = row['tables']
        if self.method == 'draft_model':
            meta = AttnMeta(block_tables=tables, history_lens=dpos, q_lens=q1)
            logits = self.draft_model.forward(self.draft_params, tok[:, None], pos[:, None],
                                              self.draft_kv, meta, self.draft_cos,
                                              self.draft_sin)
            return logits, None
        if self.method in FEATURE_METHODS:
            return self.draft_model.step(self.draft_params, agent.params, h, tok, pos,
                                         self.draft_kv, tables, q1, agent.rope_cos,
                                         agent.rope_sin, max_len)
        dlogits, h = self.draft_model.step(self.draft_params, self._emb_table(), h, tok, pos,
                                           self.draft_kv, tables, q1, agent.rope_cos,
                                           agent.rope_sin, max_len)
        logits = torch.full((tok.shape[0], agent.model_config.vocab_size), UNMAPPED_LOGIT,
                            dtype=torch.float32, device=tok.device)
        return logits.index_copy_(1, self.d2t, dlogits), h

    def _emb_table(self):
        """EAGLE-3's embedding: its own where its checkpoint shipped one."""
        if self.draft_model.saw_embed:
            return self.draft_params['embed']
        return self.agent.params['embed']

    @torch.no_grad()
    def _body(self, run: SpecRun, scratch: bool = False):
        """One speculative step over rows [0, B) of the decode state into ``run``'s
        outputs or, with ``scratch``, over a state of B inactive rows of its own (the
        warm pass before a capture: inactive rows write only the padding block of
        either cache and add nothing to the penalty counts)."""
        agent = self.agent
        K, B = self.k, run.key[2]
        st: DecodeState = agent.decode_state
        hidden = None if self.hidden is None else self.hidden[:B]
        if scratch:
            st = make_initial_state(B, agent.state_table_width, agent.token_counts,
                                    agent.prompt_mask)
            hidden = None if hidden is None else torch.zeros_like(hidden)
        row = {n: getattr(st, n)[:B] for n in DecodeState.ROW_FIELDS}
        counts, pmask = st.token_counts[:B], st.prompt_mask[:B]
        q1 = row['active'].int()
        V = agent.model_config.vocab_size
        # (a) K proposals
        h = hidden
        if self.method == 'eagle3':
            h = self.draft_model.condition(self.draft_params, hidden, self._emb_table().dtype)
        tok, dpos = row['token'], row['position']
        toks, dists = [], []
        for i in range(K):
            logits, h = self._propose(i, tok, dpos, h, row, q1)
            dist = masked_dist(logits, row, counts, pmask)
            seeds = (row['seed'] + (row['step_no'].long() + 1 + i) * GOLDEN) & _MASK32
            tok = draw(dist, hash_uniform(seeds, V, DRAFT_SALT))
            toks.append(tok)
            dists.append(dist)
            dpos = dpos + q1
        draft_toks = torch.stack(toks, 1)                               # [B, K]
        # (b) the target verifies the chunk [token, d1..dK] in one pass
        chunk = torch.cat([row['token'][:, None], draft_toks], dim=1)
        steps = torch.arange(K + 1, dtype=row['position'].dtype, device=chunk.device)
        positions = (row['position'][:, None] + steps[None]).clamp(0, agent.max_model_len - 1)
        meta = AttnMeta(block_tables=row['tables'], history_lens=row['position'],
                        q_lens=q1 * (K + 1))
        out = agent.model.forward(agent.params, chunk, positions, agent.kv_cache, meta,
                                  agent.rope_cos, agent.rope_sin, return_all_logits=True,
                                  return_hidden=self.method in FEATURE_METHODS,
                                  return_aux_hidden=self.method == 'eagle3')
        logits_all, features = out if isinstance(out, tuple) else (out, None)
        tgt = torch.stack([masked_dist(logits_all[:, j], row, counts, pmask)
                           for j in range(K + 1)], dim=1)               # [B, K+1, V]
        # (c) accept a prefix, draw the extra token
        seeds = (row['seed'] + row['step_no'].long() * VERIFY_MIX) & _MASK32
        out_toks, n_emitted = reject_sample(tgt, torch.stack(dists, 1), draft_toks, seeds)
        n_emitted = torch.where(row['active'], n_emitted, torch.zeros_like(n_emitted))
        lp_all = torch.log_softmax(logits_all.float(), dim=-1)
        out_lps = torch.gather(lp_all, 2, out_toks.long()[..., None])[..., 0]
        # (d) advance each row by its emitted count
        advance_rows(row, st.token_counts[:B], out_toks, n_emitted, hidden, features)
        run.tokens.copy_(out_toks)
        run.num_emitted.copy_(n_emitted)
        run.logprobs.copy_(out_lps)

    def spec_decode(self, num_rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One speculative step over rows [0, num_rows) (capacity for K+1 more tokens
        a row ensured by the caller).  Returns (tokens [B, K+1], num_emitted [B],
        logprobs [B, K+1]) as numpy, once the card has them."""
        agent = self.agent
        B = bucketize(num_rows, agent.batch_buckets)
        with agent._on_stream():
            agent._flush_deactivations()
            run = agent.graphs.run(self.key(B), self._make_run)
            step = StepOutput(run.tokens, run.logprobs, (run.num_emitted,))
        return step.tokens_np(), step.top_np()[0], step.logprobs_np()

    def warmup(self, buckets):
        """Build (on the card: capture) the step of each batch bucket."""
        for B in buckets:
            self.agent.graphs.prepare(self.key(B), self._make_run)


def _mtp_head(target):
    """The MTP head of the target's family (reference :54-62)."""
    from ..models.glm4_moe import Glm4MoeModel
    from ..models.glm_moe_dsa import GlmMoeDsaModel
    from ..models.mtp import DeepseekMTP, Glm4MoeMTP, GlmMoeDsaMTP
    if not isinstance(target, DeepseekV2Model):
        raise ValueError(f'deepseek_mtp drafts with the MTP layer of a DeepSeek-V2 / V3 / '
                         f'V3.2, GLM-4.5 or GLM-MoE-DSA checkpoint, not '
                         f'{target.config.hf_arch}')
    if isinstance(target, GlmMoeDsaModel):
        return GlmMoeDsaMTP(target.config)
    if isinstance(target, Glm4MoeModel):
        return Glm4MoeMTP(target.config)
    return DeepseekMTP(target.config)
