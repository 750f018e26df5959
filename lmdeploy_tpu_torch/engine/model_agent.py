"""ModelAgent: owns parameters, KV cache and decode state; runs forward + sampling.

Port of the main-path subset of ``lmdeploy_tpu/engine/model_agent.py``: ``_run`` with
``prefill`` / ``decode``, batch-slot management, the device-resident decode state
(``insert_decode_rows``, ``update_tables``, ``ensure_table_width``) and ``decode_run``
with its greedy fast variant and its sampled variant.  A decode run is k steps in a
Python loop with the sampled token fed back on the device; the host fetches the
``[k, B]`` tokens once.  The reference's batch / chunk / table buckets are kept, so
both engines see the same padded shapes.  PyTorch runs eagerly: there is no jit and
no donation, and every cache and state update is in place.
"""
from __future__ import annotations

import heapq
import logging
from typing import Optional

import numpy as np
import torch

from ..config import EngineConfigBundle, bucketize, make_buckets
from ..models import build_model
from ..models.llama import AttnMeta
from ..nn.layers import make_rope_table
from ..ops.sampling import (GOLDEN, TOPK_CANDIDATES, SamplingInputs, sample_logits,
                            update_token_counts)
from .cache_engine import CacheEngine
from .decode_state import DecodeState, host_rows_from_seqs, make_initial_state

logger = logging.getLogger('lmdeploy_tpu_torch')


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that raises (pass ``'cpu'`` explicitly)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device available; pass device="cpu" to run '
                               'on the CPU')
        device = 'cuda'
    return torch.device(device)


class StepOutput:
    """Host view of one step's results, fetched together on first access."""

    def __init__(self, tokens, logprobs, top=None):
        self._dev = (tokens, logprobs, top)
        self._host = None

    def _fetch(self):
        if self._host is None:
            tokens, logprobs, top = self._dev
            host_top = None if top is None else tuple(t.cpu().numpy() for t in top)
            self._host = (tokens.cpu().numpy(), logprobs.cpu().numpy(), host_top)
        return self._host

    def tokens_np(self) -> np.ndarray:
        return self._fetch()[0]

    def logprobs_np(self) -> np.ndarray:
        return self._fetch()[1]

    def top_np(self):
        return self._fetch()[2]


class ModelAgent:

    def __init__(self, configs: EngineConfigBundle, model_path: Optional[str] = None,
                 device=None, init_seed: int = 42):
        self.device = resolve_device(device)
        self.configs = configs
        self.model_config = cfg = configs.model
        self.cache_config = configs.cache
        self.sched_config = configs.scheduler
        self.model = build_model(cfg)
        self.max_batch = configs.scheduler.max_batch_size
        self.max_model_len = configs.scheduler.max_session_len
        bs = configs.cache.block_size
        self.max_blocks_per_seq = (self.max_model_len + bs - 1) // bs

        if configs.misc.empty_init or model_path is None:
            params = self.model.init_params(init_seed, device=self.device)
        else:
            from ..weight_loader import load_params
            params = load_params(self.model, model_path, self.device)
        # one wide qkv GEMM and one gate/up GEMM per layer
        self.params = self.model.fuse_projections(params)

        cos, sin = make_rope_table(cfg.rope_dim, self.max_model_len, cfg.rope_theta,
                                   cfg.rope_scaling, device=self.device)
        self.rope_cos, self.rope_sin = cos, sin

        # after the weights are resident, so the free-memory budget sees them
        self.cache_engine = CacheEngine(cfg, configs.cache, self.device)
        self.num_blocks = self.cache_engine.num_blocks

        # one extra garbage row for padding slots
        counts_shape = (self.max_batch + 1, cfg.vocab_size)
        self.token_counts = torch.zeros(counts_shape, dtype=torch.int32,
                                        device=self.device)
        self.prompt_mask = torch.zeros(counts_shape, dtype=torch.bool, device=self.device)
        self._free_slots = list(range(self.max_batch))    # lowest-first (min holes)
        self._pending_deactivate = set()                  # slots freed while a step ran

        misc = configs.misc
        self.batch_buckets = misc.decode_buckets or make_buckets(self.max_batch)
        self.chunk_buckets = misc.prefill_buckets or make_buckets(
            configs.cache.max_prefill_token_num, minimum=16)
        self.table_buckets = make_buckets(self.max_blocks_per_seq)

        # block tables are tiny: keep them at full width from the start
        self.state_table_width = self.max_blocks_per_seq
        self.decode_state = make_initial_state(self.max_batch, self.state_table_width,
                                               self.token_counts, self.prompt_mask)
        # host sync once per this many decode steps
        self.decode_run_steps = 16

    @property
    def kv_cache(self) -> torch.Tensor:
        return self.cache_engine.kv_cache

    # -- slot management --------------------------------------------------------------
    def assign_slot(self, seq) -> int:
        if seq.batch_slot < 0:
            seq.batch_slot = heapq.heappop(self._free_slots)
            # a reused slot is fully re-inserted; drop a stale pending deactivation
            self._pending_deactivate.discard(seq.batch_slot)
        return seq.batch_slot

    def free_slot(self, seq):
        """Release a sequence's batch slot.  Its row is deactivated at the next
        dispatch (``_flush_deactivations``): this may run on the event-loop thread
        while a step runs on the worker thread, and a row left active would keep
        writing KV through its stale table into freed blocks."""
        if seq.batch_slot >= 0:
            self._pending_deactivate.add(seq.batch_slot)
            heapq.heappush(self._free_slots, seq.batch_slot)
            seq.batch_slot = -1

    def _flush_deactivations(self):
        if self._pending_deactivate:
            slots = sorted(self._pending_deactivate)
            self.deactivate_rows(slots)
            self._pending_deactivate.difference_update(slots)

    # -- one step over a padded batch -------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _run(self, seqs, chunk_starts, chunk_lens, count_inputs: bool,
             valid, reset) -> StepOutput:
        """Compose a padded batch from sequences and run one step (prefill chunk,
        or decode with start = num_computed and len 1)."""
        n = len(seqs)
        B = bucketize(n, self.batch_buckets)
        T = bucketize(max(chunk_lens), self.chunk_buckets) if count_inputs else 1
        bs = self.cache_config.block_size
        max_ctx_blocks = max((s.num_computed_tokens + ln + bs - 1) // bs
                             for s, ln in zip(seqs, chunk_lens))
        W = bucketize(max_ctx_blocks, self.table_buckets)

        input_ids = np.zeros((B, T), np.int32)
        positions = np.zeros((B, T), np.int32)
        block_tables = np.zeros((B, W), np.int32)
        history_lens = np.zeros(B, np.int32)
        q_lens = np.zeros(B, np.int32)
        slot_rows = np.full(B, self.max_batch, np.int64)   # garbage row for padding
        counts_reset = np.zeros(B, bool)
        valid_mask = np.zeros(B, bool)
        for i, (seq, start, length) in enumerate(zip(seqs, chunk_starts, chunk_lens)):
            input_ids[i, :length] = seq.history_ids[start:start + length]
            positions[i, :length] = np.arange(start, start + length)
            nb = min(len(seq.logical_blocks), W)
            block_tables[i, :nb] = seq.logical_blocks[:nb]
            history_lens[i] = start
            q_lens[i] = length
            slot_rows[i] = self.assign_slot(seq)
            # a seq's first chunk in its current lifetime clears the slot's
            # previous occupant's penalty counts (even after a prefix-cache hit)
            counts_reset[i] = reset[i] or (count_inputs and
                                           getattr(seq, '_fresh_counts', False))
            if count_inputs:
                seq._fresh_counts = False
            valid_mask[i] = valid[i]

        sampling = _pad_sampling(SamplingInputs.from_seqs(seqs, self.model_config.vocab_size),
                                 n, B)
        fresh = count_inputs and all(s == 0 for s in chunk_starts)
        self._flush_deactivations()
        with torch.no_grad():
            dev = self._to_dev
            meta = AttnMeta(block_tables=dev(block_tables),
                            history_lens=dev(history_lens), q_lens=dev(q_lens))
            ids = dev(input_ids)
            logits = self.model.forward(self.params, ids, dev(positions), self.kv_cache,
                                        meta, self.rope_cos, self.rope_sin,
                                        fresh_prefill=fresh)
            slots = dev(slot_rows)
            reset_t = dev(counts_reset)[:, None]
            rows = torch.where(reset_t, torch.zeros_like(self.token_counts[slots]),
                               self.token_counts[slots])
            prows = self.prompt_mask[slots] & ~reset_t
            if count_inputs:
                # prompt tokens feed the repetition penalty only (prompt mask);
                # frequency/presence count generated tokens only
                V = self.model_config.vocab_size
                hits = torch.zeros((B, V), dtype=torch.int32, device=self.device)
                t_valid = (torch.arange(T, device=self.device)[None, :]
                           < meta.q_lens[:, None]).int()
                hits.scatter_add_(1, ids.long().clamp(0, V - 1), t_valid)
                prows = prows | (hits > 0)
            tokens, logprob, top = sample_logits(logits, sampling.to(self.device), rows,
                                                 prows, full_vocab=True)
            update_token_counts(rows, tokens, dev(valid_mask))
            self.token_counts[slots] = rows
            if count_inputs:
                self.prompt_mask[slots] = prows
        return StepOutput(tokens, logprob, top if sampling.max_top_logprobs else None)

    # -- public step API --------------------------------------------------------------
    def prefill(self, chunks) -> StepOutput:
        """One prefill step over scheduler PrefillChunks."""
        return self._run([c.seq for c in chunks], [c.start for c in chunks],
                         [c.length for c in chunks], count_inputs=True,
                         valid=[c.is_last for c in chunks],
                         reset=[c.start == 0 for c in chunks])

    def decode(self, seqs) -> StepOutput:
        """One decode step over RUNNING sequences (input = last token)."""
        return self._run(seqs, [s.num_token_ids - 1 for s in seqs], [1] * len(seqs),
                         count_inputs=False, valid=[True] * len(seqs),
                         reset=[False] * len(seqs))

    # -- device-resident decode state -------------------------------------------------
    def insert_decode_rows(self, seqs):
        """Write these RUNNING seqs' rows into the device decode state."""
        if not seqs:
            return
        self.ensure_table_width(max(len(s.logical_blocks) for s in seqs))
        rows = host_rows_from_seqs(seqs, self.state_table_width)
        idx = np.asarray([self.assign_slot(s) for s in seqs], np.int64)
        self.decode_state.insert_rows(idx, rows)

    def deactivate_rows(self, slots):
        if slots:
            self.decode_state.insert_rows(np.asarray(slots, np.int64),
                                          {'active': np.zeros(len(slots), bool)})

    def update_tables(self, seqs):
        """Refresh table rows after block allocation."""
        if not seqs:
            return
        self.ensure_table_width(max(len(s.logical_blocks) for s in seqs))
        W = self.state_table_width
        tables = np.zeros((len(seqs), W), np.int32)
        for i, s in enumerate(seqs):
            nb = min(len(s.logical_blocks), W)
            tables[i, :nb] = s.logical_blocks[:nb]
        self.decode_state.insert_rows(np.asarray([s.batch_slot for s in seqs], np.int64),
                                      {'tables': tables})

    def ensure_table_width(self, needed: int):
        """Grow the state's block-table width to the next bucket."""
        if needed <= self.state_table_width:
            return
        new_w = bucketize(needed, self.table_buckets)
        old = self.decode_state.tables
        grown = torch.zeros((old.shape[0], new_w), dtype=old.dtype, device=old.device)
        grown[:, :old.shape[1]] = old
        self.decode_state.tables = grown
        self.state_table_width = new_w

    @torch.no_grad()
    def decode_run(self, num_rows: int, k: Optional[int] = None, simple: bool = False,
                   top_lp: int = 0, kmax: int = TOPK_CANDIDATES,
                   full_vocab: bool = False) -> StepOutput:
        """Run k decode steps over rows [0, num_rows) of the decode state.

        Capacity (blocks and table rows) for k more tokens per row must already be
        ensured by the caller.  ``simple`` is the greedy fast path (every active row
        greedy with neutral penalties); ``top_lp`` > 0 also returns the per-step
        top-``top_lp`` logprobs; ``kmax`` widens the top-k/p candidate set.
        Returns tokens [k, B]."""
        k = k or self.decode_run_steps
        B = bucketize(num_rows, self.batch_buckets)
        self._flush_deactivations()
        st: DecodeState = self.decode_state
        row = {n: getattr(st, n)[:B] for n in DecodeState.ROW_FIELDS}
        counts, pmask = st.token_counts[:B], st.prompt_mask[:B]
        toks, lps, tvs, tis = [], [], [], []
        for _ in range(k):
            act = row['active']
            q_lens = act.int()
            meta = AttnMeta(block_tables=row['tables'], history_lens=row['position'],
                            q_lens=q_lens)
            positions = row['position'].clamp(0, self.max_model_len - 1)[:, None]
            logits = self.model.forward(self.params, row['token'][:, None], positions,
                                        self.kv_cache, meta, self.rope_cos, self.rope_sin)
            if simple:
                tokens = torch.argmax(logits, dim=-1).int()
                lp_all = torch.log_softmax(logits, dim=-1)
                lp = torch.gather(lp_all, 1, tokens.long()[:, None])[:, 0]
                top = torch.topk(lp_all, top_lp, dim=-1) if top_lp > 0 else None
                top = None if top is None else (top.values, top.indices.int())
            else:
                si = SamplingInputs(
                    temperature=row['temperature'], top_k=row['top_k'],
                    top_p=row['top_p'], min_p=row['min_p'],
                    repetition_penalty=row['repetition_penalty'],
                    frequency_penalty=row['frequency_penalty'],
                    presence_penalty=row['presence_penalty'], do_sample=row['do_sample'],
                    seeds=(row['seed'] + (row['step_no'].long() + 1) * GOLDEN) & 0xFFFFFFFF,
                    max_top_logprobs=top_lp)
                tokens, lp, top = sample_logits(logits, si, counts, pmask, kmax=kmax,
                                                full_vocab=full_vocab)
                update_token_counts(counts, tokens, act)
            new_token = torch.where(act, tokens, row['token'])
            row['token'].copy_(new_token)
            row['position'].add_(q_lens)
            row['step_no'].add_(q_lens)
            toks.append(new_token)
            lps.append(lp)
            if top_lp > 0:
                tvs.append(top[0])
                tis.append(top[1])
        top = (torch.stack(tvs), torch.stack(tis)) if top_lp > 0 else None
        return StepOutput(torch.stack(toks), torch.stack(lps), top)


def _pad_sampling(s: SamplingInputs, n: int, B: int) -> SamplingInputs:
    if n == B:
        return s
    pad = B - n

    def pad1(x, fill):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])

    return SamplingInputs(
        temperature=pad1(s.temperature, 1.0), top_k=pad1(s.top_k, 0),
        top_p=pad1(s.top_p, 1.0), min_p=pad1(s.min_p, 0.0),
        repetition_penalty=pad1(s.repetition_penalty, 1.0),
        frequency_penalty=pad1(s.frequency_penalty, 0.0),
        presence_penalty=pad1(s.presence_penalty, 0.0),
        do_sample=pad1(s.do_sample, False), seeds=pad1(s.seeds, 0),
        bad_words_mask=None if s.bad_words_mask is None
        else pad1(s.bad_words_mask, False),
        max_top_logprobs=s.max_top_logprobs)
