"""Continuous-batching scheduler.

Reference analog: ``lmdeploy/pytorch/paging/scheduler.py`` (Scheduler ``:461``,
``schedule:841``, prefill admission with token budget ``_schedule_prefill:731``, decode
scheduling with recompute-preemption ``_schedule_decoding:788``).

Policy (same contract as the reference, simplified mechanism):
  * prefill: FCFS over WAITING, chunked by ``max_prefill_token_num``; admit while KV
    blocks and batch slots are available.
  * decode: all RUNNING sequences step together; when a sequence crosses a block
    boundary and no block is free, preempt the youngest RUNNING sequence
    (recompute-eviction — drop its blocks, back to WAITING with num_computed=0).
  * forward progress: the oldest sequence is never preempted for a younger one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..config import CacheConfig, SchedulerConfig
from ..messages import ScheduleMetrics
from .block_manager import BlockManager
from .block_trie import BlockTrie
from .seq import MessageStatus, SchedulerSequence, SequenceManager


@dataclass
class PrefillChunk:
    seq: SchedulerSequence
    start: int        # first token index computed this step (== num_computed_tokens)
    length: int       # tokens computed this step
    is_last: bool     # True when this chunk completes the prompt => sample a token


@dataclass
class SchedulerOutput:
    is_prefill: bool
    prefill_chunks: List[PrefillChunk] = field(default_factory=list)
    decode_seqs: List[SchedulerSequence] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.prefill_chunks and not self.decode_seqs


class Scheduler:

    def __init__(self, scheduler_config: SchedulerConfig, cache_config: CacheConfig,
                 num_blocks: Optional[int] = None):
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        num_blocks = num_blocks if num_blocks is not None else cache_config.num_gpu_blocks
        # Python allocator and trie only: the reference's native C++ backend
        # (paging/native.py) is a later slice of the port
        self.block_manager = BlockManager(num_blocks, cache_config.block_size)
        self.block_trie = BlockTrie(cache_config, self.block_manager) \
            if cache_config.enable_prefix_caching else None
        # sliding-window models (uniform window only — alternating-layer models
        # keep window_size=None, see ModelConfig.window_uniform): out-of-window
        # blocks are freed eagerly; prefix caching is incompatible (cached
        # prefixes would hold freed-block ids), as in the reference's
        # window_block_manager.
        self.window_size = cache_config.window_size or 0
        if self.window_size:
            self.block_trie = None
        self.num_window_freed_blocks = 0      # lifetime counter (metrics/tests)
        # SsmCkptStore of a hybrid linear-attention model under prefix caching
        # (engine/ssm_ckpt.py; set by the engine), else None
        self.ssm_ckpt = None
        self.seq_manager = SequenceManager(cache_config.block_size)
        self.num_preemptions = 0

    # -- session CRUD ------------------------------------------------------------------
    def add_session(self, session_id: int):
        return self.seq_manager.add_session(session_id)

    def end_session(self, session_id: int):
        session = self.seq_manager.get_session(session_id)
        if session is None:
            return
        for seq in list(session.sequences.values()):
            self._release_seq(seq)
        self.seq_manager.remove_session(session_id)

    def stop_seq(self, seq: SchedulerSequence):
        """Abort or finish: keep blocks until emitted outputs are drained, then release."""
        seq.status = MessageStatus.STOPPED

    def _release_seq(self, seq: SchedulerSequence):
        if self.block_trie is not None:
            self.block_trie.release_seq(seq)
        else:
            self.block_manager.free_seq(seq)
        seq.status = MessageStatus.ENDED
        seq.logical_blocks = []

    def release_stopped(self):
        for seq in self.seq_manager.seqs_with_status(MessageStatus.STOPPED):
            self._release_seq(seq)
            seq.session.sequences.pop(seq.seq_id, None)

    # -- state queries -----------------------------------------------------------------
    @property
    def waiting(self) -> List[SchedulerSequence]:
        seqs = self.seq_manager.seqs_with_status(MessageStatus.WAITING)
        return sorted(seqs, key=lambda s: s.metrics.arrival_time)

    @property
    def running(self) -> List[SchedulerSequence]:
        return self.seq_manager.seqs_with_status(MessageStatus.RUNNING)

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running)

    def has_waiting(self) -> bool:
        return bool(self.waiting)

    def make_metrics(self) -> ScheduleMetrics:
        return ScheduleMetrics(
            num_running=len(self.running),
            num_waiting=len(self.waiting),
            num_free_blocks=self.block_manager.num_free_blocks,
            num_total_blocks=self.block_manager.num_blocks,
        )

    # -- scheduling --------------------------------------------------------------------
    def schedule(self, prefer_decode: bool = False) -> SchedulerOutput:
        """Pick the next step: prefill if any WAITING can be admitted, else decode.

        Prefill-priority matches the reference default (new requests reach first token
        fast; decode throughput is preserved by the token-budget chunking).
        ``prefer_decode`` inverts the priority while sequences are RUNNING: the
        engine's overlap mode dispatches waiting prefills BEHIND the decode run
        instead (``schedule_overlap_prefill``), so decode keeps full-length runs under
        continuous arrivals.  Host swap comes with the port's swap slice.
        """
        if self.waiting and not (prefer_decode and self.running):
            out = self._schedule_prefill()
            if not out.is_empty:
                return out
        out = self._schedule_decoding()
        if out.is_empty and self.waiting and prefer_decode:
            # decode could not run (e.g. everything just finished or was preempted):
            # fall back to the prefill pass rather than stalling
            out = self._schedule_prefill()
        return out

    def _prefill_order(self, seqs: List[SchedulerSequence]
                       ) -> List[SchedulerSequence]:
        """TTFT-aware prefill ordering (reference analog: the
        ``_PrefillReorderer`` in ``lmdeploy/pytorch/paging/scheduler.py:85``).

        Shortest-remaining-prefill-first minimizes mean TTFT (a long prompt at
        the FCFS head otherwise head-of-line-blocks every short request behind
        it for its whole multi-chunk prefill).  Starvation is bounded by aging:
        each waited ``prefill_aging_s`` discounts one full token budget off the
        effective length, so any request eventually reaches the front.
        Sequences already mid-prefill go first regardless — they hold KV
        blocks that are pure waste until finished.
        """
        if not self.scheduler_config.prefill_reorder or len(seqs) <= 1:
            return seqs
        import time as _time
        now = _time.time()
        budget = max(1, self.scheduler_config.max_prefill_token_num)
        aging = self.scheduler_config.prefill_aging_s

        def key(s: SchedulerSequence):
            started = s.num_computed_tokens > 0
            wait = now - s.metrics.arrival_time
            return (0 if started else 1,
                    s.num_uncomputed / budget - wait / aging)

        return sorted(seqs, key=key)   # stable: FCFS among equals

    def _schedule_prefill(self) -> SchedulerOutput:
        ordered = self._prefill_order(self.waiting)
        out = self._schedule_prefill_pass(ordered)
        if out.is_empty and not self.running and len(ordered) > 1:
            # head-of-line livelock break: the head cannot fit while other
            # WAITING seqs (e.g. mid-chunked-prefill, still holding blocks) could
            # finish and release space.  Admit whatever fits, bypassing the head
            # — only in this nothing-else-would-run state, so the policy order is
            # preserved in the normal case.
            out = self._schedule_prefill_pass(ordered[1:])
        return out

    def schedule_overlap_prefill(self) -> SchedulerOutput:
        """Prefill pass safe to dispatch while a decode run is in flight.

        Never preempts (the running rows' blocks are being written by the in-flight
        run); trie eviction is still allowed, since it only frees blocks no live
        sequence references.  The reference also skips swapped-out sequences here;
        the port has no swap yet.  Reference analog: two-batch DP+EP overlap in
        ``lmdeploy/pytorch/engine/model_agent/agent.py:349-355``.
        """
        return self._schedule_prefill_pass(self._prefill_order(self.waiting),
                                           allow_preempt=False)

    # ceiling on (padded executable area) / (real tokens) for one prefill
    # batch.  The agent lowers a [B_bucket, T_bucket] step per shape, where
    # T is the LONGEST chunk in the batch — mixing one long chunk with many
    # short ones inflates the padded area (16 rows x 2048 for 1511 real
    # tokens = 21x waste) AND walks a huge (B, T) executable lattice, each
    # novel shape paying a multi-second XLA compile mid-serving.  Closing
    # the batch when the ratio blows keeps dispatches near the efficient
    # diagonal; deferred chunks are FIFO-next so nothing starves.
    PREFILL_PAD_CAP = 2.5

    def _schedule_prefill_pass(self, candidates,
                               allow_preempt: bool = True) -> SchedulerOutput:
        token_budget = self.scheduler_config.max_prefill_token_num
        max_batch = self.scheduler_config.max_prefill_batch
        running_count = len(self.running)
        chunks: List[PrefillChunk] = []
        from ..config import bucketize, make_buckets
        bb = make_buckets(self.scheduler_config.max_batch_size)
        cb = make_buckets(self.scheduler_config.max_prefill_token_num,
                          minimum=16)
        batch_tokens = 0
        batch_max_len = 0
        import time as _time
        for seq in candidates:
            if len(chunks) >= max_batch or token_budget <= 0:
                break
            if running_count + len(chunks) >= self.scheduler_config.max_batch_size:
                break
            if (self.block_trie is not None and seq.num_computed_tokens == 0
                    and not seq.logical_blocks):
                # multimodal prompts are cacheable too: block identity is
                # salted with per-span content digests (block_trie
                # _block_tokens / native _salted_ids), so identical
                # placeholder runs with different images never alias.  A match that
                # _ssm_trim_match cut to 0 keeps its blocks; if the sequence is not
                # admitted in this pass it holds them into the next and is not
                # matched again
                self.block_trie.match_prefix(seq)
                if self.ssm_ckpt is not None and seq.num_computed_tokens > 0:
                    self._ssm_trim_match(seq)
            num_new = min(seq.num_uncomputed, token_budget)
            if self.ssm_ckpt is not None:
                num_new = self._ssm_align_chunk(seq, num_new)
            if num_new <= 0:
                continue
            if chunks:
                pad_area = (bucketize(len(chunks) + 1, bb)
                            * bucketize(max(batch_max_len, num_new), cb))
                if pad_area > self.PREFILL_PAD_CAP * (batch_tokens + num_new):
                    break            # close the batch at the efficiency cap
            if not self.block_manager.allocate_for_seq(seq, num_new):
                if not allow_preempt:
                    # overlap mode: trie eviction only (frees unreferenced cached
                    # blocks); an in-flight decode run forbids preemption
                    need = self.block_manager.num_required_blocks(seq, num_new)
                    if not (self.block_trie is not None
                            and self.block_trie.evict(need)
                            and self.block_manager.allocate_for_seq(seq, num_new)):
                        break
                # no room: preempt the youngest RUNNING seqs; never for a seq younger
                # than the victim (forward progress)
                elif not self._try_preempt_for(seq, num_new):
                    break
            is_last = (num_new == seq.num_uncomputed)
            chunks.append(PrefillChunk(seq=seq, start=seq.num_computed_tokens,
                                       length=num_new, is_last=is_last))
            token_budget -= num_new
            batch_tokens += num_new
            batch_max_len = max(batch_max_len, num_new)
            if not seq.metrics.first_scheduled_time:
                seq.metrics.first_scheduled_time = _time.time()
        return SchedulerOutput(is_prefill=True, prefill_chunks=chunks)

    def _schedule_decoding(self) -> SchedulerOutput:
        seqs = sorted(self.running, key=lambda s: s.metrics.arrival_time)
        scheduled: List[SchedulerSequence] = []
        for seq in seqs:
            # each decode step appends 1 token; may need a new block
            if not self.block_manager.allocate_for_seq(seq, num_new_tokens=1):
                if not self._try_preempt_for(seq, 1, exclude=scheduled):
                    # cannot schedule this seq now; preempt it instead of stalling
                    self._preempt(seq)
                    continue
            scheduled.append(seq)
        return SchedulerOutput(is_prefill=False, decode_seqs=scheduled)

    def extend_decode_capacity(self, seq: SchedulerSequence, num_tokens: int,
                               exclude: Optional[List[SchedulerSequence]] = None
                               ) -> bool:
        """Ensure blocks for ``num_tokens`` more tokens (multi-step decode runs).

        May preempt younger sequences; returns False (and preempts ``seq``) when
        capacity cannot be found.
        """
        if self.block_manager.allocate_for_seq(seq, num_new_tokens=num_tokens):
            return True
        if self._try_preempt_for(seq, num_tokens, exclude=exclude):
            return True
        self._preempt(seq)
        return False

    def _try_preempt_for(self, seq: SchedulerSequence, num_new_tokens: int,
                         exclude: Optional[List[SchedulerSequence]] = None) -> bool:
        """Evict youngest RUNNING seqs until ``seq`` can allocate. Recompute-type eviction."""
        exclude_ids = {id(s) for s in (exclude or [])} | {id(seq)}
        victims = sorted((s for s in self.running if id(s) not in exclude_ids),
                         key=lambda s: s.metrics.arrival_time, reverse=True)
        # feasibility guard: never evict when eviction cannot possibly satisfy the
        # request (avoid pointless preemption storms)
        needed = self.block_manager.num_required_blocks(seq, num_new_tokens)
        reclaimable = self.block_manager.num_free_blocks + \
            sum(len(v.logical_blocks) for v in victims)
        if self.block_trie is not None:
            reclaimable += self.block_trie.num_cached_blocks
        if needed > reclaimable:
            return False
        for victim in victims:
            self._preempt(victim)
            if self.block_manager.allocate_for_seq(seq, num_new_tokens):
                return True
        # Also try evicting cached (ref-counted) prefix blocks.
        if self.block_trie is not None:
            freed = self.block_trie.evict(
                self.block_manager.num_required_blocks(seq, num_new_tokens))
            if freed and self.block_manager.allocate_for_seq(seq, num_new_tokens):
                return True
        return self.block_manager.allocate_for_seq(seq, num_new_tokens)

    # -- SSM state checkpoints (hybrid linear-attention prefix caching) ---------------
    def _ssm_trim_match(self, seq: SchedulerSequence):
        """Clamp a trie match to the deepest block boundary with a stored linear-state
        snapshot (``engine/ssm_ckpt.py``) and attach the snapshot for the model agent
        to restore; without one, decoding would resume from a zero recurrent state
        (reference :381-398).  The matched blocks stay adopted: their KV is valid, and
        the replayed span rewrites the same KV while it rebuilds the state.  A match cut
        to 0 whose sequence then waits keeps them and is not matched again (the
        reference's ``match_prefix`` asserts there; ROADMAP.md section 3)."""
        bs = self.cache_config.block_size
        nb = len(seq.logical_blocks)
        keep, snap = self.ssm_ckpt.longest_prefix(seq.history_ids, nb, bs)
        if keep < nb:
            seq.num_computed_tokens = keep * bs
        if keep:
            seq._ssm_restore = snap

    def _ssm_align_chunk(self, seq: SchedulerSequence, num_new: int) -> int:
        """Align prefill chunk ends to block boundaries, so the state after a chunk can
        be published as a checkpoint; the deepest matchable boundary ``((len - 1) //
        bs) * bs`` always ends a chunk (reference :400-418)."""
        bs = self.cache_config.block_size
        start = seq.num_computed_tokens
        end = start + num_new
        total = seq.num_token_ids
        top = ((total - 1) // bs) * bs
        if end >= total:
            if top > start:
                return top - start
            return num_new
        aligned = (end // bs) * bs
        if aligned > start:
            return aligned - start
        return num_new

    def _preempt(self, seq: SchedulerSequence):
        self.num_preemptions += 1
        # resumed sequences get DIFFERENT physical blocks; invalidate the
        # device-table sync marker (it compares lengths, which may match)
        seq._synced_blocks = -1
        if self.block_trie is not None:
            self.block_trie.release_seq(seq)
        else:
            self.block_manager.free_seq(seq)
        seq.reset_computed()
        seq.status = MessageStatus.WAITING

    # -- sliding-window block eviction ---------------------------------------------------
    def _free_out_of_window(self, seq: SchedulerSequence):
        """Free KV blocks whose every token is permanently outside the
        attention window (positions <= num_computed - window are never
        attended again).  Windowed attention masks by absolute position, so
        the freed pages need no device-side table rewrite — their (possibly
        reused) contents are masked out.  Reference analog:
        ``lmdeploy/pytorch/paging/block_manager/window_block_manager.py``.
        """
        if not self.window_size:
            return
        bs = self.cache_config.block_size
        dead = (seq.num_computed_tokens - self.window_size + 1) // bs
        if dead > seq.num_window_freed:
            self.num_window_freed_blocks += \
                self.block_manager.free_leading(seq, dead)
            seq.num_window_freed = dead

    # -- post-step updates --------------------------------------------------------------
    def on_prefill_done(self, chunk: PrefillChunk, next_token: Optional[int]):
        seq = chunk.seq
        seq.num_computed_tokens += chunk.length
        if chunk.is_last:
            # next_token None = the strategy samples differently (dllm block
            # denoising); the sequence still becomes RUNNING
            if next_token is not None:
                seq.append_token(next_token)
                seq.num_new_tokens += 1
            seq.status = MessageStatus.RUNNING
        if self.block_trie is not None:
            self.block_trie.cache_seq_blocks(seq)
        self._free_out_of_window(seq)

    def on_decode_done(self, seq: SchedulerSequence, next_token: int):
        seq.append_token(next_token)
        seq.num_computed_tokens += 1
        seq.num_new_tokens += 1
        if self.block_trie is not None:
            self.block_trie.cache_seq_blocks(seq)
        self._free_out_of_window(seq)

    def on_decode_tokens(self, seq: SchedulerSequence, token_ids):
        """Bulk on_decode_done for a whole decode run's tokens: one append,
        one prefix-cache pass, one window sweep — the per-token variant
        dominated host time at k=16 x bs=64 (1024 Python iterations/run)."""
        seq.append_tokens(token_ids)
        n = len(token_ids)
        seq.num_computed_tokens += n
        seq.num_new_tokens += n
        if self.block_trie is not None:
            self.block_trie.cache_seq_blocks(seq)
        self._free_out_of_window(seq)
