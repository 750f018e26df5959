"""Engine: the continuous-batching loop binding the scheduler and the model agent.

Port of the main-path subset of ``lmdeploy_tpu/engine/engine.py``: ``add_message``,
the asyncio loop (``_async_loop_body``), prefill result handling, k-step decode runs
with the pipelined chain (run N+1 dispatched before run N is drained) and the
prefill / decode overlap (waiting prefills dispatched behind the in-flight run), the
budget-aware drain and recompute preemption, and speculative decoding
(``speculative_config``: ``engine/spec_agent.py``; rows that ask for top logprobs then
decode one host-driven step at a time), a hybrid linear-attention model's state
checkpoints under prefix caching (``engine/ssm_ckpt.py``), guided decoding
(``response_format``: JSON mode, a JSON schema or a regex; ``guided*.py``) with the
reference's speculative grammar acceptance for greedy rows, bad words
(``bad_token_ids``), and LoRA adapters: per-request S-LoRA slots (``adapters`` on the
config, ``adapter_name`` on a request) and the merged single adapter (``load_lora``,
``activate_lora``; ``lora.py``).  ``LMDEPLOY_TPU_OVERLAP=0``, ``LMDEPLOY_TPU_PIPELINE=0``
and ``LMDEPLOY_TPU_GUIDED_SPEC=0`` turn the overlap, the chain and the grammar acceptance
off, as in the reference.  Device steps run on one worker thread so requests keep
arriving while the card computes.  Later slices bring multimodal inputs, diffusion
decoding, host swap and sleep / wakeup (see ROADMAP.md).
"""
from __future__ import annotations

import asyncio
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..config import EngineConfigBundle, check_ported
from ..messages import (EngineOutput, Logprob, RequestMetrics, ResponseType,
                        ScheduleMetrics, TpuEngineConfig)
from ..metrics import MetricsAggregator, RequestStats
from ..ops.sampling import topk_bucket
from ..paging.scheduler import Scheduler
from ..paging.seq import MessageStatus, SamplingParams, SchedulerSequence
from ..parallel.mesh import build_mesh
from .model_agent import ModelAgent, resolve_device

logger = logging.getLogger('lmdeploy_tpu_torch')


@dataclass
class _ActiveRequest:
    seq: SchedulerSequence
    queue: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    finished: bool = False


def _is_simple_sampling(p) -> bool:
    """Greedy with neutral penalties: the decode fast path is exact."""
    return (not p.do_sample and p.repetition_penalty == 1.0
            and p.frequency_penalty == 0.0 and p.presence_penalty == 0.0)


def _host_driven(seq, spec=None, linear_state: bool = False) -> bool:
    """Rows that run the single-step host path instead of the device decode state
    (reference :46-77): rows that need a host-computed mask every step (a guided row's
    grammar state, a bad-words row), and, under speculative decoding, rows that ask for
    top logprobs (the speculative step computes only each token's own).

    Speculative grammar acceptance: a GREEDY guided row with neutral penalties and no
    bad words rides the k-step device runs unmasked; the drain accepts the longest
    prefix the grammar allows, and one masked host step recovers from the first
    rejection (``_guided_recover``).  The masked argmax is the argmax whenever the
    argmax is legal, and the recovery step picks what per-step masking would, so the
    tokens are those of per-step masking.  Not under speculative decoding, not for a
    row whose acceptance EMA fell below 2 tokens a run, not with
    LMDEPLOY_TPU_GUIDED_SPEC=0, and not on a hybrid linear-attention model
    (``linear_state``): a device run advances a row's recurrent state through every
    token of the run, rejected ones included, and nothing rolls it back, so there the
    port takes the reference's per-step path (ROADMAP.md section 3)."""
    if seq.guided is not None:
        if (spec is None and not linear_state
                and _is_simple_sampling(seq.sampling_params)
                and not seq.sampling_params.bad_token_ids
                and not getattr(seq, '_guided_recover', False)
                and getattr(seq, '_guided_ema', 1e9) >= 2.0
                and os.environ.get('LMDEPLOY_TPU_GUIDED_SPEC', '1') != '0'):
            return False
        return True
    if seq.sampling_params.bad_token_ids:
        return True
    return spec is not None and seq.sampling_params.logprobs > 0


def _is_full_vocab_sampling(p) -> bool:
    return bool(p.do_sample and p.top_k <= 0 and p.top_p >= 1.0 and p.min_p <= 0.0)


def _row_top(top, i, seq):
    """One row's (top_vals, top_ids) when the request asked for them."""
    if top is None or seq.sampling_params.logprobs <= 0:
        return None
    vals, ids = top
    n = min(seq.sampling_params.logprobs, vals.shape[-1])
    return vals[i, :n], ids[i, :n]


class Engine:
    """One engine = one model on one device (or one device mesh), continuous batching.

    ``device=None`` serves on the GPU and raises when there is none; pass
    ``device='cpu'`` to run the plain PyTorch paths on the CPU.  ``mesh``
    (``parallel.mesh.build_mesh``) serves context parallelism: without one, a
    ``DistConfig`` of more than one rank builds it (reference :133-138), over
    ``cuda:0 .. cuda:n-1`` (raising with fewer cards) or, with ``device='cpu'``, over
    that many CPU ranks.  Pass ``mesh=build_mesh(cp=2, devices=['cuda:0', 'cuda:0'])``
    to put two ranks on one card.  ``speculative_config`` (``messages.SpeculativeConfig``)
    turns speculative decoding on when it names a draft ``model`` (reference
    :188-200); its proposer is built after the target's cache."""

    def __init__(self, model_path: Optional[str], engine_config: TpuEngineConfig,
                 configs: Optional[EngineConfigBundle] = None, tokenizer=None,
                 device=None, mesh=None, speculative_config=None):
        self.engine_config = engine_config
        self.tokenizer = tokenizer
        if configs is None:
            if model_path is None:
                raise ValueError('Engine needs a model_path or a configs bundle')
            configs = EngineConfigBundle.build(model_path, engine_config)
        else:
            check_ported(engine_config, configs.model)
        self.configs = configs
        dist = configs.dist
        if mesh is None and dist.world_size > 1:
            dev = resolve_device(device)
            mesh = build_mesh(dp=dist.dp, tp=dist.tp, ep=dist.ep, cp=dist.cp,
                              devices=None if dev.type == 'cuda'
                              else [dev] * dist.world_size)
        self.mesh = mesh
        adapters = getattr(engine_config, 'adapters', None)
        if adapters and speculative_config is not None:
            raise NotImplementedError('S-LoRA adapters under speculative decoding: the '
                                      'speculative step reads no adapter ids')
        # S-LoRA: the agent attaches the adapters' slot stacks (reference :143-145)
        self.model_agent = ModelAgent(
            configs, model_path if not configs.misc.empty_init else None,
            device=device, mesh=mesh, adapters=adapters)
        self._lora = None                   # the merged single adapter (load_lora)
        self.scheduler = Scheduler(configs.scheduler, configs.cache,
                                   num_blocks=self.model_agent.num_blocks)
        # a hybrid linear-attention model's prefix caching: KV pages alone cannot
        # rebuild its recurrent state, so trie matches are clamped to block boundaries
        # with a stored state snapshot, restored into the row's slot (reference
        # :169-187; engine/ssm_ckpt.py)
        self._ssm_ckpt = None
        if self.model_agent.has_linear_state and configs.cache.enable_prefix_caching:
            from .ssm_ckpt import SsmCkptStore
            self._ssm_ckpt = SsmCkptStore(capacity=int(
                os.environ.get('LMDEPLOY_TPU_SSM_CKPT_MAX', '64')))
        self.scheduler.ssm_ckpt = self._ssm_ckpt
        self.spec = None
        if speculative_config is not None and self.model_agent.has_linear_state:
            raise NotImplementedError(
                f'speculative decoding over the hybrid linear-attention model '
                f'{configs.model.hf_arch} is not ported yet (its state rollback; '
                f'ROADMAP.md item 14)')
        if speculative_config is not None and (
                speculative_config.model
                or speculative_config.method in ('deepseek_mtp', 'qwen3_5_mtp')):
            from .spec_agent import SpecExtension
            # MTP weights live in the target checkpoint itself
            self.spec = SpecExtension(
                self.model_agent, speculative_config.model or model_path,
                speculative_config.num_speculative_tokens,
                draft_empty_init=configs.misc.empty_init,
                method=speculative_config.method or 'draft_model')
        self.metrics = MetricsAggregator()
        # prefill/decode overlap: dispatch waiting requests' prefill behind an
        # in-flight decode run (LMDEPLOY_TPU_OVERLAP=0 restores k=1 clamping)
        self._overlap = os.environ.get('LMDEPLOY_TPU_OVERLAP', '1') != '0'
        self._overlap_dispatches = 0   # lifetime counter (metrics/tests)
        # pipelined decode runs: dispatch run N+1 before draining run N, so the fetch
        # and the host drain hide under device time (LMDEPLOY_TPU_PIPELINE=0 restores
        # drain-then-dispatch)
        self._pipeline = os.environ.get('LMDEPLOY_TPU_PIPELINE', '1') != '0'
        self._pipelined_runs = 0       # lifetime counter (metrics/tests)
        self._requests: Dict[int, _ActiveRequest] = {}
        self._new_work = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = False
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix='gpu-step')

    @classmethod
    def from_pretrained(cls, model_path: str,
                        engine_config: Optional[TpuEngineConfig] = None,
                        **kwargs) -> 'Engine':
        return cls(model_path, engine_config or TpuEngineConfig(), **kwargs)

    @property
    def model_config(self):
        return self.configs.model

    def create_instance(self):
        from .engine_instance import EngineInstance
        return EngineInstance(self)

    # -- session API (called from the asyncio thread) --------------------------------
    def add_session(self, session_id: int):
        if self.scheduler.seq_manager.get_session(session_id) is None:
            self.scheduler.add_session(session_id)

    def end_session(self, session_id: int):
        session = self.scheduler.seq_manager.get_session(session_id)
        if session is None:
            return
        for seq in list(session.sequences.values()):
            self.model_agent.free_slot(seq)
            req = self._requests.pop(seq.seq_id, None)
            if req is not None and not req.finished:
                self._emit(req, ResponseType.FINISH, finish=True)
        self.scheduler.end_session(session_id)

    async def stop_request(self, seq_id: int):
        req = self._requests.get(seq_id)
        if req is None:
            return
        req.seq.status = MessageStatus.STOPPED
        self._finish_request(req, ResponseType.CANCEL)

    def add_message(self, session_id: int, token_ids: List[int],
                    sampling_params: SamplingParams, mm_data=None) -> asyncio.Queue:
        """Enqueue a generation request; returns the per-request output queue.
        ``sampling_params.response_format`` asks for guided decoding (reference
        :401-441), ``adapter_name`` for an S-LoRA slot (:392-400)."""
        if mm_data:
            raise NotImplementedError('multimodal inputs are not ported yet')
        self.add_session(session_id)
        session = self.scheduler.seq_manager.get_session(session_id)
        max_len = self.configs.scheduler.max_session_len
        if len(token_ids) + 1 > max_len:
            raise ValueError(f'prompt length {len(token_ids)} exceeds session_len '
                             f'{max_len}')
        if session.sequences:            # multi-turn: extend the session's sequence
            seq = next(iter(session.sequences.values()))
            seq.update_prompt(token_ids)
            seq.sampling_params = sampling_params
            seq.status = MessageStatus.WAITING
        else:
            seq = session.add_sequence(token_ids, sampling_params)
        aname = sampling_params.adapter_name
        if aname:
            slot_map = getattr(self.model_agent, 'lora_slot_map', None) or {}
            if aname not in slot_map:
                raise ValueError(f'unknown adapter {aname!r}; loaded: {sorted(slot_map)}')
            seq.adapter_slot = slot_map[aname]
        else:
            seq.adapter_slot = 0
        guide = self._make_guide(sampling_params)
        if guide is not None:
            seq.guided = guide
        queue: asyncio.Queue = asyncio.Queue()
        self._requests[seq.seq_id] = _ActiveRequest(
            seq=seq, queue=queue, loop=asyncio.get_running_loop())
        self._ensure_loop()
        self._new_work.set()
        return queue

    def _make_guide(self, sampling_params):
        """The grammar state of a ``response_format`` (reference :401-441): a regex
        (``regex_schema``, the pattern under 'regex_schema' or 'regex'), a JSON schema
        (``json_schema``, the schema dict under json_schema.schema or schema) or any
        JSON value (``json_object``); None for no format.  EOS is the request's stop
        ids, else the model's."""
        fmt = sampling_params.response_format or {}
        kind = fmt.get('type')
        if kind not in ('regex_schema', 'json_object', 'json_schema'):
            return None
        if self.tokenizer is None:
            raise ValueError('guided decoding requires a tokenizer-backed engine')
        eos = sampling_params.stop_token_ids or self.configs.model.eos_token_id
        vocab = self.configs.model.vocab_size
        if kind == 'regex_schema':
            pattern = fmt.get('regex_schema') or fmt.get('regex')
            if not isinstance(pattern, str) or not pattern:
                raise ValueError("response_format type 'regex_schema' requires a pattern "
                                 "string under 'regex_schema'")
            from ..guided_regex import RegexGuide
            return RegexGuide(self.tokenizer, vocab, eos, pattern)
        if kind == 'json_schema':
            spec = fmt.get('json_schema') or {}
            schema = spec.get('schema') if isinstance(spec, dict) else None
            if schema is None:
                schema = fmt.get('schema')
            if not isinstance(schema, dict):
                raise ValueError("response_format type 'json_schema' requires a schema "
                                 "dict under json_schema.schema")
            from ..guided_schema import SchemaGuide
            return SchemaGuide(self.tokenizer, vocab, eos, schema)
        from ..guided import JsonGuide
        return JsonGuide(self.tokenizer, vocab, eos)

    def _host(self, seq) -> bool:
        return _host_driven(seq, self.spec, self.model_agent.has_linear_state)

    # -- main loop --------------------------------------------------------------------
    def _ensure_loop(self):
        loop = asyncio.get_running_loop()
        if (self._loop_task is None or self._loop_task.done()
                or self._loop_task.get_loop() is not loop):
            old = self._loop_task
            if old is not None and not old.done():
                if old.get_loop().is_running():
                    old.get_loop().call_soon_threadsafe(old.cancel)
                old._log_destroy_pending = False
            self._new_work = asyncio.Event()
            self._loop_task = loop.create_task(self.async_loop())

    async def async_loop(self):
        try:
            await self._async_loop_body()
        except asyncio.CancelledError:
            return
        except Exception as e:  # noqa: BLE001
            # a crash outside the step must still fail every pending request
            logger.exception('engine loop crashed')
            self._fail_all(e)
            raise

    async def _async_loop_body(self):
        loop = asyncio.get_running_loop()
        while not self._stopped:
            if not self.scheduler.has_unfinished():
                self._new_work.clear()
                await self._new_work.wait()
                continue
            # overlap mode flips to decode-priority while rows decode on the device:
            # waiting prefills dispatch BEHIND the run (see _decode_run_fast) instead
            # of collapsing it to k=1; speculative steps dispatch nothing behind them
            prefer_decode = (self._overlap and self.spec is None
                             and any(not self._host(s) for s in self.scheduler.running))
            out = self.scheduler.schedule(prefer_decode=prefer_decode)
            if out.is_empty and self.scheduler.waiting:
                # finished-but-undrained sequences may still pin blocks
                self._cleanup_stopped()
                out = self.scheduler.schedule()
            if out.is_empty:
                # forward progress: nothing runs and nothing fits -> fail the
                # head-of-line request with OOM instead of livelocking
                if not self.scheduler.running and self.scheduler.waiting:
                    seq = self.scheduler.waiting[0]
                    seq.status = MessageStatus.STOPPED
                    req = self._requests.pop(seq.seq_id, None)
                    if req is not None:
                        self._emit(req, ResponseType.OUT_OF_MEMORY, finish=True)
                    self._cleanup_stopped()
                await asyncio.sleep(0.001)
                continue
            try:
                if out.is_prefill:
                    step = await loop.run_in_executor(
                        self._executor, self.model_agent.prefill, out.prefill_chunks)
                    await self._handle_prefill_results(out.prefill_chunks, step, loop)
                else:
                    await self._decode_run(out.decode_seqs, loop)
            except Exception as e:  # noqa: BLE001
                logger.exception('engine step failed')
                self._fail_all(e)
                raise
            self._cleanup_stopped()

    async def _handle_prefill_results(self, chunks, step, loop):
        tokens = await loop.run_in_executor(self._executor, step.tokens_np)
        logprobs = step.logprobs_np()
        top = step.top_np()
        for i, chunk in enumerate(chunks):
            self.scheduler.on_prefill_done(chunk, int(tokens[i]) if chunk.is_last else None)
            if chunk.is_last:
                seq = chunk.seq
                if not seq.metrics.first_token_time:
                    seq.metrics.first_token_time = time.time()
                if seq.guided is not None:
                    seq.guided.accept_token(int(tokens[i]))
                self._post_token(seq, float(logprobs[i]), top_logprobs=_row_top(top, i, seq))
        if self._ssm_ckpt is not None:
            await self._publish_ssm_ckpts(chunks, loop)
        # newly RUNNING sequences enter the device decode state; host-driven rows
        # stay out of it
        new_running = [c.seq for c in chunks
                       if c.is_last and c.seq.status == MessageStatus.RUNNING
                       and not self._host(c.seq)]
        if new_running:
            self.model_agent.insert_decode_rows(new_running)
            for s in new_running:
                s._synced_blocks = len(s.logical_blocks)

    async def _publish_ssm_ckpts(self, chunks, loop):
        """Store the state snapshots of prefill chunks that end on a block boundary
        (the scheduler aligns chunk ends while checkpoints are on,
        ``Scheduler._ssm_align_chunk``; reference :580-595)."""
        bs = self.configs.cache.block_size
        for chunk in chunks:
            seq = chunk.seq
            end = chunk.start + chunk.length
            if (end % bs != 0 or end == 0 or seq.batch_slot < 0
                    or self._ssm_ckpt.has(seq.history_ids, end)):
                continue
            snap = await loop.run_in_executor(
                self._executor, self.model_agent.snapshot_slot_state, seq.batch_slot)
            self._ssm_ckpt.put(seq.history_ids, end, snap)

    async def _decode_run(self, seqs, loop):
        """One decode round: host-driven rows take one host step each; the others a
        speculative step, or k-step device decode runs."""
        host_seqs = [s for s in seqs if self._host(s)]
        seqs = [s for s in seqs if not self._host(s)]
        if seqs:
            if self.spec is not None:
                await self._decode_step_spec(seqs, loop)
            else:
                await self._decode_run_fast(seqs, loop)
        if host_seqs:
            await self._decode_step_host(host_seqs, loop)

    async def _decode_step_spec(self, seqs, loop):
        """One speculative step (reference :985-1021): capacity for K+1 more tokens a
        row (which may preempt), table sync, the step, then each row's emitted tokens
        one at a time until the row stops."""
        agent = self.model_agent
        k1 = self.spec.k + 1
        survivors = []
        for seq in seqs:
            if seq.status != MessageStatus.RUNNING:
                continue
            if self.scheduler.extend_decode_capacity(seq, k1, exclude=survivors):
                survivors.append(seq)
        inactive = [s.batch_slot for s in self.scheduler.seq_manager.all_sequences()
                    if s.batch_slot >= 0 and s.status != MessageStatus.RUNNING]
        if inactive:
            agent.deactivate_rows(inactive)
        if not survivors:
            return
        self._sync_tables(survivors)
        num_rows = max(s.batch_slot for s in survivors) + 1
        out_toks, n_emitted, out_lps = await loop.run_in_executor(
            self._executor, self.spec.spec_decode, num_rows)
        for seq in survivors:
            slot = seq.batch_slot
            for j in range(int(n_emitted[slot])):
                if seq.status != MessageStatus.RUNNING:
                    break
                self.scheduler.on_decode_done(seq, int(out_toks[slot, j]))
                self._post_token(seq, float(out_lps[slot, j]))
        stopped = [s.batch_slot for s in survivors
                   if s.status == MessageStatus.STOPPED and s.batch_slot >= 0]
        if stopped:
            agent.deactivate_rows(stopped)

    async def _decode_step_host(self, seqs, loop):
        """One host-driven decode step, each row's logits masked by its banned ids or
        its grammar state (reference :1025-1052).  A guided row that this step recovered
        from a rejection rejoins the device decode runs: its flag is cleared and its
        row re-inserted, which writes its stale device row (token, position, table,
        sampling parameters, adapter) in place, where the captured runs read it."""
        seqs = [s for s in seqs if s.status == MessageStatus.RUNNING]
        if not seqs:
            return
        step = await loop.run_in_executor(self._executor, self.model_agent.decode, seqs)
        tokens = await loop.run_in_executor(self._executor, step.tokens_np)
        logprobs = step.logprobs_np()
        top = step.top_np()
        for i, seq in enumerate(seqs):
            tok = int(tokens[i])
            self.scheduler.on_decode_done(seq, tok)
            if seq.guided is not None:
                seq.guided.accept_token(tok)
            self._post_token(seq, float(logprobs[i]), top_logprobs=_row_top(top, i, seq))
        recovered = [s for s in seqs if getattr(s, '_guided_recover', False)]
        for s in recovered:
            s._guided_recover = False
        back = [s for s in recovered
                if s.status == MessageStatus.RUNNING and not self._host(s)]
        if back:
            self.model_agent.insert_decode_rows(back)
            for s in back:
                s._synced_blocks = len(s.logical_blocks)

    async def _decode_run_fast(self, seqs, loop):
        """k-step device decode runs: reserve capacity for k more tokens a row, push
        changed table rows, dispatch the run, then dispatch a waiting prefill behind
        it (overlap) or chain further runs while each can run without preemption
        (pipeline), draining each run after the next is dispatched."""
        agent = self.model_agent
        k = agent.decode_run_steps
        # with overlap on, waiting requests do not shorten the run: their prefill
        # dispatches behind it instead
        if self.scheduler.has_waiting() and not self._overlap:
            k = 1                       # new arrivals wait at most one step (TTFT)
        # size the run by the LONGEST remaining budget, rounded up to a power of
        # two; rows that finish early stop there and the drain discards overrun
        remaining = max(s.sampling_params.max_new_tokens - s.num_output_tokens
                        for s in seqs)
        if remaining < k:
            k = 1
            while k < remaining:
                k *= 2
        while k & (k - 1):
            k &= k - 1
        # capacity for k tokens per row (may preempt; preempted seqs leave the run)
        survivors = []
        for seq in seqs:
            if seq.status != MessageStatus.RUNNING:
                continue
            if self.scheduler.extend_decode_capacity(seq, k, exclude=survivors):
                survivors.append(seq)
        inactive = [s.batch_slot for s in self.scheduler.seq_manager.all_sequences()
                    if s.batch_slot >= 0 and s.status != MessageStatus.RUNNING]
        if inactive:
            agent.deactivate_rows(inactive)
        if not survivors:
            return
        self._sync_tables(survivors)
        num_rows = max(s.batch_slot for s in survivors) + 1
        simple = all(_is_simple_sampling(s.sampling_params) for s in survivors)
        top_lp = 32 if any(s.sampling_params.logprobs > 0 for s in survivors) else 0
        kmax = topk_bucket(max(s.sampling_params.top_k for s in survivors),
                           self.configs.model.vocab_size)
        fv = any(_is_full_vocab_sampling(s.sampling_params) for s in survivors)
        run_args = (num_rows, k, simple, top_lp, kmax, fv)
        step = await loop.run_in_executor(self._executor, agent.decode_run, *run_args)
        # prefill/decode overlap: the run is queued on the card; compose and queue a
        # prefill for WAITING requests now, behind it on the agent's stream.  The
        # overlap pass never preempts
        overlap = None
        if self._overlap and self.scheduler.has_waiting():
            pout = self.scheduler.schedule_overlap_prefill()
            if pout.prefill_chunks:
                pstep = await loop.run_in_executor(self._executor, agent.prefill,
                                                   pout.prefill_chunks)
                overlap = (pout.prefill_chunks, pstep)
                self._overlap_dispatches += 1
        # pipelined runs: dispatch run N+1 before draining run N.  Stops found in run
        # N's drain end the chain; run N+1's tokens for stopped rows are discarded by
        # the budget-aware drain.  The chain never preempts and breaks for arrivals
        while (self._pipeline and overlap is None
               and not self.scheduler.has_waiting()
               and self._can_pipeline_next(survivors, k)):
            next_step = await loop.run_in_executor(self._executor, agent.decode_run,
                                                   *run_args)
            self._pipelined_runs += 1
            stopped = await self._drain_run(step, survivors, loop)
            step = next_step
            if stopped:
                break
            # after a grammar rejection that row's chained tokens are garbage (the
            # drain discards them): break, so that its recovery step runs now
            if any(getattr(s, '_guided_recover', False) for s in survivors):
                break
        stopped = await self._drain_run(step, survivors, loop)
        # rows awaiting a guided recovery leave the device runs until the masked host
        # step re-inserts them (their device rows are stale past the rejection)
        recover = [s.batch_slot for s in survivors
                   if getattr(s, '_guided_recover', False) and s.batch_slot >= 0
                   and s.status == MessageStatus.RUNNING]
        if stopped or recover:
            agent.deactivate_rows(stopped + recover)
        if overlap is not None:
            await self._handle_prefill_results(*overlap, loop)

    def _sync_tables(self, seqs):
        """Push the table rows of the seqs whose block lists changed since."""
        changed = [s for s in seqs
                   if getattr(s, '_synced_blocks', -1) != len(s.logical_blocks)]
        if changed:
            self.model_agent.update_tables(changed)
            for s in changed:
                s._synced_blocks = len(s.logical_blocks)

    def _can_pipeline_next(self, survivors, k: int) -> bool:
        """True when one more k-step run can dispatch before draining: every row
        still RUNNING with room in its session for the in-flight run's k tokens and
        k more, some row with more than k tokens of budget left, and blocks for k
        more tokens per row allocatable without preemption (the in-flight run writes
        to the current block set).  The new table rows queue behind the in-flight
        run on the agent's stream."""
        max_len = self.configs.scheduler.max_session_len
        any_needs = False
        for s in survivors:
            if s.status != MessageStatus.RUNNING:
                return False
            # a row past its budget does not block the chain: the drain discards its
            # overrun tokens; KV capacity must hold for every row
            if s.sampling_params.max_new_tokens - s.num_output_tokens > k:
                any_needs = True
            if s.num_token_ids + 2 * k > max_len:
                return False
        if not any_needs:
            return False          # everyone finishes within the in-flight run
        bm = self.scheduler.block_manager
        for s in survivors:
            if not bm.allocate_for_seq(s, num_new_tokens=2 * k):
                return False
        self._sync_tables(survivors)
        return True

    async def _drain_run(self, step, survivors, loop):
        """Fetch one decode run's tokens and drain them into the requests.  Returns
        the batch slots of rows that stopped during this drain."""
        tokens = await loop.run_in_executor(self._executor, step.tokens_np)
        logprobs = step.logprobs_np()
        tops = step.top_np()                # ([k, B, n], [k, B, n]) or None
        for seq in survivors:
            if seq.status != MessageStatus.RUNNING:
                continue
            slot = seq.batch_slot
            seq_tops = None if tops is None else (tops[0][:, slot], tops[1][:, slot])
            self._drain_decode_tokens(seq, tokens[:, slot], logprobs[:, slot], seq_tops)
        return [s.batch_slot for s in survivors
                if s.status == MessageStatus.STOPPED and s.batch_slot >= 0]

    # -- token post-processing --------------------------------------------------------
    def _drain_decode_tokens(self, seq: SchedulerSequence, toks, lps, tops=None):
        """Post one decode run's [k] tokens for one seq: vectorised stop scan, one
        bulk append, at most one response chunk.  A guided row keeps the longest
        prefix its grammar accepts (an EOS only where ``allowed_mask`` permits it); a
        rejection flags it for one masked host step, ``_guided_recover``, and its
        acceptance EMA is ``0.5 * prev + 0.5 * accepted`` (reference :1072-1100).  A row
        already flagged drops the whole run (a pipelined run chained past its
        rejection) without touching its grammar state."""
        p = seq.sampling_params
        req = self._requests.get(seq.seq_id)
        n_out = len(seq.output_ids)
        guide = seq.guided
        if guide is not None and getattr(seq, '_guided_recover', False):
            return
        if guide is not None:
            eos_ids = set(getattr(guide, 'eos_token_ids', ()) or ())
            n_ok = 0
            for t in toks:
                ti = int(t)
                if ti in eos_ids:
                    ok = bool(guide.allowed_mask()[ti]) and guide.accept_token(ti)
                else:
                    ok = guide.accept_token(ti)
                if not ok:
                    seq._guided_recover = True
                    break
                n_ok += 1
            seq._guided_ema = (0.5 * getattr(seq, '_guided_ema', float(len(toks)))
                               + 0.5 * n_ok)
            if n_ok < len(toks):
                toks, lps = toks[:n_ok], lps[:n_ok]
                if tops is not None:
                    tops = (tops[0][:n_ok], tops[1][:n_ok])
        max_len = self.configs.scheduler.max_session_len
        take = max(int(min(len(toks), p.max_new_tokens - n_out,
                           max_len - seq.num_token_ids)), 0)
        finish_reason = None
        if take and p.stop_token_ids:
            stop_mask = np.isin(toks[:take], list(p.stop_token_ids))
            stop_mask[:max(max(p.min_new_tokens, 1) - n_out - 1, 0)] = False
            hits = np.nonzero(stop_mask)[0]
            if hits.size:
                take = int(hits[0]) + 1
                finish_reason = 'stop'
        if finish_reason is None and (n_out + take >= p.max_new_tokens
                                      or seq.num_token_ids + take >= max_len):
            finish_reason = 'length'
        if take > 0:
            if p.logprobs >= 0:
                if not hasattr(seq, 'logprob_list'):
                    seq.logprob_list = []
                n_top = 0 if tops is None else min(p.logprobs, tops[0].shape[-1])
                for j in range(take):
                    entry = {int(toks[j]): Logprob(logprob=float(lps[j]), rank=0)}
                    for r in range(n_top):
                        tid = int(tops[1][j, r])
                        if tid not in entry:
                            entry[tid] = Logprob(logprob=float(tops[0][j, r]), rank=r + 1)
                    seq.logprob_list.append(entry)
            self.scheduler.on_decode_tokens(seq, toks[:take])
        if finish_reason is not None:
            seq.status = MessageStatus.STOPPED
            if req is not None:
                self._finish_request(req, ResponseType.FINISH, finish_reason)
        elif req is not None and take > 0:
            self._emit(req, ResponseType.SUCCESS)

    def _post_token(self, seq: SchedulerSequence, logprob: float, top_logprobs=None):
        req = self._requests.get(seq.seq_id)
        p = seq.sampling_params
        last_token = seq.output_ids[-1]
        if p.logprobs >= 0:
            entry = {last_token: Logprob(logprob=logprob, rank=0)}
            if top_logprobs is not None:
                vals, ids = top_logprobs
                for r in range(len(ids)):
                    if int(ids[r]) not in entry:
                        entry[int(ids[r])] = Logprob(logprob=float(vals[r]), rank=r + 1)
            if not hasattr(seq, 'logprob_list'):
                seq.logprob_list = []
            seq.logprob_list.append(entry)
        finish_reason = None
        if last_token in p.stop_token_ids and \
                len(seq.output_ids) >= max(p.min_new_tokens, 1):
            finish_reason = 'stop'
        elif len(seq.output_ids) >= p.max_new_tokens:
            finish_reason = 'length'
        elif seq.num_token_ids >= self.configs.scheduler.max_session_len:
            finish_reason = 'length'
        if finish_reason is not None:
            seq.status = MessageStatus.STOPPED
            if req is not None:
                self._finish_request(req, ResponseType.FINISH, finish_reason)
        elif req is not None:
            self._emit(req, ResponseType.SUCCESS)

    def _emit(self, req: _ActiveRequest, status: ResponseType, finish: bool = False,
              strip_stop: bool = False):
        seq = req.seq
        ids = seq.output_ids
        if strip_stop and ids and ids[-1] in seq.sampling_params.stop_token_ids:
            ids = ids[:-1]
        lps = None
        if seq.sampling_params.logprobs >= 0:
            lps = list(getattr(seq, 'logprob_list', ()))[:len(ids)]
        out = EngineOutput(status=status, token_ids=list(ids), num_token=len(ids),
                           logprobs=lps,
                           req_metrics=RequestMetrics(
                               arrival_time=seq.metrics.arrival_time,
                               first_scheduled_time=seq.metrics.first_scheduled_time,
                               first_token_time=seq.metrics.first_token_time,
                               finish_time=time.time() if finish else 0.0))
        req.loop.call_soon_threadsafe(req.queue.put_nowait, out)
        if finish:
            req.finished = True

    def _finish_request(self, req: _ActiveRequest, status: ResponseType,
                        finish_reason: str = 'stop'):
        seq = req.seq
        seq.metrics.finish_time = time.time()
        strip = finish_reason == 'stop' and not seq.sampling_params.ignore_eos
        self._emit(req, status, finish=True, strip_stop=strip)
        self._requests.pop(seq.seq_id, None)
        self.metrics.on_request_finished(RequestStats(
            arrival_time=seq.metrics.arrival_time,
            first_scheduled_time=seq.metrics.first_scheduled_time,
            first_token_time=seq.metrics.first_token_time,
            finish_time=seq.metrics.finish_time,
            prompt_tokens=seq.num_prompt_tokens,
            generation_tokens=len(seq.output_ids),
            finish_reason=finish_reason))

    def _cleanup_stopped(self):
        for seq in self.scheduler.seq_manager.seqs_with_status(MessageStatus.STOPPED):
            self.model_agent.free_slot(seq)
        self.scheduler.release_stopped()

    def _fail_all(self, err: Exception):
        for req in list(self._requests.values()):
            out = EngineOutput(status=ResponseType.INTERNAL_ENGINE_ERROR,
                               token_ids=list(req.seq.output_ids),
                               num_token=len(req.seq.output_ids))
            req.loop.call_soon_threadsafe(req.queue.put_nowait, out)
            req.finished = True
        self._requests.clear()

    # -- LoRA adapters, merged (reference :1269-1281; lora.py LoraManager) --------------
    def load_lora(self, name: str, adapter):
        """Load an adapter for merging: a PEFT directory, or its parsed
        ``(weights, scaling)`` (``lora.load_peft_adapter``'s result)."""
        if self._lora is None:
            from ..lora import LoraManager
            self._lora = LoraManager(self.model_agent)
        self._lora.load(name, adapter)

    def activate_lora(self, name: str):
        """Merge ``name`` into the served weights, in place (the captured decode runs
        read the merged values); the active one is unmerged first."""
        assert not self.scheduler.has_unfinished(), 'adapter swap requires a drained engine'
        self._lora.activate(name)

    def deactivate_lora(self):
        if self._lora is not None:
            self._lora.deactivate()

    # -- introspection (reference :1320-1325) -----------------------------------------
    def make_schedule_metrics(self) -> ScheduleMetrics:
        return self.scheduler.make_metrics()

    def is_alive(self) -> bool:
        return (self._loop_task is not None and not self._loop_task.done()
                or not self._stopped)

    # -- lifecycle --------------------------------------------------------------------
    def close(self):
        self._stopped = True
        try:
            self._new_work.set()
        except RuntimeError:
            pass                        # host event loop already torn down
        task = self._loop_task
        if task is not None and not task.done():
            if task.get_loop().is_running():
                task.get_loop().call_soon_threadsafe(task.cancel)
            task._log_destroy_pending = False
        self._loop_task = None
        self._executor.shutdown(wait=False)
