"""Engine: the continuous-batching loop binding the scheduler and the model agent.

Port of the main-path subset of ``lmdeploy_tpu/engine/engine.py``: ``add_message``,
the asyncio loop (``_async_loop_body``), prefill result handling, a synchronous
decode run (dispatch k steps, then drain), the budget-aware drain and recompute
preemption.  Device steps run on one worker thread so requests keep arriving while
the card computes.  Later slices bring the decode-run pipelining chain, prefill /
decode overlap, speculative / diffusion / guided / host-driven decoding, host swap,
S-LoRA and sleep / wakeup (see ROADMAP.md).
"""
from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..config import EngineConfigBundle, check_ported
from ..messages import (EngineOutput, Logprob, RequestMetrics, ResponseType,
                        TpuEngineConfig)
from ..metrics import MetricsAggregator, RequestStats
from ..ops.sampling import topk_bucket
from ..paging.scheduler import Scheduler
from ..paging.seq import MessageStatus, SamplingParams, SchedulerSequence
from .model_agent import ModelAgent

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
    """One engine = one model on one device, continuous batching.

    ``device=None`` serves on the GPU and raises when there is none; pass
    ``device='cpu'`` to run the plain PyTorch paths on the CPU."""

    def __init__(self, model_path: Optional[str], engine_config: TpuEngineConfig,
                 configs: Optional[EngineConfigBundle] = None, tokenizer=None,
                 device=None):
        self.engine_config = engine_config
        self.tokenizer = tokenizer
        if configs is None:
            if model_path is None:
                raise ValueError('Engine needs a model_path or a configs bundle')
            configs = EngineConfigBundle.build(model_path, engine_config)
        else:
            check_ported(engine_config)
        self.configs = configs
        self.model_agent = ModelAgent(
            configs, model_path if not configs.misc.empty_init else None, device=device)
        self.scheduler = Scheduler(configs.scheduler, configs.cache,
                                   num_blocks=self.model_agent.num_blocks)
        self.metrics = MetricsAggregator()
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
        """Enqueue a generation request; returns the per-request output queue."""
        if mm_data:
            raise NotImplementedError('multimodal inputs are not ported yet')
        if sampling_params.response_format or sampling_params.bad_token_ids:
            raise NotImplementedError('guided decoding and bad words are not ported yet')
        if sampling_params.adapter_name:
            raise NotImplementedError('LoRA adapters are not ported yet')
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
        queue: asyncio.Queue = asyncio.Queue()
        self._requests[seq.seq_id] = _ActiveRequest(
            seq=seq, queue=queue, loop=asyncio.get_running_loop())
        self._ensure_loop()
        self._new_work.set()
        return queue

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
            out = self.scheduler.schedule()
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
                    await self._decode_run_fast(out.decode_seqs, loop)
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
                self._post_token(seq, float(logprobs[i]), top_logprobs=_row_top(top, i, seq))
        # newly RUNNING sequences enter the device decode state
        new_running = [c.seq for c in chunks
                       if c.is_last and c.seq.status == MessageStatus.RUNNING]
        if new_running:
            self.model_agent.insert_decode_rows(new_running)
            for s in new_running:
                s._synced_blocks = len(s.logical_blocks)

    async def _decode_run_fast(self, seqs, loop):
        """One k-step device decode run, then drain its [k, B] tokens."""
        agent = self.model_agent
        k = agent.decode_run_steps
        if self.scheduler.has_waiting():
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
        changed = [s for s in survivors
                   if getattr(s, '_synced_blocks', -1) != len(s.logical_blocks)]
        if changed:
            agent.update_tables(changed)
            for s in changed:
                s._synced_blocks = len(s.logical_blocks)
        num_rows = max(s.batch_slot for s in survivors) + 1
        simple = all(_is_simple_sampling(s.sampling_params) for s in survivors)
        top_lp = 32 if any(s.sampling_params.logprobs > 0 for s in survivors) else 0
        kmax = topk_bucket(max(s.sampling_params.top_k for s in survivors),
                           self.configs.model.vocab_size)
        fv = any(_is_full_vocab_sampling(s.sampling_params) for s in survivors)
        step = await loop.run_in_executor(self._executor, agent.decode_run, num_rows, k,
                                          simple, top_lp, kmax, fv)
        tokens = await loop.run_in_executor(self._executor, step.tokens_np)
        logprobs = step.logprobs_np()
        tops = step.top_np()                # ([k, B, n], [k, B, n]) or None
        for seq in survivors:
            if seq.status != MessageStatus.RUNNING:
                continue
            slot = seq.batch_slot
            seq_tops = None if tops is None else (tops[0][:, slot], tops[1][:, slot])
            self._drain_decode_tokens(seq, tokens[:, slot], logprobs[:, slot], seq_tops)
        stopped = [s.batch_slot for s in survivors
                   if s.status == MessageStatus.STOPPED and s.batch_slot >= 0]
        if stopped:
            agent.deactivate_rows(stopped)

    # -- token post-processing --------------------------------------------------------
    def _drain_decode_tokens(self, seq: SchedulerSequence, toks, lps, tops=None):
        """Post one decode run's [k] tokens for one seq: vectorised stop scan, one
        bulk append, at most one response chunk."""
        p = seq.sampling_params
        req = self._requests.get(seq.seq_id)
        n_out = len(seq.output_ids)
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
