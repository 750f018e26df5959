"""Compiled decode runs: one CUDA graph per decode-run key (and per speculative step).

Port of the reference's jitted decode runs (``lmdeploy_tpu/engine/model_agent.py``
``_get_run_fn``, ``decode_run``, ``warmup``), which are its form of the CUDA-graph
bucketing of lmdeploy's ``backends/cuda/graph_runner.py``.  A key is the reference's
``(k, B, simple, top_lp, kmax, full_vocab)``; each key owns static output buffers
(``DecodeRun``), and on the card a graph that replays the agent's k-step decode body
over the persistent decode state, KV cache and parameters.

A key's graph is captured at its first use, or ahead of time by ``ModelAgent.warmup``:
first one eager step of the body over a scratch state whose rows are all inactive (it
builds the kernels, runs their first-launch setup, creates the cached device tables and
the split-K counters on the agent's stream, and warms the allocator at the run's
shapes, while the real state is left as it was; every step of a run has the same
shapes), then the capture, on the agent's stream and into one memory pool shared by
every graph.  A graph reads only persistent
state and writes only its own outputs, so graphs may replay in any order.  Any failure
of a capture or a replay raises.

Each counted kernel wrapper (``.launches``, ``.combines``) is called by the warm pass
and the capture but launches nothing that a decode run executes: the runner puts those
counts back as they were and keeps the capture's counts with the graph
(``DecodeRun.launches``), so a run's launches are the wrappers' counts plus, for each
graph, its launches times its replays (``launch_totals``).

A speculative step (``engine/spec_agent.py``) is a run of the same kind, keyed
``('spec', method, B)``: a ``SpecRun`` whose body is the step; it is captured, counted
and cleared with the decode runs.

On the CPU there is no capture: the agent calls the same body over the same buffers.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import torch

RunKey = Tuple[int, int, bool, int, int, bool]   # (k, B, simple, top_lp, kmax, full_vocab)


def counted_kernels() -> Dict[str, Callable]:
    """The kernel wrappers that count their launches (``.launches``), by name."""
    from ..ops import flash_prefill, paged_decode, quant_bmm, quant_matmul
    return {name: fn for mod in (flash_prefill, paged_decode, quant_bmm, quant_matmul)
            for name, fn in vars(mod).items()
            if callable(fn) and hasattr(fn, 'launches')}


def _counts(fns) -> Dict[str, Tuple[int, int]]:
    return {n: (fn.launches, getattr(fn, 'combines', 0)) for n, fn in fns.items()}


class GraphRun:
    """One key's run: its static outputs (a subclass's), the body that computes it
    (``body(run, scratch)``; None: the graphs' default body) and, once captured, its
    graph with the launches one replay makes."""

    def __init__(self, key, body: Optional[Callable] = None):
        self.key = key
        self.body = body
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}    # kernel launches one replay makes
        self.combines: Dict[str, int] = {}
        self.replays = 0
        self.eager_runs = 0
        self.capture_s = 0.0


class DecodeRun(GraphRun):
    """A decode run's static outputs: tokens [k, B] i32, logprobs [k, B] f32, top
    logprobs ([k, B, top_lp] f32, i32) or None."""

    def __init__(self, key: RunKey, device: torch.device):
        k, B, _simple, top_lp = key[:4]
        super().__init__(key)
        self.tokens = torch.zeros((k, B), dtype=torch.int32, device=device)
        self.logprobs = torch.zeros((k, B), dtype=torch.float32, device=device)
        self.top = None if top_lp <= 0 else (
            torch.zeros((k, B, top_lp), dtype=torch.float32, device=device),
            torch.zeros((k, B, top_lp), dtype=torch.int32, device=device))


class DecodeGraphs:
    """The agent's decode runs (and speculative steps, ``engine/spec_agent.py``) by key.
    ``body(run, scratch)`` runs one decode key's k steps and writes its outputs (over
    the real state, or a scratch state of inactive rows); a run that carries a body of
    its own runs that one.  ``eager_reason(key)`` says why a key may not be captured
    (None: it may).  With ``capture`` False (the CPU, or ``eager_mode``) every run calls
    its body."""

    def __init__(self, body: Callable, device: torch.device, capture: bool,
                 eager_reason: Callable[[tuple], Optional[str]]):
        self.body = body
        self.device = device
        self.capture = capture
        self.eager_reason = eager_reason
        self.runs: Dict[RunKey, DecodeRun] = {}
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.pool_bytes = 0             # device memory reserved while capturing
        self.capturing = False          # inside a warm pass or a capture

    def prepare(self, key, make: Optional[Callable] = None) -> GraphRun:
        """The key's run, made at its first use (a ``DecodeRun``, or ``make(key)``)
        and captured then where it will be (also ``ModelAgent.warmup``)."""
        run = self.runs.get(key)
        if run is None:
            run = self.runs[key] = make(key) if make else DecodeRun(key, self.device)
        if run.graph is None and self.capture and self.eager_reason(key) is None:
            self._capture(run)
        return run

    def run(self, key, make: Optional[Callable] = None) -> GraphRun:
        """One run of ``key`` on the current stream: a replay of its graph, captured
        first if this is its first use, or the body itself."""
        run = self.prepare(key, make)
        if run.graph is not None:
            run.graph.replay()
            run.replays += 1
        else:
            self._body(run)(run, scratch=False)
            run.eager_runs += 1
        return run

    def _body(self, run: GraphRun) -> Callable:
        return run.body or self.body

    def _capture(self, run: GraphRun):
        fns = counted_kernels()
        before = _counts(fns)
        body = self._body(run)
        t0 = time.perf_counter()
        self.capturing = True
        try:
            body(run, scratch=True)                   # the warm pass
            mid = _counts(fns)
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # a collection during the capture, on any thread, could free a dead graph's
            # pool (a cudaFree, which the capture may not see): hold the collector off;
            # only this thread's calls are checked, since the engine's event-loop thread
            # may free pinned host buffers meanwhile
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(pool=self.pool, capture_error_mode='thread_local')
                try:
                    body(run, scratch=False)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
            after = _counts(fns)
        finally:
            self.capturing = False
            for n, fn in fns.items():
                fn.launches = before[n][0]
                if hasattr(fn, 'combines'):
                    fn.combines = before[n][1]
        run.launches = {n: after[n][0] - mid[n][0] for n in fns
                        if after[n][0] > mid[n][0]}
        run.combines = {n: after[n][1] - mid[n][1] for n in fns
                        if after[n][1] > mid[n][1]}
        run.graph = graph
        run.capture_s = time.perf_counter() - t0

    def clear(self):
        """Drop every graph, the speculative steps' too (the state's tables were
        rebound)."""
        self.runs.clear()

    def reset_counts(self):
        for run in self.runs.values():
            run.replays = 0
            run.eager_runs = 0

    def launch_totals(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Every counted kernel's launches and combines since the counts were last
        set to 0: the wrappers' own counts plus each graph's times its replays."""
        fns = counted_kernels()
        launches = {n: fn.launches for n, fn in fns.items()}
        combines = {n: fn.combines for n, fn in fns.items() if hasattr(fn, 'combines')}
        for run in self.runs.values():
            for n, c in run.launches.items():
                launches[n] += c * run.replays
            for n, c in run.combines.items():
                combines[n] += c * run.replays
        return launches, combines

    def stats(self) -> dict:
        runs = self.runs.values()
        return {'graphs': sum(r.graph is not None for r in runs),
                'capture_s': sum(r.capture_s for r in runs),
                'replays': sum(r.replays for r in runs),
                'eager_runs': sum(r.eager_runs for r in runs),
                'pool_bytes': self.pool_bytes}
