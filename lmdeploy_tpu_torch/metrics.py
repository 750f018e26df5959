"""Request metrics the engine keeps: the part of ``lmdeploy_tpu/metrics.py`` that
``Engine`` and the API server's ``/metrics`` use (RequestStats TTFT/TPOT/e2e and the
rolling MetricsAggregator with its Prometheus text).  The client-side Profiler comes
with the port's benchmark.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional


@dataclass
class RequestStats:
    """Lifecycle timings for one finished request."""

    arrival_time: float = 0.0
    first_scheduled_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    prompt_tokens: int = 0
    generation_tokens: int = 0
    finish_reason: Optional[str] = None

    @property
    def ttft(self) -> float:
        if self.first_token_time and self.arrival_time:
            return self.first_token_time - self.arrival_time
        return 0.0

    @property
    def e2e_latency(self) -> float:
        if self.finish_time and self.arrival_time:
            return self.finish_time - self.arrival_time
        return 0.0

    @property
    def tpot(self) -> float:
        """Time per output token after the first."""
        n = self.generation_tokens - 1
        if n <= 0 or not (self.finish_time and self.first_token_time):
            return 0.0
        return (self.finish_time - self.first_token_time) / n


def _percentile(values: List[float], p: float) -> float:
    if not values:
        return 0.0
    values = sorted(values)
    idx = min(int(len(values) * p), len(values) - 1)
    return values[idx]


class MetricsAggregator:
    """Engine-wide rolling metrics; rendered by /metrics and logged periodically.

    Reference analog: metrics_processor + stat loggers collapsed into one pull-based
    aggregator (the engine is single-process; no cross-worker queue needed).
    """

    def __init__(self, window: int = 1024):
        self.finished: Deque[RequestStats] = deque(maxlen=window)
        self.num_finished_total = 0
        self.num_aborted_total = 0
        self.prompt_tokens_total = 0
        self.generation_tokens_total = 0
        # /metrics carries the reference's names; its engine advances neither counter
        self.num_preemptions_total = 0
        self.iterations_total = 0
        self.start_time = time.time()

    def on_request_finished(self, stats: RequestStats):
        self.finished.append(stats)
        self.num_finished_total += 1
        self.prompt_tokens_total += stats.prompt_tokens
        self.generation_tokens_total += stats.generation_tokens
        if stats.finish_reason == 'abort':
            self.num_aborted_total += 1

    def snapshot(self) -> Dict[str, float]:
        ttfts = [r.ttft for r in self.finished if r.ttft > 0]
        tpots = [r.tpot for r in self.finished if r.tpot > 0]
        e2es = [r.e2e_latency for r in self.finished if r.e2e_latency > 0]
        return {
            'num_requests_finished': self.num_finished_total,
            'num_requests_aborted': self.num_aborted_total,
            'prompt_tokens_total': self.prompt_tokens_total,
            'generation_tokens_total': self.generation_tokens_total,
            'num_preemptions_total': self.num_preemptions_total,
            'iterations_total': self.iterations_total,
            'ttft_mean_s': sum(ttfts) / len(ttfts) if ttfts else 0.0,
            'ttft_p50_s': _percentile(ttfts, 0.5),
            'ttft_p99_s': _percentile(ttfts, 0.99),
            'tpot_mean_s': sum(tpots) / len(tpots) if tpots else 0.0,
            'tpot_p50_s': _percentile(tpots, 0.5),
            'tpot_p99_s': _percentile(tpots, 0.99),
            'e2e_p50_s': _percentile(e2es, 0.5),
            'uptime_s': time.time() - self.start_time,
        }

    def prometheus_text(self, extra: Optional[Dict[str, float]] = None) -> str:
        """``lmdeploy_<name> <value>`` lines of the snapshot and ``extra``."""
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        return ''.join(f'lmdeploy_{key} {value}\n' for key, value in snap.items())
