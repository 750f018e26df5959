"""Engine health monitoring.

Port of ``lmdeploy_tpu/serve/health.py``: a host module, copied as it is.

Reference analog: ``lmdeploy/serve/core/health.py`` (EngineHealthMonitor:36 — probes
that the scheduler keeps making progress while work is pending) and the ``/health``
liveness check (``endpoints/management.py:24``).
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

logger = logging.getLogger('lmdeploy_tpu_torch')


class EngineHealthMonitor:
    """Watches scheduler step progress; marks the engine unhealthy on stall.

    A stall means: there are unfinished sequences but the step counter has not
    advanced within ``timeout`` seconds (hung device call, dead loop task).
    """

    def __init__(self, engine, timeout: float = 120.0, interval: float = 5.0):
        self.engine = engine
        self.timeout = timeout
        self.interval = interval
        self._last_step = -1
        self._last_progress_time = time.time()
        self._healthy = True
        self._task: Optional[asyncio.Task] = None

    @property
    def healthy(self) -> bool:
        return self._healthy and self.engine.is_alive()

    def start(self):
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self):
        if self._task is not None:
            self._task.cancel()

    def _probe(self) -> bool:
        sched = self.engine.scheduler
        step = sched._step_count
        busy = sched.has_unfinished()
        now = time.time()
        if step != self._last_step or not busy:
            self._last_step = step
            self._last_progress_time = now
            return True
        return (now - self._last_progress_time) < self.timeout

    async def _run(self):
        while True:
            await asyncio.sleep(self.interval)
            ok = self._probe()
            if not ok and self._healthy:
                self._healthy = False
                logger.error('engine health: scheduler stalled for %.0fs with '
                             'pending work', self.timeout)
            elif ok and not self._healthy:
                self._healthy = True
                logger.warning('engine health: recovered')
