"""Multi-server launcher: N data-parallel API servers behind a built-in proxy.

Port of ``lmdeploy_tpu/serve/launch_server.py`` (reference analog:
``lmdeploy/serve/openai/launch_server.py:104``): one ``python -m lmdeploy_tpu_torch
serve api_server`` subprocess per rank, each on its own card (``CUDA_VISIBLE_DEVICES``
= its rank when there are several), and the proxy (``proxy.py``) in this process,
balancing over them with the configured routing strategy.  Multi-node launches
(``nnodes`` > 1) are not ported yet (ROADMAP item 16).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import List, Optional


def launch_server(model_path: str, num_ranks: int = 1, base_port: int = 23334,
                  proxy_port: int = 8000,
                  routing_strategy: str = 'min_expected_latency',
                  extra_args: Optional[List[str]] = None,
                  wait: bool = True,
                  nnodes: int = 1, node_rank: int = 0,
                  coordinator: Optional[str] = None,
                  proxy_url: Optional[str] = None):
    """Spawn ``num_ranks`` API servers + a proxy; returns (procs, manager)."""
    if nnodes > 1 or node_rank > 0:
        raise NotImplementedError('multi-node launches are not ported yet '
                                  '(ROADMAP item 16)')
    procs: List[subprocess.Popen] = []
    for rank in range(num_ranks):
        port = base_port + rank
        cmd = [sys.executable, '-m', 'lmdeploy_tpu_torch', 'serve', 'api_server',
               model_path, '--server-port', str(port),
               '--server-name', '127.0.0.1'] + list(extra_args or [])
        env = dict(os.environ, LMDEPLOY_TPU_DP_RANK=str(rank))
        if num_ranks > 1:
            env['CUDA_VISIBLE_DEVICES'] = str(rank)
        procs.append(subprocess.Popen(cmd, env=env))

    from .proxy import NodeManager, create_proxy_app
    manager = NodeManager(routing_strategy)
    for rank in range(num_ranks):
        manager.add(f'http://127.0.0.1:{base_port + rank}', [model_path])

    def _shutdown(*_):
        for p in procs:
            p.terminate()
        raise SystemExit(0)

    if wait:
        from aiohttp import web
        signal.signal(signal.SIGTERM, _shutdown)
        try:
            web.run_app(create_proxy_app(manager), host='0.0.0.0',
                        port=proxy_port)
        finally:
            for p in procs:
                p.terminate()
    return procs, manager
