"""Cluster proxy/router: node registry + request forwarding.

Port of ``lmdeploy_tpu/serve/proxy.py``: a host module, copied as it is (the PD routes
it drives answer 501 on the port's servers until ``disagg`` is ported).

Reference analog: ``lmdeploy/serve/proxy/proxy.py`` (NodeManager:71 — node registry
with heartbeat expiry, routing strategies RANDOM / MIN_EXPECTED_LATENCY /
MIN_OBSERVED_LATENCY ``:279-318``, node add/remove REST, forwarding with retry
and fault tolerance).  aiohttp implementation.

Endpoints:
  GET  /nodes/status            — list registered nodes
  POST /nodes/add               — {"url": "http://host:port", "models": [...]}
  POST /nodes/remove            — {"url": ...}
  GET  /health
  any  /v1/* , /generate        — forwarded to a node per the routing strategy
"""
from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger('lmdeploy_tpu_torch')

HEARTBEAT_EXPIRY = 60.0
LATENCY_WINDOW = 64


@dataclass
class Node:
    url: str
    models: List[str] = field(default_factory=list)
    role: str = 'hybrid'          # hybrid | prefill | decode (PD disaggregation)
    registered_at: float = field(default_factory=time.time)
    last_alive: float = field(default_factory=time.time)
    inflight: int = 0
    latencies: List[float] = field(default_factory=list)
    failures: int = 0

    def observe(self, latency: float):
        self.latencies.append(latency)
        if len(self.latencies) > LATENCY_WINDOW:
            self.latencies.pop(0)

    @property
    def mean_latency(self) -> float:
        return sum(self.latencies) / len(self.latencies) if self.latencies else 0.0


class NodeManager:

    def __init__(self, strategy: str = 'min_expected_latency',
                 serving_strategy: str = 'hybrid'):
        assert strategy in ('random', 'min_expected_latency', 'min_observed_latency')
        assert serving_strategy in ('hybrid', 'distserve')
        self.strategy = strategy
        self.serving_strategy = serving_strategy
        self.nodes: Dict[str, Node] = {}

    def add(self, url: str, models: Optional[List[str]] = None,
            role: str = 'hybrid'):
        url = url.rstrip('/')
        assert role in ('hybrid', 'prefill', 'decode')
        self.nodes[url] = Node(url=url, models=models or [], role=role)

    def remove(self, url: str):
        self.nodes.pop(url.rstrip('/'), None)

    def heartbeat(self, url: str):
        node = self.nodes.get(url.rstrip('/'))
        if node:
            node.last_alive = time.time()

    def alive_nodes(self) -> List[Node]:
        now = time.time()
        return [n for n in self.nodes.values()
                if now - n.last_alive < HEARTBEAT_EXPIRY]

    def pick(self, exclude: Optional[set] = None,
             role: Optional[str] = None) -> Optional[Node]:
        """Pick a node per the routing strategy.  ``role``: restrict to PD
        role (reference: proxy.py:251 get_node_url(role)).  Only the decode
        role may fall back to hybrid nodes: a hybrid engine releases a
        stopped sequence's KV blocks in its step loop, so routing the
        PREFILL leg to one races the follow-up /distserve/export against
        block reuse (the reference's get_node_url never crosses PD roles
        either); with no prefill node the caller serves the request as a
        plain hybrid forward instead."""
        nodes = self.alive_nodes()
        if exclude:
            nodes = [n for n in nodes if n.url not in exclude]
        if role is not None:
            matched = [n for n in nodes if n.role == role]
            if role == 'prefill':
                nodes = matched
            else:
                nodes = matched or [n for n in nodes if n.role == 'hybrid']
        if not nodes:
            return None
        if self.strategy == 'random':
            return random.choice(nodes)
        if self.strategy == 'min_observed_latency':
            return min(nodes, key=lambda n: (n.mean_latency, n.inflight))
        # min_expected_latency: queue depth x observed latency
        return min(nodes, key=lambda n: (n.inflight + 1) * max(n.mean_latency, 1e-3))


def create_proxy_app(manager: Optional[NodeManager] = None,
                     routing_strategy: str = 'min_expected_latency',
                     serving_strategy: str = 'hybrid'):
    import aiohttp
    from aiohttp import web

    manager = manager or NodeManager(routing_strategy, serving_strategy)

    async def health(request):
        return web.json_response({'status': 'ok',
                                  'nodes': len(manager.alive_nodes())})

    async def nodes_status(request):
        return web.json_response({'nodes': [
            {'url': n.url, 'models': n.models, 'role': n.role,
             'inflight': n.inflight,
             'mean_latency_s': round(n.mean_latency, 4), 'failures': n.failures}
            for n in manager.nodes.values()]})

    async def nodes_add(request):
        data = await request.json()
        manager.add(data['url'], data.get('models'),
                    role=data.get('role', 'hybrid'))
        return web.json_response({'status': 'ok'})

    async def nodes_remove(request):
        data = await request.json()
        manager.remove(data['url'])
        return web.json_response({'status': 'ok'})

    async def heartbeat(request):
        data = await request.json()
        manager.heartbeat(data['url'])
        return web.json_response({'status': 'ok'})

    async def distserve_forward(request, body: bytes):
        """PD-disaggregated serving (reference: proxy.py:654-733 DistServe).

        1. A prefill node runs the prompt for one token and retains its KV
           (POST /distserve/prefill on the engine server).
        2. A decode node pulls that KV over DCN and streams the continuation
           as a plain OpenAI response (POST /distserve/decode), which is
           relayed to the client verbatim — clients keep /v1/* semantics.
        """
        import json as _json
        kind = 'chat' if 'chat' in request.path else 'completion'
        try:
            req_body = _json.loads(body)
        except Exception:  # noqa: BLE001
            return web.json_response(
                {'error': {'message': 'invalid JSON body'}}, status=400)
        p = manager.pick(role='prefill')
        if p is None:
            # no dedicated prefill node: serve as a plain hybrid forward
            # (routing the prefill leg to a hybrid engine would race its
            # step-loop KV release against /distserve/export)
            return await hybrid_forward(request, body)
        timeout = aiohttp.ClientTimeout(total=600)

        async def release_prefill_session(sid):
            """Best-effort KV release on the prefill node after a decode-leg
            failure — a prefill-role engine only frees a session's blocks on
            export-with-release, so errors here would otherwise pin KV
            forever and exhaust the node."""
            try:
                t5 = aiohttp.ClientTimeout(total=15)
                async with aiohttp.ClientSession(timeout=t5) as session:
                    async with session.get(
                            f'{p.url}/distserve/export/{sid}',
                            params={'release': '1'}) as resp:
                        await resp.read()
            except Exception:  # noqa: BLE001
                logger.warning('PD: failed to release prefill session %s on %s',
                               sid, p.url)

        p.inflight += 1
        p_start = time.time()
        try:
            async with aiohttp.ClientSession(timeout=timeout) as session:
                async with session.post(
                        p.url + '/distserve/prefill',
                        json={'kind': kind, 'request': req_body}) as resp:
                    if resp.status != 200:
                        p.failures += 1
                        return web.json_response(
                            {'error': {'message': 'prefill node failed'}},
                            status=502)
                    info = await resp.json()
            p.observe(time.time() - p_start)
        finally:
            p.inflight -= 1
        d = manager.pick(role='decode', exclude={p.url})
        if d is None:
            d = manager.pick(role='decode')
        if d is None:
            await release_prefill_session(info['session_id'])
            return web.json_response(
                {'error': {'message': 'no decode nodes available'}}, status=503)
        d.inflight += 1
        d_start = time.time()
        try:
            async with aiohttp.ClientSession(timeout=timeout) as session:
                async with session.post(
                        d.url + '/distserve/decode',
                        json={'kind': kind, 'request': req_body,
                              'prefill_url': p.url,
                              'remote_session_id': info['session_id'],
                              'prompt_len': info['prompt_len'],
                              'first_token_ids': info['first_token_ids']},
                        ) as resp:
                    if resp.headers.get('Content-Type', '').startswith(
                            'text/event-stream'):
                        out = web.StreamResponse(
                            status=resp.status,
                            headers={'Content-Type': 'text/event-stream'})
                        await out.prepare(request)
                        async for chunk in resp.content.iter_any():
                            await out.write(chunk)
                        await out.write_eof()
                        d.observe(time.time() - d_start)
                        return out
                    payload = await resp.read()
                    d.observe(time.time() - d_start)
                    if resp.status != 200:
                        d.failures += 1
                        await release_prefill_session(info['session_id'])
                    return web.Response(body=payload, status=resp.status,
                                        content_type=resp.content_type)
        except Exception:  # noqa: BLE001
            d.failures += 1
            await release_prefill_session(info['session_id'])
            raise
        finally:
            d.inflight -= 1

    async def forward(request):
        body = await request.read()
        if (manager.serving_strategy == 'distserve'
                and request.path in ('/v1/chat/completions',
                                     '/v1/completions')):
            return await distserve_forward(request, body)
        return await hybrid_forward(request, body)

    async def hybrid_forward(request, body):
        tried = set()
        for _ in range(3):                       # retry on other nodes on failure
            node = manager.pick(exclude=tried)
            if node is None:
                break
            tried.add(node.url)
            node.inflight += 1
            start = time.time()
            try:
                timeout = aiohttp.ClientTimeout(total=600)
                async with aiohttp.ClientSession(timeout=timeout) as session:
                    async with session.request(
                            request.method, node.url + request.path_qs,
                            data=body, headers={'Content-Type':
                                                request.content_type or
                                                'application/json'}) as resp:
                        if resp.headers.get('Content-Type', '').startswith(
                                'text/event-stream'):
                            out = web.StreamResponse(
                                status=resp.status,
                                headers={'Content-Type': 'text/event-stream'})
                            await out.prepare(request)
                            async for chunk in resp.content.iter_any():
                                await out.write(chunk)
                            await out.write_eof()
                            node.observe(time.time() - start)
                            return out
                        payload = await resp.read()
                        node.observe(time.time() - start)
                        return web.Response(body=payload, status=resp.status,
                                            content_type=resp.content_type)
            except Exception:  # noqa: BLE001
                node.failures += 1
                logger.exception('proxy: node %s failed; retrying', node.url)
            finally:
                node.inflight -= 1
        return web.json_response(
            {'error': {'message': 'no healthy nodes available'}}, status=503)

    async def _probe_nodes(app):
        """Pull-based liveness: refresh last_alive via each node's /health.

        (The reference's nodes push heartbeats; pull keeps node servers unaware
        of the proxy and covers externally-registered nodes too.)
        """
        import asyncio as _asyncio

        async def loop():
            while True:
                for node in list(manager.nodes.values()):
                    try:
                        timeout = aiohttp.ClientTimeout(total=5)
                        async with aiohttp.ClientSession(timeout=timeout) as s:
                            async with s.get(node.url + '/health') as resp:
                                if resp.status == 200:
                                    manager.heartbeat(node.url)
                    except Exception:  # noqa: BLE001
                        pass
                await _asyncio.sleep(10)

        app['probe_task'] = _asyncio.get_event_loop().create_task(loop())

    app = web.Application()
    app.on_startup.append(_probe_nodes)
    app.router.add_get('/health', health)
    app.router.add_get('/nodes/status', nodes_status)
    app.router.add_post('/nodes/add', nodes_add)
    app.router.add_post('/nodes/remove', nodes_remove)
    app.router.add_post('/heartbeat', heartbeat)
    app.router.add_route('*', '/v1/{tail:.*}', forward)
    app.router.add_post('/generate', forward)
    app['node_manager'] = manager
    return app


def proxy(server_name: str = '0.0.0.0', server_port: int = 8000,
          routing_strategy: str = 'min_expected_latency',
          serving_strategy: str = 'hybrid'):
    from aiohttp import web
    app = create_proxy_app(routing_strategy=routing_strategy,
                           serving_strategy=serving_strategy)
    web.run_app(app, host=server_name, port=server_port)
