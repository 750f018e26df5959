"""The port's OpenAI / Anthropic API server against the JAX package's, in process
(aiohttp's test client), both over the tiny f32 llama: the same route table; greedy
chat completions, completions, ``/generate``, Anthropic messages and the Responses API
equal, streamed deltas joined, ids and timestamps left out; ``/v1/encode``,
``/get_ppl`` (within 1e-5), error statuses, ``/metrics`` names and abort; the routes of
engine methods that are not ported (ROADMAP item 10) answer 501.  Beside them: the
response and stream parsers of both packages on the reference tests' inputs, the
proxy's routing (its PD path as far as the 501s allow) and the CLI's argument tree."""
import asyncio
import json
import re

import numpy as np
import pytest

KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=8,
          session_len=256, max_prefill_token_num=128)
VOLATILE = {'id', 'created', 'created_at', 'call_id', 'item_id', 'response_id'}
ID_RE = re.compile(r'^(chatcmpl|cmpl|msg|resp|rs|fc|call)[-_][0-9a-f]+$')


def norm(x):
    """``x`` without ids and timestamps."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [norm(v) for v in x]
    if isinstance(x, str) and ID_RE.match(x):
        return '<id>'
    return x


def same(got, ref, path=''):
    """``got`` equals ``ref``, floats within 1e-5 (logprobs)."""
    if isinstance(ref, float):
        assert abs(got - ref) <= 1e-5, path
    elif isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            same(got[k], ref[k], f'{path}/{k}')
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            same(g, r, f'{path}/{i}')
    else:
        assert got == ref, path


def sse(body: str):
    """SSE frames -> [(event or None, parsed data or '[DONE]')]."""
    frames = []
    for block in body.split('\n\n'):
        event, data = None, None
        for line in block.splitlines():
            if line.startswith('event: '):
                event = line[7:]
            elif line.startswith('data: '):
                data = line[6:]
        if data is not None:
            frames.append((event, data if data == '[DONE]' else json.loads(data)))
    return frames


@pytest.fixture(scope='module')
def servers(tiny_model_dir):
    """(loop, {'jax': client, 'torch': client}, {'jax': engine, 'torch': engine})."""
    from aiohttp.test_utils import TestClient, TestServer

    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu.serve.api_server import create_app as jcreate
    from lmdeploy_tpu.serve.async_engine import AsyncEngine as JAsync
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    from lmdeploy_tpu_torch.serve.api_server import create_app as tcreate
    from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine as TAsync
    loop = asyncio.new_event_loop()
    engines = {'jax': JAsync(tiny_model_dir, backend_config=JCfg(**KW)),
               'torch': TAsync(tiny_model_dir, backend_config=TCfg(**KW), device='cpu')}
    apps = {'jax': jcreate(engines['jax'], 'tiny-test'),
            'torch': tcreate(engines['torch'], 'tiny-test')}

    async def start():
        clients = {k: TestClient(TestServer(app)) for k, app in apps.items()}
        for c in clients.values():
            await c.start_server()
        return clients

    clients = loop.run_until_complete(start())
    yield loop, clients, engines
    for c in clients.values():
        loop.run_until_complete(c.close())
    for e in engines.values():
        e.close()
    loop.close()


def ask(servers, method, path, **kw):
    """The same request to both servers: {pkg: (status, text)}."""
    loop, clients, _ = servers

    async def one(client):
        r = await client.request(method, path, **kw)
        return r.status, await r.text()
    return {pkg: loop.run_until_complete(one(c)) for pkg, c in clients.items()}


def test_route_tables_equal(servers):
    from lmdeploy_tpu.serve.api_server import create_app as jcreate
    from lmdeploy_tpu_torch.serve.api_server import create_app as tcreate
    _, _, engines = servers

    def table(app):
        return sorted((r.method, r.resource.canonical) for r in app.router.routes())
    assert table(tcreate(engines['torch'], 'x')) == table(jcreate(engines['jax'], 'x'))


CHAT = {'model': 'tiny-test', 'messages': [{'role': 'user', 'content': 'hello there'}],
        'max_tokens': 12, 'temperature': 0}


@pytest.mark.parametrize('body', [
    pytest.param(CHAT, id='chat'),
    pytest.param(dict(CHAT, messages=[{'role': 'system', 'content': 'be brief'},
                                      {'role': 'user', 'content': [
                                          {'type': 'text', 'text': 'hi '},
                                          {'type': 'text', 'text': 'you'}]}],
                      max_completion_tokens=7), id='parts'),
    pytest.param(dict(CHAT, logprobs=True, top_logprobs=2, max_tokens=5), id='logprobs'),
])
def test_chat_completions_equal(servers, body):
    out = ask(servers, 'POST', '/v1/chat/completions', json=body)
    (js, jt), (ts, tt) = out['jax'], out['torch']
    assert js == ts == 200
    ref, got = json.loads(jt), json.loads(tt)
    assert got['usage']['completion_tokens'] > 0
    same(norm(got), norm(ref))


def _joined_chat(frames):
    chunks = [d for _, d in frames if d != '[DONE]']
    text = ''.join(c['choices'][0]['delta'].get('content') or '' for c in chunks)
    finish = [c['choices'][0]['finish_reason'] for c in chunks
              if c['choices'][0]['finish_reason']]
    return chunks[0]['choices'][0]['delta']['role'], text, finish, frames[-1][1]


def test_chat_completions_streamed_equal(servers):
    out = ask(servers, 'POST', '/v1/chat/completions', json=dict(CHAT, stream=True))
    (js, jt), (ts, tt) = out['jax'], out['torch']
    assert js == ts == 200
    got = _joined_chat(sse(tt))
    assert got == _joined_chat(sse(jt))
    assert got[0] == 'assistant' and got[3] == '[DONE]' and got[2] == ['length']


@pytest.mark.parametrize('stream', [False, True])
def test_completions_equal(servers, stream):
    body = {'model': 'tiny-test', 'prompt': ['abc', 'hello world'] if not stream else 'abc',
            'max_tokens': 6, 'temperature': 0, 'stream': stream}
    out = ask(servers, 'POST', '/v1/completions', json=body)
    (js, jt), (ts, tt) = out['jax'], out['torch']
    assert js == ts == 200
    if not stream:
        assert norm(json.loads(tt)) == norm(json.loads(jt))
        assert len(json.loads(tt)['choices']) == 2
        return

    def joined(frames):
        chunks = [d for _, d in frames if d != '[DONE]']
        return (''.join(c['choices'][0]['text'] for c in chunks),
                [c['choices'][0]['finish_reason'] for c in chunks][-1])
    assert joined(sse(tt)) == joined(sse(jt))


@pytest.mark.parametrize('body', [
    {'input_ids': [5, 10, 20], 'max_tokens': 4, 'ignore_eos': True},
    {'prompt': 'hello', 'max_tokens': 5},
], ids=['ids', 'prompt'])
def test_generate_equal(servers, body):
    out = ask(servers, 'POST', '/generate', json=body)
    assert out['torch'] == out['jax'] and out['torch'][0] == 200


@pytest.mark.parametrize('stream', [False, True])
def test_anthropic_messages_equal(servers, stream):
    body = {'model': 'tiny-test', 'max_tokens': 8, 'temperature': 0, 'stream': stream,
            'system': 'be brief', 'messages': [{'role': 'user', 'content': 'hello'}]}
    out = ask(servers, 'POST', '/v1/messages', json=body)
    (js, jt), (ts, tt) = out['jax'], out['torch']
    assert js == ts == 200
    if not stream:
        assert norm(json.loads(tt)) == norm(json.loads(jt))
        return

    def joined(frames):
        text = ''.join(d['delta']['text'] for e, d in frames if e == 'content_block_delta')
        events = [e for i, (e, _) in enumerate(frames) if i == 0 or frames[i - 1][0] != e]
        rest = [norm(d) for e, d in frames if e not in ('content_block_delta',)]
        return text, events, rest
    assert joined(sse(tt)) == joined(sse(jt))


@pytest.mark.parametrize('stream', [False, True])
def test_responses_api_equal(servers, stream):
    body = {'model': 'tiny-test', 'input': [{'role': 'user', 'content': 'hello'}],
            'instructions': 'be brief', 'max_output_tokens': 6, 'temperature': 0,
            'stream': stream, 'store': False}
    out = ask(servers, 'POST', '/v1/responses', json=body)
    (js, jt), (ts, tt) = out['jax'], out['torch']
    assert js == ts == 200
    if not stream:
        assert norm(json.loads(tt)) == norm(json.loads(jt))
        return

    def joined(frames):
        text = ''.join(d['delta'] for e, d in frames if e == 'response.output_text.delta')
        return text, norm([d for e, d in frames if e != 'response.output_text.delta'])
    assert joined(sse(tt)) == joined(sse(jt))


def test_encode_and_get_ppl(servers):
    out = ask(servers, 'POST', '/v1/encode', json={'input': ['hello world', 'abc']})
    assert out['torch'] == out['jax'] and out['torch'][0] == 200
    body = {'input_ids': [[5, 17, 23, 9, 40, 41, 7], [3, 4]]}
    out = ask(servers, 'POST', '/get_ppl', json=body)
    assert out['torch'][0] == out['jax'][0] == 200
    got, ref = (json.loads(out[k][1])['ppl'] for k in ('torch', 'jax'))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    text = ask(servers, 'POST', '/get_ppl', json={'input': 'hello world this is'})
    np.testing.assert_allclose(json.loads(text['torch'][1])['ppl'],
                               json.loads(text['jax'][1])['ppl'], rtol=0, atol=1e-5)


@pytest.mark.parametrize('path,kw', [
    ('/v1/chat/completions', {'data': 'not json',
                              'headers': {'Content-Type': 'application/json'}}),
    ('/v1/chat/completions', {'json': {'model': 'x'}}),
    ('/v1/chat/completions', {'json': dict(CHAT, messages=[
        {'role': 'user', 'content': 'hello ' * 300}])}),
    ('/v1/completions', {'json': {'model': 'x'}}),
    ('/generate', {'json': {'max_tokens': 3}}),
    ('/v1/messages', {'json': {'model': 'x', 'messages': []}}),
    ('/v1/responses', {'json': {'model': 'x'}}),
    ('/v1/encode', {'json': {'input': 3}}),
    ('/get_ppl', {'json': {'input': 3}}),
    ('/pooling', {'json': {'input': [[1, 2]]}}),
], ids=['bad-json', 'no-messages', 'too-long', 'no-prompt', 'generate', 'anthropic',
        'responses', 'encode', 'ppl', 'pooling-lm'])
def test_error_statuses_equal(servers, path, kw):
    out = ask(servers, 'POST', path, **kw)
    assert out['torch'][0] == out['jax'][0] == 400
    ref, got = json.loads(out['jax'][1]), json.loads(out['torch'][1])
    assert set(got) == set(ref) and set(got['error']) == set(ref['error'])


def test_metrics_names_equal(servers):
    out = ask(servers, 'GET', '/metrics')

    def names(text):
        return {line.split(' ')[0] for line in text.strip().splitlines()}
    assert out['torch'][0] == out['jax'][0] == 200
    assert names(out['torch'][1]) == names(out['jax'][1])
    assert {'lmdeploy_num_requests_finished', 'lmdeploy_cache_usage'} <= names(
        out['torch'][1])


def test_models_health_sleep_state_equal(servers):
    for method, path in (('GET', '/v1/models'), ('GET', '/health'),
                         ('GET', '/is_sleeping'), ('POST', '/init_weights_update_group'),
                         ('POST', '/destroy_weights_update_group')):
        out = ask(servers, method, path, json={})
        assert out['torch'][0] == out['jax'][0] == 200, path
        assert norm(json.loads(out['torch'][1])) == norm(json.loads(out['jax'][1])), path
    assert json.loads(out['torch'][1]) == {'status': 'ok'}


def test_health_monitor_follows_scheduler_steps(servers):
    """``serve/health.py``'s monitor on the port's engine: healthy while idle, and a
    busy scheduler whose step count stands still past the timeout reads stalled."""
    from lmdeploy_tpu_torch.serve.health import EngineHealthMonitor
    engine = servers[2]['torch'].engine
    monitor = EngineHealthMonitor(engine, timeout=0.0)
    assert monitor._probe() and monitor.healthy
    steps = engine.scheduler._step_count
    engine.scheduler.schedule()
    assert engine.scheduler._step_count == steps + 1
    busy = type(engine.scheduler).has_unfinished
    type(engine.scheduler).has_unfinished = lambda self: True
    try:
        assert monitor._probe()            # the step count moved since the last probe
        assert not monitor._probe()        # it stood still past the timeout
    finally:
        type(engine.scheduler).has_unfinished = busy


@pytest.mark.parametrize('method,path', [
    ('POST', '/sleep'), ('POST', '/wakeup'), ('POST', '/update_weights'),
    ('POST', '/distserve/prefill'), ('POST', '/distserve/decode'),
    ('GET', '/distserve/export/3'), ('POST', '/distserve/import'),
    ('POST', '/distserve/continue')])
def test_item10_routes_answer_501(servers, method, path):
    loop, clients, _ = servers

    async def run():
        r = await clients['torch'].request(method, path, json={})
        return r.status, await r.json()
    status, body = loop.run_until_complete(run())
    assert status == 501
    assert set(body['error']) == {'message', 'type', 'code'}
    assert 'not ported' in body['error']['message']


def test_abort_all_sessions(servers):
    """POST /abort_request without a session id aborts every in-flight stream of the
    port's server, which serves on afterwards."""
    loop, clients, _ = servers
    client = clients['torch']

    async def run():
        async def one_stream():
            async with client.post('/v1/chat/completions', json=dict(
                    CHAT, max_tokens=200, stream=True, ignore_eos=True)) as r:
                reason = None
                async for line in r.content:
                    line = line.decode().strip()
                    if line.startswith('data: {'):
                        reason = json.loads(line[6:])['choices'][0]['finish_reason'] or reason
                return reason

        tasks = [asyncio.ensure_future(one_stream()) for _ in range(3)]
        for _ in range(200):
            await asyncio.sleep(0.02)
            if len(servers[2]['torch'].engine._requests) == 3:
                break
        r = await client.post('/abort_request', json={})
        assert r.status == 200
        reasons = await asyncio.gather(*tasks)
        assert reasons == ['abort'] * 3
        r = await client.post('/v1/chat/completions', json=dict(CHAT, max_tokens=4))
        assert r.status == 200
        assert (await r.json())['choices'][0]['finish_reason'] in ('length', 'stop')
    loop.run_until_complete(run())


# -- parsers ------------------------------------------------------------------------
HERMES = ('I will check.\n<tool_call>\n{"name": "get_weather", "arguments": '
          '{"city": "Paris", "unit": "C"}}\n</tool_call>done')
PARSER_CASES = [
    ('parse_tool_calls', ('I will check the weather.\n<tool_call>\n{"name": '
                          '"get_weather", "arguments": {"city": "Paris"}}\n</tool_call>',)),
    ('parse_tool_calls', ('<tool_call>{"name": "a", "arguments": {}}</tool_call>'
                          '<tool_call>not json</tool_call><tool_call>{"name": "b", '
                          '"arguments": {"x": 1}}</tool_call>',)),
    ('parse_tool_calls', ('<|action_start|><|plugin|>{"name": "search", "arguments": '
                          '{"q": "tpu"}}<|action_end|>',)),
    ('parse_reasoning', ('<think>step 1, step 2</think>The answer is 4.',)),
    ('parse_reasoning', ('<think>still thinking about',)),
    ('parse_reasoning', ('plain answer',)),
    ('parse_response', ('<think>I should call the tool.</think>Sure. <tool_call>'
                        '{"name": "f", "arguments": {}}</tool_call>',)),
    ('format_tools_system', ([{'type': 'function',
                               'function': {'name': 'get_weather', 'parameters': {}}}],)),
]
STREAM_CASES = [
    ('hermes', HERMES, 1), ('hermes', HERMES, 3), ('hermes', HERMES, 7),
    ('hermes', HERMES, 1000),
    ('hermes', '<tool_call>{"name": "f", "arguments": {"x": 1', 5),
    ('hermes', 'a <tool_ca' + 'll>{"name": "g", "arguments": {}}</tool_call> b', 2),
    ('deepseek_v3', '<think>let me see</think>It is 4.', 3),
    ('deepseek_v3', '<think>never closed', 4),
    ('internlm2', '<|action_start|><|plugin|>\n{"name": "s", "arguments": {"q": 1}}'
                  '<|action_end|>', 4),
    ('qwen3coder', '<tool_call>\n<function=get_time>\n<parameter=tz>\nUTC\n'
                    '</parameter>\n</function>\n</tool_call>', 6),
    ('glm47', '<tool_call>get_time<arg_key>tz</arg_key><arg_value>UTC</arg_value>'
              '</tool_call>', 5),
    ('harmony', '<|channel|>analysis<|message|>think<|end|><|start|>assistant'
                '<|channel|>final<|message|>hi', 4),
]


def _plain(x):
    """Parser outputs as plain data (dataclasses as dicts), ids left out."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return norm({k: _plain(v) for k, v in x.items()})
    return norm(x)


@pytest.mark.parametrize('case', range(len(PARSER_CASES) + len(STREAM_CASES)))
def test_parsers_match_reference(case):
    """Both packages' ``parsers`` / ``stream_parser`` on the reference tests' inputs
    (tests/test_parsers.py, tests/test_stream_parser.py): equal outputs and events."""
    # the reference package's ``serve`` attribute is its serve() function
    from lmdeploy_tpu.serve import parsers as jp
    from lmdeploy_tpu.serve import stream_parser as jsp
    from lmdeploy_tpu_torch.serve import parsers as tp
    from lmdeploy_tpu_torch.serve import stream_parser as tsp
    if case < len(PARSER_CASES):
        name, args = PARSER_CASES[case]
        got, ref = (_plain(getattr(m, name)(*args)) for m in (tp, jp))
        assert got == ref
        return
    spec, text, step = STREAM_CASES[case - len(PARSER_CASES)]

    def drive(mod):
        p = mod.StreamParser(mod.REGISTRY[spec], tools_enabled=True)
        events = []
        for i in range(0, len(text), step):
            events += p.push(text[i:i + step])
        events += p.finish()
        return _plain(events), p.saw_tool_call
    got, ref = drive(tsp), drive(jsp)
    assert got == ref
    for arch in ('Qwen3ForCausalLM', 'InternLM2ForCausalLM', 'GptOssForCausalLM', None):
        assert _plain(tsp.resolve_parser(arch, None)) == _plain(jsp.resolve_parser(arch, None))


# -- proxy and CLI ------------------------------------------------------------------
def test_proxy_routing_matches_reference():
    """The reference tests' routing scenarios (tests/test_proxy.py) on the port's
    ``NodeManager``: strategies, heartbeat expiry, exclusion and PD roles."""
    import time

    from lmdeploy_tpu_torch.serve.proxy import HEARTBEAT_EXPIRY, NodeManager
    nm = NodeManager('min_observed_latency')
    nm.add('http://a:1')
    nm.add('http://b:1')
    nm.nodes['http://a:1'].observe(0.5)
    nm.nodes['http://b:1'].observe(0.1)
    assert nm.pick().url == 'http://b:1'
    nm2 = NodeManager('min_expected_latency')
    nm2.add('http://a:1')
    nm2.add('http://b:1')
    for n in nm2.nodes.values():
        n.observe(0.1)
    nm2.nodes['http://a:1'].inflight = 5
    assert nm2.pick().url == 'http://b:1'
    nm3 = NodeManager('random')
    nm3.add('http://a:1')
    nm3.add('http://b:1')
    nm3.nodes['http://a:1'].last_alive = time.time() - HEARTBEAT_EXPIRY - 1
    assert [n.url for n in nm3.alive_nodes()] == ['http://b:1']
    assert nm3.pick(exclude={'http://b:1'}) is None
    nm3.heartbeat('http://a:1')
    assert len(nm3.alive_nodes()) == 2
    pd = NodeManager('random', 'distserve')
    pd.add('http://p:1', role='prefill')
    pd.add('http://h:1')
    assert pd.pick(role='prefill').url == 'http://p:1'
    assert pd.pick(role='decode').url == 'http://h:1'     # decode falls back to hybrid
    pd.remove('http://p:1')
    assert pd.pick(role='prefill') is None


def test_proxy_forwards_to_port_servers(servers):
    """The port's proxy in front of the port's server: a hybrid forward answers as the
    server does; under ``distserve`` the prefill leg's /distserve/prefill answers 501,
    which the proxy reports as 502 and counts as the node's failure."""
    from aiohttp.test_utils import TestClient, TestServer

    from lmdeploy_tpu_torch.serve.proxy import create_proxy_app
    loop, clients, _ = servers
    url = f'http://127.0.0.1:{clients["torch"].port}'

    async def run():
        hybrid = create_proxy_app(routing_strategy='random')
        hybrid['node_manager'].add(url)
        pd = create_proxy_app(routing_strategy='random', serving_strategy='distserve')
        pd['node_manager'].add(url, role='prefill')
        pd['node_manager'].add(url.replace('127.0.0.1', 'localhost'), role='decode')
        hc, pc = TestClient(TestServer(hybrid)), TestClient(TestServer(pd))
        await hc.start_server()
        await pc.start_server()
        try:
            r = await hc.post('/v1/chat/completions', json=CHAT)
            via = await r.json()
            direct = await (await clients['torch'].post('/v1/chat/completions',
                                                        json=CHAT)).json()
            assert r.status == 200 and norm(via) == norm(direct)
            r = await pc.post('/v1/chat/completions', json=CHAT)
            assert r.status == 502
            assert pd['node_manager'].nodes[url].failures == 1
        finally:
            await hc.close()
            await pc.close()
    loop.run_until_complete(run())


def _tree(parser):
    """{command path: sorted (option strings, default) of its actions}."""
    import argparse
    out = {}

    def walk(p, path):
        opts = []
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sub in a.choices.items():
                    walk(sub, path + (name,))
            elif not isinstance(a, argparse._HelpAction):
                opts.append((tuple(a.option_strings) or (a.dest,), repr(a.default),
                             repr(a.choices)))
        out[path] = sorted(opts)
    walk(parser, ())
    return out


def test_cli_tree_matches_reference(capsys):
    """``python -m lmdeploy_tpu_torch``'s commands and options are the reference's,
    plus ``--device`` on the engine commands; ``lite`` exits non-zero."""
    from lmdeploy_tpu.cli.entrypoint import build_parser as jbuild
    from lmdeploy_tpu_torch.cli.entrypoint import build_parser as tbuild
    from lmdeploy_tpu_torch.cli.entrypoint import main
    ref, got = _tree(jbuild()), _tree(tbuild())
    assert set(got) == set(ref)
    device = (('--device',), 'None', 'None')
    for path, opts in got.items():
        extra = [device] if path in (('chat',), ('serve', 'api_server')) else []
        want = sorted(ref[path] + extra)
        if path == ('serve', 'launch_server'):
            # only the coordinator's help text differs
            assert [o[0] for o in opts] == [o[0] for o in want]
        else:
            assert opts == want, path
    args = tbuild().parse_args(['serve', 'api_server', 'm', '--device', 'cpu'])
    assert args.device == 'cpu' and args.func.__name__ == 'cmd_serve'
    with pytest.raises(SystemExit) as e:
        main(['lite', 'auto_awq', 'm'])
    assert e.value.code != 0 and 'not ported' in str(e.value.code)
    main(['check_env'])
    assert 'torch:' in capsys.readouterr().out
