"""OpenAI-compatible API server (aiohttp).

Port of ``lmdeploy_tpu/serve/api_server.py`` over the port's ``AsyncEngine``: the same
routes, wire format and middleware (API key, CORS, the concurrency cap, a ValueError
as 400).  The routes whose engine methods are not ported yet (ROADMAP item 10:
``/sleep``, ``/wakeup``, ``/update_weights`` and ``/distserve/*``) answer status 501 in
the reference's error shape, naming the method; ``/is_sleeping`` answers false, as the
reference does for an engine that never slept.  ``aiohttp`` is imported inside
``create_app`` and ``serve``, so importing this module needs none.

Endpoints: GET /v1/models, /health, /metrics, /is_sleeping; POST /v1/chat/completions,
/v1/completions, /generate, /abort_request, /v1/messages (``anthropic_api.py``),
/v1/responses (``responses_api.py``), /pooling, /v1/encode, /get_ppl,
/init_weights_update_group, /destroy_weights_update_group, /terminate.
"""
from __future__ import annotations

import asyncio
import os
from typing import Optional

from ..chat_template import ChatTemplateConfig
from ..messages import GenerationConfig, TpuEngineConfig
from .async_engine import AsyncEngine
from .openai_protocol import (ChatCompletionChoice, ChatCompletionRequest,
                              ChatCompletionResponse, ChatCompletionStreamChoice,
                              ChatCompletionStreamResponse, ChatMessage,
                              CompletionChoice, CompletionRequest, CompletionResponse,
                              DeltaMessage, ErrorResponse, GenerateRequest, ModelCard,
                              ModelList, UsageInfo)


def _gen_config_from_chat(req: ChatCompletionRequest) -> GenerationConfig:
    max_new = req.max_completion_tokens or req.max_tokens or 512
    stop = req.stop if isinstance(req.stop, list) else ([req.stop] if req.stop else None)
    return GenerationConfig(
        max_new_tokens=max_new,
        do_sample=(req.temperature or 0) > 0,
        temperature=req.temperature if req.temperature is not None else 0.7,
        top_p=req.top_p or 1.0,
        top_k=req.top_k or 0,
        min_p=req.min_p or 0.0,
        repetition_penalty=req.repetition_penalty or 1.0,
        presence_penalty=req.presence_penalty or 0.0,
        frequency_penalty=req.frequency_penalty or 0.0,
        stop_words=stop,
        random_seed=req.seed,
        skip_special_tokens=bool(req.skip_special_tokens),
        logprobs=(req.top_logprobs or 0) if req.logprobs else None,
        response_format=req.response_format,
    )


def _gen_config_from_completion(req: CompletionRequest) -> GenerationConfig:
    return GenerationConfig(
        max_new_tokens=req.max_tokens or 16,
        do_sample=(req.temperature or 0) > 0,
        temperature=req.temperature if req.temperature is not None else 0.7,
        top_p=req.top_p or 1.0, top_k=req.top_k or 0,
        repetition_penalty=req.repetition_penalty or 1.0,
        presence_penalty=req.presence_penalty or 0.0,
        frequency_penalty=req.frequency_penalty or 0.0,
        stop_words=req.stop if isinstance(req.stop, list)
        else ([req.stop] if req.stop else None),
        random_seed=req.seed,
        logprobs=req.logprobs)


def _chat_logprobs(entries, token_ids, tokenizer):
    """OpenAI chat-completions ``logprobs`` object for these generated tokens.

    ``entries``: per-token dicts {token_id: Logprob} from the engine (chosen
    token at rank 0, requested top-k after).  Reference:
    serve/openai/endpoints/chat_completions.py logprobs assembly.
    """
    content = []
    for tok, entry in zip(token_ids, entries or ()):
        text = tokenizer.decode([tok])
        tops = []
        for tid, lp in sorted(entry.items(),
                              key=lambda kv: (kv[1].rank if kv[1].rank else 0)):
            if tid == tok:
                continue
            t_text = tokenizer.decode([tid])
            tops.append({'token': t_text, 'logprob': lp.logprob,
                         'bytes': list(t_text.encode('utf-8', 'replace'))})
        chosen = entry.get(tok)
        content.append({
            'token': text,
            'logprob': chosen.logprob if chosen else 0.0,
            'bytes': list(text.encode('utf-8', 'replace')),
            'top_logprobs': tops,
        })
    return {'content': content}


def _completion_logprobs(entries, token_ids, tokenizer):
    """Legacy completions-API logprobs object (tokens/token_logprobs arrays)."""
    tokens, token_logprobs, top_logprobs = [], [], []
    for tok, entry in zip(token_ids, entries or ()):
        tokens.append(tokenizer.decode([tok]))
        chosen = entry.get(tok)
        token_logprobs.append(chosen.logprob if chosen else 0.0)
        top_logprobs.append({tokenizer.decode([tid]): lp.logprob
                             for tid, lp in entry.items()})
    return {'tokens': tokens, 'token_logprobs': token_logprobs,
            'top_logprobs': top_logprobs, 'text_offset': []}


def create_app(engine: AsyncEngine, model_name: str, api_key: Optional[str] = None,
               allow_origins: Optional[list] = None,
               max_concurrent_requests: Optional[int] = None):
    from aiohttp import web

    def error_response(msg: str, status: int = 400) -> 'web.Response':
        body = {'error': ErrorResponse(message=msg).model_dump()}
        return web.json_response(body, status=status)

    # concurrency limiter (reference: openai/api_server.py:159
    # ConcurrencyLimitMiddleware — reject with 429 above the cap instead of
    # queueing unboundedly); env fallback mirrors the reference's CLI flag.
    limit = max_concurrent_requests or int(
        os.environ.get('LMDEPLOY_TPU_MAX_CONCURRENT_REQUESTS', '0')) or None
    inflight = {'n': 0}
    _GEN_PATHS = ('/v1/chat/completions', '/v1/completions', '/generate',
                  '/v1/messages', '/v1/responses', '/pooling', '/v1/encode')
    origins = allow_origins if allow_origins is not None else [
        o for o in os.environ.get('LMDEPLOY_TPU_ALLOW_ORIGINS', '').split(',')
        if o]

    def _cors_headers(request):
        origin = request.headers.get('Origin')
        if not origins or origin is None:
            return {}
        if '*' in origins or origin in origins:
            return {'Access-Control-Allow-Origin': origin,
                    'Access-Control-Allow-Methods': 'GET, POST, OPTIONS',
                    'Access-Control-Allow-Headers':
                        'Content-Type, Authorization'}
        return {}

    @web.middleware
    async def auth_middleware(request, handler):
        if request.method == 'OPTIONS':        # CORS preflight
            return web.Response(headers=_cors_headers(request))
        if api_key is not None and request.path.startswith('/v1'):
            auth = request.headers.get('Authorization', '')
            if auth != f'Bearer {api_key}':
                return error_response('invalid api key', 401)
        limited = limit is not None and request.path in _GEN_PATHS
        if limited and inflight['n'] >= limit:
            resp = error_response('too many concurrent requests', 429)
            resp.headers.update(_cors_headers(request))
            return resp
        if limited:
            inflight['n'] += 1
        try:
            resp = await handler(request)
        except ValueError as e:
            # user-input errors raised by the engine (e.g. prompt > session_len)
            resp = error_response(str(e), 400)
        finally:
            if limited:
                inflight['n'] -= 1
        if not getattr(resp, 'prepared', False):   # SSE already sent headers
            resp.headers.update(_cors_headers(request))
        return resp

    async def parse(request, model_cls):
        try:
            return model_cls.model_validate(await request.json()), None
        except Exception as e:  # noqa: BLE001
            return None, error_response(f'invalid request: {e}', 400)

    # -- handlers ----------------------------------------------------------------------
    async def health(request):
        if engine.engine.is_alive():
            return web.json_response({'status': 'ok'})
        return web.json_response({'status': 'dead'}, status=500)

    async def list_models(request):
        return web.json_response(
            ModelList(data=[ModelCard(id=model_name)]).model_dump())

    async def metrics(request):
        m = engine.engine.make_schedule_metrics()
        text = engine.engine.metrics.prometheus_text(extra={
            'num_running': m.num_running,
            'num_waiting': m.num_waiting,
            'cache_usage': round(m.cache_usage, 4),
            'free_blocks': m.num_free_blocks,
            'num_preemptions': engine.engine.scheduler.num_preemptions,
        })
        return web.Response(text=text)

    async def chat_completions(request):
        req, err = await parse(request, ChatCompletionRequest)
        if err:
            return err
        gen_config = _gen_config_from_chat(req)
        session_id = engine.next_session_id()
        messages = req.messages
        if req.tools and isinstance(messages, list):
            from .parsers import format_tools_system
            messages = ([{'role': 'system',
                          'content': format_tools_system(req.tools)}]
                        + list(messages))

        if req.stream:
            # incremental tool-call / reasoning parsing during SSE (reference:
            # serve/parsers/response_parser.py streaming deltas).  The parser
            # turns detokenizer increments into typed frames; tool-call
            # arguments stream as they are generated, not post-hoc at EOS.
            from .stream_parser import StreamParser, resolve_parser
            arch = getattr(getattr(engine.engine, 'configs', None), 'model',
                           None)
            spec = resolve_parser(getattr(arch, 'hf_arch', None),
                                  getattr(engine, 'tool_call_parser', None))
            sparser = StreamParser(spec, tools_enabled=bool(req.tools))

            def frames(events, finish_reason, lp_obj, first):
                """Pack parser events into DeltaMessage SSE frames."""
                deltas = []
                for ev in events:
                    if ev[0] == 'content':
                        deltas.append(DeltaMessage(content=ev[1]))
                    elif ev[0] == 'reasoning':
                        deltas.append(DeltaMessage(reasoning_content=ev[1]))
                    elif ev[0] == 'tool_name':
                        deltas.append(DeltaMessage(tool_calls=[{
                            'index': ev[1], 'id': ev[2], 'type': 'function',
                            'function': {'name': ev[3], 'arguments': ''}}]))
                    elif ev[0] == 'tool_args':
                        deltas.append(DeltaMessage(tool_calls=[{
                            'index': ev[1],
                            'function': {'arguments': ev[2]}}]))
                if not deltas and (finish_reason or first):
                    deltas.append(DeltaMessage())
                if deltas and first:
                    deltas[0].role = 'assistant'
                packed = []
                for i, d in enumerate(deltas):
                    last = i == len(deltas) - 1
                    packed.append(ChatCompletionStreamChoice(
                        delta=d, finish_reason=finish_reason if last else None,
                        logprobs=lp_obj if last else None))
                return packed

            resp = web.StreamResponse(headers={
                'Content-Type': 'text/event-stream',
                'Cache-Control': 'no-cache'})
            await resp.prepare(request)
            rid = None
            first = True

            async def write_choices(choices):
                nonlocal rid
                for choice in choices:
                    chunk = ChatCompletionStreamResponse(model=req.model)
                    rid = rid or chunk.id
                    chunk.id = rid
                    chunk.choices = [choice]
                    await resp.write(
                        f'data: {chunk.model_dump_json()}\n\n'.encode())

            try:
                finish = None
                async for out in engine.generate(messages, session_id,
                                                 gen_config=gen_config):
                    lp_obj = None
                    if req.logprobs and out.logprobs:
                        lp_obj = _chat_logprobs(out.logprobs, out.token_ids,
                                                engine.tokenizer)
                    events = sparser.push(out.response)
                    finish = out.finish_reason
                    if finish is not None:
                        events += sparser.finish()
                        if sparser.saw_tool_call and finish == 'stop':
                            finish = 'tool_calls'
                    choices = frames(events, finish, lp_obj, first)
                    if choices:
                        first = False
                        await write_choices(choices)
            except (ConnectionResetError, asyncio.CancelledError):
                await engine.stop_session(session_id)
                raise
            await resp.write(b'data: [DONE]\n\n')
            await resp.write_eof()
            return resp

        text = ''
        finish_reason = None
        input_len = 0
        gen_len = 0
        all_ids, all_lps = [], []
        async for out in engine.generate(messages, session_id,
                                         gen_config=gen_config):
            text += out.response
            finish_reason = out.finish_reason
            input_len = out.input_token_len
            gen_len = out.generate_token_len
            if req.logprobs and out.logprobs:
                all_ids.extend(out.token_ids)
                all_lps.extend(out.logprobs)
        from .parsers import parse_response
        parsed = parse_response(text, enable_tools=bool(req.tools))
        if parsed['tool_calls']:
            finish_reason = 'tool_calls'
        lp_obj = _chat_logprobs(all_lps, all_ids, engine.tokenizer) \
            if all_lps else None
        body = ChatCompletionResponse(
            model=req.model,
            choices=[ChatCompletionChoice(
                message=ChatMessage(role='assistant', content=parsed['content'],
                                    reasoning_content=parsed['reasoning_content'],
                                    tool_calls=parsed['tool_calls']),
                finish_reason=finish_reason, logprobs=lp_obj)],
            usage=UsageInfo(prompt_tokens=input_len, completion_tokens=gen_len,
                            total_tokens=input_len + gen_len))
        return web.json_response(body.model_dump())

    async def completions(request):
        req, err = await parse(request, CompletionRequest)
        if err:
            return err
        prompts = req.prompt if isinstance(req.prompt, list) else [req.prompt]
        gen_config = _gen_config_from_completion(req)

        if req.stream:
            session_id = engine.next_session_id()
            resp = web.StreamResponse(headers={
                'Content-Type': 'text/event-stream',
                'Cache-Control': 'no-cache'})
            await resp.prepare(request)
            async for out in engine.generate(prompts[0], session_id,
                                             gen_config=gen_config,
                                             do_preprocess=False):
                body = CompletionResponse(model=req.model, choices=[
                    CompletionChoice(text=out.response,
                                     finish_reason=out.finish_reason)])
                await resp.write(f'data: {body.model_dump_json()}\n\n'.encode())
            await resp.write(b'data: [DONE]\n\n')
            await resp.write_eof()
            return resp

        async def one(i, prompt):
            session_id = engine.next_session_id()
            text = ''
            finish_reason = None
            input_len = gen_len = 0
            all_ids, all_lps = [], []
            async for out in engine.generate(prompt, session_id,
                                             gen_config=gen_config,
                                             do_preprocess=False):
                text += out.response
                finish_reason = out.finish_reason
                input_len = out.input_token_len
                gen_len = out.generate_token_len
                if req.logprobs is not None and out.logprobs:
                    all_ids.extend(out.token_ids)
                    all_lps.extend(out.logprobs)
            lp_obj = _completion_logprobs(all_lps, all_ids, engine.tokenizer) \
                if all_lps else None
            return CompletionChoice(index=i, text=text, logprobs=lp_obj,
                                    finish_reason=finish_reason), input_len, gen_len

        results = await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])
        usage = UsageInfo()
        choices = []
        for choice, input_len, gen_len in results:
            choices.append(choice)
            usage.prompt_tokens += input_len
            usage.completion_tokens += gen_len
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        body = CompletionResponse(model=req.model, choices=choices, usage=usage)
        return web.json_response(body.model_dump())

    async def generate(request):
        """Token-level generation API (reference: endpoints/generate.py:65)."""
        req, err = await parse(request, GenerateRequest)
        if err:
            return err
        gen_config = GenerationConfig(
            max_new_tokens=req.max_tokens, do_sample=req.do_sample,
            temperature=req.temperature, top_p=req.top_p, top_k=req.top_k,
            stop_token_ids=req.stop_token_ids, ignore_eos=req.ignore_eos)
        session_id = req.session_id or engine.next_session_id()
        if req.input_ids is not None:
            from ..messages import ResponseType
            from ..paging.seq import SamplingParams
            gen_config.validate()
            sampling = SamplingParams.from_gen_config(
                gen_config, engine.engine.model_config.eos_token_id)
            queue = engine.engine.add_message(session_id, req.input_ids, sampling)
            token_ids = []
            while True:
                out = await queue.get()
                token_ids = out.token_ids
                if out.status != ResponseType.SUCCESS:
                    break
            engine.engine.end_session(session_id)
            return web.json_response({'token_ids': token_ids,
                                      'num_token': len(token_ids)})
        if req.prompt is None:
            return error_response('prompt or input_ids required')
        text = ''
        async for out in engine.generate(req.prompt, session_id,
                                         gen_config=gen_config, do_preprocess=False):
            text += out.response
        return web.json_response({'text': text})

    async def abort_request(request):
        """Abort one session, or ALL in-flight sessions when no session_id is
        given (reference: stop_all_session epoch bump)."""
        data = await request.json()
        session_id = data.get('session_id')
        if session_id is not None:
            await engine.stop_session(int(session_id))
        else:
            await engine.stop_all_sessions()
        return web.json_response({'status': 'ok'})

    def not_ported(method: str):
        """A handler for a route whose engine method is not ported yet (ROADMAP item
        10): 501 in the reference's error shape."""
        async def handler(request):
            return error_response(f'{method} is not ported to the PyTorch engine yet',
                                  501)
        return handler

    async def pooling(request):
        """Reward-model scoring with an Embeddings-API-shaped input
        (reference: serve/openai/endpoints/auxiliary.py /pooling)."""
        try:
            body = await request.json()
        except Exception as e:  # noqa: BLE001
            return error_response(f'invalid request: {e}', 400)
        inp = body.get('input')
        if isinstance(inp, str):
            input_ids = [engine.tokenizer.encode(inp)]
        elif isinstance(inp, list) and inp:
            if isinstance(inp[0], str):
                input_ids = [engine.tokenizer.encode(p) for p in inp]
            elif isinstance(inp[0], int):
                input_ids = [inp]
            elif isinstance(inp[0], list):
                input_ids = inp
            else:
                return error_response('input list contains an invalid type', 400)
        else:
            return error_response('input must be a string or a list', 400)
        try:
            scores = await engine.async_get_reward_score(input_ids)
        except ValueError as e:
            return error_response(str(e), 400)
        return web.json_response({
            'object': 'list', 'model': model_name,
            'data': [{'object': 'pooling', 'index': i, 'data': s}
                     for i, s in enumerate(scores)],
        })

    def _parse_input_ids(body):
        inp = body.get('input')
        if isinstance(inp, str):
            return [engine.tokenizer.encode(inp)]
        if isinstance(inp, list) and inp:
            if isinstance(inp[0], str):
                return [engine.tokenizer.encode(p) for p in inp]
            if isinstance(inp[0], int):
                return [inp]
            if isinstance(inp[0], list):
                return inp
        raise ValueError('input must be a string or a list')

    async def encode(request):
        """Tokenize (reference: endpoints/auxiliary.py /v1/encode)."""
        try:
            body = await request.json()
            ids = _parse_input_ids(body)
        except Exception as e:  # noqa: BLE001
            return error_response(f'invalid request: {e}', 400)
        return web.json_response({
            'input_ids': ids if len(ids) > 1 else ids[0],
            'length': [len(x) for x in ids] if len(ids) > 1 else len(ids[0]),
        })

    async def get_ppl(request):
        """Per-sequence perplexity over given token ids (reference:
        endpoints/auxiliary.py /get_ppl)."""
        try:
            body = await request.json()
            ids = body.get('input_ids') or _parse_input_ids(body)
            if ids and isinstance(ids[0], int):
                ids = [ids]
        except Exception as e:  # noqa: BLE001
            return error_response(f'invalid request: {e}', 400)
        try:
            ppl = await engine.async_get_ppl(ids)
        except ValueError as e:
            return error_response(str(e), 400)
        return web.json_response({'ppl': [float(p) for p in ppl]})

    async def is_sleeping(request):
        return web.json_response({'is_sleeping': False})

    async def init_weights_update_group(request):
        """RL weight-sync group setup (reference: endpoints/management.py), a no-op
        answered as the reference answers it: its weights sync through POST
        /update_weights (npz over HTTP), which answers 501 here until
        ``Engine.update_params`` is ported (ROADMAP item 10)."""
        return web.json_response({'status': 'ok', 'transport': 'http-npz'})

    async def destroy_weights_update_group(request):
        return web.json_response({'status': 'ok'})

    async def terminate(request):
        """Graceful shutdown (reference: endpoints/management.py
        terminate): finish in-flight requests, then stop the process."""
        import asyncio as aio
        import os
        import signal

        async def _exit():
            await aio.sleep(0.2)          # let the response flush
            engine.engine.close()
            os.kill(os.getpid(), signal.SIGTERM)

        aio.get_running_loop().create_task(_exit())
        return web.json_response({'status': 'terminating'})

    app = web.Application(middlewares=[auth_middleware])
    from .anthropic_api import add_anthropic_routes
    add_anthropic_routes(app, engine, model_name)
    from .responses_api import add_responses_routes
    add_responses_routes(app, engine, model_name)
    app.router.add_get('/health', health)
    app.router.add_get('/v1/models', list_models)
    app.router.add_get('/metrics', metrics)
    app.router.add_post('/v1/chat/completions', chat_completions)
    app.router.add_post('/v1/completions', completions)
    app.router.add_post('/generate', generate)
    app.router.add_post('/abort_request', abort_request)
    app.router.add_post('/sleep', not_ported('Engine.sleep'))
    app.router.add_post('/wakeup', not_ported('Engine.wakeup'))
    app.router.add_post('/pooling', pooling)
    app.router.add_post('/update_weights', not_ported('Engine.update_params'))
    app.router.add_post('/v1/encode', encode)
    app.router.add_post('/get_ppl', get_ppl)
    app.router.add_get('/is_sleeping', is_sleeping)
    app.router.add_post('/init_weights_update_group',
                        init_weights_update_group)
    app.router.add_post('/destroy_weights_update_group',
                        destroy_weights_update_group)
    app.router.add_post('/terminate', terminate)
    app.router.add_post('/distserve/prefill', not_ported('disagg prefill'))
    app.router.add_post('/distserve/decode', not_ported('disagg decode'))
    app.router.add_get('/distserve/export/{session_id}',
                       not_ported('disagg.export_session_kv'))
    app.router.add_post('/distserve/import', not_ported('disagg.import_session_kv'))
    app.router.add_post('/distserve/continue', not_ported('Engine.continue_session'))
    return app


def serve(model_path: str, model_name: Optional[str] = None,
          server_name: str = '0.0.0.0', server_port: int = 23333,
          backend_config: Optional[TpuEngineConfig] = None,
          chat_template_config: Optional[ChatTemplateConfig] = None,
          api_key: Optional[str] = None, log_level: str = 'INFO', device=None,
          **kwargs):
    """Build the engine (on the GPU, or the CPU with ``device='cpu'``) and the app,
    and serve (reference api_server.py serve()).  A multi-node launch
    (LMDEPLOY_TPU_COORDINATOR) is not ported yet."""
    from aiohttp import web

    if os.environ.get('LMDEPLOY_TPU_COORDINATOR'):
        raise NotImplementedError('multi-node serving is not ported yet (ROADMAP item 16)')
    engine = AsyncEngine(model_path, backend_config=backend_config,
                         chat_template_config=chat_template_config, device=device,
                         **kwargs)
    app = create_app(engine, model_name or model_path, api_key)
    web.run_app(app, host=server_name, port=server_port)
