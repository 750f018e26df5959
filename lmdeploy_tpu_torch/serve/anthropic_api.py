"""Anthropic Messages API adapter (/v1/messages).

Port of ``lmdeploy_tpu/serve/anthropic_api.py``: a host module, copied as it is.

Reference analog: ``lmdeploy/serve/anthropic/`` (adapter.py, streaming.py): accepts
Anthropic-format requests, maps them onto the engine, and emits Anthropic SSE
events (message_start / content_block_delta / message_delta / message_stop).
"""
from __future__ import annotations

import json
import uuid
from typing import Any, Dict, List, Optional

from ..messages import GenerationConfig


def _to_engine_messages(body: Dict[str, Any]) -> List[Dict[str, str]]:
    messages = []
    system = body.get('system')
    if system:
        if isinstance(system, list):
            system = ''.join(part.get('text', '') for part in system)
        messages.append({'role': 'system', 'content': system})
    for m in body.get('messages', []):
        content = m.get('content')
        if isinstance(content, list):
            content = ''.join(part.get('text', '')
                              for part in content if part.get('type') == 'text')
        messages.append({'role': m['role'], 'content': content})
    return messages


def _gen_config(body: Dict[str, Any]) -> GenerationConfig:
    temp = body.get('temperature', 1.0)
    return GenerationConfig(
        max_new_tokens=body.get('max_tokens', 1024),
        do_sample=(temp or 0) > 0,
        temperature=temp if temp is not None else 1.0,
        top_p=body.get('top_p', 1.0),
        top_k=body.get('top_k', 0) or 0,
        stop_words=body.get('stop_sequences'),
    )


def _finish_to_stop_reason(reason: Optional[str]) -> str:
    return {'stop': 'end_turn', 'length': 'max_tokens',
            'abort': 'end_turn'}.get(reason or 'stop', 'end_turn')


def add_anthropic_routes(app, engine, model_name: str):
    from aiohttp import web

    async def messages(request):
        try:
            body = await request.json()
        except Exception as e:  # noqa: BLE001
            return web.json_response(
                {'type': 'error',
                 'error': {'type': 'invalid_request_error', 'message': str(e)}},
                status=400)
        if 'messages' not in body or 'max_tokens' not in body:
            return web.json_response(
                {'type': 'error',
                 'error': {'type': 'invalid_request_error',
                           'message': 'messages and max_tokens are required'}},
                status=400)
        gen_config = _gen_config(body)
        engine_messages = _to_engine_messages(body)
        session_id = engine.next_session_id()
        msg_id = f'msg_{uuid.uuid4().hex[:24]}'

        if body.get('stream'):
            resp = web.StreamResponse(headers={
                'Content-Type': 'text/event-stream', 'Cache-Control': 'no-cache'})
            await resp.prepare(request)

            async def send(event: str, data: Dict):
                await resp.write(f'event: {event}\ndata: '
                                 f'{json.dumps(data)}\n\n'.encode())

            await send('message_start', {
                'type': 'message_start',
                'message': {'id': msg_id, 'type': 'message', 'role': 'assistant',
                            'model': model_name, 'content': [],
                            'stop_reason': None,
                            'usage': {'input_tokens': 0, 'output_tokens': 0}}})
            await send('content_block_start', {
                'type': 'content_block_start', 'index': 0,
                'content_block': {'type': 'text', 'text': ''}})
            out_tokens = 0
            finish = None
            async for out in engine.generate(engine_messages, session_id,
                                             gen_config=gen_config):
                if out.response:
                    await send('content_block_delta', {
                        'type': 'content_block_delta', 'index': 0,
                        'delta': {'type': 'text_delta', 'text': out.response}})
                out_tokens = out.generate_token_len
                finish = out.finish_reason
            await send('content_block_stop',
                       {'type': 'content_block_stop', 'index': 0})
            await send('message_delta', {
                'type': 'message_delta',
                'delta': {'stop_reason': _finish_to_stop_reason(finish)},
                'usage': {'output_tokens': out_tokens}})
            await send('message_stop', {'type': 'message_stop'})
            await resp.write_eof()
            return resp

        text = ''
        finish = None
        input_tokens = output_tokens = 0
        async for out in engine.generate(engine_messages, session_id,
                                         gen_config=gen_config):
            text += out.response
            finish = out.finish_reason
            input_tokens = out.input_token_len
            output_tokens = out.generate_token_len
        return web.json_response({
            'id': msg_id, 'type': 'message', 'role': 'assistant',
            'model': model_name,
            'content': [{'type': 'text', 'text': text}],
            'stop_reason': _finish_to_stop_reason(finish),
            'stop_sequence': None,
            'usage': {'input_tokens': input_tokens,
                      'output_tokens': output_tokens}})

    app.router.add_post('/v1/messages', messages)
