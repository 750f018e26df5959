"""OpenAI Responses API (/v1/responses).

Port of ``lmdeploy_tpu/serve/responses_api.py``: a host module, copied as it is.

Reference analog: ``lmdeploy/serve/openai/responses/`` (request.py item
conversion, serving.py, streaming.py event sequence — ~1.1k LoC).  Covers:

  * ``input`` as string or item list: message items (string or content-part
    lists, ``developer`` -> system), ``function_call`` items (assistant
    tool_calls turns), ``function_call_output`` items (tool-role turns)
  * ``tools`` in the Responses flat format + ``tool_choice``
  * tool-call OUTPUT items: the model's tool calls come back as
    ``function_call`` output items; streamed as ``response.output_item.added``
    + ``response.function_call_arguments.delta`` frames via the incremental
    stream parser (serve/stream_parser.py)
  * reasoning output items (``<think>`` models)
  * conversation state: ``store`` + ``previous_response_id`` chain turns
    across requests through an in-process LRU (the reference's Text V1
    rejects these; the public API semantic is implemented here directly)
"""
from __future__ import annotations

import json
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..messages import GenerationConfig


class ResponseStore:
    """In-memory conversation state for store=true / previous_response_id."""

    def __init__(self, cap: int = 512):
        self._items: 'OrderedDict[str, List[Dict]]' = OrderedDict()
        self.cap = cap

    def put(self, rid: str, messages: List[Dict]):
        self._items[rid] = messages
        self._items.move_to_end(rid)
        while len(self._items) > self.cap:
            self._items.popitem(last=False)

    def get(self, rid: str) -> Optional[List[Dict]]:
        return self._items.get(rid)


def _content_text(content: Any) -> str:
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return ''.join(p.get('text', '') for p in content
                       if isinstance(p, dict)
                       and p.get('type') in ('input_text', 'output_text',
                                             'text'))
    return ''


def _to_messages(body: Dict[str, Any],
                 prior: Optional[List[Dict]]) -> List[Dict[str, Any]]:
    """Responses input items -> chat messages (reference: request.py
    messages_from_input)."""
    system_parts: List[str] = []
    messages: List[Dict[str, Any]] = list(prior or [])
    if body.get('instructions'):
        system_parts.append(body['instructions'])
    inp = body.get('input', '')
    if isinstance(inp, str):
        messages.append({'role': 'user', 'content': inp})
    else:
        for item in inp:
            itype = item.get('type', 'message')
            if itype == 'function_call':
                name = item.get('name', '')
                args = item.get('arguments', '')
                # content carries a renderable form of the call so chat
                # templates that ignore tool_calls still keep the context
                rendered = (f'<tool_call>\n{{"name": {json.dumps(name)}, '
                            f'"arguments": {args or "{}"}}}\n</tool_call>')
                messages.append({
                    'role': 'assistant', 'content': rendered,
                    'tool_calls': [{
                        'id': item.get('call_id') or item.get('id', ''),
                        'type': 'function',
                        'function': {'name': name, 'arguments': args}}]})
            elif itype == 'function_call_output':
                messages.append({'role': 'tool',
                                 'tool_call_id': item.get('call_id', ''),
                                 'content': _content_text(item.get('output',
                                                                   ''))})
            elif itype == 'reasoning':
                continue                     # replayed reasoning items: drop
            elif itype == 'message':
                role = item.get('role', 'user')
                if role == 'developer':
                    role = 'system'
                text = _content_text(item.get('content', ''))
                if role == 'system':
                    system_parts.append(text)
                else:
                    messages.append({'role': role, 'content': text})
    if system_parts:
        messages = ([{'role': 'system', 'content': '\n\n'.join(system_parts)}]
                    + messages)
    return messages


def _chat_tools(body: Dict[str, Any]) -> Optional[List[Dict]]:
    """Responses flat tool format -> chat tools list."""
    tools = body.get('tools')
    if not tools:
        return None
    out = []
    for t in tools:
        if t.get('type') != 'function':
            continue
        out.append({'type': 'function',
                    'function': {'name': t.get('name', ''),
                                 'description': t.get('description', ''),
                                 'parameters': t.get('parameters', {})}})
    return out or None


def _gen_config(body: Dict[str, Any]) -> GenerationConfig:
    temp = body.get('temperature', 1.0)
    return GenerationConfig(
        max_new_tokens=body.get('max_output_tokens', 1024),
        do_sample=(temp or 0) > 0,
        temperature=temp if temp is not None else 1.0,
        top_p=body.get('top_p', 1.0),
        response_format=body.get('response_format'),
    )


def _response_object(rid: str, model: str, output: List[Dict], status: str,
                     input_tokens: int, output_tokens: int) -> Dict:
    text = ''.join(
        p['text'] for item in output if item.get('type') == 'message'
        for p in item.get('content', []) if p.get('type') == 'output_text')
    return {
        'id': rid, 'object': 'response', 'created_at': int(time.time()),
        'model': model, 'status': status, 'output': output,
        'output_text': text,
        'usage': {'input_tokens': input_tokens, 'output_tokens': output_tokens,
                  'total_tokens': input_tokens + output_tokens},
    }


def _msg_item(text: str, status: str = 'completed') -> Dict:
    return {'type': 'message', 'id': f'msg_{uuid.uuid4().hex[:20]}',
            'role': 'assistant', 'status': status,
            'content': [{'type': 'output_text', 'text': text,
                         'annotations': []}]}


def _reasoning_item(text: str) -> Dict:
    return {'type': 'reasoning', 'id': f'rs_{uuid.uuid4().hex[:20]}',
            'summary': [], 'content': [{'type': 'reasoning_text',
                                        'text': text}]}


def _fc_item(call_id: str, name: str, arguments: str,
             status: str = 'completed') -> Dict:
    return {'type': 'function_call', 'id': f'fc_{uuid.uuid4().hex[:20]}',
            'call_id': call_id, 'name': name, 'arguments': arguments,
            'status': status}


def add_responses_routes(app, engine, model_name: str):
    from aiohttp import web

    from .parsers import format_tools_system
    from .stream_parser import StreamParser, resolve_parser

    store = ResponseStore()
    arch_cfg = getattr(getattr(engine, 'engine', None), 'configs', None)
    arch = getattr(getattr(arch_cfg, 'model', None), 'hf_arch', None)

    async def responses(request):
        try:
            body = await request.json()
        except Exception as e:  # noqa: BLE001
            return web.json_response(
                {'error': {'type': 'invalid_request_error', 'message': str(e)}},
                status=400)
        if 'input' not in body:
            return web.json_response(
                {'error': {'type': 'invalid_request_error',
                           'message': 'input is required'}}, status=400)
        prior = None
        prev_id = body.get('previous_response_id')
        if prev_id:
            prior = store.get(prev_id)
            if prior is None:
                return web.json_response(
                    {'error': {'type': 'invalid_request_error',
                               'message': f'previous response {prev_id!r} '
                                          'not found'}}, status=404)
        messages = _to_messages(body, prior)
        tools = _chat_tools(body)
        send_messages = messages
        if tools:
            send_messages = ([{'role': 'system',
                               'content': format_tools_system(tools)}]
                             + list(messages))
        gen_config = _gen_config(body)
        session_id = engine.next_session_id()
        rid = f'resp_{uuid.uuid4().hex[:24]}'
        sparser = StreamParser(resolve_parser(arch),
                               tools_enabled=bool(tools))

        def finalize_output(content, reasoning, calls) -> List[Dict]:
            output: List[Dict] = []
            if reasoning:
                output.append(_reasoning_item(reasoning))
            for c in calls:
                output.append(_fc_item(c['id'], c['name'], c['args']))
            if content or not output:
                output.append(_msg_item(content))
            return output

        def remember(output):
            if body.get('store', True):
                turn = []
                for item in output:
                    if item['type'] == 'message':
                        turn.append({'role': 'assistant',
                                     'content': _content_text(
                                         item['content'])})
                    elif item['type'] == 'function_call':
                        rendered = (
                            f'<tool_call>\n{{"name": '
                            f'{json.dumps(item["name"])}, "arguments": '
                            f'{item["arguments"] or "{}"}}}\n</tool_call>')
                        turn.append({'role': 'assistant', 'content': rendered,
                                     'tool_calls': [{
                                         'id': item['call_id'],
                                         'type': 'function',
                                         'function': {
                                             'name': item['name'],
                                             'arguments': item['arguments']}}]})
                store.put(rid, list(messages) + turn)

        if body.get('stream'):
            resp = web.StreamResponse(headers={
                'Content-Type': 'text/event-stream', 'Cache-Control': 'no-cache'})
            await resp.prepare(request)
            seq = 0

            async def send(event: str, data: Dict):
                nonlocal seq
                data = dict(data, sequence_number=seq)
                seq += 1
                await resp.write(f'event: {event}\ndata: '
                                 f'{json.dumps(data)}\n\n'.encode())

            await send('response.created', {
                'type': 'response.created',
                'response': _response_object(rid, model_name, [],
                                             'in_progress', 0, 0)})
            content = ''
            reasoning = ''
            calls: List[Dict] = []
            in_tok = out_tok = 0

            async def emit(events):
                nonlocal content, reasoning
                for ev in events:
                    if ev[0] == 'content':
                        content += ev[1]
                        await send('response.output_text.delta', {
                            'type': 'response.output_text.delta',
                            'delta': ev[1]})
                    elif ev[0] == 'reasoning':
                        reasoning += ev[1]
                        await send('response.reasoning_text.delta', {
                            'type': 'response.reasoning_text.delta',
                            'delta': ev[1]})
                    elif ev[0] == 'tool_name':
                        calls.append({'id': f'call_{uuid.uuid4().hex[:24]}',
                                      'name': ev[3], 'args': ''})
                        await send('response.output_item.added', {
                            'type': 'response.output_item.added',
                            'output_index': len(calls) - 1,
                            'item': _fc_item(calls[-1]['id'], ev[3], '',
                                             'in_progress')})
                    elif ev[0] == 'tool_args' and calls:
                        calls[-1]['args'] += ev[2]
                        await send('response.function_call_arguments.delta', {
                            'type': 'response.function_call_arguments.delta',
                            'output_index': len(calls) - 1,
                            'delta': ev[2]})

            async for out in engine.generate(send_messages, session_id,
                                             gen_config=gen_config):
                await emit(sparser.push(out.response))
                in_tok = out.input_token_len
                out_tok = out.generate_token_len
                if out.finish_reason is not None:
                    await emit(sparser.finish())
            output = finalize_output(content, reasoning, calls)
            remember(output)
            await send('response.completed', {
                'type': 'response.completed',
                'response': _response_object(rid, model_name, output,
                                             'completed', in_tok, out_tok)})
            await resp.write_eof()
            return resp

        content = ''
        reasoning = ''
        calls: List[Dict] = []
        in_tok = out_tok = 0

        def absorb(events):
            nonlocal content, reasoning
            for ev in events:
                if ev[0] == 'content':
                    content += ev[1]
                elif ev[0] == 'reasoning':
                    reasoning += ev[1]
                elif ev[0] == 'tool_name':
                    calls.append({'id': f'call_{uuid.uuid4().hex[:24]}',
                                  'name': ev[3], 'args': ''})
                elif ev[0] == 'tool_args' and calls:
                    calls[-1]['args'] += ev[2]

        async for out in engine.generate(send_messages, session_id,
                                         gen_config=gen_config):
            absorb(sparser.push(out.response))
            in_tok = out.input_token_len
            out_tok = out.generate_token_len
            if out.finish_reason is not None:
                absorb(sparser.finish())
        output = finalize_output(content, reasoning, calls)
        remember(output)
        return web.json_response(
            _response_object(rid, model_name, output, 'completed',
                             in_tok, out_tok))

    app.router.add_post('/v1/responses', responses)
