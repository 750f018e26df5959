"""Response parsers: tool calls and reasoning splitting.

Port of ``lmdeploy_tpu/serve/parsers.py``: a host module, copied as it is.

Reference analog: ``lmdeploy/serve/parsers/`` (response_parser.py, 780 LoC —
tool-call and reasoning parsers per model family incl. gpt-oss Harmony).
Coverage: the hermes/qwen ``<tool_call>{json}</tool_call>`` convention
(also used by internlm2 with <|action_start|> markers) and ``<think>…</think>``
reasoning extraction (qwen3/deepseek-r1 style).
"""
from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_TOOL_RE = re.compile(r'<tool_call>\s*(.*?)\s*</tool_call>', re.DOTALL)
_ACTION_RE = re.compile(r'<\|action_start\|><\|plugin\|>\s*(.*?)\s*<\|action_end\|>',
                        re.DOTALL)
_THINK_RE = re.compile(r'<think>(.*?)</think>', re.DOTALL)


@dataclass
class ToolCall:
    name: str
    arguments: str                     # JSON string (OpenAI wire format)
    id: str = field(default_factory=lambda: f'call_{uuid.uuid4().hex[:24]}')

    def to_openai(self) -> Dict:
        return {'id': self.id, 'type': 'function',
                'function': {'name': self.name, 'arguments': self.arguments}}


def parse_tool_calls(text: str) -> Tuple[str, List[ToolCall]]:
    """Extract tool-call blocks; returns (remaining_text, calls)."""
    calls: List[ToolCall] = []

    def consume(match):
        raw = match.group(1)
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError:
            return match.group(0)      # malformed: leave in text
        name = obj.get('name', '')
        args = obj.get('arguments', obj.get('parameters', {}))
        if not isinstance(args, str):
            args = json.dumps(args, ensure_ascii=False)
        calls.append(ToolCall(name=name, arguments=args))
        return ''

    text = _TOOL_RE.sub(consume, text)
    text = _ACTION_RE.sub(consume, text)
    return text.strip(), calls


def parse_reasoning(text: str) -> Tuple[Optional[str], str]:
    """Split <think> reasoning from the final answer.

    Returns (reasoning_content or None, content).  An unterminated <think> block
    (length-capped generation) counts entirely as reasoning.
    """
    m = _THINK_RE.search(text)
    if m:
        reasoning = m.group(1).strip()
        content = (text[:m.start()] + text[m.end():]).strip()
        return reasoning or None, content
    if '<think>' in text:
        head, _, tail = text.partition('<think>')
        return tail.strip() or None, head.strip()
    return None, text


_HARMONY_SEG = re.compile(
    r'<\|channel\|>(?P<header>.*?)<\|message\|>'
    r'(?P<body>.*?)(?:<\|end\|>|<\|call\|>|<\|return\|>|$)',
    re.DOTALL)
_HARMONY_TO = re.compile(r'to=(?:functions\.)?([\w.\-]+)')


def parse_harmony(text: str) -> Dict:
    """gpt-oss Harmony response format (reference: serve/parsers/_openai_harmony.py).

    Channels: ``analysis`` -> reasoning_content, ``final`` -> content,
    ``commentary to=functions.X`` -> tool call with the message body as JSON
    arguments.  Segment terminators: <|end|> (more follows), <|call|> (tool
    invocation), <|return|> (final answer done); an unterminated segment
    (length-capped generation) is kept.
    """
    reasoning_parts: List[str] = []
    content_parts: List[str] = []
    calls: List[ToolCall] = []
    for m in _HARMONY_SEG.finditer(text):
        header = m.group('header').strip()
        body = m.group('body')
        channel = header.split()[0] if header.split() else ''
        to = _HARMONY_TO.search(header)
        if to is not None:
            args = body.strip()
            try:
                json.loads(args)
            except json.JSONDecodeError:
                args = json.dumps({'raw': args}, ensure_ascii=False)
            calls.append(ToolCall(name=to.group(1), arguments=args))
        elif channel.startswith('analysis'):
            reasoning_parts.append(body.strip())
        else:                               # final / commentary without target
            content_parts.append(body.strip())
    if not (reasoning_parts or content_parts or calls):
        content_parts.append(text)
    return {'content': '\n'.join(p for p in content_parts if p),
            'reasoning_content': '\n'.join(reasoning_parts) or None,
            'tool_calls': [c.to_openai() for c in calls] or None}


def parse_response(text: str, enable_tools: bool = True,
                   enable_reasoning: bool = True) -> Dict:
    """Full pipeline -> {'content', 'reasoning_content', 'tool_calls'}."""
    if '<|channel|>' in text:
        return parse_harmony(text)
    reasoning = None
    if enable_reasoning:
        reasoning, text = parse_reasoning(text)
    calls: List[ToolCall] = []
    if enable_tools:
        text, calls = parse_tool_calls(text)
    return {'content': text,
            'reasoning_content': reasoning,
            'tool_calls': [c.to_openai() for c in calls] or None}


TOOLS_SYSTEM_TEMPLATE = (
    'You may call one or more functions to assist with the user query. '
    'You are provided with function signatures within <tools></tools> XML tags:\n'
    '<tools>\n{tools}\n</tools>\n'
    'For each function call, return a json object with function name and '
    'arguments within <tool_call></tool_call> XML tags:\n'
    '<tool_call>\n{{"name": <function-name>, "arguments": <args-json-object>}}\n'
    '</tool_call>')


def format_tools_system(tools) -> str:
    """Hermes-style tools system prompt (qwen convention)."""
    lines = [json.dumps(t.get('function', t), ensure_ascii=False) for t in tools]
    return TOOLS_SYSTEM_TEMPLATE.format(tools='\n'.join(lines))
