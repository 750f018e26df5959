"""Incremental (SSE-time) tool-call and reasoning parsing, per model family.

Port of ``lmdeploy_tpu/serve/stream_parser.py``: a host module, copied as it is.

Reference analog: ``lmdeploy/serve/parsers/response_parser.py`` (780 LoC) +
``parsers/tool_parser/*`` — the reference emits OpenAI ``tool_calls`` delta
frames *while streaming*; post-hoc parsing (``parsers.py``) cannot,
so agent clients that act on streamed tool-call deltas stalled until EOS.

Design: one generic marker state machine (TEXT / REASONING / TOOL) driven by
a per-family ``ParserSpec``; the payload grammar inside a tool block is a
pluggable decoder (json / xml-function / glm-kv / sep).  A partial marker at
the buffer tail is held back exactly like stop-word holdback, so markers
split across detokenizer increments never leak into content deltas.

Events pushed to the caller:
    ('content', text)                      assistant-visible delta
    ('reasoning', text)                    reasoning_content delta
    ('tool_name', index, id, name)         a tool call opened + name known
    ('tool_args', index, fragment)         incremental JSON-arguments text
"""
from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Event = Tuple  # ('content', str) | ('reasoning', str) | ('tool_name', int, str, str) | ('tool_args', int, str)


@dataclass(frozen=True)
class ParserSpec:
    name: str
    tool_open: Tuple[str, ...] = ('<tool_call>',)
    tool_close: Tuple[str, ...] = ('</tool_call>',)
    payload: str = 'json'                 # json | xml | kv | sep | harmony
    reasoning_open: Optional[str] = '<think>'
    reasoning_close: Optional[str] = '</think>'
    # sep payload (deepseek): name <sep> json-args
    sep: Optional[str] = None


REGISTRY: Dict[str, ParserSpec] = {}


def _register(spec: ParserSpec):
    REGISTRY[spec.name] = spec
    return spec


_register(ParserSpec('hermes'))           # qwen2.5/qwen3/internlm3 default
_register(ParserSpec(
    'internlm2',
    tool_open=('<|action_start|><|plugin|>',),
    tool_close=('<|action_end|>',)))
_register(ParserSpec(
    'llama3',
    tool_open=('<|python_tag|>',),
    tool_close=('<|eom_id|>', '<|eot_id|>'),
    reasoning_open=None, reasoning_close=None))
_register(ParserSpec(
    'qwen3coder',
    tool_open=('<function=',),            # name embedded in the open tag
    tool_close=('</function>',),
    payload='xml'))
_register(ParserSpec(
    'glm47',
    tool_open=('<tool_call>',),
    tool_close=('</tool_call>',),
    payload='kv'))
_register(ParserSpec(
    'deepseek_v3',
    tool_open=('<|tool▁call▁begin|>',),
    tool_close=('<|tool▁call▁end|>',),
    payload='sep', sep='<|tool▁sep|>'))
_register(ParserSpec('harmony', payload='harmony',
                     reasoning_open=None, reasoning_close=None))

# hf architecture -> parser family (per-family registry; reference:
# response_parser.py REGISTERED_PARSERS + cli --tool-call-parser)
ARCH_PARSERS = {
    'Qwen2ForCausalLM': 'hermes',
    'Qwen3ForCausalLM': 'hermes',
    'Qwen3MoeForCausalLM': 'hermes',
    'InternLM2ForCausalLM': 'internlm2',
    'InternLM3ForCausalLM': 'hermes',
    'LlamaForCausalLM': 'hermes',         # llama3 opt-in via --tool-call-parser
    'GptOssForCausalLM': 'harmony',
    'DeepseekV3ForCausalLM': 'deepseek_v3',
    'Glm4MoeForCausalLM': 'glm47',
}


def resolve_parser(arch: Optional[str], override: Optional[str] = None) -> ParserSpec:
    if override:
        return REGISTRY[override]
    return REGISTRY.get(ARCH_PARSERS.get(arch or '', 'hermes'), REGISTRY['hermes'])


def _call_id() -> str:
    return f'call_{uuid.uuid4().hex[:24]}'


class _JsonArgStreamer:
    """Incremental extraction of the ``arguments`` object from a tool-call
    JSON body: once ``"arguments"`` (or ``"parameters"``) and its opening
    brace are seen, raw fragments of the value stream out as they arrive."""

    KEY_RE = re.compile(r'"(?:arguments|parameters)"\s*:\s*')

    def __init__(self):
        self.name: Optional[str] = None
        self.args_started = False
        self.args_done = False
        self.depth = 0
        self.in_str = False
        self.esc = False
        self.emitted = 0               # chars of the args value emitted
        self.buf = ''

    def push(self, frag: str) -> List[Tuple[str, str]]:
        """Returns [('name', name)] and/or [('args', fragment)] events."""
        self.buf += frag
        out: List[Tuple[str, str]] = []
        if self.name is None:
            m = re.search(r'"name"\s*:\s*"((?:[^"\\]|\\.)*)"', self.buf)
            if m:
                self.name = json.loads(f'"{m.group(1)}"')
                out.append(('name', self.name))
        if not self.args_started:
            m = self.KEY_RE.search(self.buf)
            if m and m.end() < len(self.buf) and self.buf[m.end()] == '{':
                self.args_started = True
                self.emitted = m.end()
        if self.args_started and not self.args_done:
            i = self.emitted
            start = i
            while i < len(self.buf):
                c = self.buf[i]
                if self.in_str:
                    if self.esc:
                        self.esc = False
                    elif c == '\\':
                        self.esc = True
                    elif c == '"':
                        self.in_str = False
                elif c == '"':
                    self.in_str = True
                elif c == '{':
                    self.depth += 1
                elif c == '}':
                    self.depth -= 1
                    if self.depth == 0:
                        i += 1
                        self.args_done = True
                        break
                i += 1
            if i > start:
                out.append(('args', self.buf[start:i]))
                self.emitted = i
        return out

    def finalize(self) -> List[Tuple[str, str]]:
        """Close-out for payloads whose args never streamed (malformed or
        non-object arguments): emit whatever parses post-hoc."""
        out: List[Tuple[str, str]] = []
        if self.args_started:
            return out
        try:
            obj = json.loads(self.buf.strip())
        except json.JSONDecodeError:
            return out
        if self.name is None and 'name' in obj:
            self.name = obj['name']
            out.append(('name', self.name))
        args = obj.get('arguments', obj.get('parameters', {}))
        if not isinstance(args, str):
            args = json.dumps(args, ensure_ascii=False)
        out.append(('args', args))
        return out


def _xml_payload_to_args(body: str) -> Tuple[Optional[str], str]:
    """qwen3coder: ``name>\n<parameter=k>\nv\n</parameter>...`` (name is the
    remainder of the <function= open tag)."""
    name, _, rest = body.partition('>')
    params = {}
    for m in re.finditer(r'<parameter=([^>]+)>\n?(.*?)\n?</parameter>',
                         rest, re.DOTALL):
        params[m.group(1)] = m.group(2)
    return name.strip() or None, json.dumps(params, ensure_ascii=False)


def _kv_payload_to_args(body: str) -> Tuple[Optional[str], str]:
    """glm4.x: ``name\n<arg_key>k</arg_key><arg_value>v</arg_value>...``"""
    head = re.split(r'<arg_key>', body, 1)[0].strip()
    params = {}
    for m in re.finditer(r'<arg_key>(.*?)</arg_key>\s*<arg_value>(.*?)'
                         r'</arg_value>', body, re.DOTALL):
        params[m.group(1).strip()] = m.group(2).strip()
    return head or None, json.dumps(params, ensure_ascii=False)


def _sep_payload_to_args(body: str, sep: str) -> Tuple[Optional[str], str]:
    """deepseek: ``tool-kind<sep>name\n'''json\nargs\n'''`` (be liberal)."""
    parts = body.split(sep)
    name = parts[1].strip().splitlines()[0].strip() if len(parts) > 1 \
        else (parts[0].strip() or None)
    m = re.search(r'\{.*\}', body, re.DOTALL)
    args = m.group(0) if m else '{}'
    return name, args


class StreamParser:
    """Per-request incremental parser: feed detokenized text deltas, get
    typed events suitable for OpenAI SSE delta frames."""

    def __init__(self, spec: ParserSpec, tools_enabled: bool = True):
        self.spec = spec
        self.tools_enabled = tools_enabled
        self.state = 'text'
        self.buf = ''
        self.tool_index = -1
        self.tool_id = ''
        self.tool_buf = ''
        self._json: Optional[_JsonArgStreamer] = None
        self._name_emitted = False
        # markers that can open something from TEXT state
        self._openers: List[Tuple[str, str]] = []
        if spec.payload == 'harmony':
            self._openers.append(('<|channel|>', 'harmony'))
        else:
            if tools_enabled:
                for o in spec.tool_open:
                    self._openers.append((o, 'tool'))
            if spec.reasoning_open:
                self._openers.append((spec.reasoning_open, 'reasoning'))
        self._harmony_header = ''
        self._harmony_channel = None

    # -- helpers ------------------------------------------------------------------
    def _holdback(self, markers: List[str]) -> int:
        """Length of the buffer tail to hold (a proper prefix of a marker)."""
        hold = 0
        for mk in markers:
            for n in range(min(len(mk) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(mk[:n]):
                    hold = max(hold, n)
                    break
        return hold

    def push(self, delta: str) -> List[Event]:
        self.buf += delta
        out: List[Event] = []
        progressed = True
        while progressed:
            progressed = False
            if self.state == 'text':
                progressed = self._step_text(out)
            elif self.state == 'reasoning':
                progressed = self._step_region(
                    out, self.spec.reasoning_close, 'reasoning', 'text')
            elif self.state == 'tool':
                progressed = self._step_tool(out)
            elif self.state == 'harmony_header':
                progressed = self._step_harmony_header(out)
            elif self.state == 'harmony_body':
                progressed = self._step_harmony_body(out)
        return out

    def _emit_text(self, out: List[Event], text: str, kind: str = 'content'):
        if text:
            out.append((kind, text))

    def _step_text(self, out) -> bool:
        first = None
        for mk, target in self._openers:
            i = self.buf.find(mk)
            if i >= 0 and (first is None or i < first[0]):
                first = (i, mk, target)
        if first is None:
            hold = self._holdback([m for m, _ in self._openers])
            emit = self.buf[:len(self.buf) - hold]
            self.buf = self.buf[len(self.buf) - hold:]
            self._emit_text(out, emit)
            return False
        i, mk, target = first
        self._emit_text(out, self.buf[:i])
        self.buf = self.buf[i + len(mk):]
        if target == 'tool':
            self.state = 'tool'
            self.tool_index += 1
            self.tool_id = _call_id()
            self.tool_buf = '' if self.spec.payload != 'xml' else ''
            self._json = _JsonArgStreamer() if self.spec.payload == 'json' \
                else None
            self._name_emitted = False
        elif target == 'reasoning':
            self.state = 'reasoning'
        elif target == 'harmony':
            self.state = 'harmony_header'
            self._harmony_header = ''
        return True

    def _step_region(self, out, close: Optional[str], kind: str,
                     next_state: str) -> bool:
        if close is None:
            self._emit_text(out, self.buf, kind)
            self.buf = ''
            return False
        i = self.buf.find(close)
        if i < 0:
            hold = self._holdback([close])
            emit = self.buf[:len(self.buf) - hold]
            self.buf = self.buf[len(self.buf) - hold:]
            self._emit_text(out, emit, kind)
            return False
        self._emit_text(out, self.buf[:i], kind)
        self.buf = self.buf[i + len(close):]
        self.state = next_state
        return True

    def _tool_events(self, pairs, out):
        for k, v in pairs:
            if k == 'name' and not self._name_emitted:
                self._name_emitted = True
                out.append(('tool_name', self.tool_index, self.tool_id, v))
            elif k == 'args':
                out.append(('tool_args', self.tool_index, v))

    def _step_tool(self, out) -> bool:
        i = -1
        close = ''
        for c in self.spec.tool_close:
            j = self.buf.find(c)
            if j >= 0 and (i < 0 or j < i):
                i, close = j, c
        chunk = self.buf if i < 0 else self.buf[:i]
        if i < 0:
            hold = self._holdback(list(self.spec.tool_close))
            chunk = self.buf[:len(self.buf) - hold]
            self.buf = self.buf[len(self.buf) - hold:]
        else:
            self.buf = self.buf[i + len(close):]
        self.tool_buf += chunk
        if self._json is not None and chunk:
            self._tool_events(self._json.push(chunk), out)
        if i < 0:
            return False
        # block closed: finalize payload
        self._finalize_tool(out)
        self.state = 'text'
        return True

    def _finalize_tool(self, out):
        spec = self.spec
        if self._json is not None:
            self._tool_events(self._json.finalize(), out)
            self._json = None
            return
        if spec.payload == 'xml':
            name, args = _xml_payload_to_args(self.tool_buf)
        elif spec.payload == 'kv':
            name, args = _kv_payload_to_args(self.tool_buf)
        elif spec.payload == 'sep':
            name, args = _sep_payload_to_args(self.tool_buf, spec.sep or '')
        else:
            name, args = None, '{}'
        if name:
            self._tool_events([('name', name), ('args', args)], out)

    # -- harmony (gpt-oss channels) ------------------------------------------------
    def _step_harmony_header(self, out) -> bool:
        i = self.buf.find('<|message|>')
        if i < 0:
            return False
        self._harmony_header = self.buf[:i].strip()
        self.buf = self.buf[i + len('<|message|>'):]
        header = self._harmony_header
        to = re.search(r'to=(?:functions\.)?([\w.\-]+)', header)
        if to is not None:
            self.tool_index += 1
            self.tool_id = _call_id()
            self.tool_buf = ''
            self._name_emitted = False
            self._harmony_channel = 'tool'
            out.append(('tool_name', self.tool_index, self.tool_id,
                        to.group(1)))
        elif header.split() and header.split()[0].startswith('analysis'):
            self._harmony_channel = 'reasoning'
        else:
            self._harmony_channel = 'content'
        self.state = 'harmony_body'
        return True

    def _step_harmony_body(self, out) -> bool:
        ends = ['<|end|>', '<|call|>', '<|return|>', '<|channel|>']
        i = -1
        end = ''
        for e in ends:
            j = self.buf.find(e)
            if j >= 0 and (i < 0 or j < i):
                i, end = j, e
        chunk = self.buf if i < 0 else self.buf[:i]
        if i < 0:
            hold = self._holdback(ends)
            chunk = self.buf[:len(self.buf) - hold]
            self.buf = self.buf[len(self.buf) - hold:]
        else:
            self.buf = self.buf[i + (0 if end == '<|channel|>' else len(end)):]
        if chunk:
            if self._harmony_channel == 'tool':
                self.tool_buf += chunk
                out.append(('tool_args', self.tool_index, chunk))
            elif self._harmony_channel == 'reasoning':
                out.append(('reasoning', chunk))
            else:
                out.append(('content', chunk))
        if i < 0:
            return False
        self.state = 'text' if end != '<|channel|>' else 'harmony_header'
        if end == '<|channel|>':
            # _step_text would re-find the marker; jump straight to header
            self._harmony_header = ''
        return True

    def finish(self) -> List[Event]:
        """Flush held-back text and close any open block (length-capped)."""
        out: List[Event] = []
        if self.state == 'text':
            self._emit_text(out, self.buf)
        elif self.state == 'reasoning':
            self._emit_text(out, self.buf, 'reasoning')
        elif self.state == 'tool':
            self.tool_buf += self.buf
            if self._json is not None:
                self._tool_events(self._json.push(self.buf), out)
            self._finalize_tool(out)
        elif self.state == 'harmony_body':
            if self.buf:
                kind = {'tool': None, 'reasoning': 'reasoning'}.get(
                    self._harmony_channel, 'content')
                if kind:
                    self._emit_text(out, self.buf, kind)
                elif self._harmony_channel == 'tool':
                    out.append(('tool_args', self.tool_index, self.buf))
        self.buf = ''
        return out

    @property
    def saw_tool_call(self) -> bool:
        return self.tool_index >= 0
