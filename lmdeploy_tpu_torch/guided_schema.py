"""Schema-constrained guided decoding: JSON-Schema → character-level automaton.

A copy of ``lmdeploy_tpu/guided_schema.py`` (host-only Python and numpy): the port keeps its own
so that it never imports the JAX package.  The class-level caches are the
reference's, keyed the same way.

Reference analog: ``lmdeploy/pytorch/engine/guided_process.py`` compiles
``json_schema`` response formats through xgrammar into a token bitmask applied
every step.  xgrammar is unavailable in this environment, so this module
compiles a practical JSON-Schema subset into a nondeterministic character
automaton: a *frontier* of states advances one character at a time, and a token
is permitted iff feeding its decoded characters keeps the frontier non-empty.
Vocab masks are cached per frontier key (frontiers repeat heavily during
generation, e.g. "inside a free-form string value").

Supported schema subset (matches what the serving layer's structured-output
users rely on):
  - ``type: object`` with ``properties`` (emitted in declared order),
    ``required`` (non-required properties may be skipped)
  - ``type: array`` with ``items``, ``minItems``/``maxItems``
  - ``type: string`` (free string; ``enum``/``const`` restrict to literals)
  - ``type: number`` / ``integer`` / ``boolean`` / ``null``
  - ``enum`` / ``const`` of arbitrary JSON values
  - ``anyOf`` / ``oneOf`` unions
  - missing/unknown ``type``: any JSON value (falls back to the generic PDA
    from :mod:`lmdeploy_tpu_torch.guided`)

State representation: an immutable tuple of frames; the LAST frame is active.
A frame completing pops itself (its parent was already advanced to its
post-child phase before the push), so "value finished" needs no upward
signalling.  Nondeterminism (optional properties, unions, enum prefixes,
number termination) branches the frontier.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from .guided import (AFTER_VALUE, IN_NUMBER, JsonState, _advance_char)

_WS = ' \t\n\r'
_NUM_CHARS = '0123456789.eE+-'
_INT_CHARS = '0123456789'
_ESCAPES = '"\\/bfnrtu'


# ---------------------------------------------------------------------------
# schema compilation: schema dict -> node table (ints reference nodes)
# ---------------------------------------------------------------------------

def compile_schema(schema: dict) -> List[dict]:
    """Flatten a schema into a node list; node 0 is the root."""
    nodes: List[dict] = []

    def add(sch) -> int:
        idx = len(nodes)
        nodes.append({})
        nodes[idx] = build(sch)
        return idx

    def build(sch) -> dict:
        if sch is True or sch is None or sch == {}:
            return {'kind': 'any'}
        if not isinstance(sch, dict):
            return {'kind': 'any'}
        if '$ref' in sch:
            # only self-rooted refs ('#' / '#/') are representable without a
            # resolver; anything else degrades to unconstrained JSON
            return {'kind': 'root'} if sch['$ref'].rstrip('/') in ('#',) \
                else {'kind': 'any'}
        if 'const' in sch:
            return {'kind': 'enum',
                    'literals': (json.dumps(sch['const'],
                                            separators=(',', ':')),)}
        if 'enum' in sch:
            return {'kind': 'enum',
                    'literals': tuple(json.dumps(v, separators=(',', ':'))
                                      for v in sch['enum'])}
        for key in ('anyOf', 'oneOf'):
            if key in sch:
                return {'kind': 'union',
                        'options': tuple(add(o) for o in sch[key])}
        t = sch.get('type')
        if isinstance(t, list):
            return {'kind': 'union',
                    'options': tuple(add(dict(sch, type=tt)) for tt in t)}
        if t == 'object':
            props = sch.get('properties') or {}
            required = set(sch.get('required') or ())
            # draft-07 style: properties emitted in declared order; without
            # declared properties it is a free-form object
            if not props:
                return {'kind': 'any'}
            return {'kind': 'object',
                    'props': tuple((name, add(psch), name in required)
                                   for name, psch in props.items())}
        if t == 'array':
            return {'kind': 'array',
                    'items': add(sch.get('items', True)),
                    'min': int(sch.get('minItems', 0)),
                    'max': sch.get('maxItems')}
        if t == 'string':
            return {'kind': 'string'}
        if t == 'integer':
            return {'kind': 'integer'}
        if t == 'number':
            return {'kind': 'number'}
        if t == 'boolean':
            return {'kind': 'enum', 'literals': ('true', 'false')}
        if t == 'null':
            return {'kind': 'enum', 'literals': ('null',)}
        return {'kind': 'any'}

    add(schema)
    return nodes


# ---------------------------------------------------------------------------
# the automaton
# ---------------------------------------------------------------------------
# Frames (immutable tuples; last frame of the state tuple is active):
#   ('val', node_id)                      expecting start of this node's value
#   ('obj', node_id, idx, phase)          phase: 'key' | 'colon' | 'after'
#   ('keylit', node_id, idx, pos)         inside the key string of prop idx
#   ('arr', node_id, count, phase)        phase: 'first' | 'after'
#   ('str', esc)                          free string body; esc: bool
#   ('num', allowed_chars)                number body (already started)
#   ('enum', suffixes)                    literal candidates, remaining text
#   ('free', mode, stack)                 generic JSON value (guided.py PDA)

class SchemaGuide:
    """Per-request schema-guided decoding; same interface as JsonGuide."""

    _mask_cache: Dict[Tuple, np.ndarray] = {}

    def __init__(self, tokenizer, vocab_size: int, eos_token_ids, schema: dict):
        from .guided import JsonGuide
        self.vocab_size = vocab_size
        if isinstance(eos_token_ids, int):
            eos_token_ids = [eos_token_ids]
        self.eos_token_ids = [t for t in eos_token_ids if 0 <= t < vocab_size]
        self.nodes = compile_schema(schema)
        self.tokens = JsonGuide._token_strings(tokenizer, vocab_size)
        self._schema_key = json.dumps(schema, sort_keys=True)
        self.frontier: Tuple[Tuple, ...] = ((('val', 0),),)
        self.dead = False

    # -- state transitions ---------------------------------------------------

    def _start_value(self, state: Tuple, node_id: int, ch: str) -> List[Tuple]:
        """Dispatch the first char of node's value; state excludes the active
        ('val', node) frame (already removed)."""
        node = self.nodes[node_id]
        kind = node['kind']
        if kind == 'root':
            return self._start_value(state, 0, ch)
        if kind == 'union':
            out = []
            for opt in node['options']:
                out.extend(self._start_value(state, opt, ch))
            return out
        if kind == 'any':
            nxt = _advance_char(JsonState(), ch)
            if nxt is None:
                return []
            return self._free_norm(state, nxt)
        if kind == 'object':
            if ch == '{':
                return self._obj_key_entry(state, node_id, 0)
            return []
        if kind == 'array':
            if ch == '[':
                return [state + (('arr', node_id, 0, 'first'),)]
            return []
        if kind == 'string':
            return [state + (('str', False),)] if ch == '"' else []
        if kind in ('number', 'integer'):
            chars = _NUM_CHARS if kind == 'number' else _INT_CHARS
            if ch == '-' or ch in _INT_CHARS:
                return [state + (('num', chars),)]
            return []
        if kind == 'enum':
            suf = tuple(lit[1:] for lit in node['literals']
                        if lit and lit[0] == ch)
            return self._enum_norm(state, suf)
        return []

    def _enum_norm(self, state: Tuple, suffixes: Tuple[str, ...]) -> List[Tuple]:
        """Branch an enum frame: exhausted suffixes complete the value."""
        out = []
        live = tuple(s for s in suffixes if s)
        if any(s == '' for s in suffixes):
            out.append(state)             # literal complete -> frame popped
        if live:
            out.append(state + (('enum', live),))
        return out

    def _free_norm(self, state: Tuple, js: JsonState) -> List[Tuple]:
        """Wrap a generic-PDA state; a completed top-level value pops.

        IN_NUMBER at depth 0 is both continuable and completable, so both
        successors are produced (the pop branch is taken lazily when the next
        char only parses in the parent)."""
        out = []
        if js.mode == AFTER_VALUE and not js.stack:
            out.append(state)
        else:
            out.append(state + (('free', js.mode, js.stack, js.lit),))
        return out

    def _obj_key_entry(self, state: Tuple, node_id: int, idx: int) -> List[Tuple]:
        """States available when expecting the next object key from prop idx:
        any emittable property (skipping leading optionals) or '}' if the rest
        are optional — the actual char transition happens later; this only
        positions the frame."""
        return [state + (('obj', node_id, idx, 'key'),)]

    def _advance(self, state: Tuple, ch: str) -> List[Tuple]:
        """All successor states of `state` after consuming ch."""
        if not state:
            return []                     # complete: only EOS may follow
        frame = state[-1]
        parent = state[:-1]
        tag = frame[0]

        if tag == 'val':
            if ch in _WS:
                return [state]
            return self._start_value(parent, frame[1], ch)

        if tag == 'str':
            esc = frame[1]
            if esc:
                return [parent + (('str', False),)] if ch in _ESCAPES else []
            if ch == '"':
                return [parent]
            if ch == '\\':
                return [parent + (('str', True),)]
            if ord(ch) < 0x20:
                return []
            return [state]

        if tag == 'num':
            out = []
            if ch in frame[1]:
                out.append(state)
            # number may terminate here; re-advance ch in the parent context
            out.extend(self._advance(parent, ch))
            return out

        if tag == 'enum':
            suf = tuple(s[1:] for s in frame[1] if s and s[0] == ch)
            return self._enum_norm(parent, suf)

        if tag == 'free':
            js = _advance_char(JsonState(frame[1], frame[2], frame[3]), ch)
            if js is None:
                # an IN_NUMBER top-level free value also completes on a
                # boundary char: handled via AFTER_VALUE transition inside
                # the PDA (non-empty stack) — at empty stack nothing follows
                # a complete value except WS, which the PDA accepts.
                if frame[1] == IN_NUMBER and not frame[2]:
                    return self._advance(parent, ch)
                return []
            return self._free_norm(parent, js)

        if tag == 'obj':
            node_id, idx, phase = frame[1], frame[2], frame[3]
            props = self.nodes[node_id]['props']
            if ch in _WS:
                return [state]
            if phase == 'key':
                out = []
                if ch == '"':
                    # choose any property >= idx whose predecessors are all
                    # optional
                    j = idx
                    while j < len(props):
                        out.append(parent + (('keylit', node_id, j, 0),))
                        if props[j][2]:   # required: cannot skip past it
                            break
                        j += 1
                elif ch == '}' and all(not p[2] for p in props[idx:]):
                    out.append(parent)    # object complete
                return out
            if phase == 'colon':
                if ch == ':':
                    nxt = parent + (('obj', node_id, idx + 1, 'after'),)
                    return [nxt + (('val', props[idx][1]),)]
                return []
            if phase == 'after':
                out = []
                if ch == ',' and idx < len(props):
                    out.append(parent + (('obj', node_id, idx, 'key'),))
                elif ch == '}' and all(not p[2] for p in props[idx:]):
                    out.append(parent)
                return out
            return []

        if tag == 'keylit':
            node_id, idx, pos = frame[1], frame[2], frame[3]
            name = self.nodes[node_id]['props'][idx][0]
            if pos < len(name):
                if ch == name[pos]:
                    return [state[:-1] + (('keylit', node_id, idx, pos + 1),)]
                return []
            if ch == '"':
                return [state[:-1] + (('obj', node_id, idx, 'colon'),)]
            return []

        if tag == 'arr':
            node_id, count, phase = frame[1], frame[2], frame[3]
            node = self.nodes[node_id]
            if ch in _WS:
                return [state]
            if phase == 'first':
                out = []
                if ch == ']' and node['min'] == 0:
                    out.append(parent)
                if node['max'] is None or node['max'] > 0:
                    nxt = parent + (('arr', node_id, 1, 'after'),)
                    out.extend(self._advance(nxt + (('val', node['items']),),
                                             ch) if ch not in _WS else [])
                return out
            if phase == 'after':
                out = []
                if ch == ',' and (node['max'] is None or count < node['max']):
                    nxt = parent + (('arr', node_id, count + 1, 'after'),)
                    out.append(nxt + (('val', node['items']),))
                if ch == ']' and count >= node['min']:
                    out.append(parent)
                return out
            return []

        return []

    # -- frontier ops --------------------------------------------------------

    def _advance_frontier(self, frontier, text: str):
        for ch in text:
            nxt = []
            seen = set()
            for st in frontier:
                for s in self._advance(st, ch):
                    if s not in seen:
                        seen.add(s)
                        nxt.append(s)
            frontier = tuple(nxt)
            if not frontier:
                return ()
        return frontier

    def _is_complete(self) -> bool:
        for st in self.frontier:
            if not st:
                return True
            if len(st) == 1 and st[-1][0] == 'num':
                return True
            if len(st) == 1 and st[-1][0] == 'free' \
                    and st[-1][1] == IN_NUMBER and not st[-1][2]:
                return True
        return False

    # -- JsonGuide-compatible interface --------------------------------------

    def allowed_mask(self) -> np.ndarray:
        cache_key = (self._schema_key, id(self.tokens), self.frontier)
        mask = self._mask_cache.get(cache_key)
        if mask is None:
            mask = np.zeros(self.vocab_size, dtype=bool)
            for tid, text in enumerate(self.tokens):
                if not text:
                    continue
                if self._advance_frontier(self.frontier, text):
                    mask[tid] = True
            self._mask_cache[cache_key] = mask
        mask = mask.copy()
        if self._is_complete():
            for t in self.eos_token_ids:
                mask[t] = True
        elif not mask.any():
            for t in self.eos_token_ids:
                mask[t] = True
        return mask

    def accept_token(self, token_id: int) -> bool:
        if token_id in self.eos_token_ids:
            self.dead = True
            self.frontier = ()
            return True
        text = self.tokens[token_id] if 0 <= token_id < self.vocab_size else ''
        if not text:
            return True
        nxt = self._advance_frontier(self.frontier, text)
        if not nxt:
            return False
        self.frontier = nxt
        return True
