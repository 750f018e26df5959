"""Guided decoding: JSON-mode token masking via a character-level pushdown automaton.

A copy of ``lmdeploy_tpu/guided.py`` (host-only Python and numpy): the port keeps its own
so that it never imports the JAX package.  The class-level caches are the
reference's, keyed the same way.

Reference analog: ``lmdeploy/pytorch/engine/guided_process.py`` (xgrammar matcher
pool) and the token-bitmask application in FusedLogitsProcessor.  xgrammar is not
available in this environment, so the framework carries a native JSON PDA: a token
is permitted iff feeding its decoded characters through the automaton stays valid.
Vocab masks are cached per automaton state (states repeat heavily — e.g. one
"inside string" state covers most of generation), so the O(V * len) scan runs once
per distinct state.

Scope: ``response_format={'type': 'json_object'}`` (any valid JSON value at top
level, object-first like the reference).  Schema-constrained JSON and regex
grammars extend the same machinery.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# PDA modes
VALUE = 0          # expecting start of a value
IN_STRING = 1
STR_ESCAPE = 2
IN_NUMBER = 3
AFTER_VALUE = 4    # value finished; expect , } ] or EOF (if stack empty)
OBJ_KEY = 5        # expecting a key string or }
OBJ_COLON = 6
OBJ_COMMA_OR_END = 7
ARR_COMMA_OR_END = 8
IN_LITERAL = 9     # true/false/null partial
DONE = 10

_LITERALS = ('true', 'false', 'null')
_WS = ' \t\n\r'
_NUM_START = '-0123456789'
_NUM_CHARS = '0123456789.eE+-'


class JsonState:
    """Immutable-ish PDA state: (mode, stack of '{'/'[' chars, literal progress)."""

    __slots__ = ('mode', 'stack', 'lit')

    def __init__(self, mode=VALUE, stack=(), lit=''):
        self.mode = mode
        self.stack = stack
        self.lit = lit

    def key(self) -> Tuple:
        return (self.mode, self.stack, self.lit)

    def clone(self):
        return JsonState(self.mode, self.stack, self.lit)


def _advance_char(st: JsonState, ch: str) -> Optional[JsonState]:
    """One character transition; returns None when invalid."""
    m = st.mode
    if m == DONE:
        return None
    if m == IN_STRING:
        if ch == '"':
            return _close_value(st)
        if ch == '\\':
            return JsonState(STR_ESCAPE, st.stack, '')
        if ord(ch) < 0x20:
            return None
        return st
    if m == STR_ESCAPE:
        if ch in '"\\/bfnrtu':
            return JsonState(IN_STRING, st.stack, '')
        return None
    if m == IN_NUMBER:
        if ch in _NUM_CHARS:
            return st
        # number ended; the char must be valid in AFTER_VALUE context
        return _advance_char(_close_value(st), ch)
    if m == IN_LITERAL:
        lit = st.lit + ch
        if any(word.startswith(lit) for word in _LITERALS):
            if lit in _LITERALS:
                return _close_value(JsonState(IN_LITERAL, st.stack, ''))
            return JsonState(IN_LITERAL, st.stack, lit)
        return None

    if ch in _WS:
        return st

    if m == VALUE:
        return _start_value(st, ch)
    if m == OBJ_KEY:
        if ch == '"':
            return JsonState(IN_STRING, st.stack + ('k',), '')
        if ch == '}' and st.stack and st.stack[-1] == '{':
            return _close_value(JsonState(AFTER_VALUE, st.stack[:-1], ''),
                                already_closed=True)
        return None
    if m == OBJ_COLON:
        if ch == ':':
            return JsonState(VALUE, st.stack, '')
        return None
    if m == AFTER_VALUE:
        if not st.stack:
            return None                      # top-level value complete: only WS/EOF
        top = st.stack[-1]
        if ch == ',':
            if top == '{':
                return JsonState(OBJ_KEY, st.stack, '')
            return JsonState(VALUE, st.stack, '')
        if ch == '}' and top == '{':
            return _close_value(JsonState(AFTER_VALUE, st.stack[:-1], ''),
                                already_closed=True)
        if ch == ']' and top == '[':
            return _close_value(JsonState(AFTER_VALUE, st.stack[:-1], ''),
                                already_closed=True)
        return None
    return None


def _start_value(st: JsonState, ch: str) -> Optional[JsonState]:
    if ch == '"':
        return JsonState(IN_STRING, st.stack, '')
    if ch == '{':
        return JsonState(OBJ_KEY, st.stack + ('{',), '')
    if ch == '[':
        # empty array needs ']' allowed right away: use VALUE with a marker via
        # AFTER-style handling: treat as VALUE but allow ']' through _advance.
        return JsonState(VALUE, st.stack + ('[',), '')
    if ch == ']' and st.stack and st.stack[-1] == '[':
        # empty array close (only valid direct after '[')
        return _close_value(JsonState(AFTER_VALUE, st.stack[:-1], ''),
                            already_closed=True)
    if ch in _NUM_START:
        return JsonState(IN_NUMBER, st.stack, '')
    if ch in 'tfn':
        return JsonState(IN_LITERAL, st.stack, ch)
    return None


def _close_value(st: JsonState, already_closed: bool = False) -> JsonState:
    """A value (string/number/literal/closed container) just finished."""
    stack = st.stack
    if not already_closed and stack and stack[-1] == 'k':
        # closing a KEY string -> expect colon
        return JsonState(OBJ_COLON, stack[:-1], '')
    if not stack:
        return JsonState(AFTER_VALUE, (), '')
    return JsonState(AFTER_VALUE, stack, '')


def advance_string(st: JsonState, text: str) -> Optional[JsonState]:
    for ch in text:
        st = _advance_char(st, ch)
        if st is None:
            return None
    return st


def is_complete(st: JsonState) -> bool:
    """The emitted text so far is a complete top-level JSON value.

    A bare top-level number is treated as completable (its end is only known at
    EOF; '12' may still grow to '123' — both are valid stopping points).
    """
    if st.mode == AFTER_VALUE and not st.stack:
        return True
    return st.mode == IN_NUMBER and not st.stack


class JsonGuide:
    """Per-request guided-decoding state + vocab-mask computation."""

    _token_strings_cache: Dict[int, List[str]] = {}
    _mask_cache: Dict[Tuple, np.ndarray] = {}

    def __init__(self, tokenizer, vocab_size: int, eos_token_ids: List[int]):
        self.vocab_size = vocab_size
        self.eos_token_ids = [t for t in eos_token_ids if 0 <= t < vocab_size]
        self.state: Optional[JsonState] = JsonState()
        self.tokens = self._token_strings(tokenizer, vocab_size)

    @classmethod
    def _token_strings(cls, tokenizer, vocab_size: int) -> List[str]:
        key = id(getattr(tokenizer, 'model', tokenizer))
        cached = cls._token_strings_cache.get(key)
        if cached is None:
            model = getattr(tokenizer, 'model', tokenizer)
            cached = [model.decode([i]) for i in range(vocab_size)]
            cls._token_strings_cache[key] = cached
        return cached

    def allowed_mask(self) -> np.ndarray:
        """bool[V]: True = token permitted in the current state."""
        st = self.state
        cache_key = (id(self.tokens), st.key())
        mask = self._mask_cache.get(cache_key)
        if mask is None:
            mask = np.zeros(self.vocab_size, dtype=bool)
            for tid, text in enumerate(self.tokens):
                if not text:
                    continue
                if advance_string(st, text) is not None:
                    mask[tid] = True
            self._mask_cache[cache_key] = mask
        mask = mask.copy()
        if is_complete(st):
            for t in self.eos_token_ids:
                mask[t] = True
        elif not mask.any():
            # dead end (shouldn't happen with valid JSON grammar): allow eos
            for t in self.eos_token_ids:
                mask[t] = True
        return mask

    def accept_token(self, token_id: int) -> bool:
        if token_id in self.eos_token_ids:
            self.state = JsonState(DONE, (), '')
            return True
        text = self.tokens[token_id] if 0 <= token_id < self.vocab_size else ''
        nxt = advance_string(self.state, text) if text else self.state
        if nxt is None:
            return False
        self.state = nxt
        return True
