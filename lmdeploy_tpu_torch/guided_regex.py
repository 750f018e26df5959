"""Regex-constrained guided decoding: pattern → character NFA → token masks.

A copy of ``lmdeploy_tpu/guided_regex.py`` (host-only Python and numpy): the port keeps its own
so that it never imports the JAX package.  The class-level caches are the
reference's, keyed the same way.

Reference analog: ``lmdeploy/serve/openai/protocol.py:131-134`` (the
``regex_schema`` response format) compiled through xgrammar in
``lmdeploy/pytorch/engine/guided_process.py:78``.  xgrammar is unavailable in
this environment, so this module compiles a practical regex subset via
Thompson construction into an NFA whose *frontier* (epsilon-closed state set)
advances one character at a time — the same frontier/cached-mask interface as
guided.JsonGuide / guided_schema.SchemaGuide, so the engine's guided path is
shared.

Full-match semantics (the generation must match the whole pattern; ``^``/``$``
at the ends are accepted as no-ops).  Supported syntax:
  literals, ``.``, escapes (``\\d \\D \\w \\W \\s \\S`` + literal escapes),
  classes ``[a-z0-9_]`` / ``[^...]``, groups ``(...)`` / ``(?:...)``,
  alternation ``|``, quantifiers ``* + ?`` and ``{m} {m,} {m,n}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_DIGITS = ((ord('0'), ord('9')),)
_WORD = ((ord('0'), ord('9')), (ord('A'), ord('Z')), (ord('a'), ord('z')),
         (ord('_'), ord('_')))
_SPACE = tuple((ord(c), ord(c)) for c in ' \t\n\r\f\v')

_MAX_STATES = 20000


class RegexError(ValueError):
    pass


# ---------------------------------------------------------------------------
# parser: pattern -> AST
# ---------------------------------------------------------------------------

def _parse(pattern: str):
    pos = 0
    n = len(pattern)

    def peek():
        return pattern[pos] if pos < n else ''

    def take():
        nonlocal pos
        c = pattern[pos]
        pos += 1
        return c

    def parse_alt(depth):
        branches = [parse_cat(depth)]
        while peek() == '|':
            take()
            branches.append(parse_cat(depth))
        node = branches[0]
        for b in branches[1:]:
            node = ('alt', node, b)
        return node

    def parse_cat(depth):
        items = []
        while pos < n and peek() not in '|)':
            items.append(parse_rep(depth))
        if not items:
            return ('empty',)
        node = items[0]
        for it in items[1:]:
            node = ('cat', node, it)
        return node

    def parse_rep(depth):
        nonlocal pos
        node = parse_atom(depth)
        while pos < n and peek() in '*+?{':
            c = peek()
            if c == '{':
                save = pos
                take()
                m = ''
                while peek().isdigit():
                    m += take()
                if m == '':
                    pos = save            # a literal '{'
                    break
                if peek() == '}':
                    take()
                    node = ('rep', node, int(m), int(m))
                elif peek() == ',':
                    take()
                    k = ''
                    while peek().isdigit():
                        k += take()
                    if peek() != '}':
                        raise RegexError(f'bad {{m,n}} at {save}')
                    take()
                    node = ('rep', node, int(m), int(k) if k else None)
                else:
                    raise RegexError(f'bad {{...}} at {save}')
            else:
                take()
                node = {'*': ('star', node), '+': ('plus', node),
                        '?': ('opt', node)}[c]
        return node

    def parse_class():
        neg = False
        if peek() == '^':
            take()
            neg = True
        ranges = []
        if peek() == ']':               # literal ] first in class
            take()
            ranges.append((ord(']'), ord(']')))
        while pos < n and peek() != ']':
            c = take()
            if c == '\\':
                esc = take()
                sub = _escape_ranges(esc)
                if sub is not None:
                    ranges.extend(sub[0])
                    continue
                c = _escape_char(esc)
            lo = ord(c)
            if peek() == '-' and pos + 1 < n and pattern[pos + 1] != ']':
                take()
                hi = take()
                if hi == '\\':
                    hi = _escape_char(take())
                ranges.append((lo, ord(hi)))
            else:
                ranges.append((lo, lo))
        if pos >= n:
            raise RegexError('unterminated [...] class')
        take()
        return ('class', tuple(ranges), neg)

    def parse_atom(depth):
        nonlocal pos
        c = take()
        if c == '(':
            if peek() == '?':
                take()
                if peek() == ':':
                    take()
                else:
                    raise RegexError('only (?:...) groups supported')
            node = parse_alt(depth + 1)
            if peek() != ')':
                raise RegexError('unbalanced (')
            take()
            return node
        if c == '[':
            return parse_class()
        if c == '.':
            return ('any',)
        if c == '\\':
            esc = take() if pos < n else ''
            sub = _escape_ranges(esc)
            if sub is not None:
                return ('class', sub[0], sub[1])
            return ('char', _escape_char(esc))
        if c == '^' and pos == 1:
            return ('empty',)             # full-match anchor: no-op
        if c == '$' and pos == n:
            return ('empty',)
        if c in '*+?':
            raise RegexError(f'dangling quantifier {c!r}')
        return ('char', c)

    node = parse_alt(0)
    if pos != n:
        raise RegexError(f'unexpected {pattern[pos]!r} at {pos}')
    return node


def _escape_ranges(esc: str):
    """Class-escape -> (ranges, negated) or None for literal escapes."""
    return {'d': (_DIGITS, False), 'D': (_DIGITS, True),
            'w': (_WORD, False), 'W': (_WORD, True),
            's': (_SPACE, False), 'S': (_SPACE, True)}.get(esc)


def _escape_char(esc: str) -> str:
    return {'n': '\n', 't': '\t', 'r': '\r', 'f': '\f', 'v': '\v',
            '0': '\0', 'a': '\a', 'b': '\b'}.get(esc, esc)


# ---------------------------------------------------------------------------
# Thompson NFA
# ---------------------------------------------------------------------------

class _NFA:
    """states: list of edge lists; edge = (matcher, target).
    matcher None = epsilon; ('any',); ('char', c); ('class', ranges, neg)."""

    def __init__(self):
        self.edges: List[List[Tuple[Optional[tuple], int]]] = []

    def new_state(self) -> int:
        if len(self.edges) >= _MAX_STATES:
            raise RegexError('regex too large to compile')
        self.edges.append([])
        return len(self.edges) - 1

    def add(self, src: int, matcher, dst: int):
        self.edges[src].append((matcher, dst))


def _build(nfa: _NFA, node) -> Tuple[int, int]:
    """Return (start, accept) fragment for an AST node."""
    kind = node[0]
    if kind == 'empty':
        s = nfa.new_state()
        return s, s
    if kind in ('char', 'any', 'class'):
        s, a = nfa.new_state(), nfa.new_state()
        matcher = node if kind != 'char' else ('char', node[1])
        nfa.add(s, matcher, a)
        return s, a
    if kind == 'cat':
        s1, a1 = _build(nfa, node[1])
        s2, a2 = _build(nfa, node[2])
        nfa.add(a1, None, s2)
        return s1, a2
    if kind == 'alt':
        s, a = nfa.new_state(), nfa.new_state()
        for sub in (node[1], node[2]):
            ss, aa = _build(nfa, sub)
            nfa.add(s, None, ss)
            nfa.add(aa, None, a)
        return s, a
    if kind == 'star':
        s, a = nfa.new_state(), nfa.new_state()
        ss, aa = _build(nfa, node[1])
        nfa.add(s, None, ss)
        nfa.add(s, None, a)
        nfa.add(aa, None, ss)
        nfa.add(aa, None, a)
        return s, a
    if kind == 'plus':
        return _build(nfa, ('cat', node[1], ('star', node[1])))
    if kind == 'opt':
        s, a = nfa.new_state(), nfa.new_state()
        ss, aa = _build(nfa, node[1])
        nfa.add(s, None, ss)
        nfa.add(aa, None, a)
        nfa.add(s, None, a)
        return s, a
    if kind == 'rep':
        _, sub, m, mx = node
        parts = [sub] * m
        if mx is None:
            parts.append(('star', sub))
        else:
            if mx < m:
                raise RegexError('{m,n} with n < m')
            parts.extend([('opt', sub)] * (mx - m))
        if not parts:
            return _build(nfa, ('empty',))
        ast = parts[0]
        for p in parts[1:]:
            ast = ('cat', ast, p)
        return _build(nfa, ast)
    raise RegexError(f'unknown AST node {kind}')


def _matches(matcher, ch: str) -> bool:
    if matcher[0] == 'any':
        return ch != '\n'
    if matcher[0] == 'char':
        return ch == matcher[1]
    ranges, neg = matcher[1], matcher[2]
    o = ord(ch)
    hit = any(lo <= o <= hi for lo, hi in ranges)
    return hit != neg


class RegexGuide:
    """Per-request regex-guided decoding; same interface as JsonGuide."""

    _mask_cache: Dict[Tuple, np.ndarray] = {}

    def __init__(self, tokenizer, vocab_size: int, eos_token_ids,
                 pattern: str):
        from .guided import JsonGuide
        self.vocab_size = vocab_size
        if isinstance(eos_token_ids, int):
            eos_token_ids = [eos_token_ids]
        self.eos_token_ids = [t for t in eos_token_ids
                              if 0 <= t < vocab_size]
        self.pattern = pattern
        self.nfa = _NFA()
        start, accept = _build(self.nfa, _parse(pattern))
        self.accept = accept
        self.tokens = JsonGuide._token_strings(tokenizer, vocab_size)
        self.frontier = self._closure(frozenset([start]))
        self.dead = False

    def _closure(self, states: frozenset) -> frozenset:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for matcher, dst in self.nfa.edges[s]:
                if matcher is None and dst not in out:
                    out.add(dst)
                    stack.append(dst)
        return frozenset(out)

    def _advance_frontier(self, frontier: frozenset, text: str) -> frozenset:
        for ch in text:
            nxt = set()
            for s in frontier:
                for matcher, dst in self.nfa.edges[s]:
                    if matcher is not None and _matches(matcher, ch):
                        nxt.add(dst)
            if not nxt:
                return frozenset()
            frontier = self._closure(frozenset(nxt))
        return frontier

    def _is_complete(self) -> bool:
        return self.accept in self.frontier

    # -- JsonGuide-compatible interface --------------------------------------

    def allowed_mask(self) -> np.ndarray:
        cache_key = (self.pattern, id(self.tokens), self.frontier)
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
        if self._is_complete() or not mask.any():
            for t in self.eos_token_ids:
                mask[t] = True
        return mask

    def accept_token(self, token_id: int) -> bool:
        if token_id in self.eos_token_ids:
            self.dead = True
            self.frontier = frozenset()
            return True
        text = self.tokens[token_id] if 0 <= token_id < self.vocab_size else ''
        if not text:
            return True
        nxt = self._advance_frontier(self.frontier, text)
        if not nxt:
            return False
        self.frontier = nxt
        return True
