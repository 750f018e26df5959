"""The port's guided-decoding grammars (``lmdeploy_tpu_torch/guided*.py``) against the
reference's (``lmdeploy_tpu/guided*.py``), host-only numpy on both sides.

On the tiny test tokenizer, along seeded token walks that mix legal and illegal
tokens, each step's ``allowed_mask()`` must equal the reference's bit for bit, and so
must ``accept_token``'s decisions and completeness.  The semantic cases of the
reference's test_guided.py, test_guided_regex.py and test_guided_schema.py are mirrored
as parametrised cases, each checked on both packages.  The sampler takes a guided row's
mask as its ``bad_words_mask``: the masks and the seeded tokens of the candidate path
equal the reference's (trap 5: the full-vocab path's threefry draw is not
reproducible).
"""
import numpy as np
import pytest
import torch

SCHEMA = {'type': 'object',
          'properties': {'name': {'type': 'string'},
                         'age': {'type': 'integer'},
                         'color': {'enum': ['red', 'green', 'blue']},
                         'xs': {'type': 'array', 'items': {'type': 'number'}},
                         'meta': {'type': 'object',
                                  'properties': {'ok': {'type': 'boolean'},
                                                 'note': {}},
                                  'required': ['ok']}},
          'required': ['name', 'age', 'xs']}

GUIDES = {
    'json_object': ('json', None),
    'json_schema': ('schema', SCHEMA),
    'regex_date': ('regex', r'\d{4}-\d{2}-\d{2}'),
    'regex_alt': ('regex', r'(yes|no|maybe): [a-z ]+\.?'),
    'regex_classes': ('regex', r'[A-Za-z_]\w*(\s*,\s*[^,\d]{1,3})*'),
}


@pytest.fixture(autouse=True)
def fresh_guide_caches():
    """Empty both packages' class-level guide caches before each test: they are keyed
    by object ids (the tokenizer model's, the token list's), which a later tokenizer can
    reuse once an earlier one is freed, with another vocabulary."""
    import lmdeploy_tpu.guided as jg
    import lmdeploy_tpu.guided_regex as jr
    import lmdeploy_tpu.guided_schema as js
    import lmdeploy_tpu_torch.guided as tg
    import lmdeploy_tpu_torch.guided_regex as tr
    import lmdeploy_tpu_torch.guided_schema as ts
    for cls in (jg.JsonGuide, jr.RegexGuide, js.SchemaGuide, tg.JsonGuide, tr.RegexGuide,
                ts.SchemaGuide):
        cls._mask_cache.clear()
        getattr(cls, '_token_strings_cache', {}).clear()


def make(pkg, kind, spec, tok, vocab=256, eos=(2,)):
    """A guide of ``kind`` ('json', 'schema' or 'regex') from package ``pkg``."""
    from importlib import import_module
    mod = 'lmdeploy_tpu' if pkg == 'jax' else 'lmdeploy_tpu_torch'
    if kind == 'json':
        return import_module(f'{mod}.guided').JsonGuide(tok, vocab, list(eos))
    if kind == 'schema':
        return import_module(f'{mod}.guided_schema').SchemaGuide(tok, vocab, list(eos), spec)
    return import_module(f'{mod}.guided_regex').RegexGuide(tok, vocab, list(eos), spec)


def complete(g):
    """The guide's state is a complete value (JsonGuide: ``is_complete``)."""
    if hasattr(g, '_is_complete'):
        return g._is_complete()
    from lmdeploy_tpu_torch.guided import is_complete
    return is_complete(g.state)


@pytest.fixture(scope='module')
def tokenizers(tiny_model_dir):
    from lmdeploy_tpu.tokenizer import Tokenizer as JTok
    from lmdeploy_tpu_torch.tokenizer import Tokenizer as TTok
    return JTok(tiny_model_dir), TTok(tiny_model_dir)


@pytest.mark.parametrize('name', list(GUIDES))
def test_masks_match_reference_along_walks(tokenizers, name):
    """Seeded walks: 3 of 4 steps take a legal token (uniform over the mask), the
    fourth any token, legal or not; a walk ends at EOS or after 48 steps."""
    jtok, ttok = tokenizers
    kind, spec = GUIDES[name]
    assert make('torch', kind, spec, ttok).tokens == make('jax', kind, spec, jtok).tokens
    rng = np.random.RandomState(sum(map(ord, name)))
    for walk in range(6):
        ref, port = make('jax', kind, spec, jtok), make('torch', kind, spec, ttok)
        for step in range(48):
            m_ref, m_port = ref.allowed_mask(), port.allowed_mask()
            assert m_port.dtype == np.bool_ and np.array_equal(m_port, m_ref), (walk, step)
            assert complete(port) == complete(ref)
            legal = np.nonzero(m_port)[0]
            tok = int(rng.choice(legal)) if rng.rand() < 0.75 else int(rng.randint(256))
            ok = port.accept_token(tok)
            assert ok == ref.accept_token(tok), (walk, step, tok)
            assert ok or not m_port[tok]
            if tok == 2:
                break


def _json_valid(pkg, text, want_complete=None):
    from importlib import import_module
    g = import_module(f'{pkg}.guided')
    st = g.advance_string(g.JsonState(), text)
    if want_complete is None:
        return st is not None
    return st is not None and g.is_complete(st)


def _regex_guide(pkg, pattern):
    from importlib import import_module
    m = import_module(f'{pkg}.guided_regex')
    g = m.RegexGuide.__new__(m.RegexGuide)
    g.vocab_size, g.eos_token_ids, g.pattern, g.nfa = 1, [0], pattern, m._NFA()
    start, g.accept = m._build(g.nfa, m._parse(pattern))
    g.tokens, g.dead = [''], False
    g.frontier = g._closure(frozenset([start]))
    return g


def _regex(pkg, pattern, text, full):
    g = _regex_guide(pkg, pattern)
    f = g._advance_frontier(g.frontier, text)
    return g.accept in f if full else bool(f)


def _schema(pkg, schema, text, full):
    from importlib import import_module
    m = import_module(f'{pkg}.guided_schema')
    g = m.SchemaGuide.__new__(m.SchemaGuide)
    g.nodes = m.compile_schema(schema)
    g.frontier = g._advance_frontier(((('val', 0),),), text)
    return bool(g.frontier) and (not full or g._is_complete())


OBJ = {'type': 'object', 'properties': {'name': {'type': 'string'},
                                        'age': {'type': 'integer'}},
       'required': ['name', 'age']}
OPT = {'type': 'object', 'properties': {'a': {'type': 'integer'}, 'b': {'type': 'string'}},
       'required': ['b']}
NESTED = {'type': 'object',
          'properties': {'tags': {'type': 'array', 'items': {'type': 'string'}},
                         'meta': {'type': 'object',
                                  'properties': {'id': {'type': 'integer'}},
                                  'required': ['id']}},
          'required': ['tags', 'meta']}
ARR = {'type': 'array', 'items': {'type': 'integer'}, 'minItems': 2, 'maxItems': 3}

# (check, argument, text, full match?, expected): the reference tests' cases
CASES = {
    'json_prefixes': [('json', None, t, None, True) for t in [
        '{', '{"a"', '{"a": 1', '{"a": [1, 2', '[', '[{"x": "y"}', '"hel', '12.5e', 'tru',
        '{"a": nul', '  {  "k" : ']],
    'json_invalid': [('json', None, t, None, False) for t in [
        '}', '{,', '{"a" 1', '{"a": 1,,', '[1 2]', 'truthy', '{"a"}', '{1: 2}', '{"a": }',
        ']']],
    'json_complete': [('json', None, t, True, True) for t in [
        '{}', '{"a": 1}', '[1, 2, 3]', '"hi"', 'true', 'null', '{"a": {"b": []}}', '42',
        '{"s": "a\\"b\\\\c\\n", "e": -1.5e-3}']]
    + [('json', None, t, True, False) for t in ['{', '{"a":', '[1,', '"unterminated', 'tr']],
    'regex_literals_classes': [
        ('regex', 'abc', 'abc', True, True), ('regex', 'abc', 'ab', True, False),
        ('regex', 'abc', 'abd', False, False), ('regex', '[a-c]+', 'abccba', True, True),
        ('regex', '[a-c]+', 'd', False, False), ('regex', '[^0-9]', 'x', True, True),
        ('regex', '[^0-9]', '5', False, False)],
    'regex_escapes': [
        ('regex', r'\d{3}-\d{4}', '555-0199', True, True),
        ('regex', r'\d{3}-\d{4}', '55a', False, False),
        ('regex', r'\w+\s\w+', 'hello world', True, True),
        ('regex', r'a\.b', 'a.b', True, True), ('regex', r'a\.b', 'axb', False, False)],
    'regex_quantifiers': [
        ('regex', 'a*', '', True, True), ('regex', 'a*', 'aaaa', True, True),
        ('regex', 'a+b?', 'aa', True, True), ('regex', 'a+b?', 'aab', True, True),
        ('regex', 'a+', '', True, False), ('regex', 'a{2,3}', 'aa', True, True),
        ('regex', 'a{2,3}', 'aaa', True, True), ('regex', 'a{2,3}', 'a', True, False),
        ('regex', 'a{2,3}', 'aaaa', False, False), ('regex', 'a{2,}', 'aaaaa', True, True)],
    'regex_alternation_groups': [
        ('regex', '(yes|no)', 'yes', True, True), ('regex', '(yes|no)', 'no', True, True),
        ('regex', '(yes|no)', 'mx', False, False), ('regex', '(?:ab)+', 'abab', True, True),
        ('regex', '(?:ab)+', 'aba', True, False), ('regex', '^(a|b)c$', 'ac', True, True),
        ('regex', 'a.c', 'abc', True, True), ('regex', 'a.c', 'a\nc', False, False)],
    'schema_object': [
        ('schema', OBJ, '{"name": "bob", "age": 33}', True, True),
        *[('schema', OBJ, p, False, True) for p in [
            '{', '{"', '{"name', '{"name":', '{"name": "b', '{"name": "bob", ',
            '{"name": "bob", "age": 3']],
        *[('schema', OBJ, p, False, False) for p in [
            '{"nope', '{"namex', '{"age', '{}', '{"name": "bob"}', '{"name": 3',
            '{"name": "b", "age": "x"', '{"name": "b", "age": 3.5']],
        ('schema', OPT, '{"b": "x"}', True, True), ('schema', OPT, '{"a": 1, "b": "x"}', True, True),
        ('schema', OPT, '{"a": 1}', False, False)],
    'schema_types': [
        ('schema', {'type': 'array', 'items': {'type': 'integer'}}, '[1, 2, 3]', True, True),
        ('schema', {'type': 'array', 'items': {'type': 'integer'}}, '[]', True, True),
        ('schema', {'type': 'array', 'items': {'type': 'integer'}}, '["a"', False, False),
        ('schema', ARR, '[1]', True, False), ('schema', ARR, '[1,2]', True, True),
        ('schema', ARR, '[1,2,3]', True, True), ('schema', ARR, '[1,2,3,', False, False),
        ('schema', ARR, '[]', False, False),
        ('schema', {'enum': ['red', 'green', 42]}, '"green"', True, True),
        ('schema', {'enum': ['red', 'green', 42]}, '42', True, True),
        ('schema', {'enum': ['red', 'green', 42]}, '"blue"', False, False),
        ('schema', {'enum': ['red', 'green', 42]}, '"gre', False, True),
        ('schema', {'const': {'ok': True}}, '{"ok":true}', True, True),
        ('schema', {'type': 'boolean'}, 'false', True, True),
        ('schema', {'type': 'null'}, 'null', True, True),
        ('schema', {'type': 'boolean'}, 'nul', False, False),
        ('schema', {'anyOf': [{'type': 'integer'}, {'type': 'string'}]}, '7', True, True),
        ('schema', {'anyOf': [{'type': 'integer'}, {'type': 'string'}]}, '"x"', True, True),
        ('schema', {'anyOf': [{'type': 'integer'}, {'type': 'string'}]}, 'tr', False, False),
        ('schema', {'type': 'number'}, '-1e5', True, True),
        ('schema', {'type': 'integer'}, '1.', False, False),
        ('schema', {'type': 'string'}, '"a\\nb"', True, True),
        ('schema', {'type': 'string'}, '"a\\x', False, False)],
    'schema_nested': [
        ('schema', NESTED, '{"tags": ["a", "b"], "meta": {"id": 5}}', True, True),
        ('schema', NESTED, '{"tags": [1', False, False),
        ('schema', NESTED, '{"tags": [], "meta": {"id": "s"', False, False),
        *[('schema', {'type': 'object', 'properties': {'x': {}}, 'required': ['x']},
           '{"x": %s}' % v, True, True)
          for v in ['1', '"s"', '[1, {"k": null}]', '{"a": true}']],
        ('schema', SCHEMA, '{"name": "a", "age": -3, "color": "red", "xs": [1.5, -2e3], '
                           '"meta": {"ok": false, "note": [null]}}', True, True),
        ('schema', SCHEMA, '{"name": "a", "age": 3, "color": "pink"', False, False)],
}


@pytest.mark.parametrize('group', list(CASES))
def test_semantics_match_reference(group):
    """Each case's verdict on both packages: equal, and as the reference's tests say."""
    for check, arg, text, full, want in CASES[group]:
        got = {}
        for pkg in ('lmdeploy_tpu', 'lmdeploy_tpu_torch'):
            if check == 'json':
                got[pkg] = _json_valid(pkg, text, full)
            elif check == 'regex':
                got[pkg] = _regex(pkg, arg, text, full)
            else:
                got[pkg] = _schema(pkg, arg, text, full)
        assert got['lmdeploy_tpu_torch'] == got['lmdeploy_tpu'] == want, (group, arg, text)


@pytest.mark.parametrize('bad', ['(ab', 'a)', '[ab', '*a', 'a{2,1}'])
def test_regex_errors_match_reference(bad):
    from lmdeploy_tpu.guided_regex import RegexError as JErr
    from lmdeploy_tpu_torch.guided_regex import RegexError
    with pytest.raises(JErr):
        _regex_guide('lmdeploy_tpu', bad)
    with pytest.raises(RegexError):
        _regex_guide('lmdeploy_tpu_torch', bad)


@pytest.mark.parametrize('pkg', ['lmdeploy_tpu', 'lmdeploy_tpu_torch'])
def test_regex_token_masks_and_eos(pkg):
    """The reference's TestTokenMasks on a fixed string table, on both packages."""
    def guide(pattern, tokens):
        g = _regex_guide(pkg, pattern)
        g.tokens, g.vocab_size = tokens, len(tokens)
        return g
    g = guide('(?:ab)+', ['</s>', 'ab', 'cd', 'a', '9', 'abab'])
    assert list(np.nonzero(g.allowed_mask())[0]) == [1, 3, 5]
    assert g.accept_token(1)
    m = g.allowed_mask()
    assert m[0] and m[1] and m[5] and not m[4]
    g = guide('x', ['</s>', 'x', 'y'])
    assert g.accept_token(1)
    assert list(g.allowed_mask()) == [True, False, False]
    g = guide('x+', ['</s>', 'x', 'y'])
    assert not g.accept_token(2) and g.accept_token(1)


class _Seq:
    def __init__(self, params, guided=None, n_out=0):
        self.sampling_params, self.guided, self.num_output_tokens = params, guided, n_out


def test_sampling_masks_and_candidate_tokens_match_reference(tokenizers):
    """``SamplingInputs.from_seqs`` over guided rows (a guide's mask replaces the row's
    banned ids, as in the reference), bad-words rows and plain rows: the masks bit for
    bit; then seeded top-k / top-p draws on the candidate path over the masked logits:
    the same tokens and logprobs (1e-5) as the reference's."""
    import jax.numpy as jnp
    from lmdeploy_tpu.ops.sampling import SamplingInputs as JInputs
    from lmdeploy_tpu.ops.sampling import sample_logits as jsample
    from lmdeploy_tpu.paging.seq import SamplingParams as JParams
    from lmdeploy_tpu_torch.ops.sampling import SamplingInputs, sample_logits
    from lmdeploy_tpu_torch.paging.seq import SamplingParams
    jtok, ttok = tokenizers
    rng = np.random.RandomState(5)
    rows = []
    for i, (name, bad) in enumerate([('json_object', None), ('json_schema', [5, 9]),
                                     ('regex_date', None), (None, [3, 4, 40, 41]),
                                     (None, None), ('regex_alt', None)]):
        kw = dict(do_sample=True, top_k=[0, 40, 8, 0, 3, 20][i], top_p=[1.0, 0.9, 1.0,
                  0.8, 1.0, 0.95][i], temperature=0.7, random_seed=100 + i,
                  bad_token_ids=bad or [])
        guides = [None, None]
        if name is not None:
            kind, spec = GUIDES[name]
            guides = [make('jax', kind, spec, jtok), make('torch', kind, spec, ttok)]
            for t in rng.choice(np.nonzero(guides[1].allowed_mask())[0], 1):
                assert guides[0].accept_token(int(t)) and guides[1].accept_token(int(t))
        rows.append((JParams(**kw), SamplingParams(**kw), guides))
    jin = JInputs.from_seqs([_Seq(j, g[0], 3) for j, _, g in rows], 256)
    tin = SamplingInputs.from_seqs([_Seq(t, g[1], 3) for _, t, g in rows], 256)
    assert np.array_equal(tin.bad_words_mask, np.asarray(jin.bad_words_mask))
    assert np.array_equal(tin.seeds, np.asarray(jin.seeds).astype(np.int64))
    logits = rng.randn(len(rows), 256).astype(np.float32) * 3
    counts = np.zeros((len(rows), 256), np.int32)
    jtok_out, jlp, _ = jsample(jnp.asarray(logits), jin, jnp.asarray(counts))
    ttok_out, tlp, _ = sample_logits(torch.from_numpy(logits), tin.to('cpu'),
                                     torch.from_numpy(counts))
    assert ttok_out.tolist() == np.asarray(jtok_out).tolist()
    assert not tin.bad_words_mask[np.arange(len(rows)), ttok_out.numpy()].any()
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)
