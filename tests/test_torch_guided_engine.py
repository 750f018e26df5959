"""Guided decoding and bad words through the port's Engine, against the JAX Engine
(CPU, f32, the tiny checkpoint and its tokenizer).

One mixed batch: greedy json_object, json_schema and regex rows, an accept-everything
regex row that rides the device runs, plain rows and bad-words rows.  The tokens must
equal the JAX engine's both with the speculative grammar acceptance (the default: greedy
guided rows ride the decode runs unmasked, a rejection is recovered by one masked host
step, a row whose acceptance EMA drops below 2 falls back to per-step masking; mirrors
tests/test_guided_device.py:47, 65) and with LMDEPLOY_TPU_GUIDED_SPEC=0 (per-step
masking), and the two modes must agree.  On the tiny Qwen3-Next the JAX engine's two
modes disagree (a device run advances the recurrent state through rejected tokens);
the port takes the per-step path there and equals the JAX per-step tokens.
"""
import asyncio
import os

import numpy as np
import pytest

SCHEMA = {'type': 'object',
          'properties': {'name': {'type': 'string'}, 'n': {'type': 'integer'},
                         'c': {'enum': ['red', 'green']},
                         'xs': {'type': 'array', 'items': {'type': 'number'}}},
          'required': ['name', 'n']}
JSON = {'type': 'json_object'}
SCHEMA_FMT = {'type': 'json_schema', 'json_schema': {'name': 's', 'schema': SCHEMA}}
DATE = {'type': 'regex_schema', 'regex_schema': r'\d{4}-\d{2}-\d{2}'}
ANY = {'type': 'regex_schema', 'regex_schema': r'(.|\n)*'}
ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=96, max_batch_size=8,
                 session_len=160, max_prefill_token_num=64)
NEW = 24


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


def _pkg(pkg):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import GenerationConfig, TpuEngineConfig
        from lmdeploy_tpu.tokenizer import Tokenizer
        return Engine, GenerationConfig, TpuEngineConfig, Tokenizer, {}
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
    from lmdeploy_tpu_torch.tokenizer import Tokenizer
    return Engine, GenerationConfig, TpuEngineConfig, Tokenizer, {'device': 'cpu'}


class GuidedStats:
    """Counts, on a port engine, the host steps of guided rows recovering from a
    rejection and of rows demoted by their acceptance EMA, and the recovered rows
    re-inserted into the device decode state."""

    def __init__(self, engine):
        self.recover = self.demoted = self.rejoined = 0
        host, insert = engine._decode_step_host, engine.model_agent.insert_decode_rows

        async def counted_host(seqs, loop):
            for s in seqs:
                if s.guided is not None and getattr(s, '_guided_recover', False):
                    self.recover += 1
                elif s.guided is not None and getattr(s, '_guided_ema', 1e9) < 2.0:
                    self.demoted += 1
            return await host(seqs, loop)

        def counted_insert(seqs):
            self.rejoined += sum(s.guided is not None and s.num_output_tokens > 1
                                 for s in seqs)
            return insert(seqs)
        engine._decode_step_host = counted_host
        engine.model_agent.insert_decode_rows = counted_insert


def serve(pkg, path, rows, env=None, cfg=None, stats=False, new_tokens=NEW):
    """Serve ``rows`` ((prompt, generation kwargs) pairs) concurrently on a fresh
    engine, with ``env`` set while it runs: (token lists, GuidedStats or None)."""
    Engine, Gen, Cfg, Tok, kw = _pkg(pkg)
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    engine = Engine.from_pretrained(path, Cfg(**(cfg or ENGINE_KW)), tokenizer=Tok(path),
                                    **kw)
    counts = GuidedStats(engine) if stats else None
    inst = engine.create_instance()

    async def go():
        return await asyncio.gather(*[
            inst.async_infer(i + 1, p, Gen(**dict(dict(max_new_tokens=new_tokens), **g)))
            for i, (p, g) in enumerate(rows)])
    try:
        outs = asyncio.run(go())
    finally:
        engine.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return [list(o.token_ids) for o in outs], counts


def replay_ok(path, fmt, ids, new_tokens=NEW, vocab=256):
    """A fresh guide of ``fmt`` from its start state accepts every token of ``ids``,
    and a row that stopped before ``new_tokens`` (on EOS, stripped) ends complete."""
    from lmdeploy_tpu_torch.guided import JsonGuide, is_complete
    from lmdeploy_tpu_torch.guided_regex import RegexGuide
    from lmdeploy_tpu_torch.guided_schema import SchemaGuide
    from lmdeploy_tpu_torch.tokenizer import Tokenizer
    tok = Tokenizer(path)
    if fmt['type'] == 'json_object':
        g = JsonGuide(tok, vocab, [2])
    elif fmt['type'] == 'json_schema':
        g = SchemaGuide(tok, vocab, [2], fmt['json_schema']['schema'])
    else:
        g = RegexGuide(tok, vocab, [2], fmt['regex_schema'])
    if not all(g.accept_token(int(t)) for t in ids):
        return False
    done = is_complete(g.state) if isinstance(g, JsonGuide) else g._is_complete()
    return len(ids) == new_tokens or done


@pytest.fixture(scope='module')
def mixed(tiny_model_dir):
    """The mixed batch: 8 rows (4 guided, 2 plain, 2 with bad words: the first four
    tokens the port emits for their prompts unmasked)."""
    from lmdeploy_tpu_torch.tokenizer import Tokenizer
    tok = Tokenizer(tiny_model_dir)
    rng = np.random.RandomState(0)
    prompts = [tok.encode('emit json:')] + [rng.randint(3, 250, size=n).tolist()
                                             for n in (5, 9, 12, 7, 20, 14, 31)]
    fmts = [JSON, SCHEMA_FMT, DATE, ANY, None, None, None, None]
    plain, _ = serve('torch', tiny_model_dir, [(p, dict(ignore_eos=True))
                                               for p in prompts[6:]])
    bad = [list(dict.fromkeys(t))[:4] for t in plain]
    rows = [(p, dict(response_format=f)) for p, f in zip(prompts[:6], fmts)]
    rows += [(p, dict(bad_token_ids=b, ignore_eos=True)) for p, b in zip(prompts[6:], bad)]
    return rows, bad


@pytest.mark.parametrize('mode', ['default', 'per_step'])
def test_guided_and_bad_words_tokens_match_jax(tiny_model_dir, mixed, mode):
    rows, bad = mixed
    env = {'LMDEPLOY_TPU_GUIDED_SPEC': '0'} if mode == 'per_step' else {}
    ref, _ = serve('jax', tiny_model_dir, rows, env)
    out, st = serve('torch', tiny_model_dir, rows, env, stats=True)
    assert out == ref
    for (p, g), ids in zip(rows[:4], out[:4]):
        assert replay_ok(tiny_model_dir, g['response_format'], ids)
    for ids, banned in zip(out[6:], bad):
        assert not set(ids) & set(banned) and len(ids) == NEW
    if mode == 'default':
        # rejections recovered by masked host steps, recovered rows back in the device
        # runs, rows demoted by the EMA; and the same tokens as per-step masking
        assert st.recover > 0 and st.rejoined > 0 and st.demoted > 0
        per_step, _ = serve('torch', tiny_model_dir, rows,
                            {'LMDEPLOY_TPU_GUIDED_SPEC': '0'})
        assert out == per_step
    else:
        assert st.recover == st.rejoined == 0


def test_sampled_guided_rows_reproducible(tiny_model_dir, mixed):
    """Seeded sampled guided rows (every step masked on the host; the reference's
    threefry draw is not reproducible, trap 5, so the candidate-path tokens are held in
    test_torch_guided.py): the same tokens twice, each output legal."""
    rows, _ = mixed
    sampled = [(p, dict(g, do_sample=True, top_k=40, temperature=0.9, random_seed=7 + i))
               for i, (p, g) in enumerate(rows[:3])]
    a, _ = serve('torch', tiny_model_dir, sampled)
    b, _ = serve('torch', tiny_model_dir, sampled)
    assert a == b
    for (p, g), ids in zip(sampled, a):
        assert replay_ok(tiny_model_dir, g['response_format'], ids)


def test_pipeline_response_format_matches_jax(tiny_model_dir):
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu_torch import pipeline as tpipeline
    texts = []
    for pkg, make in (('jax', jpipeline), ('torch', tpipeline)):
        _, Gen, Cfg, _, kw = _pkg(pkg)
        pipe = make(tiny_model_dir, backend_config=Cfg(**ENGINE_KW), **kw)
        try:
            outs = pipe(['emit json', 'a date'], gen_config=[
                Gen(max_new_tokens=16, response_format=SCHEMA_FMT),
                Gen(max_new_tokens=16, response_format=DATE)])
        finally:
            pipe.close()
        texts.append([(o.text, o.token_ids) for o in outs])
    assert texts[1] == texts[0]


@pytest.mark.parametrize('fmt,match', [
    ({'type': 'json_schema'}, 'json_schema'),
    ({'type': 'json_schema', 'json_schema': {'name': 'x'}}, 'json_schema'),
    ({'type': 'regex_schema'}, 'regex_schema'),
    ({'type': 'regex_schema', 'regex': ''}, 'regex_schema'),
    (JSON, 'tokenizer')])
def test_guided_request_errors(tiny_model_dir, fmt, match):
    """A missing schema or pattern, and a guide on an engine without a tokenizer,
    raise ValueError, as in the reference."""
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
    from lmdeploy_tpu_torch.tokenizer import Tokenizer
    tok = None if match == 'tokenizer' else Tokenizer(tiny_model_dir)
    engine = Engine.from_pretrained(tiny_model_dir, TpuEngineConfig(**ENGINE_KW),
                                    tokenizer=tok, device='cpu')
    inst = engine.create_instance()

    async def go():
        with pytest.raises(ValueError, match=match):
            await inst.async_infer(1, [5, 6], GenerationConfig(max_new_tokens=4,
                                                               response_format=fmt))
    try:
        asyncio.run(go())
    finally:
        engine.close()


def test_hybrid_guided_rows_take_per_step_masking(tmp_path):
    """Qwen3-Next (tests/hybrid_cases.py): the JAX engine's default greedy guided tokens
    leave its per-step masked tokens after the first rejection (its device run advanced
    the recurrent state through the rejected tokens and nothing rolls it back); the
    port's guided rows take the per-step path on a hybrid model and give the JAX
    per-step tokens (ROADMAP.md section 3, reference behaviour)."""
    import hybrid_cases as hc
    from conftest import make_tiny_tokenizer
    path = hc.write_qwen3_next(str(tmp_path))
    make_tiny_tokenizer(path, vocab_size=hc.GEOM['vocab_size'])
    cfg = dict(hc.ENGINE_KW, **hc.ROOMY)
    fmts = [JSON, {'type': 'regex_schema', 'regex_schema': r'[a-z ]*'}, ANY, None]
    rows = [(p, dict(response_format=f, ignore_eos=False))
            for p, f in zip(hc.prompts(0, (5, 9, 12, 7)), fmts)]
    per_step = {'LMDEPLOY_TPU_GUIDED_SPEC': '0'}
    ref_default, _ = serve('jax', path, rows, cfg=cfg, new_tokens=16)
    ref_per_step, _ = serve('jax', path, rows, per_step, cfg=cfg, new_tokens=16)
    out, st = serve('torch', path, rows, cfg=cfg, stats=True, new_tokens=16)
    assert ref_default != ref_per_step
    assert out == ref_per_step
    assert st.recover == st.rejoined == 0
    for (p, g), ids in zip(rows[:3], out[:3]):
        assert replay_ok(path, g['response_format'], ids, 16, hc.GEOM['vocab_size'])
