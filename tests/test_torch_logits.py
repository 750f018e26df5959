"""The port's scoring path against the JAX package: ``ModelAgent.compute_logits``,
``AsyncEngine.async_get_logits`` / ``async_get_ppl`` and ``Pipeline.get_ppl`` on the
tiny llama (f32 logits allclose 1e-5; ppl within 1e-5, the bound of
tests/test_metrics_ppl.py), on a tiny DeepSeek MLA model (1e-4, as
tests/test_torch_deepseek.py holds its logits) and on a tiny Qwen3-Next (1e-3, as the
hybrid tests hold theirs: the chunked form's triangular solve amplifies the packages'
f32 summation orders), and the ``LMDEPLOY_TPU_KV_SIM`` harness' fills and ppl.

Texts stream through the cache in chunks of the largest chunk bucket (64 here): a
150-token text takes three, a 300-token one is cut at the session length (256) by
``async_get_ppl``, and a one-token text has ppl 0.0.  On a hybrid model the reference
runs the request in batch slot 0 without a reset, so its logits start from whatever
state slot 0 holds and leave the request's state there; the port runs it in the garbage
slot with a reset.
"""
import asyncio

import numpy as np
import pytest

from conftest import make_tiny_tokenizer

KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=8,
          session_len=256, max_prefill_token_num=64)
TOL = dict(rtol=1e-5, atol=1e-5)


def _ids(seed, lengths, vocab=250):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, vocab, size=n).tolist() for n in lengths]


def _engines(path, **cfg):
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu.serve.async_engine import AsyncEngine as JAsync
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine as TAsync
    kw = dict(KW, **cfg)
    return (JAsync(path, backend_config=JCfg(**kw)),
            TAsync(path, backend_config=TCfg(**kw), device='cpu'))


@pytest.fixture(scope='module')
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope='module')
def dense(tiny_model_dir):
    engines = _engines(tiny_model_dir)
    yield engines
    for e in engines:
        e.close()


def test_logits_match_jax(dense, loop):
    """Short, three-chunk and one-token texts: [n, V] f32 logits, equal within 1e-5;
    ``compute_logits`` on the agent gives what ``async_get_logits`` gives."""
    jax_engine, port = dense
    texts = _ids(0, (20, 150, 1))
    ref = loop.run_until_complete(jax_engine.async_get_logits(texts))
    got = loop.run_until_complete(port.async_get_logits(texts))
    for r, g, ids in zip(ref, got, texts):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        assert g.shape == r.shape == (len(ids), 256)
        np.testing.assert_allclose(g, r, **TOL)
    bm = port.engine.scheduler.block_manager
    free = bm.num_free_blocks
    blocks = bm.allocate(10)
    direct = port.engine.model_agent.compute_logits(texts[1], blocks)
    bm.free(blocks)
    assert bm.num_free_blocks == free
    np.testing.assert_array_equal(direct, got[1])


def test_ppl_matches_jax(dense, loop):
    """Mean NLL per text within 1e-5: a one-token text 0.0, a 300-token text cut at the
    session length (its ppl is that of its first 256 tokens)."""
    jax_engine, port = dense
    texts = _ids(1, (20, 150, 1, 300))
    ref = loop.run_until_complete(jax_engine.async_get_ppl(texts))
    got = loop.run_until_complete(port.async_get_ppl(texts))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got[2] == ref[2] == 0.0
    assert all(p > 0 for p in got[:2] + got[3:])
    cut = loop.run_until_complete(port.async_get_ppl([texts[3][:256]]))
    assert cut[0] == got[3]
    # the device NLL is the reference's numpy float64 log-sum-exp of the port's logits
    lg = loop.run_until_complete(port.async_get_logits([texts[1]]))[0][:-1].astype(np.float64)
    tgt = np.asarray(texts[1][1:])
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
    assert abs(float((lse - lg[np.arange(len(tgt)), tgt]).mean()) - got[1]) < 1e-12


def test_pipeline_get_ppl_matches_jax(tiny_model_dir, dense, loop):
    from lmdeploy_tpu_torch import pipeline
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    jax_engine, _ = dense
    texts = ['hello world this is a test', 'a tiny test corpus ' * 12]
    ids = [jax_engine.tokenizer.encode(t) for t in texts]
    ref = loop.run_until_complete(jax_engine.async_get_ppl(ids))
    pipe = pipeline(tiny_model_dir, backend_config=TpuEngineConfig(**KW), device='cpu')
    try:
        got = pipe.get_ppl(texts)
        single = pipe.get_ppl(texts[0])
    finally:
        pipe.close()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert single == got[0]


@pytest.fixture(scope='module')
def hybrid(tmp_path_factory):
    from hybrid_cases import ENGINE_KW, write_qwen3_next
    path = write_qwen3_next(str(tmp_path_factory.mktemp('tiny_qwen3_next')))
    make_tiny_tokenizer(path, vocab_size=128)
    engines = _engines(path, **ENGINE_KW)
    yield engines
    for e in engines:
        e.close()


def test_hybrid_logits_match_jax_idle_and_slot0_trap(hybrid, loop):
    """On an idle engine the two packages agree (slot 0 still holds zeros).  The
    reference leaves the request's final state in slot 0 and reads it without a reset
    on the next request, so its second call differs from its first; the port's calls
    run in the garbage slot with a reset and repeat exactly."""
    jax_engine, port = hybrid
    text = _ids(2, (100,), vocab=120)
    ref = [loop.run_until_complete(jax_engine.async_get_logits(text))[0] for _ in range(2)]
    got = [loop.run_until_complete(port.async_get_logits(text))[0] for _ in range(2)]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got[1], got[0])
    assert np.abs(ref[1] - ref[0]).max() > 1e-2
    _idle(jax_engine)
    ppl = [e.async_get_ppl(_ids(3, (90, 1), vocab=120)) for e in hybrid]
    np.testing.assert_allclose(loop.run_until_complete(ppl[1]),
                               loop.run_until_complete(ppl[0]), rtol=0, atol=1e-3)


def _idle(jax_engine):
    """Zero the reference's per-slot linear state, as on an idle engine."""
    import jax.numpy as jnp
    ce = jax_engine.engine.model_agent.cache_engine
    ce.kv_cache = {k: v if k == 'pages' else jnp.zeros_like(v)
                   for k, v in ce.kv_cache.items()}


def test_hybrid_live_sequence_unaffected(hybrid, loop):
    """A logits request issued while a sequence decodes in batch slot 0 of the port's
    engine: the request's logits equal its idle ones and the sequence's tokens equal
    those it gets undisturbed."""
    from lmdeploy_tpu_torch.messages import GenerationConfig
    _, port = hybrid
    text = _ids(4, (80,), vocab=120)
    idle = loop.run_until_complete(port.async_get_logits(text))[0]
    prompt = _ids(5, (24,), vocab=120)[0]
    gen = GenerationConfig(max_new_tokens=40, ignore_eos=True)

    async def serve(session_id, probe):
        live, tokens = None, []
        async for out in port.instance.async_stream_infer(session_id, prompt, gen):
            tokens = out.token_ids
            if probe and live is None and tokens:
                assert port.engine.scheduler.running and \
                    port.engine.scheduler.running[0].batch_slot == 0
                live = (await port.async_get_logits(text))[0]
        await port.end_session(session_id)
        return list(tokens), live

    alone, _ = loop.run_until_complete(serve(101, False))
    probed, live = loop.run_until_complete(serve(102, True))
    assert len(alone) == 40 and probed == alone
    np.testing.assert_array_equal(live, idle)


@pytest.fixture(scope='module')
def mla(tmp_path_factory):
    from test_torch_deepseek import _write_checkpoint
    path = _write_checkpoint(tmp_path_factory.mktemp('tiny_ds_logits'), 'ds')
    engines = _engines(path, max_batch_size=4)
    yield engines
    for e in engines:
        e.close()


def test_mla_logits_and_ppl_match_jax(mla, loop):
    jax_engine, port = mla
    texts = _ids(6, (100, 7), vocab=120)
    ref = loop.run_until_complete(jax_engine.async_get_logits(texts))
    got = loop.run_until_complete(port.async_get_logits(texts))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loop.run_until_complete(port.async_get_ppl(texts)),
                               loop.run_until_complete(jax_engine.async_get_ppl(texts)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize('mode', ['turbo', 'turbo_k', 'turbo_v'])
def test_kv_sim_fills_and_ppl_match_jax(tiny_model_dir, loop, monkeypatch, mode):
    """LMDEPLOY_TPU_KV_SIM: the plain cache holds K and / or V through the TurboQuant
    codec and back; both packages' fills of a two-chunk text agree (the codec's
    Hadamard products sum in another order on each side, so within 1e-5) and so do the
    ppl, which the codec moves; the port reads the variable when its agent is built."""
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
    from lmdeploy_tpu_torch.weight_convert import cache_to_reference
    text = _ids(7, (90,))
    plain_engine = AsyncEngine(tiny_model_dir, backend_config=TpuEngineConfig(**KW),
                               device='cpu')
    plain = loop.run_until_complete(plain_engine.async_get_ppl(text))
    plain_cache = cache_to_reference(plain_engine.engine.model_agent.kv_cache)
    plain_engine.close()
    monkeypatch.setenv('LMDEPLOY_TPU_KV_SIM', mode)
    jax_engine, port = _engines(tiny_model_dir)
    monkeypatch.delenv('LMDEPLOY_TPU_KV_SIM')
    try:
        assert port.engine.model_agent.model.kv_sim == mode
        got = loop.run_until_complete(port.async_get_ppl(text))
        monkeypatch.setenv('LMDEPLOY_TPU_KV_SIM', mode)     # JAX reads it when tracing
        ref = loop.run_until_complete(jax_engine.async_get_ppl(text))
        monkeypatch.delenv('LMDEPLOY_TPU_KV_SIM')
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert got[0] != plain[0]
        jcache = np.asarray(jax_engine.engine.model_agent.cache_engine.kv_cache)
        tcache = cache_to_reference(port.engine.model_agent.kv_cache)
        # block 0 is the padding block: the padded rows' writes land there
        np.testing.assert_allclose(tcache[:, 1:], jcache[:, 1:], rtol=1e-5, atol=1e-5)
        # layer 0's simulated planes moved off the plain cache's, the others did not
        for plane in (0, 1):
            moved = np.abs(tcache[0, 1:, plane] - plain_cache[0, 1:, plane]).max()
            if 'kv'[plane] in {'turbo': 'kv', 'turbo_k': 'k', 'turbo_v': 'v'}[mode]:
                assert moved > 1e-3
            else:
                assert moved == 0
    finally:
        jax_engine.close()
        port.close()


def test_kv_sim_rejects_unknown_mode(tiny_model_dir, monkeypatch):
    from lmdeploy_tpu_torch.engine.model_agent import kv_sim_mode
    monkeypatch.setenv('LMDEPLOY_TPU_KV_SIM', 'int3')
    with pytest.raises(ValueError, match='LMDEPLOY_TPU_KV_SIM'):
        kv_sim_mode()
    monkeypatch.setenv('LMDEPLOY_TPU_KV_SIM', '')
    assert kv_sim_mode() is None
