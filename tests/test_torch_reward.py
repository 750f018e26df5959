"""The port's reward models (``Qwen2ForRewardModel``, ``InternLM2ForRewardModel``)
against the JAX package: loaded trees leaf for leaf (the score heads' leaves in,
``lm_head`` out; InternLM2's fused ``wqkv`` split), scores of ``async_get_reward_score``
and ``Pipeline.get_reward_score`` within 1e-4 (the reference test's bound), the refusal
on a model without a score head, and the ``/pooling`` route."""
import asyncio
import json
import os

import numpy as np
import pytest

from conftest import make_tiny_tokenizer
from dense_family_cases import CFGS, H, _tensors, models, tree_equal

KW = dict(dtype='float32', block_size=16, num_gpu_blocks=32, max_batch_size=2,
          session_len=256, max_prefill_token_num=64)
# one prompt longer than the 64-token chunk: its score reads the cache
PROMPTS = [[3, 17, 42, 99, 7], [5, 8, 13, 21, 34, 55, 89],
           np.random.RandomState(9).randint(3, 120, size=100).tolist()]


def _save(path, cfg, tensors):
    from safetensors.numpy import save_file
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    make_tiny_tokenizer(str(path), vocab_size=128)
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in tensors.items()},
              os.path.join(path, 'model.safetensors'))
    return str(path)


def write_qwen2_reward(path):
    """The reference test's checkpoint (tests/test_reward.py ``qwen2_reward_dir``)."""
    cfg = {'architectures': ['Qwen2ForRewardModel'], 'model_type': 'qwen2',
           'hidden_size': 48, 'intermediate_size': 96, 'num_hidden_layers': 2,
           'num_attention_heads': 4, 'num_key_value_heads': 2, 'head_dim': 12,
           'vocab_size': 128, 'max_position_embeddings': 256,
           'rms_norm_eps': 1e-6, 'rope_theta': 10000.0,
           'torch_dtype': 'float32', 'tie_word_embeddings': False}
    rng = np.random.RandomState(5)
    Hq, V, nh, nkv, hd = 48, 128, 4, 2, 12
    t = {'model.embed_tokens.weight': rng.randn(V, Hq) * 0.02,
         'model.norm.weight': np.ones(Hq),
         'score.0.weight': rng.randn(Hq, Hq) * 0.1, 'score.0.bias': rng.randn(Hq) * 0.1,
         'score.2.weight': rng.randn(1, Hq) * 0.1, 'score.2.bias': rng.randn(1) * 0.1}
    for layer in range(2):
        p = f'model.layers.{layer}.'
        t[p + 'input_layernorm.weight'] = np.ones(Hq)
        t[p + 'post_attention_layernorm.weight'] = np.ones(Hq)
        for name, out_dim in (('q', nh * hd), ('k', nkv * hd), ('v', nkv * hd)):
            t[p + f'self_attn.{name}_proj.weight'] = rng.randn(out_dim, Hq) * 0.05
            t[p + f'self_attn.{name}_proj.bias'] = rng.randn(out_dim) * 0.02
        t[p + 'self_attn.o_proj.weight'] = rng.randn(Hq, nh * hd) * 0.05
        t[p + 'mlp.gate_proj.weight'] = rng.randn(96, Hq) * 0.05
        t[p + 'mlp.up_proj.weight'] = rng.randn(96, Hq) * 0.05
        t[p + 'mlp.down_proj.weight'] = rng.randn(Hq, 96) * 0.05
    return _save(path, cfg, t)


def write_internlm2_reward(path):
    """tests/dense_family_cases.py's InternLM2 (fused ``wqkv``) with a ``v_head`` in
    place of ``output``."""
    rng = np.random.RandomState(12)
    t = _tensors('internlm2', rng)
    del t['output.weight']
    t['v_head.weight'] = rng.randn(1, H) * 0.1
    return _save(path, dict(CFGS['internlm2'], architectures=['InternLM2ForRewardModel']),
                 t)


WRITERS = {'qwen2': write_qwen2_reward, 'internlm2': write_internlm2_reward}


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return {name: fn(tmp_path_factory.mktemp(f'tiny_{name}_reward'))
            for name, fn in WRITERS.items()}


@pytest.fixture(scope='module')
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def _engine(pkg, path):
    if pkg == 'jax':
        from lmdeploy_tpu.messages import TpuEngineConfig
        from lmdeploy_tpu.serve.async_engine import AsyncEngine
        return AsyncEngine(path, backend_config=TpuEngineConfig(**KW))
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
    return AsyncEngine(path, backend_config=TpuEngineConfig(**KW), device='cpu')


@pytest.mark.parametrize('name', list(WRITERS))
def test_loader_matches_jax(ckpt, name):
    jm, jp, tm, tp = models(ckpt[name])
    tree_equal(tp, jp)
    assert tm.is_reward_model and 'lm_head' not in tp
    head = {'qwen2': {'score_w1', 'score_b1', 'score_w2', 'score_b2'},
            'internlm2': {'v_head'}}[name]
    assert head <= set(tp)


@pytest.mark.parametrize('name', list(WRITERS))
def test_scores_match_jax(ckpt, loop, name):
    """Scores of three prompts (one over two chunks), and of one prompt given flat,
    within 1e-4 of the JAX engine's; ``Pipeline.get_reward_score`` gives the same."""
    from lmdeploy_tpu_torch import pipeline
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    ref_engine = _engine('jax', ckpt[name])
    try:
        ref = loop.run_until_complete(ref_engine.async_get_reward_score(PROMPTS))
    finally:
        ref_engine.close()
    pipe = pipeline(ckpt[name], backend_config=TpuEngineConfig(**KW), device='cpu')
    try:
        got = pipe.get_reward_score(PROMPTS)
        single = pipe.get_reward_score(PROMPTS[0])
    finally:
        pipe.close()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert single == got[:1]
    assert len(set(got)) == len(got)


def test_reward_rejected_on_lm(tiny_model_dir, loop):
    """A model without a score head refuses reward scores (reference guard)."""
    engine = _engine('torch', tiny_model_dir)
    try:
        with pytest.raises(ValueError, match='not a reward model'):
            loop.run_until_complete(engine.async_get_reward_score([[1, 2, 3]]))
    finally:
        engine.close()


def test_pooling_route(ckpt, tiny_model_dir, loop):
    """``/pooling`` on the port's app: the scores of ``async_get_reward_score`` for
    token lists, a flat list and text; 400 on an invalid input and on a causal LM."""
    from aiohttp.test_utils import TestClient, TestServer

    from lmdeploy_tpu_torch.serve.api_server import create_app
    engine = _engine('torch', ckpt['qwen2'])
    lm = _engine('torch', tiny_model_dir)

    async def run():
        want = await engine.async_get_reward_score(PROMPTS[:2])
        text = await engine.async_get_reward_score([engine.tokenizer.encode('hello world')])
        client = TestClient(TestServer(create_app(engine, 'reward')))
        lm_client = TestClient(TestServer(create_app(lm, 'lm')))
        await client.start_server()
        await lm_client.start_server()
        try:
            r = await client.post('/pooling', json={'input': PROMPTS[:2]})
            assert r.status == 200
            body = await r.json()
            assert body['object'] == 'list' and body['model'] == 'reward'
            assert [d['data'] for d in body['data']] == want
            assert [d['index'] for d in body['data']] == [0, 1]
            r = await client.post('/pooling', json={'input': PROMPTS[0]})
            assert [d['data'] for d in (await r.json())['data']] == want[:1]
            r = await client.post('/pooling', json={'input': 'hello world'})
            assert [d['data'] for d in (await r.json())['data']] == text
            for bad in (42, [], [1.5]):
                r = await client.post('/pooling', json={'input': bad})
                assert r.status == 400
            r = await lm_client.post('/pooling', json={'input': [[1, 2, 3]]})
            assert r.status == 400
            assert 'not a reward model' in (await r.json())['error']['message']
        finally:
            await client.close()
            await lm_client.close()

    try:
        loop.run_until_complete(run())
    finally:
        engine.close()
        lm.close()
