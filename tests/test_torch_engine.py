"""The port's Engine against the JAX Engine on the tiny random checkpoint (CPU, f32).

Greedy tokens must be identical, request by request: with chunked prefill, with
penalties (the sampled decode-run variant), under recompute preemption and with a
prefix-cache hit.  They must also equal a dense, unpaged greedy decode of the same
weights (tests/test_engine_e2e.py:dense_reference_greedy).
"""
import asyncio

import numpy as np
import pytest
import torch

from test_engine_e2e import dense_reference_greedy

ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=8,
                 session_len=256, max_prefill_token_num=64)


def make_prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 250, size=n).tolist() for n in lengths]


def generate(pkg, path, prompts, new_tokens=12, sequential=False, gen_kw=None, **cfg):
    """Greedy tokens for each prompt; returns (tokens, engine)."""
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import GenerationConfig, TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
        kw = {'device': 'cpu'}
    engine = Engine.from_pretrained(path, TpuEngineConfig(**dict(ENGINE_KW, **cfg)), **kw)
    inst = engine.create_instance()
    gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True, **(gen_kw or {}))

    async def go():
        if sequential:
            return [await inst.async_infer(i + 1, p, gen) for i, p in enumerate(prompts)]
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen)
                                      for i, p in enumerate(prompts)])
    try:
        outs = asyncio.run(go())
    finally:
        engine.close()
    return [o.token_ids for o in outs], engine


@pytest.mark.parametrize('case', ['batch', 'penalties', 'preempt', 'prefix'])
def test_greedy_tokens_match_jax_engine(tiny_model_dir, case):
    prompts = make_prompts(0, (5, 37, 70, 12, 23))
    kw = {}
    if case == 'penalties':
        kw['gen_kw'] = dict(repetition_penalty=1.3, frequency_penalty=0.2)
    elif case == 'preempt':
        # 14 usable blocks of 16 tokens cannot hold five growing sequences
        kw.update(num_gpu_blocks=15, new_tokens=40)
    elif case == 'prefix':
        shared = make_prompts(1, (48,))[0]
        prompts = [shared + p for p in make_prompts(2, (3, 9))] + [shared + [7]]
        kw.update(enable_prefix_caching=True, sequential=True)
    ref, _ = generate('jax', tiny_model_dir, prompts, **kw)
    out, engine = generate('torch', tiny_model_dir, prompts, **kw)
    assert out == ref
    if case == 'preempt':
        assert engine.scheduler.num_preemptions > 0
    if case == 'prefix':
        assert engine.scheduler.block_trie.num_cached_blocks >= 3


def test_greedy_tokens_match_dense_reference(tiny_model_dir):
    from lmdeploy_tpu_torch.config import ModelConfig
    prompts = make_prompts(3, (9, 30))
    out, engine = generate('torch', tiny_model_dir, prompts, new_tokens=10)
    agent = engine.model_agent
    params = agent.model.unfuse_projections(agent.params)
    params_np = {k: v.numpy() if not isinstance(v, dict)
                 else {k2: v2.numpy() for k2, v2 in v.items()} for k, v in params.items()}
    cfg = ModelConfig.from_pretrained(tiny_model_dir)
    for p, toks in zip(prompts, out):
        assert toks == dense_reference_greedy(params_np, cfg, p, 10)


def test_sampled_requests_are_seeded(tiny_model_dir):
    """Sampled rows run the candidate path in the decode runs: same seed, same tokens;
    another seed, other tokens."""
    prompts = make_prompts(4, (6, 11))
    gk = dict(do_sample=True, top_k=20, temperature=1.0, random_seed=7)
    a, _ = generate('torch', tiny_model_dir, prompts, new_tokens=16, gen_kw=gk)
    b, _ = generate('torch', tiny_model_dir, prompts, new_tokens=16, gen_kw=gk)
    c, _ = generate('torch', tiny_model_dir, prompts, new_tokens=16,
                    gen_kw=dict(gk, random_seed=8))
    assert a == b and a != c
    assert all(len(t) == 16 for t in a)


@pytest.mark.parametrize('field', [
    dict(tp=2), dict(dp=2), dict(ep=2), dict(cp=2), dict(attn_tp_size=2),
    dict(num_cpu_blocks=16), dict(quant_policy=8), dict(model_format='awq'),
    dict(eager_mode=True), dict(role='prefill'), dict(adapters={'a': 'path'}),
    dict(dllm_block_length=4), dict(memdecode={'memory_model_path': 'path'}),
    dict(revision='main')])
def test_unported_engine_config_raises(tiny_model_dir, field):
    """A field the port does not serve yet raises, on both ways into the Engine,
    rather than serving plain single-device output."""
    from lmdeploy_tpu_torch.config import EngineConfigBundle
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    name = next(iter(field))
    with pytest.raises(NotImplementedError, match=name):
        Engine.from_pretrained(tiny_model_dir, TpuEngineConfig(**ENGINE_KW, **field),
                               device='cpu')
    bundle = EngineConfigBundle.build(tiny_model_dir, TpuEngineConfig(**ENGINE_KW))
    with pytest.raises(NotImplementedError, match=name):
        Engine(None, TpuEngineConfig(**field), configs=bundle, device='cpu')


def test_entry_points_need_cuda_unless_cpu(tiny_model_dir, monkeypatch):
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        Engine.from_pretrained(tiny_model_dir, TpuEngineConfig(**ENGINE_KW))
