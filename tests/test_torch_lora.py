"""LoRA adapters in the port (``lmdeploy_tpu_torch/lora.py``) against the reference's
(``lmdeploy_tpu/lora.py``), on the tiny checkpoint in f32 on the CPU.

PEFT checkpoints are written here with ``safetensors.numpy`` as the reference's
tests/test_lora.py writes them (q / v adapters of rank 4 and 2, and one of rank 3 on all
seven targets).  Parsing, the merge deltas and the S-LoRA slot stacks must equal the
reference's bit for bit; merged, swapped and unmerged engines, per-request slots and a
concurrent mixed batch must give the JAX engine's tokens (mirrors tests/test_lora.py:35,
62, 135, 172).  A merge writes the served leaves in place, so the decode runs built
before it read the merged weights; S-LoRA over a W4A16 base is held at the logits.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

H, I, NH, NKV, HD = 64, 128, 4, 2, 16
OUT = {'q_proj': NH * HD, 'k_proj': NKV * HD, 'v_proj': NKV * HD, 'o_proj': H,
       'gate_proj': I, 'up_proj': I, 'down_proj': H}
IN = {'q_proj': H, 'k_proj': H, 'v_proj': H, 'o_proj': NH * HD, 'gate_proj': H,
      'up_proj': H, 'down_proj': I}
MLP = ('gate_proj', 'up_proj', 'down_proj')
ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=48, max_batch_size=8,
                 session_len=128, max_prefill_token_num=64)
PROMPT = [1, 17, 42, 99, 7]


def peft_tensors(r, targets, seed, scale=0.1):
    """PEFT tensors of a rank-``r`` adapter on ``targets`` of both layers."""
    rng = np.random.RandomState(seed)
    tensors = {}
    for layer in range(2):
        for t in targets:
            group = 'mlp' if t in MLP else 'self_attn'
            p = f'base_model.model.model.layers.{layer}.{group}.{t}.'
            tensors[p + 'lora_A.weight'] = rng.randn(r, IN[t]).astype(np.float32) * scale
            tensors[p + 'lora_B.weight'] = rng.randn(OUT[t], r).astype(np.float32) * scale
    return tensors


def write_peft(path, r, alpha, targets, seed):
    from safetensors.numpy import save_file
    with open(path / 'adapter_config.json', 'w') as f:
        json.dump({'r': r, 'lora_alpha': alpha, 'peft_type': 'LORA',
                   'target_modules': list(targets)}, f)
    save_file(peft_tensors(r, targets, seed), str(path / 'adapter_model.safetensors'))
    return str(path)


# name: (rank, alpha, targets, seed)
SPECS = {'a': (4, 8, ('q_proj', 'v_proj'), 0), 'b': (2, 4, ('q_proj', 'v_proj'), 9),
         'c': (3, 6, tuple(OUT), 17)}


@pytest.fixture(scope='module')
def adapters(tmp_path_factory):
    """SPECS written as PEFT directories: name -> path."""
    return {n: write_peft(tmp_path_factory.mktemp(f'peft_{n}'), *s) for n, s in SPECS.items()}


def models(path):
    from lmdeploy_tpu.config import ModelConfig as JCfg
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    return (jbuild(JCfg.from_pretrained(path, dtype='float32')),
            build_model(ModelConfig.from_pretrained(path, dtype='float32')))


@pytest.mark.parametrize('name', ['a', 'b', 'c'])
def test_peft_parsing_and_deltas_match_reference(tiny_model_dir, adapters, name):
    from lmdeploy_tpu import lora as jlora
    from lmdeploy_tpu_torch import lora
    jw, js = jlora.load_peft_adapter(adapters[name])
    w, s = lora.load_peft_adapter(adapters[name])
    assert s == js and set(w) == set(jw)
    for module in w:
        for layer in (0, 1):
            for ab in 'AB':
                assert np.array_equal(w[module][layer][ab], jw[module][layer][ab])
    # the same adapter from tensors already in memory (no safetensors)
    r, alpha, targets, seed = SPECS[name]
    mem_w, mem_s = lora.peft_weights(peft_tensors(r, targets, seed),
                                     {'r': r, 'lora_alpha': alpha})
    assert mem_s == s and all(np.array_equal(mem_w[m][li][ab], w[m][li][ab])
                              for m in w for li in (0, 1) for ab in 'AB')
    jm, tm = models(tiny_model_dir)
    jd, td = jlora.build_deltas(jm, jw, js), lora.build_deltas(tm, w, s)
    assert set(td) == set(jd) and all(np.array_equal(td[m], jd[m]) for m in td)


def test_slora_stacks_and_weight_convert_match_reference(tiny_model_dir, adapters):
    from lmdeploy_tpu import lora as jlora
    from lmdeploy_tpu_torch import lora
    from lmdeploy_tpu_torch.weight_convert import slora_stacks_from_reference
    jm, tm = models(tiny_model_dir)
    jstacks, jmap = jlora.build_slora_stacks(jm, adapters)
    stacks, slot_map = lora.build_slora_stacks(tm, adapters)
    assert slot_map == jmap == {'a': 1, 'b': 2, 'c': 3}
    conv = slora_stacks_from_reference(jstacks)
    assert set(stacks) == set(jstacks) == set(lora.SLORA_TARGETS)
    for t, ab in stacks.items():
        for k in 'ab':
            assert ab[k].dtype == torch.float32
            assert torch.equal(ab[k], conv[t][k])
            assert np.array_equal(ab[k].numpy(), jstacks[t][k])
            assert not ab[k][:, 0].any()                 # slot 0: no adapter
        assert ab['a'].shape[-1] == 4                    # ranks padded to the largest


def _engine(pkg, path, **cfg):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import TpuEngineConfig
        return Engine.from_pretrained(path, TpuEngineConfig(**ENGINE_KW, **cfg))
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    return Engine.from_pretrained(path, TpuEngineConfig(**ENGINE_KW, **cfg), device='cpu')


def gen(engine, rows, first=1, n=6):
    """Serve ``rows`` (adapter names, None for none) concurrently on PROMPT (and
    variants of it): each row's greedy tokens."""
    if type(engine).__module__.startswith('lmdeploy_tpu_torch'):
        from lmdeploy_tpu_torch.messages import GenerationConfig
    else:
        from lmdeploy_tpu.messages import GenerationConfig
    inst = engine.create_instance()

    async def go():
        outs = await asyncio.gather(*[inst.async_infer(
            first + i, PROMPT + [3 + i], GenerationConfig(max_new_tokens=n, ignore_eos=True,
                                                          adapter_name=name))
            for i, name in enumerate(rows)])
        for i in range(len(rows)):
            await inst.async_end(first + i)
        return [list(o.token_ids) for o in outs]
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


def merge_sequence(pkg, path, adapters):
    """base, merged 'a', swapped to 'c', unmerged: each stage's tokens for one row
    of each kind; the port also shows that the merges keep every leaf's storage."""
    engine = _engine(pkg, path)
    try:
        out = {'base': gen(engine, [None], 1)}
        if pkg == 'torch':
            agent = engine.model_agent
            agent.warmup(batch_sizes=[1])
            runs = dict(agent.graphs.runs)
            leaves = agent.model.unfuse_projections(agent.params)['layers']
            ptrs = {k: v.data_ptr() for k, v in leaves.items() if torch.is_tensor(v)}
            base_wq = leaves['wq'].clone()
        engine.load_lora('a', adapters['a'])
        engine.load_lora('c', adapters['c'])
        engine.activate_lora('a')
        out['a'] = gen(engine, [None], 11)
        engine.activate_lora('c')
        out['c'] = gen(engine, [None], 21)
        engine.deactivate_lora()
        out['restored'] = gen(engine, [None], 31)
        if pkg == 'torch':
            leaves = agent.model.unfuse_projections(agent.params)['layers']
            assert {k: v.data_ptr() for k, v in leaves.items() if torch.is_tensor(v)} == ptrs
            assert all(agent.graphs.runs[k] is r for k, r in runs.items())
            np.testing.assert_allclose(leaves['wq'].numpy(), base_wq.numpy(), atol=1e-6)
        return out
    finally:
        engine.close()


def test_lora_merge_swap_unmerge_matches_jax(tiny_model_dir, adapters):
    """Merged engines: the port's tokens at every stage equal the JAX engine's; the
    port writes the merge into the leaves the decode runs built before it read (same
    storage, same runs), and unmerging gives back the base up to rounding."""
    ref = merge_sequence('jax', tiny_model_dir, adapters)
    out = merge_sequence('torch', tiny_model_dir, adapters)
    assert out == ref
    assert out['a'] != out['base'] and out['c'] != out['a'] and out['restored'] == out['base']


def test_slora_multiplexing_matches_jax(tiny_model_dir, adapters):
    """Per-request slots, one row at a time and all in one concurrent batch: the JAX
    engine's tokens; slot 0 gives the base model's tokens and each slot its merged
    adapter's (the port's merged engine)."""
    rows = [None, 'a', 'b', 'c', None]
    got = {}
    for pkg in ('jax', 'torch'):
        engine = _engine(pkg, tiny_model_dir, adapters=adapters)
        try:
            solo = [gen(engine, [name], 100 + 10 * i)[0] for i, name in enumerate(rows)]
            together = gen(engine, rows, 200)
        finally:
            engine.close()
        got[pkg] = (solo, together)
    assert got['torch'] == got['jax']
    solo, together = got['torch']
    assert together == [gen_one(tiny_model_dir, adapters, name, i)
                        for i, name in enumerate(rows)]
    assert len({tuple(t) for t in together[:4]}) == 4


def test_slora_stacks_before_cache_budget(tiny_model_dir, adapters, monkeypatch):
    """An S-LoRA engine at the default cache fraction, its KV cache sized from free
    memory: the agent attaches the stacks to leaves it never fused before the cache
    reads its budget, so the budget counts them; a mixed batch then gives the JAX
    engine's tokens."""
    from lmdeploy_tpu_torch import lora
    from lmdeploy_tpu_torch.engine import cache_engine
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    order = []
    build, derive = lora.build_slora_stacks, cache_engine.CacheEngine._derive_num_blocks
    monkeypatch.setattr(lora, 'build_slora_stacks',
                        lambda *a, **k: order.append('stacks') or build(*a, **k))
    monkeypatch.setattr(cache_engine.CacheEngine, '_derive_num_blocks',
                        lambda self: order.append('budget') or derive(self))
    monkeypatch.setattr(cache_engine, 'CPU_CACHE_BYTES', 8 << 20)
    kw = dict(ENGINE_KW, num_gpu_blocks=0)
    config = TpuEngineConfig(**kw, adapters=adapters)
    assert config.cache_max_entry_count == TpuEngineConfig().cache_max_entry_count
    engine = Engine.from_pretrained(tiny_model_dir, config, device='cpu')
    rows = [None, 'c', 'a', 'b']
    try:
        assert order == ['stacks', 'budget']
        agent = engine.model_agent
        assert agent.num_blocks == int((8 << 20) * config.cache_max_entry_count) // (
            agent.cache_engine.block_bytes())
        layers = agent.params['layers']
        assert 'wqkv' not in layers and 'w_gateup' not in layers
        assert all(layers[t].is_contiguous() for t in lora.SLORA_TARGETS)
        got = gen(engine, rows, 300)
    finally:
        engine.close()
    ref_engine = _engine('jax', tiny_model_dir, adapters=adapters)
    try:
        assert got == gen(ref_engine, rows, 300)
    finally:
        ref_engine.close()


def gen_one(path, adapters, name, i):
    """Row ``i``'s tokens on the port's merged engine of adapter ``name`` (or the
    base)."""
    engine = _engine('torch', path)
    try:
        if name is not None:
            engine.load_lora(name, adapters[name])
            engine.activate_lora(name)
        inst = engine.create_instance()
        from lmdeploy_tpu_torch.messages import GenerationConfig

        async def go():
            return await inst.async_infer(1, PROMPT + [3 + i],
                                          GenerationConfig(max_new_tokens=6, ignore_eos=True))
        return list(asyncio.run(go()).token_ids)
    finally:
        engine.close()


def test_slora_refusals(tiny_model_dir, adapters, tmp_path):
    """An unknown adapter name raises ValueError naming the loaded ones; a family
    whose forward the reference does not give adapters (Qwen3-Next), one whose own MLP
    the reference's S-LoRA MLP would replace (Gemma's gelu) and a speculative config
    raise NotImplementedError."""
    import dense_family_cases as dfc
    import hybrid_cases as hc
    from lmdeploy_tpu_torch.messages import GenerationConfig, SpeculativeConfig
    engine = _engine('torch', tiny_model_dir, adapters={'a': adapters['a']})
    inst = engine.create_instance()

    async def go():
        with pytest.raises(ValueError, match=r"unknown adapter 'nope'; loaded: \['a'\]"):
            await inst.async_infer(1, PROMPT, GenerationConfig(max_new_tokens=2,
                                                               adapter_name='nope'))
    try:
        asyncio.run(go())
    finally:
        engine.close()
    with pytest.raises(NotImplementedError, match='Qwen3NextModel'):
        _engine('torch', hc.write_qwen3_next(str(tmp_path)), adapters={'a': adapters['a']})
    gemma = tmp_path / 'gemma'
    gemma.mkdir()
    with pytest.raises(NotImplementedError, match="GemmaModel.*silu MLP"):
        _engine('torch', dfc.write_checkpoint(str(gemma), 'gemma'),
                adapters={'a': adapters['a']})
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    with pytest.raises(NotImplementedError, match='speculative'):
        Engine.from_pretrained(tiny_model_dir, TpuEngineConfig(**ENGINE_KW, adapters=adapters),
                               device='cpu', speculative_config=SpeculativeConfig(
                                   method='draft_model', model=tiny_model_dir,
                                   num_speculative_tokens=2))


def test_slora_over_w4a16_matches_jax(tiny_model_dir, adapters, tmp_path):
    """S-LoRA adds to each projection's output, so it runs over W4A16 leaves (the gd
    schedule's prepared form, unfused) in both packages: prefill and 3 decode steps of
    rows on slots 0, 1 and 3, logits within the W4A16 tests' LOGIT_ATOL of the
    reference's (Pallas in interpret mode), the adapters moving them far more."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from lmdeploy_tpu import lora as jlora
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch import lora
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    from lmdeploy_tpu_torch.weight_loader import load_params
    from lmdeploy_tpu.weight_loader import load_model_params
    from test_torch_quant_matmul import LOGIT_ATOL, _write_w4_checkpoint
    path = _write_w4_checkpoint(tiny_model_dir, tmp_path, 'awq')
    jm, tm = models(path)
    jp = jm.prep_quant_leaves(load_model_params(jm, path), mode='gd')
    tp = tm.prep_quant_leaves(load_params(tm, path, 'cpu'), mode='gd')
    jstacks, _ = jlora.build_slora_stacks(jm, adapters)
    stacks, _ = lora.build_slora_stacks(tm, adapters)
    jp = dict(jp, lora={t: {k: jnp.asarray(v) for k, v in ab.items()}
                        for t, ab in jstacks.items()})
    cfg = jm.config
    L, BS, NB = cfg.num_layers, 16, 12
    _, hdp = kv_row_width(cfg.num_key_value_heads, cfg.head_dim)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = torch.zeros((L, NB, 2, BS, cfg.num_key_value_heads * cfg.head_dim))
    tcache_base = tcache.clone()
    jcos, jsin = jrope(cfg.head_dim, 256, cfg.rope_theta)
    tcos, tsin = make_rope_table(cfg.head_dim, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    ids = np.random.RandomState(0).randint(3, 250, size=(3, 24)).astype(np.int32)
    slots = np.array([0, 1, 3], np.int32)
    moved = 0.0
    with pltpu.force_tpu_interpret_mode():
        for hist, T, fresh in [(0, 20, True)] + [(20 + i, 1, False) for i in range(3)]:
            x, pos = ids[:, hist:hist + T], np.tile(np.arange(hist, hist + T), (3, 1))
            h, q = np.full(3, hist, np.int32), np.full(3, T, np.int32)
            jl, jcache = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos.astype(np.int32)),
                                    jcache, JMeta(jnp.asarray(tables), jnp.asarray(h),
                                                  jnp.asarray(q)), jcos, jsin,
                                    fresh_prefill=fresh, adapter_ids=jnp.asarray(slots))
            xs = (torch.from_numpy(x), torch.from_numpy(pos.astype(np.int32)))
            meta = (AttnMeta(torch.from_numpy(tables), torch.from_numpy(h),
                             torch.from_numpy(q)), tcos, tsin)
            tl = tm.forward(dict(tp, lora=stacks), *xs, tcache, *meta, fresh_prefill=fresh,
                            adapter_ids=torch.from_numpy(slots))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
            base = tm.forward(tp, *xs, tcache_base, *meta, fresh_prefill=fresh)
            assert torch.equal(base[0], tl[0])           # slot 0 adds zeros
            moved = max(moved, float((tl[1:] - base[1:]).abs().max()))
    assert moved > 10 * LOGIT_ATOL
