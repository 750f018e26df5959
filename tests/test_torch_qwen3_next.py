"""Qwen3-Next in the port against the JAX package on a tiny seeded checkpoint (hidden
64, 4 layers: 3 gated-DeltaNet, 1 gated full attention; 4 experts, top-2, a shared
expert): the loader against ``load_params_np``, forward logits and the state rows and
pages each step leaves, inactive rows and the graph runner's scratch pass leaving every
live slot's state bit for bit, the scheduler's SSM-checkpoint decisions, exact greedy
Engine tokens (concurrent sessions over reused slots, chunked prefill, prompts of 64
tokens and more, recompute preemption, prefix caching with state checkpoints) and the
guards that raise."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybrid_cases as hc

# logits and state rows: the chunked form's unit-triangular solve amplifies the two
# packages' f32 summation-order differences (~4e-4 at |logits| <= 5 after a 70-token
# chunk; ~1e-5 on scan steps), so the model-level tolerance is 1e-3; the ops
# themselves match at 1e-5 (test_torch_gated_delta.py)
TOL = dict(rtol=1e-3, atol=1e-3)
TABLES = np.array([[1, 2, 3, 4, 5, 0], [6, 7, 8, 9, 10, 11]], np.int32)


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return hc.write_qwen3_next(str(tmp_path_factory.mktemp('qwen3_next') / 'ckpt'))


@pytest.fixture(scope='module')
def models(ckpt):
    return hc.models(ckpt)


def test_loader_matches_load_params_np(ckpt, models):
    """Every leaf equals the JAX loader's, converted; the zero-centred norms carry +1
    (the gated norm does not), conv1d [C, 1, K] -> [C, K], the per-key-head qkvz kept
    fused."""
    from safetensors.numpy import load_file
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    _, jp, tm, tp = models
    conv = params_from_jax(jp)
    assert set(conv) == set(tp) and set(conv['blocks']) == set(tp['blocks'])
    for k in ('embed', 'final_norm', 'lm_head'):
        assert torch.equal(conv[k], tp[k]), k
    for k, v in tp['blocks'].items():
        assert torch.equal(conv['blocks'][k], v), k
    sd = load_file(ckpt + '/model.safetensors')
    b = tp['blocks']
    np.testing.assert_array_equal(b['attn_norms'][0, 1].numpy(),
                                  sd['model.layers.1.input_layernorm.weight'] + 1)
    np.testing.assert_array_equal(b['fa_q_norm'][0].numpy(),
                                  sd['model.layers.3.self_attn.q_norm.weight'] + 1)
    np.testing.assert_array_equal(b['lin_gate_norm'][0, 2].numpy(),
                                  sd['model.layers.2.linear_attn.norm.weight'])
    np.testing.assert_array_equal(b['lin_conv_w'][0, 0].numpy(),
                                  sd['model.layers.0.linear_attn.conv1d.weight'][:, 0])
    np.testing.assert_array_equal(tp['final_norm'].numpy(), sd['model.norm.weight'] + 1)


def _caches(jm, slots, NB=12, BS=16):
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference
    cfg = jm.config
    _, hdp = kv_row_width(cfg.num_key_value_heads, cfg.head_dim)
    jcache = {'pages': jnp.zeros((cfg.num_cache_layers, NB, 2, BS, hdp), jnp.float32)}
    for name, sd in jm.state_shapes(slots).items():
        jcache[name] = jnp.zeros(sd.shape, sd.dtype)
    tcache = cache_from_reference(jax.tree_util.tree_map(np.asarray, jcache),
                                  cfg.num_key_value_heads, cfg.head_dim)
    return jcache, tcache


def test_cache_converts_both_ways(models):
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference
    jm = models[0]
    rng = np.random.RandomState(0)
    jcache, _ = _caches(jm, 5)
    ref = {k: rng.randn(*v.shape).astype(np.float32) for k, v in jcache.items()}
    cfg = jm.config
    back = cache_to_reference(cache_from_reference(ref, cfg.num_key_value_heads,
                                                   cfg.head_dim))
    pages = ref['pages'].copy()
    pages[..., cfg.num_key_value_heads * cfg.head_dim:] = 0      # the reference's padding
    np.testing.assert_array_equal(back['pages'], pages)
    for k in ('conv', 'rec'):
        np.testing.assert_array_equal(back[k], ref[k])


@functools.lru_cache(maxsize=None)
def _jitted(jm):
    """The reference's forward jitted once per model (eager JAX compiles every
    primitive), so steps of one shape share a compile."""
    return jax.jit(jm.forward, static_argnames=('return_all_logits', 'fresh_prefill'))


def _step(models, jcache, tcache, ids, hist, qlen, T, slots, reset, fresh):
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    jm, jp, tm, tp = models
    cfg = jm.config
    B = len(hist)
    tables = TABLES[:B]
    hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
    x = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    for b in range(B):
        x[b, :qlen[b]] = ids[b, hist[b]:hist[b] + qlen[b]]
        pos[b, :qlen[b]] = np.arange(hist[b], hist[b] + qlen[b])
    slots, reset = np.array(slots, np.int32), np.array(reset, bool)
    jcos, jsin = jrope(cfg.rope_dim, 256, cfg.rope_theta)
    tcos, tsin = trope(cfg.rope_dim, 256, cfg.rope_theta)
    jl, jcache = _jitted(jm)(
        jp, jnp.asarray(x), jnp.asarray(pos), jcache,
        JMeta(jnp.asarray(tables), jnp.asarray(hist), jnp.asarray(qlen), jnp.asarray(slots),
              jnp.asarray(reset)),
        jcos, jsin, return_all_logits=True, fresh_prefill=fresh)
    tl = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                    TMeta(torch.from_numpy(tables), torch.from_numpy(hist),
                          torch.from_numpy(qlen), torch.from_numpy(slots),
                          torch.from_numpy(reset)),
                    tcos, tsin, return_all_logits=True, fresh_prefill=fresh)
    jl = np.asarray(jl)
    for b in range(B):
        np.testing.assert_allclose(tl[b, :qlen[b]].numpy(), jl[b, :qlen[b]], **TOL)
    return jcache


def test_logits_and_state_rows_match_jax(models):
    """A fresh prefill of 70 / 45 tokens (T 80 > 63: the chunked form) into slots 2 and
    0 over stale state (zeroed by the reset), a continuation chunk of 9 / 16 (the scan),
    then two decode steps with row 1 inactive at the second: logits, pages and every
    state row against the JAX model's."""
    from lmdeploy_tpu_torch.weight_convert import cache_to_reference
    jm = models[0]
    jcache, tcache = _caches(jm, 4)
    rng = np.random.RandomState(7)
    stale = {k: rng.randn(*tcache[k].shape).astype(np.float32) for k in ('conv', 'rec')}
    for k, v in stale.items():
        jcache[k] = jnp.asarray(v)
        tcache[k].copy_(torch.from_numpy(v))
    ids = rng.randint(3, 120, size=(2, 96)).astype(np.int32)
    steps = [((0, 0), (70, 45), 80, (2, 0), (True, True), True),
             ((70, 45), (9, 16), 16, (2, 0), (False, False), False),
             ((79, 61), (1, 1), 1, (2, 0), (False, False), False),
             ((80, 62), (1, 0), 1, (2, 0), (False, False), False)]
    for hist, qlen, T, slots, reset, fresh in steps:
        before = {k: v.clone() for k, v in tcache.items() if k != 'pages'}
        jcache = _step(models, jcache, tcache, ids, hist, qlen, T, slots, reset, fresh)
        ref = jax.tree_util.tree_map(np.asarray, jcache)
        got = cache_to_reference(tcache)
        # the pages at every valid token so far (padding tokens write garbage)
        for b, (h, q) in enumerate(zip(hist, qlen)):
            n = h + q
            blocks = TABLES[b, :(n + 15) // 16]
            rows = lambda c: c['pages'][:, blocks].swapaxes(1, 2).reshape(
                c['pages'].shape[0], 2, -1, c['pages'].shape[-1])[:, :, :n]
            np.testing.assert_allclose(rows(got), rows(ref), **TOL)
        for k in ('conv', 'rec'):
            # the live slots 0 and 2 as the reference's; slot 1 (never used) untouched
            np.testing.assert_allclose(got[k][:, [0, 2]], ref[k][:, [0, 2]], **TOL)
            assert torch.equal(tcache[k][:, 1], before[k][:, 1])
        if qlen == (1, 0):
            # the inactive row's slot keeps its state bit for bit
            assert all(torch.equal(tcache[k][:, 0], before[k][:, 0]) for k in before)



def test_scratch_pass_and_inactive_rows_keep_state_bitwise(ckpt):
    """The decode graph runner's scratch pass (``_decode_body(scratch=True)``: one step
    over a state of inactive rows, run while live rows hold state) and a decode run
    whose row 1 is inactive leave every slot's conv and rec state bit for bit as it was,
    but the active row's (which moves); rows without a valid token write the garbage
    slot (the last) instead of their own."""
    from lmdeploy_tpu_torch.engine.graph_runner import DecodeRun
    from lmdeploy_tpu_torch.ops.sampling import TOPK_CANDIDATES
    engine = hc.build('torch', ckpt)
    try:
        agent = engine.model_agent
        cache = agent.kv_cache
        gen = torch.Generator().manual_seed(0)
        for k in ('conv', 'rec'):
            cache[k].copy_(torch.randn(cache[k].shape, generator=gen))
        key = (1, 2, True, 0, TOPK_CANDIDATES, False)
        live = slice(0, agent.max_batch)
        before = {k: cache[k][:, live].clone() for k in ('conv', 'rec')}
        agent._decode_body(DecodeRun(key, agent.device), scratch=True)
        assert all(torch.equal(cache[k][:, live], before[k]) for k in before)
        st = agent.decode_state
        st.active[0], st.token[0], st.position[0], st.tables[0, 0] = True, 5, 3, 1
        agent._decode_body(DecodeRun(key, agent.device))
        for k in before:
            assert not torch.equal(cache[k][:, 0], before[k][:, 0])
            assert torch.equal(cache[k][:, 1:agent.max_batch], before[k][:, 1:])
    finally:
        engine.close()


def test_guards_raise(ckpt, tmp_path):
    """Speculative decoding over a hybrid target (its state rollback), context
    parallelism on a hybrid model, and the Qwen3.5 meta-MoE names raise, naming the
    ROADMAP item; a hybrid model's cache holds pages for its full-attention layers only,
    and its expert stacks keep 128-row decode buckets eager."""
    import json
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.messages import SpeculativeConfig
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    with pytest.raises(NotImplementedError, match='item 14'):
        Engine.from_pretrained(ckpt, TpuEngineConfig(**hc.ENGINE_KW), device='cpu',
                               speculative_config=SpeculativeConfig(
                                   method='draft_model', model=ckpt,
                                   num_speculative_tokens=2))
    with pytest.raises(NotImplementedError, match='hybrid linear-attention'):
        hc.build('torch', ckpt, cp=2)
    cfg = json.load(open(ckpt + '/config.json'))
    cfg['architectures'] = ['MetaMoeForConditionalGeneration']
    with pytest.raises(NotImplementedError, match='item 14'):
        build_model(ModelConfig.from_hf_config(cfg))
    from lmdeploy_tpu_torch.engine.model_agent import ragged_min_rows
    from lmdeploy_tpu_torch.ops.moe import RAGGED_MIN_TOKENS
    engine = hc.build('torch', ckpt)
    try:
        # a decode bucket of 128 rows takes the grouped expert GEMM: graphs stay off
        assert ragged_min_rows(engine.model_agent.params) == RAGGED_MIN_TOKENS
        cache = engine.model_agent.kv_cache
        assert set(cache) == {'pages', 'conv', 'rec'}
        assert cache['pages'].shape[0] == 1 and cache['rec'].shape[:2] == (3, 5)
        assert cache['conv'].shape == (3, 5, 3, 2 * hc.KD + hc.VD)
    finally:
        engine.close()
