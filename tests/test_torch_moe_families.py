"""PhiMoE, GLM-4.5 MoE and DeepSeek-MoE 16B: the port against the JAX package (CPU).

Three tiny checkpoints written here with safetensors (f32, random norms and biases):
  * ``phimoe`` (``PhiMoEForCausalLM``): LayerNorm with bias, biased q / k / v / o
    projections, an lm_head bias, sparsemixer top-2 over 4 experts and longrope tables
    (the factors and ``original_max_position_embeddings`` 64 in ``rope_scaling``, so
    the engine's 256-position table takes the long factors and the attention factor);
  * ``glm4_moe`` (``Glm4MoeForCausalLM``): GQA with bias and qk-norm, rope on half of
    each head, one dense layer then two MoE layers of sigmoid scores with the
    correction bias, 2 groups of which 1 is kept, routed scaling 1.5, one shared expert;
  * ``deepseek_v1`` (``DeepseekForCausalLM``): full rotary, softmax scores without
    renormalization, two shared experts.
Checked: ``sparsemixer_route`` (ties, scores at the jitter threshold, the weights of
given choices), longrope tables on both sides of ``original_max_position_embeddings``,
the LayerNorm, the public geometries ``chip_smoke.py`` serves, the loaders' trees, f32
logits of prefill (one chunked row) and decode steps, and exact greedy tokens of
``Engine`` against the JAX engine.

Tolerances: routing choices equal and weights at 1e-6; rope tables at 1e-6 (both f32,
one cos / sin each); LayerNorm at 1e-6 in f32 and one bf16 ulp in bf16; logits at 1e-4
absolute (they reach ~0.5).
"""
import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import DEEPSEEK_MOE_16B, GLM45_AIR, PHI35_MOE
from conftest import make_tiny_tokenizer

V = 128
ROPE_FACTORS = np.random.RandomState(3)
LONGROPE = {'type': 'longrope', 'original_max_position_embeddings': 64,
            'short_factor': (1.0 + ROPE_FACTORS.rand(8)).round(4).tolist(),
            'long_factor': (1.0 + 4 * ROPE_FACTORS.rand(8)).round(4).tolist()}
BASE = {'hidden_size': 64, 'num_attention_heads': 4, 'num_key_value_heads': 2,
        'head_dim': 16, 'vocab_size': V, 'max_position_embeddings': 512,
        'rope_theta': 10000.0, 'bos_token_id': 1, 'eos_token_id': 2,
        'torch_dtype': 'float32', 'tie_word_embeddings': False}
CFGS = {
    'phimoe': dict(BASE, architectures=['PhiMoEForCausalLM'], model_type='phimoe',
                   intermediate_size=48, num_hidden_layers=2, num_local_experts=4,
                   num_experts_per_tok=2, router_jitter_noise=0.01, attention_bias=True,
                   lm_head_bias=True, rms_norm_eps=1e-5, rope_scaling=LONGROPE),
    'glm4_moe': dict(BASE, architectures=['Glm4MoeForCausalLM'], model_type='glm4_moe',
                     intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
                     first_k_dense_replace=1, partial_rotary_factor=0.5,
                     attention_bias=True, use_qk_norm=True, n_routed_experts=8,
                     n_shared_experts=1, num_experts_per_tok=2, n_group=2, topk_group=1,
                     norm_topk_prob=True, routed_scaling_factor=1.5, rms_norm_eps=1e-5),
    'deepseek_v1': dict(BASE, architectures=['DeepseekForCausalLM'], model_type='deepseek',
                        intermediate_size=96, moe_intermediate_size=32,
                        num_hidden_layers=3, first_k_dense_replace=1, n_routed_experts=8,
                        n_shared_experts=2, num_experts_per_tok=3, moe_layer_freq=1,
                        norm_topk_prob=False, scoring_func='softmax', rms_norm_eps=1e-6),
}
ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
ATOL = 1e-4


def _write_checkpoint(path, name, seed=11):
    from safetensors.numpy import save_file
    c = CFGS[name]
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(c, f)
    make_tiny_tokenizer(str(path), vocab_size=V)
    rng = np.random.RandomState(seed)
    H, nh, nkv, D = (c['hidden_size'], c['num_attention_heads'], c['num_key_value_heads'],
                     c['head_dim'])
    phi = name == 'phimoe'
    t = {'model.embed_tokens.weight': rng.randn(V, H) * 0.02,
         'lm_head.weight': rng.randn(V, H) * 0.02}

    def norm(prefix, n=H, bias=phi):
        t[prefix + '.weight'] = 1.0 + 0.1 * rng.randn(n)
        if bias:
            t[prefix + '.bias'] = 0.1 * rng.randn(n)

    def lin(prefix, out_dim, in_dim, bias=False, scale=0.05):
        t[prefix + '.weight'] = rng.randn(out_dim, in_dim) * scale
        if bias:
            t[prefix + '.bias'] = rng.randn(out_dim) * 0.05
    norm('model.norm')
    if phi:
        t['lm_head.bias'] = rng.randn(V) * 0.05
    for layer in range(c['num_hidden_layers']):
        p = f'model.layers.{layer}.'
        norm(p + 'input_layernorm')
        norm(p + 'post_attention_layernorm')
        bias = c.get('attention_bias', False)
        lin(p + 'self_attn.q_proj', nh * D, H, bias)
        lin(p + 'self_attn.k_proj', nkv * D, H, bias)
        lin(p + 'self_attn.v_proj', nkv * D, H, bias)
        lin(p + 'self_attn.o_proj', H, nh * D, phi)
        if c.get('use_qk_norm'):
            norm(p + 'self_attn.q_norm', D, False)
            norm(p + 'self_attn.k_norm', D, False)
        if phi:
            E, ie = c['num_local_experts'], c['intermediate_size']
            t[p + 'block_sparse_moe.gate.weight'] = rng.randn(E, H) * 0.3
            for e in range(E):
                for hf, od, idim in (('w1', ie, H), ('w3', ie, H), ('w2', H, ie)):
                    lin(p + f'block_sparse_moe.experts.{e}.{hf}', od, idim, scale=0.2)
            continue
        if layer < c['first_k_dense_replace']:
            inter = c['intermediate_size']
            lin(p + 'mlp.gate_proj', inter, H)
            lin(p + 'mlp.up_proj', inter, H)
            lin(p + 'mlp.down_proj', H, inter)
            continue
        E, ie = c['n_routed_experts'], c['moe_intermediate_size']
        t[p + 'mlp.gate.weight'] = rng.randn(E, H) * 0.3
        if c.get('scoring_func', 'sigmoid') == 'sigmoid':
            t[p + 'mlp.gate.e_score_correction_bias'] = rng.randn(E) * 0.05
        for e in range(E):
            for hf, od, idim in (('gate_proj', ie, H), ('up_proj', ie, H), ('down_proj', H, ie)):
                lin(p + f'mlp.experts.{e}.{hf}', od, idim, scale=0.2)
        shared = c['n_shared_experts'] * ie
        lin(p + 'mlp.shared_experts.gate_proj', shared, H)
        lin(p + 'mlp.shared_experts.up_proj', shared, H)
        lin(p + 'mlp.shared_experts.down_proj', H, shared)
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in t.items()},
              os.path.join(path, 'model.safetensors'))
    return str(path)


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return {name: _write_checkpoint(tmp_path_factory.mktemp(f'tiny_{name}'), name)
            for name in CFGS}


# -- routing, rope, norm ---------------------------------------------------------------------
def _sparsemixer_logits():
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 8).astype(np.float32)
    logits[0] = [0.7, 1.2, 1.2, -0.3, 1.2, 0.0, 0.1, 0.2]          # a three-way tie
    logits[1] = [1.0, 0.98, 0.5, 0.98, -1.0, 1.0, 0.0, 0.9]        # two ties at the top
    base = np.float32(1.0)
    logits[2] = [base, base - np.float32(0.02), base - np.float32(0.019999),
                 base - np.float32(0.020001), 0.0, -5.0, 0.3, 0.99]   # at the threshold
    logits[3] = 0.0                                                  # all equal
    logits[4] = [-2.0, -1.0, -1.0, -3.0, -1.02, -1.01, -4.0, -1.5]  # negative maxima
    return logits


def test_sparsemixer_route_matches_jax():
    """Choices and weights equal to the reference's, ties to the lower index, and the
    weights of given choices (the parity runs' fixed routing) equal to the route's."""
    from lmdeploy_tpu.models.phimoe import sparsemixer_route as jroute
    from lmdeploy_tpu_torch.models.phimoe import sparsemixer_route, sparsemixer_weights
    logits = _sparsemixer_logits()
    ji, jw = jroute(jnp.asarray(logits), 0.01)
    ti, tw = sparsemixer_route(torch.from_numpy(logits), 0.01)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert ti[0].tolist() == [1, 2] and ti[1].tolist() == [0, 5] and ti[3].tolist() == [0, 1]
    np.testing.assert_array_equal(
        sparsemixer_weights(torch.from_numpy(logits), ti, 0.01).numpy(), tw.numpy())


@pytest.mark.parametrize('max_len', [48, 64, 256])
def test_longrope_tables_match_jax(max_len):
    """One table for every position: the short factors up to
    original_max_position_embeddings (64), the long factors and the attention factor
    sqrt(1 + ln(s) / ln(64)) beyond it, as the reference builds them."""
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    jc, js = jrope(16, max_len, 10000.0, LONGROPE)
    tc, ts = trope(16, max_len, 10000.0, LONGROPE)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    factors = LONGROPE['long_factor' if max_len > 64 else 'short_factor']
    inv = 1.0 / (10000.0 ** (np.arange(0, 16, 2) / 16)) / np.asarray(factors)
    attn = np.sqrt(1 + np.log(max_len / 64) / np.log(64)) if max_len > 64 else 1.0
    np.testing.assert_allclose(tc.numpy()[5], np.cos(5 * inv) * attn, rtol=0, atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_layer_norm_matches_jax(dtype):
    from lmdeploy_tpu.models.phimoe import PhiMoeModel as JPhi
    from lmdeploy_tpu_torch.nn.layers import layer_norm
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 64) * 3 + 1).astype(np.float32)
    w, b = (1 + 0.1 * rng.randn(64)).astype(np.float32), rng.randn(64).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(JPhi._norm(None, jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                                 jnp.asarray(b).astype(jd), 1e-5).astype(jnp.float32))
    got = layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                     torch.from_numpy(b).to(td), 1e-5).float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize('name,geometry', [('phimoe', PHI35_MOE), ('glm4_moe', GLM45_AIR),
                                           ('deepseek_v1', DEEPSEEK_MOE_16B)])
def test_public_configs(name, geometry):
    """The published geometries chip_smoke.py serves build on both packages with the
    same parameter shapes; the registry's switches (GLM's sigmoid scores, PhiMoE's
    biases) and DeepSeek-MoE's moe_layer_freq check hold."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    cfg = dict(geometry, num_hidden_layers=2)
    jm = jbuild(JConfig.from_hf_config(json.loads(json.dumps(cfg))))
    tm = build_model(ModelConfig.from_hf_config(cfg))
    jshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape) if hasattr(s, 'shape') else s,
                                     jm.param_shapes(),
                                     is_leaf=lambda s: isinstance(s, tuple))
    assert jshapes == tm.param_shapes()
    assert tm.config.scoring_func == jm.config.scoring_func
    if name == 'glm4_moe':
        assert tm.config.scoring_func == 'sigmoid' and tm.config.rope_dim == 64
    if name == 'deepseek_v1':
        with pytest.raises(ValueError, match='moe_layer_freq'):
            build_model(ModelConfig.from_hf_config(dict(cfg, moe_layer_freq=2)))


QUANT_CONFIGS = {'w8a8': {'quant_method': 'smooth_quant'},
                 'fp8': {'quant_method': 'fbgemm_fp8', 'activation_scheme': 'dynamic'},
                 'fp8_blocked': {'quant_method': 'fp8', 'activation_scheme': 'dynamic',
                                 'fmt': 'e4m3', 'weight_block_size': [128, 128]}}


@pytest.mark.parametrize('fmt', list(QUANT_CONFIGS))
@pytest.mark.parametrize('name,geometry', [('phimoe', PHI35_MOE), ('glm4_moe', GLM45_AIR),
                                           ('deepseek_v1', DEEPSEEK_MOE_16B)])
def test_eight_bit_checkpoints(name, geometry, fmt):
    """The MoE families refuse W8A8 and per-channel fp8 checkpoints (8-bit linear leaves
    serve the dense llama family); GLM-4.5 and DeepSeek-MoE take blocked fp8 by
    dequantizing it at load, PhiMoE refuses it too."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    cfg = ModelConfig.from_hf_config(dict(geometry, num_hidden_layers=2,
                                          quantization_config=QUANT_CONFIGS[fmt]))
    if fmt == 'fp8_blocked' and name != 'phimoe':
        model = build_model(cfg)
        assert model.quant_method is None and model.dequant_on_load
        return
    with pytest.raises(NotImplementedError, match=f'{fmt} checkpoints of .*dense llama'):
        build_model(cfg)


# -- checkpoints -----------------------------------------------------------------------------
def _models(path):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(path, dtype='float32'))
    tm = tbuild(TConfig.from_pretrained(path, dtype='float32'))
    jp = jax.tree_util.tree_map(np.asarray, load_model_params(jm, path))
    return jm, jp, tm, load_params(tm, path, 'cpu')


def _tree_equal(tp, jp, path=''):
    assert set(tp) == set(jp), (path, sorted(set(tp) ^ set(jp)))
    for name, leaf in tp.items():
        if isinstance(leaf, dict):
            _tree_equal(leaf, jp[name], path + '/' + name)
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jp[name]),
                                          err_msg=path + '/' + name)


@pytest.mark.parametrize('name', list(CFGS))
def test_loader_matches_jax(ckpt, name):
    """The loaded tree equals the JAX loader's: PhiMoE's norm biases, bo and
    lm_head_b; the GQA leaves and the expert, router and shared stacks of the layer
    groups."""
    _, jp, _, tp = _models(ckpt[name])
    _tree_equal(tp, jp)


@pytest.mark.parametrize('name', list(CFGS))
def test_forward_logits_match_jax(ckpt, name):
    """Prefill of two rows (one chunked: its second chunk reads the cache), then 3
    decode steps, f32, on the JAX loader's tree."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, params_from_jax
    jm, jp, tm, _ = _models(ckpt[name])
    tp = tm.fuse_projections(params_from_jax(jp, dtype=torch.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    cfg = jm.config
    L, BS, NB, hkv, D = cfg.num_layers, 16, 12, cfg.num_key_value_heads, cfg.head_dim
    _, hdp = kv_row_width(hkv, D)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), hkv, D)
    jcos, jsin = jrope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    tcos, tsin = trope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    ids = np.random.RandomState(0).randint(3, V, size=(2, 80)).astype(np.int32)
    steps = [((0, 0), (40, 48), 48, True), ((40, 48), (24, 0), 24, False)] + [
        ((64 + i, 48 + i), (1, 1), 1, False) for i in range(3)]
    for hist, qlen, T, fresh in steps:
        hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
        x = np.zeros((2, T), np.int32)
        pos = np.zeros((2, T), np.int32)
        for b in range(2):
            x[b, :qlen[b]] = ids[b, hist[b]:hist[b] + qlen[b]]
            pos[b, :qlen[b]] = np.arange(hist[b], hist[b] + qlen[b])
        jl, jcache = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos), jcache,
                                JMeta(jnp.asarray(tables), jnp.asarray(hist),
                                      jnp.asarray(qlen)), jcos, jsin, fresh_prefill=fresh)
        tl = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                        TMeta(torch.from_numpy(tables), torch.from_numpy(hist),
                              torch.from_numpy(qlen)), tcos, tsin, fresh_prefill=fresh)
        valid = qlen > 0
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=0, atol=ATOL)


def _greedy(pkg, path, prompts, new_tokens=8):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import GenerationConfig, TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
        kw = {'device': 'cpu'}
    engine = Engine.from_pretrained(path, TpuEngineConfig(**ENGINE_KW), **kw)
    inst = engine.create_instance()
    gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True)

    async def go():
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen)
                                      for i, p in enumerate(prompts)])
    try:
        return [o.token_ids for o in asyncio.run(go())]
    finally:
        engine.close()


@pytest.mark.parametrize('name', list(CFGS))
def test_engine_greedy_tokens_match_jax(ckpt, name):
    """Two concurrent prompts (the 70-token one in two prefill chunks), 8 greedy tokens
    each, f32: the port's Engine gives the JAX Engine's tokens."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, V, size=n).tolist() for n in (30, 70)]
    ref = _greedy('jax', ckpt[name], prompts)
    out = _greedy('torch', ckpt[name], prompts)
    assert out == ref
    assert all(len(t) == 8 for t in out)
