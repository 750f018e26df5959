"""DeepSeek-V2 / V3 (MLA + DeepSeek-MoE, blocked-fp8 experts): the port against the JAX
package (CPU).

Two tiny checkpoints written here with safetensors, as tests/test_deepseek.py and
tests/test_moe_quant.py write theirs:
  * ``ds``: tests/test_deepseek.py's ``DS_CFG`` (softmax scores, 3 layers, the first
    dense) with V2-Lite's routing (``norm_topk_prob`` false), f32 weights;
  * ``dsq``: tests/test_moe_quant.py's ``DSQ_CFG`` (sigmoid scores, correction bias,
    blocked fp8 32 x 32 on every linear) with V3's group-limited routing (2 groups, 1
    kept) and routed scaling 2.5; its experts stay fp8-resident, everything else
    dequantizes at load; ``LMDEPLOY_TPU_FP8_DEQUANT=1`` dequantizes the experts too.
Checked: the configs (V2-Lite's and V3's public ones too), the yarn table at V2-Lite's
rope config (the reference's attention factor, not HF's), the loader's leaves and its
blocked-fp8 stream adapter, ``params_from_jax`` on fp8 leaves, the cache round trip at
one kv head of 576, the absorbed attention block, routing (ties, groups, both scoring
functions), f32 logits of prefill (one chunked row) and decode steps, and exact greedy
tokens of ``Engine`` and ``pipeline()`` against the JAX engine.

Tolerances: f32 logits and hidden states at 1e-4 absolute (they reach ~0.5-5); both
sides round x to bf16 before every fp8 expert product, and an element on a rounding
boundary may round the other way after f32 sums in another order (one bf16 ulp of
one input).  Routing: equal choices, weights at 1e-6.
"""
import asyncio
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import DEEPSEEK_V2_LITE, DEEPSEEK_V3, FP8_BLOCKED
from conftest import make_tiny_tokenizer
from test_deepseek import DS_CFG
from test_moe_quant import DSQ_CFG, _quantize_blocked

CFGS = {'ds': dict(DS_CFG, norm_topk_prob=False),
        'dsq': dict(DSQ_CFG, n_group=2, topk_group=1, routed_scaling_factor=2.5)}
ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
ATOL = 1e-4


def _write_checkpoint(path, name, seed=7):
    """A tiny DeepSeek checkpoint: dense f32 (``ds``) or native blocked fp8 on every
    linear (``dsq``, as tests/test_moe_quant.py's ``ds_fp8_dir``, plus a random
    correction bias)."""
    from safetensors.numpy import save_file
    c = CFGS[name]
    fp8 = 'quantization_config' in c
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(c, f)
    make_tiny_tokenizer(str(path), vocab_size=128)
    rng = np.random.RandomState(seed)
    H, V = c['hidden_size'], c['vocab_size']
    nh, dn, dr, dv, r = (c['num_attention_heads'], c['qk_nope_head_dim'],
                         c['qk_rope_head_dim'], c['v_head_dim'], c['kv_lora_rank'])
    t = {'model.embed_tokens.weight': rng.randn(V, H) * 0.02,
         'model.norm.weight': np.ones(H), 'lm_head.weight': rng.randn(V, H) * 0.02}

    def lin(prefix, out_dim, in_dim, scale=0.05):
        w = (rng.randn(out_dim, in_dim) * scale).astype(np.float32)
        if fp8:
            t[prefix + '.weight'], t[prefix + '.weight_scale_inv'] = _quantize_blocked(w, 32, 32)
        else:
            t[prefix + '.weight'] = w
    for layer in range(c['num_hidden_layers']):
        p = f'model.layers.{layer}.'
        t[p + 'input_layernorm.weight'] = np.ones(H)
        t[p + 'post_attention_layernorm.weight'] = np.ones(H)
        lin(p + 'self_attn.q_proj', nh * (dn + dr), H)
        lin(p + 'self_attn.kv_a_proj_with_mqa', r + dr, H)
        t[p + 'self_attn.kv_a_layernorm.weight'] = np.ones(r)
        lin(p + 'self_attn.kv_b_proj', nh * (dn + dv), r)
        lin(p + 'self_attn.o_proj', H, nh * dv)
        if layer < c['first_k_dense_replace']:
            inter = c['intermediate_size']
            lin(p + 'mlp.gate_proj', inter, H)
            lin(p + 'mlp.up_proj', inter, H)
            lin(p + 'mlp.down_proj', H, inter)
            continue
        E, ie = c['n_routed_experts'], c['moe_intermediate_size']
        t[p + 'mlp.gate.weight'] = rng.randn(E, H) * 0.05
        t[p + 'mlp.gate.e_score_correction_bias'] = rng.randn(E) * 0.05
        for e in range(E):
            for hf, od, idim in (('gate_proj', ie, H), ('up_proj', ie, H), ('down_proj', H, ie)):
                lin(p + f'mlp.experts.{e}.{hf}', od, idim, 0.2)
        shared = c['n_shared_experts'] * ie
        lin(p + 'mlp.shared_experts.gate_proj', shared, H)
        lin(p + 'mlp.shared_experts.up_proj', shared, H)
        lin(p + 'mlp.shared_experts.down_proj', H, shared)
    t = {k: np.ascontiguousarray(v if v.dtype == ml_dtypes.float8_e4m3fn
                                 else v.astype(np.float32)) for k, v in t.items()}
    save_file(t, os.path.join(path, 'model.safetensors'))
    return str(path)


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return {name: _write_checkpoint(tmp_path_factory.mktemp(f'tiny_{name}'), name)
            for name in CFGS}


def _models(path, dtype='float32'):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(path, dtype=dtype))
    tm = tbuild(TConfig.from_pretrained(path, dtype=dtype))
    jp = jax.tree_util.tree_map(np.asarray, load_model_params(jm, path))
    return jm, jp, tm, load_params(tm, path, 'cpu')


def _tree_equal(tp, jp):
    for name, leaf in tp.items():
        ref = jp[name]
        if isinstance(leaf, dict):
            assert set(leaf) == set(ref), name
            _tree_equal(leaf, ref)
        elif leaf.dtype == torch.float8_e4m3fn:
            np.testing.assert_array_equal(leaf.view(torch.uint8).numpy(),
                                          np.asarray(ref).view(np.uint8))
        else:
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(ref, leaf.numpy().dtype), err_msg=name)


# -- configs ------------------------------------------------------------------------------
@pytest.mark.parametrize('name', ['v2_lite', 'v2_lite_fp8', 'v3'])
def test_public_configs(name):
    """V2-Lite (and its blocked-fp8 form, the card's cell) and V3: the fields, the one
    latent kv head of 576, the rope dim, the scale and the fp8 leaves' shapes."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.models.deepseek import DeepseekV2Model
    hf = {'v2_lite': DEEPSEEK_V2_LITE, 'v3': DEEPSEEK_V3,
          'v2_lite_fp8': dict(DEEPSEEK_V2_LITE, quantization_config=FP8_BLOCKED)}[name]
    cfg, ref = ModelConfig.from_hf_config(hf), JConfig.from_hf_config(hf)
    for field in ('q_lora_rank', 'kv_lora_rank', 'qk_nope_head_dim', 'qk_rope_head_dim',
                  'v_head_dim', 'first_k_dense_replace', 'routed_scaling_factor',
                  'scoring_func', 'n_group', 'topk_group', 'norm_topk_prob',
                  'num_shared_experts', 'num_experts', 'num_experts_per_tok',
                  'moe_intermediate_size', 'is_mla', 'cache_head_dim', 'rope_dim'):
        assert getattr(cfg, field) == getattr(ref, field), field
    model = build_model(cfg)
    assert isinstance(model, DeepseekV2Model) and cfg.num_key_value_heads == 1
    assert cfg.cache_head_dim == 576 and cfg.rope_dim == 64
    assert model.scale == 1 / np.sqrt(192)
    shapes = model.param_shapes()
    moe = shapes['moe_layers']
    L, fk = cfg.num_layers, cfg.first_k_dense_replace
    if name == 'v2_lite':
        assert moe['we_gate'] == (26, 64, 2048, 1408) and not model.moe_fp8
        assert moe['ws_gate'] == (26, 2048, 2816) and shapes['layers']['wq'] == (1, 2048, 3072)
    else:
        assert model.moe_fp8 and model.dequant_on_load and model.quant_method is None
        E, H, ie = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
        assert moe['we_gate']['w8'].shape == (L - fk, E, H, ie)
        assert moe['we_gate']['w8'].dtype == torch.float8_e4m3fn
        assert moe['we_down']['gscale'].shape == (L - fk, E, ie // 128, H)
        assert model.keep_fp8('model.layers.3.mlp.experts.7.up_proj.weight_scale_inv')
        assert not model.keep_fp8('model.layers.3.mlp.shared_experts.up_proj.weight')


def test_v2_lite_yarn_attention_factor_is_the_reference_one():
    """V2-Lite's yarn (factor 40 from 4096, mscale = mscale_all_dim = 0.707): the port's
    tables equal the reference's, whose cos and sin carry 0.1 * mscale * ln(40) + 1 =
    1.2608, while the softmax scale stays 1/sqrt(192).  HF's DeepSeek-V2 puts
    yarn_get_mscale(40, 0.707)^2 on the softmax and mscale / mscale_all_dim = 1 on cos
    and sin; the port keeps the reference's choice (ROADMAP section 3)."""
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    cfg = ModelConfig.from_hf_config(DEEPSEEK_V2_LITE)
    got = trope(cfg.rope_dim, 4096, cfg.rope_theta, cfg.rope_scaling)
    want = jrope(cfg.rope_dim, 4096, cfg.rope_theta, cfg.rope_scaling)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[:2], np.asarray(w)[:2], rtol=0, atol=2e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=3.5e-4)
    factor = 0.1 * 0.707 * np.log(40) + 1
    np.testing.assert_allclose(got[0][0].numpy(), factor, rtol=1e-6)
    assert abs(factor - 1.0) > 0.25


# -- loader and conversions -----------------------------------------------------------------
@pytest.mark.parametrize('name,dequant', [('ds', False), ('dsq', False), ('dsq', True)])
def test_loader_matches_jax(ckpt, monkeypatch, name, dequant):
    if dequant:
        monkeypatch.setenv('LMDEPLOY_TPU_FP8_DEQUANT', '1')
    _, jp, tm, tp = _models(ckpt[name])
    resident = name == 'dsq' and not dequant
    assert tm.moe_fp8 is resident
    assert isinstance(tp['moe_layers']['we_gate'], dict) is resident
    _tree_equal(tp, jp)


def test_dequant_blocked_fp8_matches_reference(ckpt):
    """The stream adapter yields the reference's f32 weights and passes the kept names
    (expert weights and their scale grids) through untouched."""
    from lmdeploy_tpu.weight_loader import _dequant_blocked_fp8 as jdeq
    from lmdeploy_tpu.weight_loader import iter_safetensors as jiter
    from lmdeploy_tpu_torch.weight_loader import _dequant_blocked_fp8 as tdeq
    from lmdeploy_tpu_torch.weight_loader import iter_safetensors as titer

    def keep(n):
        return '.mlp.experts.' in n
    want = dict(jdeq(jiter(ckpt['dsq']), keep=keep))
    got = dict(tdeq(titer(ckpt['dsq']), keep=keep))
    assert set(got) == set(want)
    assert any(k.endswith('weight_scale_inv') for k in got)
    for k, v in got.items():
        ref = np.asarray(want[k])
        if v.dtype == torch.float8_e4m3fn:
            assert keep(k)
            np.testing.assert_array_equal(v.view(torch.uint8).numpy(), ref.view(np.uint8))
        else:
            np.testing.assert_array_equal(v.float().numpy(), ref.astype(np.float32), err_msg=k)


def test_params_from_jax_carries_fp8_leaves(ckpt):
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    _, jp, _, _ = _models(ckpt['dsq'])
    tp = params_from_jax(jp, dtype=torch.float32)
    leaf = tp['moe_layers']['we_up']
    assert leaf['w8'].dtype == torch.float8_e4m3fn and leaf['gscale'].dtype == torch.float32
    _tree_equal(tp, jp)


def test_mla_cache_round_trip_and_fill():
    """One latent kv head of 576: the reference's 640-lane rows convert both ways
    without loss, and the port's fill writes the reference's rows."""
    from lmdeploy_tpu.ops.attention import fill_kv_cache as jfill
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.ops.attention import fill_kv_cache as tfill
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference
    rng = np.random.RandomState(3)
    L, NB, BS, D = 2, 5, 16, 576
    _, hdp = kv_row_width(1, D)
    assert hdp == 640
    ref = rng.randn(L, NB, 2, BS, hdp).astype(np.float32)
    ref[..., D:] = 0
    port = cache_from_reference(ref, 1, D)
    assert port.shape == (L, NB, 2, BS, D)
    np.testing.assert_array_equal(cache_to_reference(port), ref)
    k = rng.randn(20, 1, D).astype(np.float32)
    v = np.concatenate([k[..., :512], np.zeros((20, 1, 64), np.float32)], -1)
    slots = rng.permutation(np.arange(BS, NB * BS))[:20].astype(np.int32)
    want = jfill(jnp.asarray(ref), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots), 1)
    tfill(port, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots).long(), 1)
    np.testing.assert_array_equal(cache_to_reference(port), np.asarray(want))


# -- blocks ----------------------------------------------------------------------------------
def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


@pytest.mark.parametrize('name', ['ds', 'dsq'])
def test_attention_block_matches_jax(ckpt, name):
    """The absorbed MLA block of the first MoE layer on a fresh prefill of two rows,
    then one decode step: hidden states and the latent cache."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import compute_slot_mapping as jslots
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.ops.attention import compute_slot_mapping as tslots
    from lmdeploy_tpu_torch.weight_convert import (cache_from_reference,
                                                   cache_to_reference, params_from_jax)
    jm, jp, tm, _ = _models(ckpt[name])
    tp = params_from_jax(jp, dtype=torch.float32)
    cfg = jm.config
    D = cfg.cache_head_dim
    layer = cfg.first_k_dense_replace
    jw = jax.tree_util.tree_map(jnp.asarray, _layer(jp['moe_layers'], 0))
    tw = _layer(tp['moe_layers'], 0)
    _, hdp = kv_row_width(1, D)
    jcache = jnp.zeros((cfg.num_layers, 8, 2, 16, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), 1, D)
    jcos, jsin = jrope(cfg.rope_dim, 64, cfg.rope_theta)
    tcos, tsin = trope(cfg.rope_dim, 64, cfg.rope_theta)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    rng = np.random.RandomState(1)
    for hist, qlen, T, fresh in (((0, 0), (20, 13), 20, True), ((20, 13), (1, 1), 1, False)):
        hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
        h = rng.randn(2, T, cfg.hidden_size).astype(np.float32)
        pos = hist[:, None] + np.arange(T)[None]
        jmeta = JMeta(jnp.asarray(tables), jnp.asarray(hist), jnp.asarray(qlen))
        tmeta = TMeta(torch.from_numpy(tables), torch.from_numpy(hist), torch.from_numpy(qlen))
        jh, jcache = jm._attn_block(jnp.asarray(h), jw, layer, jcache, jmeta, jcos[pos],
                                    jsin[pos], jslots(jmeta.block_tables, jmeta.history_lens,
                                                      jmeta.q_lens, T, 16), fresh)
        th = tm._attn_block(tw, torch.from_numpy(h), layer, tcache, tmeta, tcos[pos],
                            tsin[pos], tslots(tmeta.block_tables, tmeta.history_lens,
                                              tmeta.q_lens, T, 16), fresh)
        for b in range(2):
            np.testing.assert_allclose(th.numpy()[b, :qlen[b]], np.asarray(jh)[b, :qlen[b]],
                                       rtol=0, atol=ATOL)
        np.testing.assert_allclose(cache_to_reference(tcache)[:, 1:],
                                   np.asarray(jcache)[:, 1:], rtol=0, atol=ATOL)
        # the V plane is the latent followed by zeros
        assert np.all(cache_to_reference(tcache)[layer, 1:, 1, :, cfg.kv_lora_rank:] == 0)


@pytest.mark.parametrize('scoring,groups,ties', [
    ('softmax', 0, False), ('softmax', 2, True), ('sigmoid', 0, True), ('sigmoid', 2, False),
    ('sigmoid', 4, True)])
def test_routing_matches_jax(ckpt, monkeypatch, scoring, groups, ties):
    """Expert choices and weights (captured at the reference's ``moe_ffn``) and the
    MoE block's output: softmax or sigmoid scores, group-limited top-k, ties planted by
    duplicating router columns (the lower index wins in both)."""
    import lmdeploy_tpu.ops.moe as jmoe
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    hf = dict(CFGS['dsq'], scoring_func=scoring, n_routed_experts=8, num_experts_per_tok=3,
              n_group=groups, topk_group=max(groups // 2, 1) if groups else 0,
              norm_topk_prob=scoring == 'sigmoid')
    hf.pop('quantization_config')
    jm = jbuild(JConfig.from_hf_config(hf, dtype='float32'))
    tm = tbuild(TConfig.from_hf_config(hf, dtype='float32'))
    rng = np.random.RandomState(2)
    H, E, ie = hf['hidden_size'], 8, hf['moe_intermediate_size']
    router = (rng.randn(H, E) * 0.3).astype(np.float32)
    bias = (rng.randn(E) * 0.1).astype(np.float32)
    if ties:
        router[:, 5] = router[:, 2]
        router[:, 7] = router[:, 0]
        bias[5], bias[7] = bias[2], bias[0]
    w = {'router': router, 'router_bias': bias,
         'we_gate': rng.randn(E, H, ie).astype(np.float32) * 0.2,
         'we_up': rng.randn(E, H, ie).astype(np.float32) * 0.2,
         'we_down': rng.randn(E, ie, H).astype(np.float32) * 0.2,
         'ws_gate': rng.randn(H, ie).astype(np.float32) * 0.1,
         'ws_up': rng.randn(H, ie).astype(np.float32) * 0.1,
         'ws_down': rng.randn(ie, H).astype(np.float32) * 0.1}
    x = rng.randn(2, 9, H).astype(np.float32)
    seen = {}
    real = jmoe.moe_ffn

    def capture(xf, top_idx, top_w, *args, **kwargs):
        seen['idx'], seen['w'] = np.asarray(top_idx), np.asarray(top_w)
        return real(xf, top_idx, top_w, *args, **kwargs)
    monkeypatch.setattr(jmoe, 'moe_ffn', capture)
    with jax.default_matmul_precision('highest'):
        want = np.asarray(jm._moe_mlp({k: jnp.asarray(v) for k, v in w.items()},
                                      jnp.asarray(x)))
    tw = params_from_jax(w)
    _, idx, wts = tm.route(tw, torch.from_numpy(x.reshape(-1, H)))
    np.testing.assert_array_equal(idx.numpy(), seen['idx'])
    np.testing.assert_allclose(wts.numpy(), seen['w'], rtol=0, atol=1e-6)
    if ties:       # a tie was met and went to the lower index
        assert (np.isin(seen['idx'], [2, 0]).any(-1)).any()
    got = tm._moe_mlp(tw, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# -- forward ---------------------------------------------------------------------------------
@pytest.mark.parametrize('name', ['ds', 'dsq'])
def test_forward_logits_match_jax(ckpt, name):
    """Prefill of two rows (one chunked: its second chunk reads the cache through the
    gathered path), then 4 decode steps; f32 logits and the latent cache."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import (cache_from_reference,
                                                   cache_to_reference, params_from_jax)
    jm, jp, tm, _ = _models(ckpt[name])
    tp = params_from_jax(jp, dtype=torch.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    cfg = jm.config
    L, BS, NB, D = cfg.num_layers, 16, 12, cfg.cache_head_dim
    _, hdp = kv_row_width(1, D)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), 1, D)
    jcos, jsin = jrope(cfg.rope_dim, 256, cfg.rope_theta)
    tcos, tsin = trope(cfg.rope_dim, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    ids = np.random.RandomState(0).randint(3, cfg.vocab_size, size=(2, 80)).astype(np.int32)
    steps = [((0, 0), (40, 48), 48, True), ((40, 48), (24, 0), 24, False)] + [
        ((64 + i, 48 + i), (1, 1), 1, False) for i in range(4)]
    for hist, qlen, T, fresh in steps:
        hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
        x = np.zeros((2, T), np.int32)
        pos = np.zeros((2, T), np.int32)
        for b in range(2):
            x[b, :qlen[b]] = ids[b, hist[b]:hist[b] + qlen[b]]
            pos[b, :qlen[b]] = np.arange(hist[b], hist[b] + qlen[b])
        with jax.default_matmul_precision('highest'):
            jl, jcache = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos), jcache,
                                    JMeta(jnp.asarray(tables), jnp.asarray(hist),
                                          jnp.asarray(qlen)), jcos, jsin,
                                    fresh_prefill=fresh)
        tl = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                        TMeta(torch.from_numpy(tables), torch.from_numpy(hist),
                              torch.from_numpy(qlen)), tcos, tsin, fresh_prefill=fresh)
        valid = qlen > 0
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=0, atol=ATOL)
        np.testing.assert_allclose(cache_to_reference(tcache)[:, 1:],
                                   np.asarray(jcache)[:, 1:], rtol=0, atol=ATOL)


# -- engine ----------------------------------------------------------------------------------
def _greedy(pkg, path, prompts, new_tokens=10, **cfg):
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
    gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True)

    async def go():
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen)
                                      for i, p in enumerate(prompts)])
    try:
        return [o.token_ids for o in asyncio.run(go())], engine
    finally:
        engine.close()


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(3, 128, size=n).tolist() for n in (30, 70)]


def _expert_bytes(params):
    moe = params['moe_layers']
    return sum(t.numel() * t.element_size() for k in ('we_gate', 'we_up', 'we_down')
               for t in (moe[k].values() if isinstance(moe[k], dict) else [moe[k]]))


@pytest.mark.parametrize('name,dequant', [('ds', False), ('dsq', False), ('dsq', True)])
def test_engine_greedy_tokens_match_jax(ckpt, monkeypatch, name, dequant):
    """Two concurrent prompts (the 70-token one in two prefill chunks), 10 greedy
    tokens each, f32: the port's Engine gives the JAX Engine's tokens, for the
    fp8-resident model and its dequantize-on-load twin."""
    from lmdeploy_tpu_torch.ops import quant_bmm
    if dequant:
        monkeypatch.setenv('LMDEPLOY_TPU_FP8_DEQUANT', '1')
    ref, _ = _greedy('jax', ckpt[name], _prompts())
    out, engine = _greedy('torch', ckpt[name], _prompts())
    assert out == ref
    assert all(len(t) == 10 for t in out)
    resident = name == 'dsq' and not dequant
    assert isinstance(engine.model_agent.params['moe_layers']['we_gate'], dict) is resident
    assert engine.model_agent.cache_engine.row_width == 40
    assert quant_bmm.fp8_bmm.launches == 0             # CPU tensors: the plain version


@pytest.mark.parametrize('policy', [4, 8])
def test_engine_kv_quant_greedy_tokens_match_jax(ckpt, policy):
    """MLA on the int8 (quant_policy 4) and int4 (8) caches: the latent kv head is
    quantized per token as any kv head, and the port's Engine gives the JAX Engine's
    greedy tokens (the card serves D 576 through the kernels' wide paths)."""
    from lmdeploy_tpu_torch.ops.kv_quant import QuantKV, QuantKV4
    ref, _ = _greedy('jax', ckpt['ds'], _prompts(), quant_policy=policy)
    out, engine = _greedy('torch', ckpt['ds'], _prompts(), quant_policy=policy)
    assert out == ref
    kv = engine.model_agent.kv_cache
    assert type(kv) is (QuantKV if policy == 4 else QuantKV4)
    assert kv.shape[-1] == 40 and kv.scale.shape[-1] == 1


def test_fp8_resident_footprint_and_dequant_twin(ckpt, monkeypatch):
    """bf16, as the reference's own test: the fp8-resident experts give the
    dequantize-at-load twin's greedy tokens with < 0.65x its expert bytes."""
    got, eng = _greedy('torch', ckpt['dsq'], _prompts(), dtype='bfloat16')
    quant_bytes = _expert_bytes(eng.model_agent.params)
    monkeypatch.setenv('LMDEPLOY_TPU_FP8_DEQUANT', '1')
    want, eng = _greedy('torch', ckpt['dsq'], _prompts(), dtype='bfloat16')
    assert got == want
    # 1 B fp8 + 4 B / 32 scales = 1.125 B a weight against 2 (bf16)
    assert quant_bytes < 0.65 * _expert_bytes(eng.model_agent.params)


def test_pipeline_on_cpu_matches_jax(ckpt):
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu.messages import GenerationConfig as JGen
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch import pipeline as tpipeline
    from lmdeploy_tpu_torch.messages import GenerationConfig as TGen
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    prompts = ['hello world this is a tiny test corpus ' * 2, 'hi']
    runs = []
    for make, cfg, gen, extra in ((jpipeline, JCfg, JGen, {}),
                                  (tpipeline, TCfg, TGen, {'device': 'cpu'})):
        pipe = make(ckpt['dsq'], backend_config=cfg(**ENGINE_KW), **extra)
        try:
            runs.append(pipe(prompts, gen_config=gen(max_new_tokens=6, ignore_eos=True)))
        finally:
            pipe.close()
    ref, out = runs
    assert [o.token_ids for o in out] == [r.token_ids for r in ref]
    assert [o.text for o in out] == [r.text for r in ref]
