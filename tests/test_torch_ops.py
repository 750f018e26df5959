"""The PyTorch port's layer and attention ops against the JAX package, on the CPU.

Same numpy inputs into both; float32 on both sides (the JAX tests run at matmul
precision 'highest').  Tolerance: allclose at rtol/atol 1e-5 unless stated.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.nn import layers as jl
from lmdeploy_tpu.ops import attention as ja
from lmdeploy_tpu_torch.nn import layers as tl
from lmdeploy_tpu_torch.ops import attention as ta
from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('scaling', [
    None,
    {'rope_type': 'linear', 'factor': 2.0},
    {'type': 'dynamic', 'factor': 2.0, 'original_max_position_embeddings': 64},
    {'rope_type': 'llama3', 'factor': 8.0, 'low_freq_factor': 1.0,
     'high_freq_factor': 4.0, 'original_max_position_embeddings': 32},
    {'rope_type': 'yarn', 'factor': 4.0, 'original_max_position_embeddings': 64,
     'beta_fast': 32.0, 'beta_slow': 1.0},
])
def test_rope_tables_and_apply(scaling):
    D, L = 32, 128
    jc, js = jl.make_rope_table(D, L, 10000.0, scaling)
    tc, ts = tl.make_rope_table(D, L, 10000.0, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, 4, D).astype(np.float32)
    k = rng.randn(2, 5, 2, D).astype(np.float32)
    pos = rng.randint(0, L, size=(2, 5))
    jq, jk = jl.apply_rope(jnp.asarray(q), jnp.asarray(k), jc[pos], js[pos])
    tq, tk = tl.apply_rope(t(q), t(k), tc[pos], ts[pos])
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)


def test_rms_norm():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(t(x), t(w), 1e-6).numpy(),
                               np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
                               **TOL)


def test_silu_mlp():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 32).astype(np.float32)
    gu = (rng.randn(32, 2 * 48) * 0.1).astype(np.float32)
    down = (rng.randn(48, 32) * 0.1).astype(np.float32)
    ref = jl.silu_mlp(jnp.asarray(x), jnp.asarray(gu), jnp.asarray(down))
    np.testing.assert_allclose(tl.silu_mlp(t(x), t(gu), t(down)).numpy(), np.asarray(ref),
                               **TOL)


def test_config_matches(tiny_model_dir):
    from lmdeploy_tpu.config import ModelConfig as JM
    from lmdeploy_tpu_torch.config import ModelConfig as TM
    cfg = json.load(open(f'{tiny_model_dir}/config.json'))
    cfg['rope_scaling'] = {'rope_type': 'llama3', 'factor': 8.0}
    j, p = JM.from_hf_config(cfg), TM.from_hf_config(cfg)
    for f in ('num_layers', 'num_attention_heads', 'num_key_value_heads', 'hidden_size',
              'intermediate_size', 'vocab_size', 'head_dim', 'max_position_embeddings',
              'rope_theta', 'rope_scaling', 'rms_norm_eps', 'tie_word_embeddings',
              'eos_token_id', 'dtype', 'hf_arch', 'attention_bias', 'rope_dim',
              'sliding_window', 'window_uniform'):
        assert getattr(p, f) == getattr(j, f), f


def _cache_pair(rng, L, NB, BS, Hkv, D):
    """Random reference cache [L, NB, 2, BS, HDp] (lane-padded) and the port's."""
    _, hdp = ja.kv_row_width(Hkv, D)
    ref = rng.randn(L, NB, 2, BS, hdp).astype(np.float32)
    ref[..., Hkv * D:] = 0
    return ref, cache_from_reference(ref, Hkv, D)


def test_cache_layout_round_trip():
    rng = np.random.RandomState(2)
    ref, port = _cache_pair(rng, 2, 6, 16, 2, 16)
    assert tuple(port.shape) == (2, 6, 2, 16, 32)
    np.testing.assert_array_equal(cache_to_reference(port), ref)


@pytest.mark.parametrize('fresh', [False, True])
def test_slot_mapping_and_fill(fresh):
    """Row scatter (padded tokens to block 0) and the page-granular fresh write."""
    rng = np.random.RandomState(3)
    L, NB, BS, Hkv, D, layer = 2, 10, 16, 2, 16, 1
    B, T = 2, 32
    ref, port = _cache_pair(rng, L, NB, BS, Hkv, D)
    tables = np.array([[3, 7, 0], [5, 2, 9]], np.int32)
    hist = np.array([0, 0], np.int32) if fresh else np.array([5, 17], np.int32)
    qlen = np.array([32, 20], np.int32)
    k = rng.randn(B * T, Hkv, D).astype(np.float32)
    v = rng.randn(B * T, Hkv, D).astype(np.float32)
    js = ja.compute_slot_mapping(jnp.asarray(tables), jnp.asarray(hist), jnp.asarray(qlen),
                                 T, BS)
    ts = ta.compute_slot_mapping(t(tables), t(hist), t(qlen), T, BS)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jout = ja.fill_kv_cache(jnp.asarray(ref), jnp.asarray(k), jnp.asarray(v), js,
                            jnp.int32(layer), jnp.asarray(tables) if fresh else None)
    ta.fill_kv_cache(port, t(k), t(v), ts, layer, t(tables) if fresh else None)
    out = cache_to_reference(port)
    jout = np.asarray(jout)
    # block 0 is the padding block: its contents are don't-care
    np.testing.assert_array_equal(out[:, 1:], jout[:, 1:])


@pytest.mark.parametrize('opts', [
    {},
    {'window_size': 9},
    {'logit_softcap': 5.0},
    {'sinks': True},
    {'window_size': 7, 'logit_softcap': 3.0, 'sinks': True},
])
def test_gather_and_dense_attention(opts):
    rng = np.random.RandomState(4)
    L, NB, BS, Hkv, G, D, layer = 2, 12, 8, 2, 3, 16, 1
    B, T = 3, 5
    ref, port = _cache_pair(rng, L, NB, BS, Hkv, D)
    tables = rng.permutation(np.arange(1, NB))[:B * 3].reshape(B, 3).astype(np.int32)
    hist = np.array([0, 7, 14], np.int32)
    q = rng.randn(B, T, Hkv * G, D).astype(np.float32)
    opts = dict(opts)
    if opts.get('sinks'):
        opts['sinks'] = rng.randn(Hkv * G).astype(np.float32)
    jk, jv = ja.gather_layer_kv(jnp.asarray(ref), jnp.int32(layer), jnp.asarray(tables),
                                Hkv, D)
    tk, tv = ta.gather_layer_kv(port, layer, t(tables), Hkv, D)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jopts = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in opts.items()}
    topts = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in opts.items()}
    jo = ja.attention_dense_gathered(jnp.asarray(q), jk, jv, jnp.asarray(hist),
                                     D ** -0.5, **jopts)
    to = ta.attention_dense_gathered(t(q), tk, tv, t(hist), D ** -0.5, **topts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    # the port's CPU dispatch is the same gather + dense path
    pa = ta.paged_attention(t(q), port, t(tables), t(hist), t(np.full(B, T, np.int32)),
                            D ** -0.5, layer, Hkv, **topts)
    np.testing.assert_allclose(pa.numpy(), np.asarray(jo), **TOL)
