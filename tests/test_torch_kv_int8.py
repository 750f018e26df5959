"""The port's int8 KV cache (quant_policy 4) against the JAX package (CPU, f32).

``quantize_rows`` and the fill are bit-equal (int8 values and f32 scales) to the
reference's under ``jax.jit``, as its engine runs them (XLA multiplies by fl(1/127)
where the eager reference divides); the
gather dequantizes to the same values; ``paged_attention`` on a ``QuantKV`` and the
plain int8 decode (the CUDA kernel's plain version) match the reference's gather path
and its Pallas int8 kernel in TPU interpret mode at f32 allclose 2e-5 (the same
products summed in another order, and the kernel's online softmax against a one-pass
one).  The Engine with an int8 cache gives exactly the JAX engine's greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops import attention as ja
from lmdeploy_tpu.ops.attention import kv_row_width, plane_rows
from lmdeploy_tpu.ops.kv_quant import QuantKV as JQuantKV
from lmdeploy_tpu.ops.kv_quant import quantize_rows as jquant
from lmdeploy_tpu_torch.ops import attention as ta
from lmdeploy_tpu_torch.ops.kv_quant import QuantKV, dequantize, quantize_rows
from lmdeploy_tpu_torch.ops.paged_decode import (int8_splits, paged_decode_attention,
                                                 paged_decode_attention_int8,
                                                 paged_decode_attention_int8_plain,
                                                 paged_decode_attention_int8_split_plain)
from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference

from test_torch_engine import generate, make_prompts


def jdecode_pallas(*args, **kwargs):
    from lmdeploy_tpu.ops.pallas.paged_decode import paged_decode_attention
    return paged_decode_attention(*args, **kwargs)

TOL = dict(rtol=2e-5, atol=2e-5)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _ref_cache(rng, L, NB, BS, Hkv, D):
    """A reference QuantKV filled from random K/V [L, NB, BS, Hkv, D]."""
    _, hdp = kv_row_width(Hkv, D)
    k = rng.randn(L, NB, BS, Hkv, D).astype(np.float32)
    v = rng.randn(L, NB, BS, Hkv, D).astype(np.float32) * 0.5
    kq, ksc = jquant(jnp.asarray(k))
    vq, vsc = jquant(jnp.asarray(v))
    rows = [plane_rows(jnp.asarray(np.asarray(x).reshape(-1, Hkv, D)), hdp).reshape(
        L, NB, BS, hdp) for x in (kq, vq)]
    return JQuantKV(jnp.stack(rows, axis=2).astype(jnp.int8), jnp.stack([ksc, vsc], 2))


def test_quantize_rows_bit_equal():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4, 32).astype(np.float32) * 3
    x[0, 0] = 0                                        # an all-zero row: scale = eps
    x[1, 1, :4] = [127.0, -63.5, 0.5, -0.5]
    jq, js = jax.jit(jquant)(jnp.asarray(x))
    tq, ts = quantize_rows(t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize(tq, ts).numpy(),
                                  np.asarray(jq, np.float32) * np.asarray(js)[..., None])
    # 4,096 rows of one head dim: the eager reference's scales differ from the jitted
    # ones in about a third of them
    x = rng.randn(4096, 128).astype(np.float32)
    jq, js = jax.jit(jquant)(jnp.asarray(x))
    tq, ts = quantize_rows(t(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize('fresh', [False, True])
def test_quant_fill_matches_jax(fresh):
    """Row scatter of int8 rows and [Hkv] scale rows, also when page tables are given
    (an int8 cache never takes the page-granular write)."""
    rng = np.random.RandomState(1)
    L, NB, BS, Hkv, D, layer = 2, 10, 16, 2, 16, 1
    B, T = 2, 32
    ref = _ref_cache(rng, L, NB, BS, Hkv, D)
    port = cache_from_reference(ref, Hkv, D)
    assert isinstance(port, QuantKV) and tuple(port.shape) == (L, NB, 2, BS, Hkv * D)
    tables = np.array([[3, 7, 0], [5, 2, 9]], np.int32)
    hist = np.array([0, 0], np.int32) if fresh else np.array([5, 17], np.int32)
    qlen = np.array([32, 20], np.int32)
    k = rng.randn(B * T, Hkv, D).astype(np.float32)
    v = rng.randn(B * T, Hkv, D).astype(np.float32)
    slots = ja.compute_slot_mapping(jnp.asarray(tables), jnp.asarray(hist),
                                    jnp.asarray(qlen), T, BS)
    jout = jax.jit(ja.fill_kv_cache)(ref, jnp.asarray(k), jnp.asarray(v), slots,
                                     jnp.int32(layer), jnp.asarray(tables) if fresh else None)
    ta.fill_kv_cache(port, t(k), t(v), t(np.asarray(slots)), layer,
                     t(tables) if fresh else None)
    data, scale = cache_to_reference(port)
    # block 0 is the padding block: its contents are don't-care
    np.testing.assert_array_equal(data[:, 1:], np.asarray(jout.data)[:, 1:])
    np.testing.assert_array_equal(scale[:, 1:], np.asarray(jout.scale)[:, 1:])


@pytest.mark.parametrize('opts', [{}, {'logit_softcap': 4.0}, {'window_size': 9},
                                  {'sinks': True}])
def test_gather_dequant_and_paged_attention(opts):
    rng = np.random.RandomState(2)
    L, NB, BS, Hkv, G, D, layer = 2, 12, 8, 2, 3, 16, 1
    B, T = 3, 5
    ref = _ref_cache(rng, L, NB, BS, Hkv, D)
    port = cache_from_reference(ref, Hkv, D)
    tables = rng.permutation(np.arange(1, NB))[:B * 3].reshape(B, 3).astype(np.int32)
    hist = np.array([0, 7, 14], np.int32)
    jk, jv = ja.gather_layer_kv(ref, jnp.int32(layer), jnp.asarray(tables), Hkv, D)
    tk, tv = ta.gather_layer_kv(port, layer, t(tables), Hkv, D)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    opts = dict(opts)
    if opts.get('sinks'):
        opts['sinks'] = rng.randn(Hkv * G).astype(np.float32)
    jopts = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in opts.items()}
    topts = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in opts.items()}
    for T_ in (T, 1):                   # a chunk, then a decode step
        q = rng.randn(B, T_, Hkv * G, D).astype(np.float32)
        qlen = np.full(B, T_, np.int32)
        jo = ja.paged_attention(jnp.asarray(q), ref, jnp.asarray(tables), jnp.asarray(hist),
                                jnp.asarray(qlen), D ** -0.5, jnp.int32(layer), Hkv,
                                **jopts)
        to = ta.paged_attention(t(q), port, t(tables), t(hist), t(qlen), D ** -0.5,
                                layer, Hkv, **topts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize('G,softcap', [(1, None), (4, None), (4, 20.0)])
def test_int8_decode_plain_matches_pallas(G, softcap):
    from lmdeploy_tpu.ops.pallas.paged_decode import paged_decode_attention as jdecode
    rng = np.random.RandomState(3)
    L, layer, NB, BS, W = 3, 1, 40, 16, 6
    B, Hkv, D = 5, 2, 64
    ref = _ref_cache(rng, L, NB, BS, Hkv, D)
    port = cache_from_reference(ref, Hkv, D)
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    kv_lens = np.array([1, 37, 0, 96, 64], np.int32)     # row 2 is inactive
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    scale = D ** -0.5
    out_ref = np.asarray(jdecode(jnp.asarray(q), ref, jnp.asarray(tables),
                                 jnp.asarray(kv_lens), jnp.int32(layer), scale, Hkv,
                                 logit_softcap=softcap))
    out = paged_decode_attention_int8_plain(t(q), port, t(tables), t(kv_lens), layer,
                                            scale, Hkv, logit_softcap=softcap).numpy()
    # active rows match; the port's inactive row is zero (ROADMAP.md section 3)
    active = kv_lens > 0
    np.testing.assert_allclose(out[active], out_ref[active], **TOL)
    assert np.all(out[~active] == 0)
    # the dispatching wrapper takes the int8 plain version on a CPU tensor and
    # counts no launch; window and sinks are refused on an int8 cache
    before = paged_decode_attention_int8.launches
    out2 = paged_decode_attention(t(q), port, t(tables), t(kv_lens), layer, scale, Hkv,
                                  logit_softcap=softcap)
    np.testing.assert_array_equal(out2.numpy(), out)
    assert paged_decode_attention_int8.launches == before
    with pytest.raises(ValueError):
        paged_decode_attention(t(q), port, t(tables), t(kv_lens), layer, scale, Hkv,
                               window=8)


@pytest.mark.parametrize('BS,W', [(16, 6), (8, 12)])
@pytest.mark.parametrize('G,softcap', [(1, None), (4, None), (4, 20.0)])
def test_int8_decode_split_plain_matches_pallas(G, softcap, BS, W):
    """The kernel's two passes in plain PyTorch -- each split's (acc, m, l) over its
    pages, then the fixed-order combine -- against the Pallas int8 kernel in interpret
    mode at 2e-5: 1, 2 and W splits of the 96-slot table and the wrapper's own split
    (``int8_splits``), on rows of 1, 37, 0 and 96 tokens (empty splits, a full table,
    an inactive row whose output is 0), at block sizes 16 and 8."""
    from lmdeploy_tpu.ops.pallas.paged_decode import paged_decode_attention as jdecode
    rng = np.random.RandomState(5)
    L, layer, NB, B, Hkv, D = 3, 1, 60, 4, 2, 64
    ref = _ref_cache(rng, L, NB, BS, Hkv, D)
    port = cache_from_reference(ref, Hkv, D)
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    kv_lens = np.array([1, 37, 0, 96], np.int32)
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    scale = D ** -0.5
    out_ref = np.asarray(jdecode(jnp.asarray(q), ref, jnp.asarray(tables),
                                 jnp.asarray(kv_lens), jnp.int32(layer), scale, Hkv,
                                 logit_softcap=softcap))
    active = kv_lens > 0
    assert int8_splits(W, BS, D, B) == 1   # 96 slots fit one split of the card's length
    for splits in (1, 2, W, None):
        out = paged_decode_attention_int8_split_plain(
            t(q), port, t(tables), t(kv_lens), layer, scale, Hkv, logit_softcap=softcap,
            splits=splits).numpy()
        np.testing.assert_allclose(out[active], out_ref[active], **TOL)
        assert np.all(out[~active] == 0)


@pytest.mark.parametrize('softcap', [None, 20.0])
def test_int8_decode_plain_matches_pallas_at_mla(softcap):
    """MLA's one latent kv head of 576 under 16 query heads (DeepSeek-V2-Lite's
    geometry), which the CUDA kernel serves through its wide path: the plain version
    against the Pallas kernel in interpret mode at 2e-5, and the wrapper's checks take
    the shape (quant_policy 4 serves DeepSeek on the card)."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    rng = np.random.RandomState(4)
    L, layer, NB, BS, W = 2, 1, 32, 16, 6
    B, Hkv, G, D = 5, 1, 16, 576
    ref = _ref_cache(rng, L, NB, BS, Hkv, D)
    port = cache_from_reference(ref, Hkv, D)
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    kv_lens = np.array([1, 37, 0, 96, 50], np.int32)
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    scale = 192 ** -0.5
    out_ref = np.asarray(jdecode_pallas(jnp.asarray(q), ref, jnp.asarray(tables),
                                        jnp.asarray(kv_lens), jnp.int32(layer), scale, Hkv,
                                        logit_softcap=softcap))
    out = paged_decode_attention_int8_plain(t(q), port, t(tables), t(kv_lens), layer,
                                            scale, Hkv, logit_softcap=softcap).numpy()
    active = kv_lens > 0
    np.testing.assert_allclose(out[active], out_ref[active], **TOL)
    assert np.all(out[~active] == 0)
    assert pd._check('paged_decode_int8', t(q), port.data, t(tables), t(kv_lens), layer,
                     Hkv, (port.scale,),
                     head_dims=pd.QUANT_HEAD_DIMS) == (B, Hkv * G, D, NB, BS, W)


def test_cache_engine_int8():
    from lmdeploy_tpu_torch.config import CacheConfig, ModelConfig
    from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
    from lmdeploy_tpu_torch.messages import QuantPolicy
    cfg = ModelConfig(num_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      hidden_size=64, intermediate_size=128, vocab_size=256, head_dim=16,
                      dtype='float32')
    ce = CacheEngine(cfg, CacheConfig(block_size=16, num_gpu_blocks=8,
                                      quant_policy=QuantPolicy.KV_INT8), torch.device('cpu'))
    kv = ce.kv_cache
    assert isinstance(kv, QuantKV) and kv.dtype == torch.int8
    assert tuple(kv.data.shape) == (2, 8, 2, 16, 32)
    assert tuple(kv.scale.shape) == (2, 8, 2, 16, 2)
    # per block: 2 layers x 2 planes x 16 tokens x (32 int8 + 2 f32 scales)
    assert ce.block_bytes() == 2 * 2 * 16 * (32 + 2 * 4) == kv.nbytes // 8
    # the int4 and TurboQuant caches (test_torch_kv_int4.py, test_torch_kv_turbo.py)
    # take fewer bytes a block
    for policy in (QuantPolicy.KV_INT4, QuantPolicy.TURBO_QUANT):
        other = CacheEngine(cfg, CacheConfig(block_size=16, num_gpu_blocks=8,
                                             quant_policy=policy), torch.device('cpu'))
        assert other.block_bytes() < ce.block_bytes()


@pytest.mark.parametrize('case', ['batch', 'preempt'])
def test_engine_kv_int8_greedy_tokens_match_jax(tiny_model_dir, case):
    """Dense weights, int8 cache: the same greedy tokens as the JAX engine, exactly."""
    prompts = make_prompts(0, (5, 37, 70, 12, 23))
    kw = dict(quant_policy=4)
    if case == 'preempt':
        kw.update(num_gpu_blocks=15, new_tokens=40)
    ref, _ = generate('jax', tiny_model_dir, prompts, **kw)
    out, engine = generate('torch', tiny_model_dir, prompts, **kw)
    assert isinstance(engine.model_agent.kv_cache, QuantKV)
    assert out == ref
    if case == 'preempt':
        assert engine.scheduler.num_preemptions > 0
