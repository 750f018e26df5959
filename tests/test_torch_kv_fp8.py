"""The port's fp8-e4m3 KV cache (quant_policy 16) against the JAX package (CPU, f32).

The cache is the plain layout in ``float8_e4m3fn``.  The port's cast (``to_fp8``)
gives the reference's bytes, also past the e4m3 range, where JAX casts to NaN and
torch alone would saturate to +-448 (ROADMAP section 3).  The fill is bit-equal through
``weight_convert`` (e4m3 bytes), fresh (page-granular) and by rows; the gather gives
the same values; ``paged_attention`` with softcap, window and sinks and the plain
decode (the plain version of the CUDA kernel's e4m3 instantiation) match the
reference's gather path at f32 allclose 2e-5, and its Pallas kernel in TPU interpret
mode on the same pages widened to f32.  On e4m3 pages the Pallas kernel rounds P to
e4m3 for the P.V product (``pr.astype(v.dtype)``, paged_decode.py:268), which the
reference's own gather path does not; the port keeps P in f32 (ROADMAP section 3), so
against those outputs it is held only to e4m3's rounding of P.  Engine and pipeline
give exactly the JAX package's greedy tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lmdeploy_tpu.ops.attention import kv_row_width
from lmdeploy_tpu.ops.pallas.paged_decode import paged_decode_attention as jdecode
from lmdeploy_tpu_torch.ops.kv_quant import to_fp8
from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                 paged_decode_attention_fp8,
                                                 paged_decode_attention_plain)

from torch_kv_cases import (check_decode_vs_pallas, check_engine_tokens, check_fill,
                            check_gather_and_attention, fill_random, pipeline_tokens, t)


def ref_cache(rng, L, NB, BS, Hkv, D, filled=True, scale=1.0):
    _, hdp = kv_row_width(Hkv, D)
    ref = jnp.zeros((L, NB, 2, BS, hdp), jnp.float8_e4m3fn)
    return fill_random(ref, rng, L, NB, BS, Hkv, D, scale) if filled else ref


@pytest.mark.parametrize('src', ['float32', 'bfloat16'])
def test_to_fp8_bytes_match_jax(src):
    """In range, at the edges, and past them: |x| > 464 (infinities too) is NaN with
    the sign kept, as JAX casts; 448 < |x| <= 464 rounds to 448."""
    rng = np.random.RandomState(0)
    edge = [0.0, -0.0, 448.0, 449.0, 463.9, 464.0, 464.1, 480.0, 1e6, np.inf, -np.inf,
            -448.0, -464.0, -464.5, -1e6, 2.0 ** -9, 2.0 ** -10, 3e-3, np.nan]
    x = np.concatenate([rng.randn(4096).astype(np.float32) * 100, np.array(edge, np.float32)])
    jx = jnp.asarray(x).astype(src)
    want = np.asarray(jx.astype(jnp.float8_e4m3fn)).view(np.uint8)
    if src == 'bfloat16':       # the same bf16 bits (torch's own cast sets NaN's sign)
        tx = t(np.asarray(jx).view(np.int16)).view(torch.bfloat16)
    else:
        tx = t(x)
    got = to_fp8(tx).numpy()
    np.testing.assert_array_equal(got, want)
    beyond = np.abs(np.asarray(jx, np.float32)) > 464
    assert beyond.sum() >= 5 and np.all((got[beyond] & 0x7F) == 0x7F)


@pytest.mark.parametrize('fresh', [False, True])
def test_fp8_fill_matches_jax(fresh):
    """Page-granular (fresh) and row scatters of e4m3 bytes; K/V scaled so some values
    lie past the e4m3 range (NaN bytes on both sides)."""
    rng = np.random.RandomState(1)
    port, jout = check_fill(ref_cache(rng, 2, 10, 16, 2, 16), 2, 16, fresh, rng, scale=150.0)
    assert port.dtype == torch.float8_e4m3fn and tuple(port.shape) == (2, 10, 2, 16, 32)
    assert np.isnan(np.asarray(jout, np.float32)).any()


@pytest.mark.parametrize('opts', [{}, {'logit_softcap': 4.0}, {'window_size': 9},
                                  {'sinks': True}])
def test_gather_and_paged_attention(opts):
    rng = np.random.RandomState(2)
    check_gather_and_attention(ref_cache(rng, 2, 12, 8, 2, 16), 2, 3, 16, opts, rng)


@pytest.mark.parametrize('G,softcap', [(1, None), (4, None), (4, 20.0)])
def test_fp8_decode_plain_matches_pallas(G, softcap):
    rng = np.random.RandomState(3)
    ref = ref_cache(rng, 3, 40, 16, 2, 64)
    port, q, tables, kv_lens, out = check_decode_vs_pallas(
        ref, 2, G, 64, softcap, paged_decode_attention_plain, paged_decode_attention_fp8,
        rng, pallas_cache=ref.astype(jnp.float32))
    # the Pallas kernel on the e4m3 pages themselves: P rounded to e4m3 (3 mantissa
    # bits, a relative error up to 2^-4 per term) is all that separates it
    with pltpu.force_tpu_interpret_mode():
        quirk = np.asarray(jdecode(jnp.asarray(q), ref, jnp.asarray(tables),
                                   jnp.asarray(kv_lens), jnp.int32(1), 0.125, 2,
                                   logit_softcap=softcap))
    active = kv_lens > 0
    vmax = np.abs(np.asarray(ref, np.float32)).max()
    assert 0 < np.abs(quirk - out)[active].max() <= 2.0 ** -4 * vmax
    # window and sinks: the fp8 route keeps the plain kernel's options
    sinks = rng.randn(2 * G).astype(np.float32)
    out = paged_decode_attention(t(q), port, t(tables), t(kv_lens), 1, 0.125, 2,
                                 window=24, sinks=t(sinks))
    ref_out = paged_decode_attention_plain(t(q), port.float(), t(tables), t(kv_lens), 1,
                                           0.125, 2, window=24, sinks=t(sinks))
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())


def test_cache_engine_fp8():
    from lmdeploy_tpu_torch.config import CacheConfig, ModelConfig
    from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
    from lmdeploy_tpu_torch.messages import QuantPolicy
    cfg = ModelConfig(num_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      hidden_size=64, intermediate_size=128, vocab_size=256, head_dim=16,
                      dtype='float32')
    ce = CacheEngine(cfg, CacheConfig(block_size=16, num_gpu_blocks=8,
                                      quant_policy=QuantPolicy.KV_FP8), torch.device('cpu'))
    kv = ce.kv_cache
    assert kv.dtype == torch.float8_e4m3fn and tuple(kv.shape) == (2, 8, 2, 16, 32)
    # per block: 2 layers x 2 planes x 16 tokens x 32 bytes
    assert ce.block_bytes() == 2 * 2 * 16 * 32 == kv.numel() // 8


@pytest.mark.parametrize('case', ['batch', 'preempt'])
def test_engine_kv_fp8_greedy_tokens_match_jax(tiny_model_dir, case):
    """Dense weights, fp8 cache: the same greedy tokens as the JAX engine, exactly."""
    out, ref = check_engine_tokens(tiny_model_dir, 16, case, torch.Tensor)
    assert out == ref


def test_pipeline_kv_fp8_matches_jax(tiny_model_dir):
    out, ref = pipeline_tokens(tiny_model_dir, 16)
    assert out == ref
