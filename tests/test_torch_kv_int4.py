"""The port's int4 KV cache (quant_policy 8) against the JAX package (CPU, f32).

The port keeps its own layout (dim pairs a byte, token-major scale and min rows;
``ops/kv_quant.py``), the reference packs token pairs and de-interleaves its scales:
``weight_convert`` maps the two, and every cache comparison goes through it bit for
bit.  ``quantize_rows_int4`` and the fill are bit-equal to the reference's under
``jax.jit``, as its engine runs them; the gather dequantizes to the
same values; ``paged_attention`` and the plain int4 decode (the CUDA kernel's plain
version) match the reference's gather path and its Pallas int4 kernel in TPU interpret
mode at f32 allclose 2e-5 (the same products summed in another order, and the
kernel's online softmax against a one-pass one).  Engine and pipeline give exactly the
JAX package's greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops import kv_quant as jq
from lmdeploy_tpu.ops.attention import kv_row_width
from lmdeploy_tpu_torch.ops.kv_quant import (QuantKV4, dequantize_int4, pack_nibbles,
                                             quantize_rows_int4, unpack_nibbles)
from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                 paged_decode_attention_int4,
                                                 paged_decode_attention_int4_plain,
                                                 paged_decode_attention_int4_split_plain)

from torch_kv_cases import (TOL, check_decode_vs_pallas, check_engine_tokens, check_fill,
                            check_gather_and_attention, fill_random, pipeline_tokens, t)


def ref_cache(rng, L, NB, BS, Hkv, D, filled=True):
    """A reference QuantKV4 (zeros, or every slot filled through the JAX fill)."""
    _, hdp = kv_row_width(Hkv, D)
    ref = jq.QuantKV4(jnp.zeros((L, NB, 2, BS // 2, hdp), jnp.uint8),
                      jnp.zeros((L, NB, 2, Hkv, BS), jnp.float32),
                      jnp.zeros((L, NB, 2, Hkv, BS), jnp.float32))
    return fill_random(ref, rng, L, NB, BS, Hkv, D) if filled else ref


def test_quantize_rows_int4_bit_equal():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4, 32).astype(np.float32) * 3
    x[0, 0] = 0                                        # a constant row: scale = eps
    x[1, 1, :4] = [7.5, -7.5, 0.25, -0.25]
    jq_, js, jm = jax.jit(jq.quantize_rows_int4)(jnp.asarray(x))
    tq, ts, tm = quantize_rows_int4(t(x))
    assert tq.dtype == torch.uint8 and ts.dtype == tm.dtype == torch.float32
    for a, b in ((tq, jq_), (ts, js), (tm, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # 4,096 rows of one head dim: the jitted reference's (max - min) * fl(1/15) + eps
    # (one fused multiply-add) differs from the eager division in most of them
    big = rng.randn(4096, 128).astype(np.float32)
    for a, b in zip(quantize_rows_int4(t(big)), jax.jit(jq.quantize_rows_int4)(big)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(dequantize_int4(tq, ts, tm).numpy(),
                                  np.asarray(jq.dequantize_int4(jq_, js, jm)))
    np.testing.assert_array_equal(unpack_nibbles(pack_nibbles(tq)).numpy(), tq.numpy())
    assert pack_nibbles(tq).shape == (64, 4, 16)


@pytest.mark.parametrize('fresh', [False, True])
def test_int4_fill_matches_jax(fresh):
    """Row scatter of nibble rows and [Hkv] scale and min rows, also when page tables
    are given (a quantized cache never takes the page-granular write); the reference's
    parity rounds of token pairs give the same bytes."""
    rng = np.random.RandomState(1)
    port, _ = check_fill(ref_cache(rng, 2, 10, 16, 2, 16), 2, 16, fresh, rng)
    assert isinstance(port, QuantKV4) and tuple(port.shape) == (2, 10, 2, 16, 32)
    assert tuple(port.data.shape) == (2, 10, 2, 16, 16)


@pytest.mark.parametrize('opts', [{}, {'logit_softcap': 4.0}, {'window_size': 9},
                                  {'sinks': True}])
def test_gather_dequant_and_paged_attention(opts):
    rng = np.random.RandomState(2)
    check_gather_and_attention(ref_cache(rng, 2, 12, 8, 2, 16), 2, 3, 16, opts, rng)


@pytest.mark.parametrize('G,softcap', [(1, None), (4, None), (4, 20.0)])
def test_int4_decode_plain_matches_pallas(G, softcap):
    rng = np.random.RandomState(3)
    ref = ref_cache(rng, 3, 40, 16, 2, 64)
    port, q, tables, kv_lens, _ = check_decode_vs_pallas(
        ref, 2, G, 64, softcap, paged_decode_attention_int4_plain,
        paged_decode_attention_int4, rng)
    with pytest.raises(ValueError):          # no window and no sinks on a quantized cache
        paged_decode_attention(t(q), port, t(tables), t(kv_lens), 1, 0.125, 2, window=8)


@pytest.mark.parametrize('G,softcap', [(1, None), (4, None), (4, 20.0), (8, None)])
def test_int4_decode_split_plain_matches_pallas(G, softcap):
    """The kernel's two passes in plain PyTorch -- each split's (acc, m, l) over its
    pages, then the fixed-order combine -- against the Pallas kernel in interpret mode
    at 2e-5: 1, 2 and W splits of the 6-page table and the wrapper's own split, on rows
    of 1, 37, 0, 96 and 32 tokens (empty splits, an inactive row whose output is 0)."""
    rng = np.random.RandomState(5)
    port, q, tables, kv_lens, out_ref = check_decode_vs_pallas(
        ref_cache(rng, 3, 40, 16, 2, 64), 2, G, 64, softcap,
        paged_decode_attention_int4_plain, paged_decode_attention_int4, rng)
    active = kv_lens > 0
    for splits in (1, 2, tables.shape[1], None):
        out = paged_decode_attention_int4_split_plain(
            t(q), port, t(tables), t(kv_lens), 1, 64 ** -0.5, 2, logit_softcap=softcap,
            splits=splits).numpy()
        np.testing.assert_allclose(out[active], out_ref[active], **TOL)
        assert np.all(out[~active] == 0)


@pytest.mark.parametrize('softcap', [None, 20.0])
def test_int4_decode_plain_matches_pallas_at_mla(softcap):
    """MLA's one latent kv head of 576 under 16 query heads (DeepSeek-V2-Lite's
    geometry), which the CUDA kernel serves through its wide path: the plain version
    against the Pallas kernel in interpret mode at 2e-5, and the wrapper's checks take
    the shape (quant_policy 8 serves DeepSeek on the card)."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    rng = np.random.RandomState(4)
    port, q, tables, kv_lens, _ = check_decode_vs_pallas(
        ref_cache(rng, 2, 32, 16, 1, 576), 1, 16, 576, softcap,
        paged_decode_attention_int4_plain, paged_decode_attention_int4, rng)
    assert pd._check('paged_decode_int4', t(q), port.data, t(tables), t(kv_lens), 1, 1,
                     (port.scale, port.minv), head_dims=pd.QUANT_HEAD_DIMS)[2] == 576


def test_cache_engine_int4():
    from lmdeploy_tpu_torch.config import CacheConfig, ModelConfig
    from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
    from lmdeploy_tpu_torch.messages import QuantPolicy
    cfg = ModelConfig(num_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      hidden_size=64, intermediate_size=128, vocab_size=256, head_dim=16,
                      dtype='float32')
    ce = CacheEngine(cfg, CacheConfig(block_size=16, num_gpu_blocks=8,
                                      quant_policy=QuantPolicy.KV_INT4), torch.device('cpu'))
    kv = ce.kv_cache
    assert isinstance(kv, QuantKV4) and kv.dtype == torch.uint8
    assert tuple(kv.shape) == (2, 8, 2, 16, 32)          # logical: shape[3] = block size
    assert tuple(kv.data.shape) == (2, 8, 2, 16, 16)
    assert tuple(kv.scale.shape) == tuple(kv.minv.shape) == (2, 8, 2, 16, 2)
    # per block: 2 layers x 2 planes x 16 tokens x (16 code bytes + 2 f32 scales + 2 mins)
    assert ce.block_bytes() == 2 * 2 * 16 * (16 + 2 * 8) == kv.nbytes // 8


@pytest.mark.parametrize('case', ['batch', 'preempt'])
def test_engine_kv_int4_greedy_tokens_match_jax(tiny_model_dir, case):
    """Dense weights, int4 cache: the same greedy tokens as the JAX engine, exactly."""
    out, ref = check_engine_tokens(tiny_model_dir, 8, case, QuantKV4)
    assert out == ref


def test_pipeline_kv_int4_matches_jax(tiny_model_dir):
    out, ref = pipeline_tokens(tiny_model_dir, 8)
    assert out == ref
