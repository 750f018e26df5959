"""The port's TurboQuant k4v2 KV cache (quant_policy 42) against the JAX package (CPU,
f32).

The port keeps its own layout (per-head code rows, V four codes a byte, token-major
meta; ``ops/kv_quant.py``), the reference packs planar rows over the whole head-major
row: ``weight_convert`` maps the two bit for bit.  The Hadamard rotation is the same
f32 product (bit-equal at D = 64 and 128, where XLA and torch sum in the same order);
the K and V codes of the quantizers and the fill are bit-equal to the reference's under
``jax.jit``, as its engine runs them (qjl_norm times fl(1/sqrt(D)), as XLA rewrites
its division); the f32 norms are sums of squares that XLA's CPU reduction adds in
another order than torch's (a unit or two in the last place; the QJL residual norm,
taken after the cancellation u - centroid, up to about ten), so they are held to a
relative 2e-6.  The gather
dequantizes the same codes to the same values; ``paged_attention`` (q rotated into
the cache's domain, the output rotated back) and the plain TurboQuant decode (the
CUDA kernel's plain version) match the reference's gather path and its Pallas kernel
in TPU interpret mode at f32 allclose 2e-5.  Engine and pipeline give exactly the JAX
package's greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops import kv_quant as jq
from lmdeploy_tpu_torch.ops import kv_quant as tq
from lmdeploy_tpu_torch.ops.kv_quant import QuantKVTurbo
from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                 paged_decode_attention_turbo,
                                                 paged_decode_attention_turbo_plain,
                                                 paged_decode_attention_turbo_split_plain)

from torch_kv_cases import (TOL, check_decode_vs_pallas, check_engine_tokens, check_fill,
                            check_gather_and_attention, fill_random, pipeline_tokens, t)

NORM_RTOL = 2e-6


def ref_cache(rng, L, NB, BS, Hkv, D, filled=True):
    """A reference QuantKVTurbo (zeros, or every slot filled through the JAX fill)."""
    rowt = (Hkv * D // 2 + 127) // 128 * 128
    ref = jq.QuantKVTurbo(jnp.zeros((L, NB, 2, BS, rowt), jnp.uint8),
                          jnp.zeros((L, NB, 2, 2, Hkv, BS), jnp.float32))
    return fill_random(ref, rng, L, NB, BS, Hkv, D) if filled else ref


@pytest.mark.parametrize('D', [16, 64, 128])
def test_hadamard_and_quantizers_match_jax(D):
    rng = np.random.RandomState(D)
    x = (rng.randn(512, 2, D) * 3).astype(np.float32)
    q = tq.hadamard(D).numpy()
    np.testing.assert_array_equal(q, jq.hadamard(D))
    jr, tr = np.asarray(jq.hadamard_rotate(jnp.asarray(x))), tq.hadamard_rotate(t(x))
    if D >= 64:
        np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tq.hadamard_rotate_inv(tr).numpy(), x, rtol=0, atol=2e-5)
    # the quantizers on the same rotated rows, against the jitted reference
    jk = [np.asarray(a) for a in jax.jit(jq.quantize_rows_turbo_k)(jnp.asarray(jr))]
    tk = [a.numpy() for a in tq.quantize_rows_turbo_k(t(jr))]
    np.testing.assert_array_equal(tk[0], jk[0])
    assert tk[0].max() == 15 and tk[0].min() == 0
    for a, b in zip(tk[1:], jk[1:]):
        np.testing.assert_allclose(a, b, rtol=NORM_RTOL, atol=0)
    jv = [np.asarray(a) for a in jax.jit(jq.quantize_rows_turbo_v)(jnp.asarray(jr))]
    tv = [a.numpy() for a in tq.quantize_rows_turbo_v(t(jr))]
    np.testing.assert_array_equal(tv[0], jv[0])
    np.testing.assert_allclose(tv[1], jv[1], rtol=NORM_RTOL, atol=0)
    # dequantization of the same codes and norms is bit-equal
    code, mse, qjl = jk
    np.testing.assert_array_equal(
        tq.dequantize_turbo_k(t(code), t(mse), t(qjl)).numpy(),
        np.asarray(jq.dequantize_turbo_k(jnp.asarray(code), jnp.asarray(mse), jnp.asarray(qjl))))
    np.testing.assert_array_equal(
        tq.dequantize_turbo_v(t(jv[0]), t(jv[1])).numpy(),
        np.asarray(jq.dequantize_turbo_v(jnp.asarray(jv[0]), jnp.asarray(jv[1]))))
    c = t(code)
    np.testing.assert_array_equal(tq.unpack_2bit(tq.pack_2bit(c & 3)).numpy(), code & 3)


@pytest.mark.parametrize('fresh', [False, True])
def test_turbo_fill_matches_jax(fresh):
    """Row scatter of rotated, coded K and V rows and their [3, Hkv] meta, also when
    page tables are given (a quantized cache never takes the page-granular write)."""
    rng = np.random.RandomState(1)
    port, _ = check_fill(ref_cache(rng, 2, 10, 16, 2, 64), 2, 64, fresh, rng,
                         float_rtol=NORM_RTOL)
    assert isinstance(port, QuantKVTurbo) and tuple(port.shape) == (2, 10, 2, 16, 128)
    assert tuple(port.data.shape) == (2, 10, 16, 96)


@pytest.mark.parametrize('opts', [{}, {'logit_softcap': 4.0}, {'window_size': 9},
                                  {'sinks': True}])
def test_gather_dequant_and_paged_attention(opts):
    rng = np.random.RandomState(2)
    check_gather_and_attention(ref_cache(rng, 2, 12, 8, 2, 16), 2, 3, 16, opts, rng)


@pytest.mark.parametrize('G,softcap', [(1, None), (4, None), (4, 20.0)])
def test_turbo_decode_plain_matches_pallas(G, softcap):
    """Hkv * D = 256: the Pallas kernel's TPU lane rule (the port's kernel has none)."""
    rng = np.random.RandomState(3)
    ref = ref_cache(rng, 3, 40, 16, 2, 128)
    port, q, tables, kv_lens, _ = check_decode_vs_pallas(
        ref, 2, G, 128, softcap, paged_decode_attention_turbo_plain,
        paged_decode_attention_turbo, rng,
        q_rotate=lambda x: np.asarray(jq.hadamard_rotate(jnp.asarray(x))))
    with pytest.raises(ValueError):          # no window and no sinks on a quantized cache
        paged_decode_attention(t(q), port, t(tables), t(kv_lens), 1, 0.1, 2,
                               sinks=torch.zeros(2 * G))


@pytest.mark.parametrize('G,softcap', [(1, None), (4, None), (4, 20.0), (8, None)])
def test_turbo_decode_split_plain_matches_pallas(G, softcap):
    """The kernel's two passes in plain PyTorch (rotated domain) -- each split's (acc,
    m, l) over its pages, then the fixed-order combine -- against the Pallas kernel in
    interpret mode at 2e-5: 1, 2 and W splits of the 6-page table and the wrapper's own
    split, on rows of 1, 37, 0, 96 and 32 tokens (empty splits, an inactive row)."""
    rng = np.random.RandomState(5)
    port, q, tables, kv_lens, out_ref = check_decode_vs_pallas(
        ref_cache(rng, 3, 40, 16, 2, 128), 2, G, 128, softcap,
        paged_decode_attention_turbo_plain, paged_decode_attention_turbo, rng,
        q_rotate=lambda x: np.asarray(jq.hadamard_rotate(jnp.asarray(x))))
    active = kv_lens > 0
    for splits in (1, 2, tables.shape[1], None):
        out = paged_decode_attention_turbo_split_plain(
            t(q), port, t(tables), t(kv_lens), 1, 128 ** -0.5, 2, logit_softcap=softcap,
            splits=splits).numpy()
        np.testing.assert_allclose(out[active], out_ref[active], **TOL)
        assert np.all(out[~active] == 0)


def test_cache_engine_turbo():
    from lmdeploy_tpu_torch.config import CacheConfig, ModelConfig
    from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
    from lmdeploy_tpu_torch.messages import QuantPolicy
    cfg = ModelConfig(num_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      hidden_size=64, intermediate_size=128, vocab_size=256, head_dim=16,
                      dtype='float32')
    ce = CacheEngine(cfg, CacheConfig(block_size=16, num_gpu_blocks=8,
                                      quant_policy=QuantPolicy.TURBO_QUANT),
                     torch.device('cpu'))
    kv = ce.kv_cache
    assert isinstance(kv, QuantKVTurbo) and kv.dtype == torch.uint8
    assert tuple(kv.shape) == (2, 8, 2, 16, 32)          # logical: shape[3] = block size
    assert tuple(kv.data.shape) == (2, 8, 16, 24) and tuple(kv.meta.shape) == (2, 8, 16, 3, 2)
    # per block: 2 layers x 16 tokens x (16 K + 8 V code bytes + 3 x 2 f32 metas)
    assert ce.block_bytes() == 2 * 16 * (24 + 3 * 2 * 4) == kv.nbytes // 8
    with pytest.raises(ValueError):
        CacheEngine(ModelConfig(**dict(cfg.__dict__, head_dim=24)),
                    CacheConfig(num_gpu_blocks=8, quant_policy=QuantPolicy.TURBO_QUANT),
                    torch.device('cpu'))


@pytest.mark.parametrize('case', ['batch', 'preempt'])
def test_engine_turbo_greedy_tokens_match_jax(tiny_model_dir, case):
    """Dense weights, TurboQuant cache: the same greedy tokens as the JAX engine."""
    out, ref = check_engine_tokens(tiny_model_dir, 42, case, QuantKVTurbo)
    assert out == ref


def test_pipeline_turbo_matches_jax(tiny_model_dir):
    out, ref = pipeline_tokens(tiny_model_dir, 42)
    assert out == ref
