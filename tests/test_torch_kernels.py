"""Plain PyTorch versions of the port's CUDA kernels against the JAX Pallas kernels.

The Pallas kernels run in TPU interpret mode on the CPU, as the JAX package's own
tests run them (tests/test_pallas_flash_prefill.py, tests/test_pallas_paged_decode.py).
The CUDA kernels themselves are held against these plain versions on the card by
chip_smoke.py.  Tolerance: f32 allclose at 2e-5 (the Pallas kernels use an online
softmax, the plain versions a one-pass softmax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops.attention import kv_row_width
from lmdeploy_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                  flash_prefill_attention_plain)
from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                 paged_decode_attention_plain)
from lmdeploy_tpu_torch.weight_convert import cache_from_reference

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize('B,T,Hq,Hkv,D', [(2, 128, 4, 2, 64), (1, 256, 8, 1, 32)])
def test_flash_prefill_plain_matches_pallas(B, T, Hq, Hkv, D):
    from lmdeploy_tpu.ops.pallas.flash_prefill import flash_prefill_attention as jflash
    rng = np.random.RandomState(0)
    q = rng.randn(B, T, Hq, D).astype(np.float32)
    k = rng.randn(B, T, Hkv, D).astype(np.float32)
    v = rng.randn(B, T, Hkv, D).astype(np.float32)
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5,
                            tile_q=64, tile_k=64))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), D ** -0.5)
    np.testing.assert_allclose(flash_prefill_attention_plain(*args).numpy(), ref, **TOL)
    # on a CPU tensor the wrapper takes the plain version and counts no launch
    before = flash_prefill_attention.launches
    np.testing.assert_allclose(flash_prefill_attention(*args).numpy(), ref, **TOL)
    assert flash_prefill_attention.launches == before


@pytest.mark.parametrize('opts', [
    {},
    {'window': 40},
    {'logit_softcap': 4.0},
    {'sinks': True},
    {'window': 23, 'logit_softcap': 2.5, 'sinks': True},
])
def test_paged_decode_plain_matches_pallas(opts):
    from lmdeploy_tpu.ops.pallas.paged_decode import paged_decode_attention as jdecode
    rng = np.random.RandomState(1)
    L, layer, NB, BS, W = 3, 1, 40, 16, 6
    B, Hkv, G, D = 5, 2, 4, 64
    _, hdp = kv_row_width(Hkv, D)
    cache = rng.randn(L, NB, 2, BS, hdp).astype(np.float32)
    cache[..., Hkv * D:] = 0
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    kv_lens = np.array([1, 37, 0, 96, 64], np.int32)     # row 2 is inactive
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    scale = D ** -0.5
    jopts, topts = {}, {}
    if 'window' in opts:
        jopts['window'] = topts['window'] = opts['window']
    if 'logit_softcap' in opts:
        jopts['logit_softcap'] = topts['logit_softcap'] = opts['logit_softcap']
    if opts.get('sinks'):
        sinks = rng.randn(Hkv * G).astype(np.float32)
        jopts['sinks'], topts['sinks'] = jnp.asarray(sinks), torch.from_numpy(sinks)
    ref = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tables),
                             jnp.asarray(kv_lens), jnp.int32(layer), scale, Hkv, **jopts))
    port_cache = cache_from_reference(cache, Hkv, D)
    out = paged_decode_attention_plain(torch.from_numpy(q), port_cache,
                                       torch.from_numpy(tables), torch.from_numpy(kv_lens),
                                       layer, scale, Hkv, **topts).numpy()
    # active rows match; an inactive row (kv_len 0) is zero in the port, while the
    # reference's row-batched program leaves it finite but filled from its
    # neighbours' pages (the engine discards that row either way)
    active = kv_lens > 0
    np.testing.assert_allclose(out[active], ref[active], **TOL)
    assert np.all(out[~active] == 0) and np.isfinite(ref).all()
    before = paged_decode_attention.launches
    out2 = paged_decode_attention(torch.from_numpy(q), port_cache, torch.from_numpy(tables),
                                  torch.from_numpy(kv_lens), layer, scale, Hkv, **topts)
    np.testing.assert_array_equal(out2.numpy(), out)
    assert paged_decode_attention.launches == before


def test_cuda_sources_present():
    """Each wrapper's kernel source is in the package, next to its build list."""
    import os

    from lmdeploy_tpu_torch.ops import cuda_build
    for name in cuda_build.SOURCES:
        path = os.path.join(cuda_build.CSRC_DIR, name + '.cu')
        src = open(path).read()
        assert 'extern "C"' in src and 'lmdeploy_tpu/ops/pallas/' in src
        assert cuda_build.lib_path(name).startswith(cuda_build.BUILD_DIR)
