"""Which path a decode step takes on the card for each KV cache (CPU).

``ops.attention.decode_route`` sends a decode step over an int8, int4 or TurboQuant
cache with a window or sinks to the gathered path (``gather_layer_kv`` +
``attention_dense_gathered``), the reference's rule, and every other step to its
kernel, whatever the block size: the quantized kernels' tensor-core bodies look up
each row's page, so pages under 16 slots (a warp's 16 rows on several pages) take
them too.  On the CPU every step takes the gathered path, so the Engine's greedy
tokens at block size 8 must equal those at 16, and the JAX engine's at 8, for each
quantized policy.
"""
import pytest
import torch

from lmdeploy_tpu_torch.config import CacheConfig, ModelConfig
from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
from lmdeploy_tpu_torch.ops import paged_decode as pd
from lmdeploy_tpu_torch.ops.attention import decode_route
from lmdeploy_tpu_torch.ops.kv_quant import QuantKV, QuantKV4, QuantKVTurbo
from test_torch_engine import generate, make_prompts

POLICIES = {4: QuantKV, 8: QuantKV4, 42: QuantKVTurbo}


def _cache(policy: int, block_size: int):
    model = ModelConfig(num_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        hidden_size=256, intermediate_size=128, vocab_size=128,
                        head_dim=64, dtype='bfloat16')
    return CacheEngine(model, CacheConfig(block_size=block_size, num_gpu_blocks=4,
                                          quant_policy=policy), torch.device('cpu')).kv_cache


@pytest.mark.parametrize('block_size', [8, 16])
@pytest.mark.parametrize('policy', [4, 8, 42])
def test_quantized_decode_route_by_block_size(policy, block_size):
    cache = _cache(policy, block_size)
    assert isinstance(cache, POLICIES[policy]) and cache.shape[3] == block_size
    assert decode_route(cache) == 'kernel'
    # a window or sinks send every quantized cache to the gathered path
    assert decode_route(cache, window_size=32) == 'gathered'
    assert decode_route(cache, sinks=torch.zeros(4)) == 'gathered'
    assert decode_route(cache, window_size=0) == 'kernel'


@pytest.mark.parametrize('policy', [0, 16])
def test_plain_layout_decode_always_takes_the_kernel(policy):
    for block_size in (1, 8, 16):
        cache = _cache(policy, block_size)
        assert decode_route(cache) == 'kernel'
        assert decode_route(cache, window_size=8, sinks=torch.zeros(4)) == 'kernel'


@pytest.mark.parametrize('block_size', [1, 8])
@pytest.mark.parametrize('policy', [4, 8, 42])
def test_quantized_kernel_checks_take_small_pages(policy, block_size):
    """The int8, int4 and TurboQuant wrappers' checks take pages under 16 slots."""
    cache = _cache(policy, block_size)
    names, dims = {4: (('scale',), pd.QUANT_HEAD_DIMS),
                   8: (('scale', 'minv'), pd.QUANT_HEAD_DIMS),
                   42: (('meta',), pd.TURBO_HEAD_DIMS)}[policy]
    extras = tuple(getattr(cache, n) for n in names)
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    tables = torch.ones(2, 3, dtype=torch.int32)
    kv_lens = torch.tensor([3, 5], dtype=torch.int32)
    assert pd._check('decode', q, cache.data, tables, kv_lens, 1, 2, extras,
                     head_dims=dims) == (2, 4, 64, 4, block_size, 3)


@pytest.mark.parametrize('policy', [4, 8, 42])
def test_small_pages_engine_tokens(tiny_model_dir, policy):
    prompts = make_prompts(4, (5, 37, 20))
    small, engine = generate('torch', tiny_model_dir, prompts, quant_policy=policy,
                             block_size=8, num_gpu_blocks=128)
    assert isinstance(engine.model_agent.kv_cache, POLICIES[policy])
    assert engine.model_agent.kv_cache.shape[3] == 8
    base, _ = generate('torch', tiny_model_dir, prompts, quant_policy=policy)
    ref, _ = generate('jax', tiny_model_dir, prompts, quant_policy=policy, block_size=8,
                      num_gpu_blocks=128)
    assert small == base == ref
