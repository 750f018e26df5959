"""The port's LlamaModel against the JAX LlamaModel on the tiny random checkpoint.

Weights come from the same safetensors file through each package's loader; the
chunk sequence is a fresh prefill, a chunked continuation and two decode steps, each
compared by logits (f32 allclose at 1e-5) and by the cache contents it leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope='module')
def models(tiny_model_dir):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(tiny_model_dir))
    tm = tbuild(TConfig.from_pretrained(tiny_model_dir))
    jp = load_model_params(jm, tiny_model_dir)
    tp = load_params(tm, tiny_model_dir, 'cpu')
    return jm, jp, tm, tp


def test_loader_matches_params_from_jax(models):
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    jm, jp, tm, tp = models
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert set(conv) == set(tp) and set(conv['layers']) == set(tp['layers'])
    for k in ('embed', 'final_norm', 'lm_head'):
        assert torch.equal(conv[k], tp[k]), k
    for k, v in tp['layers'].items():
        assert torch.equal(conv['layers'][k], v), k


@pytest.mark.parametrize('fused', [False, True])
def test_logits_prefill_continuation_decode(models, fused):
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference
    jm, jp, tm, tp = models
    if fused:
        jp, tp = jm.fuse_projections(jp), tm.fuse_projections(tp)
    cfg = jm.config
    L, BS, NB = cfg.num_layers, 16, 12
    _, hdp = kv_row_width(cfg.num_key_value_heads, cfg.head_dim)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), cfg.num_key_value_heads, cfg.head_dim)
    jcos, jsin = jrope(cfg.head_dim, 256, cfg.rope_theta)
    tcos, tsin = trope(cfg.head_dim, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    rng = np.random.RandomState(0)
    ids = rng.randint(3, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    # (history, q_lens, T, fresh): prefill rows of 20 / 32 tokens, a continuation
    # chunk of 16 / 9, then two decode steps
    steps = [((0, 0), (20, 32), 32, True), ((20, 32), (16, 9), 16, False),
             ((36, 41), (1, 1), 1, False), ((37, 42), (1, 1), 1, False)]
    for hist, qlen, T, fresh in steps:
        hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
        x = np.zeros((2, T), np.int32)
        pos = np.zeros((2, T), np.int32)
        for b in range(2):
            x[b, :qlen[b]] = ids[b, hist[b]:hist[b] + qlen[b]]
            pos[b, :qlen[b]] = np.arange(hist[b], hist[b] + qlen[b])
        jl, jcache = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos), jcache,
                                JMeta(jnp.asarray(tables), jnp.asarray(hist),
                                      jnp.asarray(qlen)),
                                jcos, jsin, return_all_logits=True, fresh_prefill=fresh)
        tl = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                        TMeta(torch.from_numpy(tables), torch.from_numpy(hist),
                              torch.from_numpy(qlen)),
                        tcos, tsin, return_all_logits=True, fresh_prefill=fresh)
        jl = np.asarray(jl)
        for b in range(2):
            np.testing.assert_allclose(tl[b, :qlen[b]].numpy(), jl[b, :qlen[b]],
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cache_to_reference(tcache)[:, 1:],
                                   np.asarray(jcache)[:, 1:], rtol=1e-5, atol=1e-6)
        # the default return is each row's last valid token
        last = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                          tcache.clone(), TMeta(torch.from_numpy(tables),
                                                torch.from_numpy(hist),
                                                torch.from_numpy(qlen)), tcos, tsin)
        np.testing.assert_allclose(last.numpy(), jl[np.arange(2), qlen - 1],
                                   rtol=1e-5, atol=1e-5)


def test_registry_options():
    """qwen2 switches on attention bias, qwen3 qk-norm, as the reference does."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    base = dict(num_hidden_layers=1, hidden_size=32, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=64, vocab_size=50)
    q2 = build_model(ModelConfig.from_hf_config(dict(base, architectures=['Qwen2ForCausalLM'])))
    q3 = build_model(ModelConfig.from_hf_config(dict(base, architectures=['Qwen3ForCausalLM'],
                                                     tie_word_embeddings=True)))
    assert 'bq' in q2.param_shapes()['layers']
    shapes = q3.param_shapes()
    assert 'q_norm' in shapes['layers'] and 'lm_head' not in shapes
    with pytest.raises(ValueError):
        build_model(ModelConfig.from_hf_config(dict(base, architectures=['Nope'])))
