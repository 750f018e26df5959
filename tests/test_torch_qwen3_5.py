"""Qwen3.5 (dense and MoE, text) in the port against the JAX package on tiny twins of
the seeded Qwen3-Next checkpoint (``hybrid_cases.write_qwen3_5``: split projections,
fused or per-expert expert tensors, the ``model.language_model.`` prefix, a nested
``text_config``).  The JAX package builds its VL class where the config nests a
``vision_config`` (mrope over three equal text position ids), the port its text model:
loaders against ``load_params_np``, logits, and exact greedy tokens of the MoE twin's
Engine (and of the Qwen3-Next model it was split from); the dense twin's ``pipeline()``
is test_torch_qwen3_5_pipeline.py's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybrid_cases as hc

TOL = dict(rtol=1e-3, atol=1e-3)          # test_torch_qwen3_next.py says why
SMALL = dict(block_size=64, session_len=128, decode_buckets=[4], prefill_buckets=[32])


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('qwen3_5')
    return {
        'moe': hc.write_qwen3_5(str(root / 'moe')),
        'moe_per_expert': hc.write_qwen3_5(str(root / 'moe_pe'), fused_experts=False,
                                           with_vision=False),
        'dense': hc.write_qwen3_5(str(root / 'dense'), moe=False),
    }


def _flat(tree, pre=''):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f'{pre}{k}/') if isinstance(v, dict) else {pre + k: v})
    return out


@pytest.mark.parametrize('name', ['moe', 'moe_per_expert', 'dense'])
def test_loader_matches_load_params_np(dirs, name):
    """Every leaf equals the JAX loader's (fused ``gate_up_proj`` / ``down_proj`` and
    per-expert names alike, under ``model.language_model.``; ``in_proj_b`` / ``_a`` in
    the halves of ``lin_in_ba``); the fused and per-expert MoE checkpoints load equal
    trees."""
    from safetensors.numpy import load_file
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    _, jp, tm, tp = hc.models(dirs[name])
    got, ref = _flat(tp), _flat(params_from_jax(jp))
    assert set(got) == set(ref)
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k
    sd = load_file(dirs[name] + '/model.safetensors')
    p = 'model.language_model.layers.1.linear_attn.'
    np.testing.assert_array_equal(tp['blocks']['lin_in_ba'][0, 1, :, hc.HV:].numpy(),
                                  sd[p + 'in_proj_a.weight'].T)
    if name == 'moe_per_expert':
        fused = _flat(hc.models(dirs['moe'])[3])
        assert all(torch.equal(v, fused[k]) for k, v in got.items())


@pytest.mark.parametrize('name', ['moe', 'dense'])
def test_logits_match_jax(dirs, name):
    """One fresh prefill of 70 / 45 tokens (T 80: the chunked form) into slots 2 and 0:
    logits and state rows against the JAX model's."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference
    jm, jp, tm, tp = hc.models(dirs[name])
    cfg = jm.config
    _, hdp = kv_row_width(cfg.num_key_value_heads, cfg.head_dim)
    jcache = {'pages': jnp.zeros((cfg.num_cache_layers, 12, 2, 16, hdp), jnp.float32)}
    jcache.update({n: jnp.zeros(sd.shape, sd.dtype) for n, sd in jm.state_shapes(4).items()})
    tcache = cache_from_reference(jax.tree_util.tree_map(np.asarray, jcache),
                                  cfg.num_key_value_heads, cfg.head_dim)
    rng = np.random.RandomState(3)
    T, qlen = 80, np.array([70, 45], np.int32)
    x = rng.randint(3, 120, size=(2, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    hist, slots, reset = np.zeros(2, np.int32), np.array([2, 0], np.int32), np.ones(2, bool)
    jl, jcache = jax.jit(jm.forward, static_argnames=('return_all_logits', 'fresh_prefill'))(
        jp, jnp.asarray(x), jnp.asarray(pos), jcache,
        JMeta(*(jnp.asarray(a) for a in (tables, hist, qlen, slots, reset))),
        *jrope(cfg.rope_dim, 256, cfg.rope_theta), return_all_logits=True,
        fresh_prefill=True)
    tl = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                    TMeta(*(torch.from_numpy(a) for a in (tables, hist, qlen, slots, reset))),
                    *trope(cfg.rope_dim, 256, cfg.rope_theta), return_all_logits=True,
                    fresh_prefill=True)
    for b in range(2):
        np.testing.assert_allclose(tl[b, :qlen[b]].numpy(), np.asarray(jl)[b, :qlen[b]],
                                   **TOL)
    for k in ('conv', 'rec'):
        np.testing.assert_allclose(tcache[k][:, [0, 2]].numpy(),
                                   np.asarray(jcache[k])[:, [0, 2]], **TOL)


def test_moe_engine_matches_jax_and_the_next_model(tmp_path):
    """The MoE twin (fused experts, a ``vision_config`` beside the text config; the JAX
    package serves it through its VL class with mrope positions) on three concurrent
    prompts: greedy tokens equal the JAX engine's and the port's on the Qwen3-Next
    checkpoint it was split from."""
    q35 = hc.write_qwen3_5(str(tmp_path / 'moe'), interval=2)
    nxt = hc.write_qwen3_next(str(tmp_path / 'next'), interval=2)
    ps = hc.prompts(21, (11, 30, 7))
    ref, _ = hc.run('jax', q35, [ps], 8, **SMALL)
    got, _ = hc.run('torch', q35, [ps], 8, **SMALL)
    assert got == ref and all(len(t) == 8 for t in got)
    assert hc.run('torch', nxt, [ps], 8, **SMALL)[0] == got
