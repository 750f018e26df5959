"""The port's DeepSeek Sparse Attention models against the JAX package (CPU, f32).

DeepSeek-V3.2 (``DSV32_CFG``) and GLM-MoE-DSA (``GLM_DSA_CFG``, 'full' and 'shared'
indexer layers, rotate-half indexer rope) at the reference tests' tiny geometry, with
random indexer norms so the LayerNorm's weight and bias count: ``hadamard_transform``
bit for bit and against the matrix form; the loaders exactly; logits and the filled
cache at 1e-5 at ``index_topk`` 4 (sparse); the indexer's picks exactly, with a planted
tie (two equal keys: the lower index first); a top-k that covers the context equal to
dense MLA on the same weights; chunked prefill equal to one shot; query blocks equal to
one block.  The DSA engine is held in test_torch_mtp_glm_engine.py.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtp_dsa_cases as mc

TOPK = 4
BS, NB = 16, 12


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp('dsa')
    return {name: mc.write_checkpoint(str(root / name), name, index_topk=TOPK)
            for name in ('v32', 'glm_dsa')}


@pytest.fixture(scope='module')
def models(ckpt):
    return {name: (*mc.jax_model(path), *mc.torch_model(path)) for name, path in ckpt.items()}


def _tables(B, W):
    return (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)


def _forward(jm, jp, tm, tp, ids, hist, q_lens, tables, jcache=None, tcache=None):
    """One chunk through both models: (port logits, JAX logits, port cache, JAX cache)."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    cfg, jcfg = tm.config, jm.config
    B, T = ids.shape
    if jcache is None:
        rowp = kv_row_width(jcfg.num_key_value_heads, jcfg.cache_head_dim)[1]
        jcache = jnp.zeros((jcfg.num_layers, NB, 2, BS, rowp), jnp.float32)
        tcache = torch.zeros((cfg.num_layers, NB, 2, BS, cfg.cache_head_dim))
    pos = hist[:, None] + np.arange(T, dtype=np.int32)[None]
    jcos, jsin = jrope(jcfg.rope_dim, 256, jcfg.rope_theta, jcfg.rope_scaling)
    tcos, tsin = trope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    fwd = jax.jit(jm.forward, static_argnames=('return_all_logits',))
    jl, jcache = fwd(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                     JMeta(jnp.asarray(tables), jnp.asarray(hist), jnp.asarray(q_lens)),
                     jcos, jsin, return_all_logits=True)
    tl = tm.forward(tp, torch.from_numpy(ids), torch.from_numpy(pos), tcache,
                    TMeta(torch.from_numpy(tables), torch.from_numpy(hist),
                          torch.from_numpy(q_lens)), tcos, tsin, return_all_logits=True)
    return tl, np.asarray(jl), tcache, jcache


def test_hadamard_matches_jax_and_matrix():
    from lmdeploy_tpu.models.deepseek_v32 import hadamard_transform as jh
    from lmdeploy_tpu_torch.models.deepseek_v32 import hadamard_transform
    rng = np.random.RandomState(0)
    jh = jax.jit(jh)
    for d in (16, 128):
        x = rng.randn(3, 5, d).astype(np.float32)
        got = hadamard_transform(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jh(jnp.asarray(x))))
        xb = torch.from_numpy(x).to(torch.bfloat16)
        ref_b = jh(jnp.asarray(x, jnp.bfloat16))
        np.testing.assert_array_equal(hadamard_transform(xb).float().numpy(),
                                      np.asarray(ref_b, np.float32))
        H = np.array([[(-1) ** bin(i & j).count('1') for j in range(d)] for i in range(d)],
                     np.float32) * d ** -0.5
        np.testing.assert_allclose(got.numpy(), x @ H.T, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='power-of-two'):
        hadamard_transform(torch.zeros(2, 24))


@pytest.mark.parametrize('name', ['v32', 'glm_dsa'])
def test_loader_logits_and_cache_match_jax(models, name):
    """Two rows (21 and 16 valid tokens) in one prefill chunk, then a decode step: the
    loaders exactly, the logits and the caches (the reference's wide rows: the port's
    one kv head padded to them) at 1e-5."""
    from lmdeploy_tpu_torch.weight_convert import cache_to_reference, params_from_jax
    jm, jp, tm, tp = models[name]
    conv = params_from_jax(jp)
    for group in ('layers', 'moe_layers'):
        for leaf, t in tp.get(group, {}).items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jp[group][leaf]), err_msg=leaf)
            np.testing.assert_array_equal(conv[group][leaf].numpy(), t.numpy())
    assert tm.config.num_key_value_heads == 1 and tm.config.cache_head_dim == 24 + 8 + 16
    rng = np.random.RandomState(3)
    ids = rng.randint(3, 120, size=(2, 21)).astype(np.int32)
    tables = _tables(2, 3)
    hist, q = np.zeros(2, np.int32), np.array([21, 16], np.int32)
    tl, jl, tc, jc = _forward(*models[name], ids, hist, q, tables)
    valid = np.arange(21)[None] < q[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], jl[valid], rtol=0, atol=1e-5)
    nxt = tl.numpy()[np.arange(2), q - 1].argmax(-1).astype(np.int32)[:, None]
    tl, jl, tc, jc = _forward(*models[name], nxt, q, np.ones(2, np.int32), tables, jc, tc)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5)
    ref = np.asarray(jc)
    np.testing.assert_allclose(cache_to_reference(tc, row=ref.shape[-1]), ref, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('name', ['v32', 'glm_dsa'])
def test_picks_match_jax_with_a_planted_tie(models, name):
    """The indexer's causal top-4 of every query over 20 cached keys, exactly the
    reference's; keys 3 and 11 are one key, so every query past 11 scores them alike:
    where both are picked the lower comes first."""
    jm, jp, tm, tp = models[name]
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    cfg = tm.config
    rng = np.random.RandomState(7)
    B, T, S = 2, 6, 20
    H, rq, Di = cfg.hidden_size, cfg.q_lora_rank, tm.idx_dim
    x = rng.randn(B, T, H).astype(np.float32)
    qr = rng.randn(B, T, rq).astype(np.float32)
    hist_k = rng.randn(B, S, Di).astype(np.float32)
    hist_k[:, 11] = hist_k[:, 3]
    pos_q = np.array([[14, 15, 16, 17, 18, 19], [2, 4, 5, 12, 13, 19]], np.int32)
    causal = np.arange(S)[None, None] <= pos_q[:, :, None]
    jcos, jsin = jrope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    tcos, tsin = trope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    jw = {k: v[0] for k, v in jp['layers'].items()}
    tw = {k: v[0] for k, v in tp['layers'].items()}
    extra = ((jnp.zeros((B, T, TOPK), jnp.int32), jnp.zeros((B, T, TOPK), bool))
             if name == 'glm_dsa' else ())
    select = jax.jit(jm._dsa_select, static_argnames=('layer',))
    jidx, jvalid, _ = select(jnp.asarray(x), jnp.asarray(qr), jw, jcos[pos_q], jsin[pos_q],
                             jnp.asarray(hist_k), jnp.asarray(causal), layer=0, extra=extra)
    picks, valid, carry = tm._dsa_select(tw, torch.from_numpy(x), torch.from_numpy(qr),
                                         tcos[pos_q], tsin[pos_q], torch.from_numpy(hist_k),
                                         torch.from_numpy(pos_q).long(), 0, None)
    np.testing.assert_array_equal(picks.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert picks.shape[-1] == TOPK
    both = ((picks == 3).any(-1) & (picks == 11).any(-1)).numpy()
    order = picks.numpy()
    for b, t in zip(*np.nonzero(both)):
        assert list(order[b, t]).index(3) < list(order[b, t]).index(11)
    assert (~valid[1, 0]).any()                 # 3 keys in range at position 2
    if name == 'glm_dsa':
        assert carry[0] is picks                # a full layer hands its picks on
        again = tm._dsa_select(tw, torch.from_numpy(x), torch.from_numpy(qr), tcos[pos_q],
                               tsin[pos_q], torch.from_numpy(hist_k) * 0,
                               torch.from_numpy(pos_q).long(), 1, carry)
        assert again[0] is picks                # a shared one reuses them


def _relabelled(path, root, arch, **over):
    out = os.path.join(root, os.path.basename(path) + '_' + arch)
    shutil.copytree(path, out)
    with open(os.path.join(out, 'config.json')) as f:
        cfg = json.load(f)
    cfg.update(architectures=[arch], **over)
    with open(os.path.join(out, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    return out


@pytest.mark.parametrize('name', ['v32', 'glm_dsa'])
def test_full_topk_equals_dense_mla(ckpt, tmp_path, name):
    """index_topk past the context picks every token: the logits of the same weights
    as DeepseekV2ForCausalLM, shared layers included."""
    full = _relabelled(ckpt[name], str(tmp_path), mc.CFGS[name]['architectures'][0],
                       index_topk=256)
    dense = _relabelled(ckpt[name], str(tmp_path), 'DeepseekV2ForCausalLM')
    rng = np.random.RandomState(6)
    ids = rng.randint(3, 120, size=(2, 17)).astype(np.int32)
    outs = []
    for path in (full, dense):
        tm, tp = mc.torch_model(path)
        from lmdeploy_tpu_torch.models.llama import AttnMeta
        from lmdeploy_tpu_torch.nn.layers import make_rope_table
        cfg = tm.config
        cos, sin = make_rope_table(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
        cache = torch.zeros((cfg.num_layers, NB, 2, BS, cfg.cache_head_dim))
        meta = AttnMeta(torch.from_numpy(_tables(2, 2)), torch.zeros(2, dtype=torch.int32),
                        torch.tensor([17, 12], dtype=torch.int32))
        outs.append(tm.forward(tp, torch.from_numpy(ids),
                               torch.arange(17, dtype=torch.int32)[None].expand(2, 17),
                               cache, meta, cos, sin, return_all_logits=True))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0, atol=1e-5)


def test_chunked_prefill_and_query_blocks(models, monkeypatch):
    """GLM-MoE-DSA at top-4: a 40-token prompt in four chunks of 10 gives the one-shot
    prefill's logits and cache (the shared layers' carry starts afresh at each chunk),
    and blocks of 7 queries give the one-block forward's logits."""
    from lmdeploy_tpu_torch.models import deepseek_v32
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    _, _, tm, tp = models['glm_dsa']
    cfg = tm.config
    cos, sin = make_rope_table(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    ids = torch.from_numpy(np.random.RandomState(9).randint(3, 120, size=(1, 40))).int()
    tables = torch.from_numpy(_tables(1, 3))

    def run(chunk):
        cache = torch.zeros((cfg.num_layers, NB, 2, BS, cfg.cache_head_dim))
        outs = []
        for s in range(0, 40, chunk):
            meta = AttnMeta(tables, torch.tensor([s], dtype=torch.int32),
                            torch.tensor([chunk], dtype=torch.int32))
            pos = torch.arange(s, s + chunk, dtype=torch.int32)[None]
            outs.append(tm.forward(tp, ids[:, s:s + chunk], pos, cache, meta, cos, sin,
                                   return_all_logits=True))
        return torch.cat(outs, 1), cache
    one, c1 = run(40)
    chunked, c4 = run(10)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c4.numpy(), c1.numpy(), rtol=0, atol=1e-5)
    shape = (1, 3 * BS, TOPK, tm.idx_heads, tm.nh, 32)
    monkeypatch.setattr(deepseek_v32, 'DSA_TILE_BYTES',
                        7 * deepseek_v32.dsa_query_bytes(*shape))
    assert deepseek_v32.dsa_query_block(*shape) == 7
    blocked, _ = run(40)
    np.testing.assert_allclose(blocked.numpy(), one.numpy(), rtol=0, atol=1e-6)
