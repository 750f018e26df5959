"""Context-parallel decode (KV pages striped over 'cp') in the port against the JAX
package (CPU, f32).

The JAX side runs as its own tests run it: on the 8-device virtual CPU mesh
(``tests/conftest.py``), with the Pallas partial kernel in TPU interpret mode.  The
port's ranks sit on the CPU (``build_mesh(cp=n, devices=['cpu'] * n)``), each running
the kernel's plain version.  Checked:
  * one rank's partials (``paged_decode_cp_partial_plain``) joined by ``cp_combine``
    against JAX's ``paged_decode_attention_cp`` at 2e-5 (the same products summed in
    another order, the kernel's online softmax against a one-pass one): cp 2 and 4,
    one-token and ragged rows, a window, sinks, rows that leave a rank no local token;
  * the stripes and the unsharded layout both ways bit for bit; the port's fill into
    the stripes against the JAX fill of the unsharded cache, then striped; the gather
    over the stripes;
  * ``Engine`` / ``pipeline()`` with ``cp=2``: greedy tokens equal to the JAX engine's
    with ``cp=2`` and to the port's with ``cp=1``;
  * what stays refused: tp / dp / ep, cp with a quantized cache or an MLA model, a
    block size the ranks do not divide.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops import attention as ja
from lmdeploy_tpu.ops.attention import kv_row_width, plane_rows
from lmdeploy_tpu_torch.ops import attention as ta
from lmdeploy_tpu_torch.ops.paged_decode import (MASK_VALUE, cp_combine, cp_local_slots,
                                                 cp_splits, paged_decode_attention_cp,
                                                 paged_decode_cp_partial,
                                                 paged_decode_cp_partial_plain,
                                                 paged_decode_cp_partial_split_plain,
                                                 plain_decode_terms, split_partials_plain,
                                                 split_rows_plain)
from lmdeploy_tpu_torch.parallel.mesh import (StripedKV, build_mesh, cache_sharding)
from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference

from test_torch_engine import ENGINE_KW, generate, make_prompts

TOL = dict(rtol=2e-5, atol=2e-5)
LAYER = 1


def t(a):
    return torch.from_numpy(np.array(a))


def _dense_cache(rng, L, Hkv, NB, BS, D):
    """Reference pages [L, NB, 2, BS, HDp] from random dense K/V (as
    tests/test_pallas_paged_decode.py builds them)."""
    _, hdp = kv_row_width(Hkv, D)
    k = rng.randn(L, NB, BS, Hkv, D).astype(np.float32)
    v = rng.randn(L, NB, BS, Hkv, D).astype(np.float32)
    kr = plane_rows(jnp.asarray(k.reshape(-1, Hkv, D)), hdp)
    vr = plane_rows(jnp.asarray(v.reshape(-1, Hkv, D)), hdp)
    return jnp.stack([kr.reshape(L, NB, BS, hdp), vr.reshape(L, NB, BS, hdp)], axis=2)


def _jax_cp(q, ref, tables, kv_lens, scale, Hkv, cp, window=None, sinks=None):
    """JAX's paged_decode_attention_cp over the cache striped on the virtual mesh."""
    from jax.sharding import NamedSharding

    from lmdeploy_tpu.ops.pallas import paged_decode
    from lmdeploy_tpu.parallel.mesh import build_mesh as jmesh
    from lmdeploy_tpu.parallel.mesh import cache_sharding as jsharding
    mesh = jmesh(cp=cp, devices=jax.devices()[:cp])
    kc = jax.device_put(ref, NamedSharding(mesh, jsharding(Hkv, cp=cp)))
    return np.asarray(paged_decode.paged_decode_attention_cp(
        jnp.asarray(q), kc, jnp.asarray(tables), jnp.asarray(kv_lens), jnp.int32(LAYER),
        scale, Hkv, mesh, window=None if window is None else jnp.int32(window),
        sinks=None if sinks is None else jnp.asarray(sinks), interpret=True))


def _port_cp(q, ref, tables, kv_lens, scale, Hkv, D, cp, window=None, sinks=None):
    """The port's ranks on the CPU: each rank's plain partials, then the combine."""
    stripes = StripedKV.from_reference_layout(cache_from_reference(ref, Hkv, D),
                                              ['cpu'] * cp)
    BS = stripes.shape[3]
    parts = [paged_decode_cp_partial_plain(t(q), s, t(tables), t(kv_lens), LAYER, scale,
                                           Hkv, r * (BS // cp), BS, window=window)
             for r, s in enumerate(stripes.stripes)]
    return parts, cp_combine(parts, None if sinks is None else t(sinks),
                             torch.float32).numpy()


@pytest.mark.parametrize('cp', [2, 4])
@pytest.mark.parametrize('lens', [[1], [37, 128, 1, 200]])
def test_cp_partials_and_combine_match_pallas(lens, cp):
    """As the reference's test_cp_decode_matches_unsharded: Hkv 2, G 4, D 64, BS 16.
    A one-token row leaves every rank but the first with no local token: its
    partials are m = MASK_VALUE, l = 0, acc = 0, and the combine gives no NaN."""
    rng = np.random.RandomState(10)
    B = len(lens)
    Hkv, G, D, BS, NB, W = 2, 4, 64, 16, 128, 16
    ref = _dense_cache(rng, 2, Hkv, NB, BS, D)
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    kv_lens = np.asarray(lens, np.int32)
    want = _jax_cp(q, ref, tables, kv_lens, D ** -0.5, Hkv, cp)
    parts, got = _port_cp(q, ref, tables, kv_lens, D ** -0.5, Hkv, D, cp)
    np.testing.assert_allclose(got, want, **TOL)
    for r, (acc, m, lsum) in enumerate(parts):
        empty = torch.from_numpy(kv_lens <= r * (BS // cp))
        assert bool((m[empty] == MASK_VALUE).all()) and bool((lsum[empty] == 0).all())
        assert bool((acc[empty] == 0).all())


@pytest.mark.parametrize('cp', [2, 4])
@pytest.mark.parametrize('window', [12, 4, None])
def test_cp_window_and_sinks_match_pallas(cp, window):
    """As the reference's test_cp_decode_window_and_sinks, with a third row of 5
    tokens: window 4 leaves the 30- and 50-token rows' in-window tokens on one rank,
    so the other ranks have none, and the sinks join the denominator once, after the
    combine."""
    rng = np.random.RandomState(11)
    B, Hkv, G, D, BS, NB, W = 3, 2, 2, 32, 16, 32, 4
    ref = _dense_cache(rng, 2, Hkv, NB, BS, D)
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    kv_lens = np.asarray([30, 50, 5], np.int32)
    sinks = rng.randn(Hkv * G).astype(np.float32)
    want = _jax_cp(q, ref, tables, kv_lens, D ** -0.5, Hkv, cp, window, sinks)
    parts, got = _port_cp(q, ref, tables, kv_lens, D ** -0.5, Hkv, D, cp, window, sinks)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()
    if window == 4:
        assert any(bool((m == MASK_VALUE).any()) for _, m, _ in parts)


@pytest.mark.parametrize('cp', [2, 4])
def test_cp_local_slots_match_a_count(cp):
    """n(x), the rank's local slots below position x, against a count of its slots
    (local slot j of page p at p * BS + r * BS / cp + j), for every x up to a 5-page
    table's end."""
    for BS in (16, 128, 12):
        bsl, W = BS // cp, 5
        for r in range(cp):
            pos = np.array([p * BS + r * bsl + j for p in range(W) for j in range(bsl)])
            xs = np.arange(W * BS + 1)
            want = [(pos < x).sum() for x in xs]
            np.testing.assert_array_equal(cp_local_slots(t(xs), r * bsl, BS, bsl).numpy(),
                                          want)


@pytest.mark.parametrize('cp', [2, 4])
@pytest.mark.parametrize('window', [None, 20, 4])
def test_cp_split_partials_match_pallas(cp, window):
    """The kernel's split form in plain PyTorch (each split's partials over the rank's
    local slots [n(ws), n(len)), then each row's non-empty splits joined in order) at
    1, 2 and W splits and the wrapper's own, the ranks joined by ``cp_combine``, against
    JAX's cp decode (Pallas, interpret mode) at 2e-5.  Rows of 1 token (ranks past the
    first hold none), 37 and 96 tokens, 30 tokens (window 4 leaves their positions on
    one rank, the others none in the window), 0 tokens (inactive: output 0); window 20
    starts mid-stripe.  A rank with no counted slot gives (0, MASK_VALUE, 0) exactly,
    and the splits a row's combine reads are exactly its non-empty ones."""
    rng = np.random.RandomState(13)
    B, Hkv, G, D, BS, NB, W = 5, 2, 4, 32, 16, 48, 6
    bsl = BS // cp
    ref = _dense_cache(rng, 2, Hkv, NB, BS, D)
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    kv_lens = np.asarray([1, 37, 96, 30, 0], np.int32)
    active = kv_lens > 0
    scale = D ** -0.5
    want = _jax_cp(q[active], ref, tables[active], kv_lens[active], scale, Hkv, cp, window)
    stripes = StripedKV.from_reference_layout(cache_from_reference(ref, Hkv, D), ['cpu'] * cp)
    lens = t(kv_lens).long()
    ws = (lens - window).clamp(min=0) if window else torch.zeros_like(lens)
    assert cp_splits(W, bsl, D, torch.float32) == 1
    for splits in (1, 2, W, None):
        parts = []
        for r, stripe in enumerate(stripes.stripes):
            acc, m, lsum = paged_decode_cp_partial_split_plain(
                t(q), stripe, t(tables), t(kv_lens), LAYER, scale, Hkv, r * bsl, BS,
                window=window, splits=splits)
            # a rank with no slot in [ws, len): exactly (0, MASK_VALUE, 0)
            n_len = cp_local_slots(lens, r * bsl, BS, bsl)
            n_ws = cp_local_slots(ws, r * bsl, BS, bsl)
            empty = n_len <= n_ws
            assert bool((m[empty] == MASK_VALUE).all()) and bool((lsum[empty] == 0).all())
            assert bool((acc[empty] == 0).all())
            assert bool((m[~empty] > 0.5 * MASK_VALUE).all())
            # the combine reads a row's splits [s_lo, s_hi): exactly those with a slot
            n = splits or cp_splits(W, bsl, D, torch.float32)
            s, pv = plain_decode_terms(t(q), stripe, t(tables), LAYER, scale, Hkv, None)
            each = split_partials_plain(s, n_len, pv, bsl, n, start=n_ws)
            s_lo, s_hi = split_rows_plain(n_len, n_ws, bsl, W, n)
            for sp, (_, m_s, _) in enumerate(each):
                reads = (s_lo <= sp) & (sp < s_hi)
                assert torch.equal(reads, (m_s > 0.5 * MASK_VALUE).all(-1)), (r, sp)
            parts.append((acc, m, lsum))
        got = cp_combine(parts, None, torch.float32).numpy()
        np.testing.assert_allclose(got[active], want, **TOL)
        assert np.all(got[~active] == 0)
        ones = [paged_decode_cp_partial_plain(t(q), st, t(tables), t(kv_lens), LAYER,
                                              scale, Hkv, r * bsl, BS, window=window)
                for r, st in enumerate(stripes.stripes)]
        for (_, m1, _), (_, m2, _) in zip(parts, ones):
            np.testing.assert_array_equal(m1.numpy(), m2.numpy())


def test_cp_wrapper_on_cpu_and_inactive_rows():
    """``paged_decode_attention_cp`` over a striped cache takes the plain partials on
    CPU tensors (no launch counted) and matches the unsharded plain decode; an
    inactive row (kv_len 0) is 0, as the unsharded decode gives it."""
    from lmdeploy_tpu_torch.ops.paged_decode import paged_decode_attention_plain
    rng = np.random.RandomState(12)
    B, Hkv, G, D, BS, NB, W = 4, 2, 3, 16, 16, 20, 4
    cache = torch.from_numpy(rng.randn(2, NB, 2, BS, Hkv * D).astype(np.float32))
    tables = t(rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32))
    kv_lens = t(np.asarray([9, 0, 64, 17], np.int32))
    q = t(rng.randn(B, Hkv * G, D).astype(np.float32))
    sinks = t(rng.randn(Hkv * G).astype(np.float32))
    mesh = build_mesh(cp=2, devices=['cpu', 'cpu'])
    kv = StripedKV.from_reference_layout(cache, mesh.cp_devices)
    before = paged_decode_cp_partial.launches
    got = paged_decode_attention_cp(q, kv, tables, kv_lens, LAYER, 0.25, Hkv, mesh,
                                    window=20, sinks=sinks)
    want = paged_decode_attention_plain(q, cache, tables, kv_lens, LAYER, 0.25, Hkv,
                                        window=20, sinks=sinks)
    assert paged_decode_cp_partial.launches == before
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert bool((got[1] == 0).all())
    with pytest.raises(ValueError):            # the cache's stripes are not the mesh's ranks
        paged_decode_attention_cp(q, kv, tables, kv_lens, LAYER, 0.25, Hkv,
                                  build_mesh(cp=4, devices=['cpu'] * 4))


# -- layout, fill, gather ------------------------------------------------------------
@pytest.mark.parametrize('cp', [2, 4])
def test_stripes_and_reference_layout_round_trip(cp):
    """Stripes <-> the unsharded cache, bit for bit both ways, also through the
    CacheEngine's to_reference_layout / from_reference_layout; rank r holds the slots
    [r*BS/cp, (r+1)*BS/cp) of every page."""
    from lmdeploy_tpu_torch.config import CacheConfig, ModelConfig
    from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
    rng = np.random.RandomState(2)
    Hkv, D, BS = 2, 16, 16
    _, hdp = kv_row_width(Hkv, D)
    ref = rng.randn(2, 6, 2, BS, hdp).astype(np.float32)
    ref[..., Hkv * D:] = 0
    port = cache_from_reference(ref, Hkv, D)
    kv = StripedKV.from_reference_layout(port, ['cpu'] * cp)
    assert kv.shape == port.shape and kv.cp == cp
    spec = cache_sharding(Hkv, cp)
    for r, stripe in enumerate(kv.stripes):
        assert tuple(stripe.shape) == (2, 6, 2, BS // cp, Hkv * D)
        assert torch.equal(stripe, port[:, :, :, spec.stripe(r, BS)])
    np.testing.assert_array_equal(cache_to_reference(kv.to_reference_layout()), ref)
    cfg = ModelConfig(num_layers=2, num_attention_heads=4, num_key_value_heads=Hkv,
                      hidden_size=64, intermediate_size=128, vocab_size=256, head_dim=D,
                      dtype='float32')
    ce = CacheEngine(cfg, CacheConfig(block_size=BS, num_gpu_blocks=6), torch.device('cpu'),
                     mesh=build_mesh(cp=cp, devices=['cpu'] * cp))
    assert isinstance(ce.kv_cache, StripedKV) and ce.kv_cache.cp == cp
    ce.from_reference_layout(port)
    assert torch.equal(ce.to_reference_layout(), port)
    assert ce.kv_cache.nbytes == port.numel() * 4


def test_cache_engine_block_budget_counts_stripes():
    """A device holding k ranks holds k stripes: cp ranks on one device take the
    unsharded cache's block count."""
    from lmdeploy_tpu_torch.config import CacheConfig, ModelConfig
    from lmdeploy_tpu_torch.engine.cache_engine import CacheEngine
    cfg = ModelConfig(num_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      hidden_size=64, intermediate_size=128, vocab_size=256, head_dim=16,
                      dtype='float32')
    plain = CacheEngine(cfg, CacheConfig(block_size=16, cache_max_entry_count=0.01),
                        torch.device('cpu'))
    striped = CacheEngine(cfg, CacheConfig(block_size=16, cache_max_entry_count=0.01),
                          torch.device('cpu'), mesh=build_mesh(cp=2, devices=['cpu'] * 2))
    assert striped.num_blocks == plain.num_blocks > 16


@pytest.mark.parametrize('cp', [2, 4])
@pytest.mark.parametrize('fresh', [False, True])
def test_striped_fill_and_gather_match_jax(fresh, cp):
    """The port's fill into the stripes equals the JAX fill of the unsharded cache,
    then striped (block 0, the padding block, is don't-care); the gather over the
    stripes gives the unsharded gather's K/V."""
    rng = np.random.RandomState(3)
    L, NB, BS, Hkv, D = 2, 10, 16, 2, 16
    B, T = 2, 32
    _, hdp = kv_row_width(Hkv, D)
    ref = rng.randn(L, NB, 2, BS, hdp).astype(np.float32)
    ref[..., Hkv * D:] = 0
    kv = StripedKV.from_reference_layout(cache_from_reference(ref, Hkv, D), ['cpu'] * cp)
    tables = np.array([[3, 7, 0], [5, 2, 9]], np.int32)
    hist = np.array([0, 0], np.int32) if fresh else np.array([5, 17], np.int32)
    qlen = np.array([32, 20], np.int32)
    k = rng.randn(B * T, Hkv, D).astype(np.float32)
    v = rng.randn(B * T, Hkv, D).astype(np.float32)
    js = ja.compute_slot_mapping(jnp.asarray(tables), jnp.asarray(hist), jnp.asarray(qlen),
                                 T, BS)
    ts = ta.compute_slot_mapping(t(tables), t(hist), t(qlen), T, BS)
    jout = np.asarray(ja.fill_kv_cache(jnp.asarray(ref), jnp.asarray(k), jnp.asarray(v), js,
                                       jnp.int32(LAYER),
                                       jnp.asarray(tables) if fresh else None))
    ta.fill_kv_cache(kv, t(k), t(v), ts, LAYER, t(tables) if fresh else None)
    want = StripedKV.from_reference_layout(cache_from_reference(jout, Hkv, D), ['cpu'] * cp)
    for got_s, want_s in zip(kv.stripes, want.stripes):
        np.testing.assert_array_equal(got_s[:, 1:].numpy(), want_s[:, 1:].numpy())
    gk, gv = ta.gather_layer_kv(kv, LAYER, t(tables), Hkv, D)
    jk, jv = ja.gather_layer_kv(jnp.asarray(jout), jnp.int32(LAYER), jnp.asarray(tables),
                                Hkv, D)
    for got, ref_ in ((gk, jk), (gv, jv)):
        ref_ = np.asarray(ref_)
        # rows whose table entry is block 0 read the padding block: don't-care
        real = np.repeat(tables != 0, BS, axis=1)
        np.testing.assert_array_equal(got.numpy()[:, real], ref_[:, real])


# -- mesh and config -----------------------------------------------------------------
def test_build_mesh():
    mesh = build_mesh(cp=2, devices=['cpu', 'cpu', 'cpu'])
    assert mesh.shape == {'dp': 1, 'ep': 1, 'cp': 2, 'tp': 1}
    assert mesh.cp_devices == (torch.device('cpu'),) * 2
    mesh = build_mesh(dp=2, cp=2, tp=2, devices=[f'cpu:{i}' for i in range(8)])
    assert [str(d) for d in mesh.axis_devices('cp')] == ['cpu:0', 'cpu:2']
    assert [str(d) for d in mesh.axis_devices('dp')] == ['cpu:0', 'cpu:4']
    assert cache_sharding(8, 1).stripe(0, 128) == slice(0, 128)
    assert cache_sharding(8, 4).stripe(3, 128) == slice(96, 128)
    assert cache_sharding(1, 2) == ('cp', None, 2)      # one kv head: no 'tp' split
    with pytest.raises(ValueError):
        build_mesh(cp=4, devices=['cpu', 'cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):               # never falls back to the CPU
            build_mesh(cp=2)


@pytest.mark.parametrize('field', [
    dict(tp=2), dict(dp=2), dict(ep=2), dict(cp=2, quant_policy=4),
    dict(cp=2, quant_policy=8), dict(cp=2, quant_policy=16), dict(cp=2, quant_policy=42),
    dict(cp=3), dict(cp=2, mla=True)])
def test_check_ported_refuses_what_cp_does_not_serve(tiny_model_dir, field):
    from lmdeploy_tpu_torch.config import ModelConfig, check_ported
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    from test_deepseek import DS_CFG
    field = dict(field)
    model = ModelConfig.from_hf_config(DS_CFG) if field.pop('mla', False) else None
    cfg = TpuEngineConfig(**dict(ENGINE_KW, **field))
    with pytest.raises(NotImplementedError):
        check_ported(cfg, model)
    if model is None:
        with pytest.raises(NotImplementedError):
            Engine.from_pretrained(tiny_model_dir, cfg, device='cpu')


# -- engine --------------------------------------------------------------------------
def _jax_cp_tokens(path, prompts, cp, new_tokens):
    """The JAX engine's greedy tokens with ``cp``: its decode through the Pallas
    partial kernel in interpret mode (tests/test_multichip_dryrun.py's
    test_engine_cp2_end_to_end)."""
    os.environ['LMDEPLOY_TPU_INTERPRET_PALLAS'] = '1'
    try:
        tokens, engine = generate('jax', path, prompts, new_tokens=new_tokens, cp=cp)
    finally:
        os.environ.pop('LMDEPLOY_TPU_INTERPRET_PALLAS', None)
    assert engine.mesh is not None and engine.mesh.shape['cp'] == cp
    return tokens


def test_engine_cp2_matches_jax_cp2_and_cp1(tiny_model_dir):
    """Three concurrent prompts (the 70-token one in two prefill chunks of 64 and
    across five 16-token pages), 12 greedy tokens each, f32: the port's Engine with
    cp=2 on two CPU ranks gives the JAX engine's cp=2 tokens and its own cp=1 tokens.
    The mesh reaches the model, the cache is striped and the weights stay unfused (as
    the reference keeps them on a mesh)."""
    prompts = make_prompts(4, (5, 37, 70))
    ref = _jax_cp_tokens(tiny_model_dir, prompts, 2, 12)
    out, engine = generate('torch', tiny_model_dir, prompts, cp=2)
    base, _ = generate('torch', tiny_model_dir, prompts)
    assert out == ref == base
    agent = engine.model_agent
    assert engine.mesh.shape['cp'] == 2 and agent.model.cp_mesh is engine.mesh
    assert isinstance(agent.kv_cache, StripedKV) and agent.kv_cache.cp == 2
    assert 'wqkv' not in agent.params['layers'] and 'wq' in agent.params['layers']
    assert paged_decode_cp_partial.launches == 0        # CPU tensors: the plain version


def test_pipeline_cp2_matches_jax(tiny_model_dir):
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu.messages import GenerationConfig as JGen
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch import pipeline as tpipeline
    from lmdeploy_tpu_torch.messages import GenerationConfig as TGen
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    prompts = ['hello world this is a tiny test corpus ' * 3, 'hi']
    runs = []
    os.environ['LMDEPLOY_TPU_INTERPRET_PALLAS'] = '1'
    try:
        for make, cfg, gen, extra in ((jpipeline, JCfg, JGen, {}),
                                      (tpipeline, TCfg, TGen, {'device': 'cpu'})):
            pipe = make(tiny_model_dir, backend_config=cfg(**ENGINE_KW, cp=2), **extra)
            try:
                runs.append(pipe(prompts, gen_config=gen(max_new_tokens=8,
                                                         ignore_eos=True)))
            finally:
                pipe.close()
    finally:
        os.environ.pop('LMDEPLOY_TPU_INTERPRET_PALLAS', None)
    ref, out = runs
    assert [o.token_ids for o in out] == [r.token_ids for r in ref]
    assert [o.text for o in out] == [r.text for r in ref]
