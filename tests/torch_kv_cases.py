"""Checks shared by the port's KV-cache policy tests (test_torch_kv_int4.py,
test_torch_kv_fp8.py, test_torch_kv_turbo.py): each runs the same inputs, made by
numpy from a seed, through the JAX package and the port on the CPU in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lmdeploy_tpu.ops import attention as ja
from lmdeploy_tpu_torch.ops import attention as ta
from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference

from test_torch_engine import ENGINE_KW, generate, make_prompts

TOL = dict(rtol=2e-5, atol=2e-5)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def leaves(ref):
    """A reference cache's leaves as numpy (its e4m3 bytes for an fp8 array)."""
    parts = ref.tree_flatten()[0] if hasattr(ref, 'tree_flatten') else (ref,)
    out = []
    for x in parts:
        a = np.asarray(x)
        out.append(a.view(np.uint8) if a.dtype.name == 'float8_e4m3fn' else a)
    return out


def assert_cache_equal(port, ref, skip_block0=False, float_rtol=0.0):
    """The port cache, converted to the reference's layout, equals ``ref`` bit for bit
    (block 0, the padding block, is don't-care after a fill); with ``float_rtol``, its
    f32 leaves within that relative tolerance."""
    got = cache_to_reference(port)
    got = got if isinstance(got, tuple) else (got,)
    want = leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if skip_block0:
            g, w = g[:, 1:], w[:, 1:]
        if float_rtol and g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=float_rtol, atol=0)
            continue
        np.testing.assert_array_equal(np.ascontiguousarray(g).view(np.uint8),
                                      np.ascontiguousarray(w).view(np.uint8))


def fill_random(ref, rng, L, NB, BS, Hkv, D, scale=1.0):
    """Every slot of every layer of a reference cache filled through the JAX fill
    from random K/V; returns the filled reference cache."""
    slots = jnp.arange(NB * BS, dtype=jnp.int32)
    for layer in range(L):
        k = (rng.randn(NB * BS, Hkv, D) * scale).astype(np.float32)
        v = (rng.randn(NB * BS, Hkv, D) * scale * 0.5).astype(np.float32)
        ref = ja.fill_kv_cache(ref, jnp.asarray(k), jnp.asarray(v), slots, jnp.int32(layer))
    return ref


def check_fill(ref, Hkv, D, fresh, rng, layer=1, scale=1.0, float_rtol=0.0):
    """The jitted JAX fill and the port's on the same rows, fresh (page tables given)
    and by rows after history: the caches agree bit for bit through the converters (f32
    leaves within ``float_rtol``)."""
    port = cache_from_reference(ref, Hkv, D)
    assert_cache_equal(port, ref)                       # the converters round-trip
    BS = port.shape[3]
    B, T = 2, 2 * BS
    tables = np.array([[3, 7, 0], [5, 2, 9]], np.int32)
    hist = np.array([0, 0], np.int32) if fresh else np.array([5, BS + 1], np.int32)
    qlen = np.array([T, T - 12], np.int32)
    k = (rng.randn(B * T, Hkv, D) * scale).astype(np.float32)
    v = (rng.randn(B * T, Hkv, D) * scale).astype(np.float32)
    slots = ja.compute_slot_mapping(jnp.asarray(tables), jnp.asarray(hist),
                                    jnp.asarray(qlen), T, BS)
    ts = ta.compute_slot_mapping(t(tables), t(hist), t(qlen), T, BS)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(slots))
    # jitted, as the reference engine runs its fill (XLA's reciprocal products)
    jout = jax.jit(ja.fill_kv_cache)(ref, jnp.asarray(k), jnp.asarray(v), slots,
                                     jnp.int32(layer), jnp.asarray(tables) if fresh else None)
    ta.fill_kv_cache(port, t(k), t(v), ts, layer, t(tables) if fresh else None)
    assert_cache_equal(port, jout, skip_block0=True, float_rtol=float_rtol)
    return port, jout


def check_gather_and_attention(ref, Hkv, G, D, opts, rng, layer=1):
    """gather_layer_kv equal to the reference's, then paged_attention (a 5-token chunk
    and a decode step) within 2e-5 on the gather + dense path."""
    port = cache_from_reference(ref, Hkv, D)
    NB = port.shape[1]
    B = 3
    tables = rng.permutation(np.arange(1, NB))[:B * 3].reshape(B, 3).astype(np.int32)
    hist = np.array([0, 7, 14], np.int32)
    jk, jv = ja.gather_layer_kv(ref, jnp.int32(layer), jnp.asarray(tables), Hkv, D)
    tk, tv = ta.gather_layer_kv(port, layer, t(tables), Hkv, D)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
    opts = dict(opts)
    if opts.get('sinks'):
        opts['sinks'] = rng.randn(Hkv * G).astype(np.float32)
    jopts = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in opts.items()}
    topts = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in opts.items()}
    for T_ in (5, 1):                   # a chunk, then a decode step
        q = rng.randn(B, T_, Hkv * G, D).astype(np.float32)
        qlen = np.full(B, T_, np.int32)
        jo = ja.paged_attention(jnp.asarray(q), ref, jnp.asarray(tables), jnp.asarray(hist),
                                jnp.asarray(qlen), D ** -0.5, jnp.int32(layer), Hkv, **jopts)
        to = ta.paged_attention(t(q), port, t(tables), t(hist), t(qlen), D ** -0.5,
                                layer, Hkv, **topts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def check_decode_vs_pallas(ref, Hkv, G, D, softcap, plain, wrapper, rng, q_rotate=None,
                           layer=1, W=6, pallas_cache=None):
    """The plain decode against the reference's Pallas kernel in TPU interpret mode
    (active rows, 2e-5) on ``pallas_cache`` (default ``ref``); the dispatching wrapper
    takes the plain version on the CPU and counts no launch.  Returns (port cache, q,
    tables, kv_lens, the Pallas output) for further checks."""
    from jax.experimental.pallas import tpu as pltpu

    from lmdeploy_tpu.ops.pallas.paged_decode import paged_decode_attention as jdecode
    from lmdeploy_tpu_torch.ops.paged_decode import paged_decode_attention
    port = cache_from_reference(ref, Hkv, D)
    NB, BS = port.shape[1], port.shape[3]
    B = 5
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    kv_lens = np.array([1, 37, 0, W * BS, 2 * BS], np.int32)    # row 2 is inactive
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    if q_rotate is not None:
        q = q_rotate(q)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out_ref = np.asarray(jdecode(jnp.asarray(q), ref if pallas_cache is None
                                     else pallas_cache, jnp.asarray(tables),
                                     jnp.asarray(kv_lens), jnp.int32(layer), scale, Hkv,
                                     logit_softcap=softcap))
    out = plain(t(q), port, t(tables), t(kv_lens), layer, scale, Hkv,
                logit_softcap=softcap).numpy()
    active = kv_lens > 0
    np.testing.assert_allclose(out[active], out_ref[active], **TOL)
    assert np.all(out[~active] == 0)
    before = wrapper.launches
    out2 = paged_decode_attention(t(q), port, t(tables), t(kv_lens), layer, scale, Hkv,
                                  logit_softcap=softcap)
    np.testing.assert_array_equal(out2.numpy(), out)
    assert wrapper.launches == before
    return port, q, tables, kv_lens, out_ref


def check_engine_tokens(tiny_model_dir, policy, case, cache_type):
    """The Engine with ``quant_policy`` gives the JAX engine's greedy tokens."""
    prompts = make_prompts(0, (5, 37, 70, 12, 23))
    kw = dict(quant_policy=policy)
    if case == 'preempt':
        kw.update(num_gpu_blocks=15, new_tokens=40)
    ref, _ = generate('jax', tiny_model_dir, prompts, **kw)
    out, engine = generate('torch', tiny_model_dir, prompts, **kw)
    assert isinstance(engine.model_agent.kv_cache, cache_type)
    if case == 'preempt':
        assert engine.scheduler.num_preemptions > 0
    return out, ref


def pipeline_tokens(tiny_model_dir, policy):
    """(port, JAX) greedy tokens of ``pipeline()`` with ``quant_policy``."""
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu.messages import GenerationConfig as JGen
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch import pipeline as tpipeline
    from lmdeploy_tpu_torch.messages import GenerationConfig as TGen
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    kw = dict(ENGINE_KW, quant_policy=policy)
    prompts = ['hello world', 'this is a tiny test of a quantized cache', 'hi']
    outs = []
    for fn, cfg, gen, extra in ((tpipeline, TCfg, TGen, {'device': 'cpu'}),
                                (jpipeline, JCfg, JGen, {})):
        pipe = fn(tiny_model_dir, backend_config=cfg(**kw), **extra)
        try:
            outs.append([r.token_ids for r in pipe(prompts, gen_config=gen(
                max_new_tokens=12, ignore_eos=True))])
        finally:
            pipe.close()
    return outs
