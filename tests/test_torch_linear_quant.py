"""The llama family's 8-bit linear leaves: the port against the JAX package (CPU).

Leaves (``nn/linear.py``): SmoothQuant W8A8 ``{'w8' int8, 'scale'}``, fp8 weight-only
``{'w8' e4m3, 'scale'}`` and blocked fp8 ``{'w8' e4m3, 'bscale'}``, each held against the
JAX package's ``linear`` for f32 and bf16 x (a ragged block tail included).  Checkpoints:
W8A8 from the reference's own ``lite/smooth_quant.py`` on the ``tiny_model_dir``
fixture; fp8 with per-channel (``fbgemm_fp8``) and per-tensor (``fp8``) scales and
blocked fp8 (32 x 32 blocks) written here from the fixture's weights.  Each checkpoint's
loaded tree equals the JAX loader's, f32 logits of prefill and decode steps agree, and
``Engine`` gives the JAX engine's greedy tokens exactly.

Tolerances: W8A8 products are equal (the same int8 codes, exact int32 sums, the same f32
scale order); fp8 and blocked fp8 at atol = rtol = 1e-5 in f32, and within one bf16 ulp
for bf16 x (f32 sums in another order may round the other way); model logits at 1e-4
absolute (they reach ~0.1; an activation on a W8A8 rounding boundary may take the next
code after f32 sums in another order).
"""
import asyncio
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
FORMATS = ('w8a8', 'fp8_channel', 'fp8_tensor', 'fp8_blocked')
LOGIT_ATOL = 1e-4
HF_LINEARS = ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj', 'self_attn.o_proj',
              'mlp.gate_proj', 'mlp.up_proj', 'mlp.down_proj')


def _quantize_fp8(w, per_tensor=False):
    """HF [N, K] f32 -> (e4m3 [N, K], scale [N, 1] or [1])."""
    amax = np.abs(w).max() if per_tensor else np.abs(w).max(axis=1, keepdims=True)
    sc = (amax / 448.0 + 1e-8).astype(np.float32)
    return (w / sc).astype(ml_dtypes.float8_e4m3fn), (sc.reshape(1) if per_tensor else sc)


def _quantize_blocked(w, b):
    """HF [N, K] f32 -> (e4m3 [N, K], scale_inv [ceil(N/b), ceil(K/b)])."""
    N, K = w.shape
    s = np.zeros((-(-N // b), -(-K // b)), np.float32)
    q = np.zeros_like(w)
    for i in range(s.shape[0]):
        for j in range(s.shape[1]):
            blk = w[i * b:(i + 1) * b, j * b:(j + 1) * b]
            s[i, j] = np.abs(blk).max() / 448.0 + 1e-8
            q[i * b:(i + 1) * b, j * b:(j + 1) * b] = blk / s[i, j]
    return q.astype(ml_dtypes.float8_e4m3fn), s


def _write_fp8(src, dst, fmt):
    """The tiny fixture's seven linears of every layer quantized to ``fmt``."""
    from safetensors.numpy import load_file, save_file
    for name in os.listdir(src):
        if not name.endswith('.safetensors'):
            shutil.copy(os.path.join(src, name), dst)
    t = load_file(glob.glob(os.path.join(src, '*.safetensors'))[0])
    out = {}
    for name, v in t.items():
        v = np.asarray(v, np.float32)
        if not any(f'.{hf}.weight' in name for hf in HF_LINEARS):
            out[name] = v
        elif fmt == 'fp8_blocked':
            out[name], out[name + '_scale_inv'] = _quantize_blocked(v, 32)
        else:
            out[name], out[name + '_scale'] = _quantize_fp8(v, fmt == 'fp8_tensor')
    save_file({k: np.ascontiguousarray(v) for k, v in out.items()},
              os.path.join(dst, 'model.safetensors'))
    cfg = json.load(open(os.path.join(src, 'config.json')))
    cfg['quantization_config'] = {
        'fp8_channel': {'quant_method': 'fbgemm_fp8'},
        'fp8_tensor': {'quant_method': 'fp8', 'activation_scheme': 'dynamic'},
        'fp8_blocked': {'quant_method': 'fp8', 'fmt': 'e4m3', 'activation_scheme': 'dynamic',
                        'weight_block_size': [32, 32]}}[fmt]
    json.dump(cfg, open(os.path.join(dst, 'config.json'), 'w'))
    return str(dst)


@pytest.fixture(scope='module')
def ckpt(tiny_model_dir, tmp_path_factory):
    from lmdeploy_tpu.lite.smooth_quant import smooth_quant
    sq = str(tmp_path_factory.mktemp('tiny_w8a8'))
    smooth_quant(tiny_model_dir, work_dir=sq, calib_samples=2, calib_seqlen=64)
    out = {'w8a8': sq}
    for fmt in FORMATS[1:]:
        out[fmt] = _write_fp8(tiny_model_dir, tmp_path_factory.mktemp(f'tiny_{fmt}'), fmt)
    return out


# -- the leaves ------------------------------------------------------------------------------
def _leaf(kind, K, N, rng):
    w = (rng.randn(N, K) * 0.05).astype(np.float32)
    if kind == 'w8a8':
        sc = (np.abs(w).max(axis=1) / 127.0).astype(np.float32)
        w8 = np.clip(np.round(w / sc[:, None]), -127, 127).astype(np.int8)
        return {'w8': np.ascontiguousarray(w8.T), 'scale': sc}
    if kind == 'fp8':
        w8, sc = _quantize_fp8(w)
        return {'w8': np.ascontiguousarray(w8.T), 'scale': sc.reshape(-1)}
    w8, s = _quantize_blocked(w, 32)
    return {'w8': np.ascontiguousarray(w8.T), 'bscale': np.ascontiguousarray(s.T)}


def _torch_leaf(leaf):
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    return params_from_jax({'w': leaf})['w']


def _bf16_ulp_close(got, want):
    """|got - want| within one bf16 ulp of |want| (of the smallest normal at 0)."""
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kind,K,N', [('w8a8', 96, 40), ('fp8', 96, 40),
                                      ('fp8_blocked', 96, 64), ('fp8_blocked', 80, 48)])
def test_linear_leaf_matches_jax(kind, K, N, dtype):
    """``linear`` on each 8-bit leaf, with a bias, against the JAX package's: rows of
    3 x 7 tokens, one an all-zero row (W8A8's scale floor); the last blocked case has
    ragged block tails along K and N."""
    from lmdeploy_tpu.nn.linear import linear as jlinear
    from lmdeploy_tpu_torch.nn.linear import linear as tlinear
    rng = np.random.RandomState(K + N)
    leaf = _leaf(kind, K, N, rng)
    x = rng.randn(3, 7, K).astype(np.float32)
    x[1, 2] = 0.0
    bias = (rng.randn(N) * 0.1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # the reference engine runs linear inside jitted steps (XLA turns W8A8's division
    # by 127 into a product by its f32 reciprocal).  W8A8's bias is added as the
    # reference's linear writes it, to the product rounded to x's dtype: in an f32
    # model XLA's CPU backend would fuse the scale product and that add into one
    # multiply-add, an order of the CPU backend's own
    jx, jw = jnp.asarray(x).astype(jd), {k: jnp.asarray(v) for k, v in leaf.items()}
    jb = jnp.asarray(bias).astype(jd)
    if kind == 'w8a8':
        y = jax.jit(jlinear)(jx, jw)
        want = (y.astype(jnp.float32) + jb.astype(jnp.float32)).astype(jd)
    else:
        want = jax.jit(jlinear)(jx, jw, jb)
    want = np.asarray(want.astype(jnp.float32))
    got = tlinear(torch.from_numpy(x).to(td), _torch_leaf(leaf),
                  torch.from_numpy(bias).to(td)).float().numpy()
    assert got.shape == want.shape == (3, 7, N)
    if kind == 'w8a8':
        np.testing.assert_array_equal(got, want)
    elif dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        _bf16_ulp_close(got, want)


def test_int8_quantizer_rounds_half_to_even():
    """Per-token int8 codes and scales equal to the jitted reference's (the quantizer of
    ``lmdeploy_tpu/nn/linear.py _w8a8``), with values on the half-code boundaries (scale
    1 exactly: absmax 127 times fl(1/127)) and a zero row."""
    from lmdeploy_tpu_torch.nn.linear import quantize_rows_int8
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                  [0.0] * 8,
                  [-3.0, 1e-3, 2.999, -0.25, 0.0, 1.0, 2.0, 0.125]], np.float32)
    a_scale, want = jax.jit(_w8a8_quantizer)(jnp.asarray(x))
    codes, scale = quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(a_scale))
    assert codes[0, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 126]


def _w8a8_quantizer(xf):
    """The activation quantizer of the reference's ``_w8a8``
    (``lmdeploy_tpu/nn/linear.py:138-141``): (scales, codes)."""
    a_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-8)
    return a_scale, jnp.clip(jnp.round(xf / a_scale), -127, 127).astype(jnp.int8)


def test_int8_quantizer_matches_jitted_reference():
    """``quantize_rows_int8`` against ``jax.jit`` of the reference's quantizer, bit for
    bit, on 4,096 rows of four decades of magnitude: XLA multiplies by fl(1/127) where
    the eager reference divides (an ulp apart in about a third of the rows)."""
    from lmdeploy_tpu_torch.nn.linear import quantize_rows_int8
    rng = np.random.RandomState(3)
    x = (rng.randn(4096, 128) * np.logspace(-2, 2, 4096)[:, None]).astype(np.float32)
    a_scale, want = jax.jit(_w8a8_quantizer)(jnp.asarray(x))
    codes, scale = quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(a_scale))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))


def test_w8a8_linear_matches_jitted_reference():
    """``linear`` on a W8A8 leaf against ``jax.jit`` of the reference's ``linear``, bit
    for bit, at the size where the division moved 37 of 512 output rows: x randn * 2
    [512, 256], random int8 codes [256, 64], per-column scales."""
    from lmdeploy_tpu.nn.linear import linear as jlinear
    from lmdeploy_tpu_torch.nn.linear import linear as tlinear
    rng = np.random.RandomState(0)
    x = (rng.randn(512, 256) * 2).astype(np.float32)
    leaf = {'w8': rng.randint(-127, 128, (256, 64)).astype(np.int8),
            'scale': (rng.rand(64) * 1e-2).astype(np.float32)}
    want = np.asarray(jax.jit(jlinear)(jnp.asarray(x),
                                       {k: jnp.asarray(v) for k, v in leaf.items()}))
    got = tlinear(torch.from_numpy(x), _torch_leaf(leaf)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fuse_and_prep_keep_the_leaves():
    """w8 / scale leaves fuse along N key by key (and unfuse back), blocked leaves stay
    unfused, prep_quant_leaves passes every 8-bit leaf through untouched, and
    layout_quant_leaves stores the W8A8 codes K-major with their values and shapes."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    from conftest import TINY_CFG
    for qcfg, fused in (({'quant_method': 'smooth_quant'}, True),
                        ({'quant_method': 'fbgemm_fp8'}, True),
                        ({'quant_method': 'fp8', 'weight_block_size': [32, 32]}, False)):
        m = build_model(ModelConfig.from_hf_config(dict(TINY_CFG, quantization_config=qcfg),
                                                   dtype='float32'))
        p = m.init_params(0)
        f = m.fuse_projections(p)
        assert ('wqkv' in f['layers'] and 'w_gateup' in f['layers']) is fused
        assert m.prep_quant_leaves(f) == f
        laid = m.layout_quant_leaves(f)['layers']
        for name, leaf in f['layers'].items():
            if not isinstance(leaf, dict):
                assert laid[name] is leaf
                continue
            for k, v in leaf.items():
                assert laid[name][k].shape == v.shape
                assert torch.equal(laid[name][k].view(torch.uint8), v.view(torch.uint8)) \
                    if v.dtype == torch.float8_e4m3fn else torch.equal(laid[name][k], v)
            k_major = laid[name]['w8'].stride()[-2] == 1
            assert k_major is (qcfg['quant_method'] == 'smooth_quant')
        if fused:
            assert f['layers']['wqkv']['scale'].shape == (2, 64 + 32 + 32)
            back = m.unfuse_projections(f)['layers']
            for name in ('wq', 'wk', 'wv', 'w_gate', 'w_up'):
                for k in ('w8', 'scale'):
                    assert torch.equal(back[name][k].view(torch.uint8) if k == 'w8'
                                       and back[name][k].dtype == torch.float8_e4m3fn
                                       else back[name][k],
                                       p['layers'][name][k].view(torch.uint8) if k == 'w8'
                                       and p['layers'][name][k].dtype == torch.float8_e4m3fn
                                       else p['layers'][name][k])
        else:
            assert f['layers']['wq']['bscale'].shape == (2, 2, 2)


# -- checkpoints -----------------------------------------------------------------------------
def _models(path):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(path, dtype='float32'))
    tm = tbuild(TConfig.from_pretrained(path, dtype='float32'))
    jp = jax.tree_util.tree_map(np.asarray, load_model_params(jm, path))
    return jm, jp, tm, load_params(tm, path, 'cpu')


def _tree_equal(tp, jp, path=''):
    assert set(tp) == set(jp), path
    for name, leaf in tp.items():
        ref = jp[name]
        if isinstance(leaf, dict):
            _tree_equal(leaf, ref, path + '/' + name)
        elif leaf.dtype == torch.float8_e4m3fn:
            np.testing.assert_array_equal(leaf.view(torch.uint8).numpy(),
                                          np.asarray(ref).view(np.uint8))
        else:
            assert leaf.numpy().dtype == np.asarray(ref).dtype, path + '/' + name
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref), err_msg=name)


@pytest.mark.parametrize('fmt', FORMATS)
def test_loader_matches_jax(ckpt, fmt):
    """The loaded tree equals the JAX loader's leaf for leaf, dtypes included: int8 or
    e4m3 ``w8``, the per-tensor scale broadcast to N, the [Kb, Nb] grid."""
    jm, jp, tm, tp = _models(ckpt[fmt])
    assert tm.quant_method == jm.quant_method == {'w8a8': 'w8a8', 'fp8_blocked': 'fp8_blocked'
                                                  }.get(fmt, 'fp8')
    _tree_equal(tp, jp)
    w = tp['layers']['wq']
    assert w['w8'].dtype == (torch.int8 if fmt == 'w8a8' else torch.float8_e4m3fn)
    if fmt == 'fp8_tensor':
        assert bool((w['scale'] == w['scale'][:, :1]).all())


@pytest.mark.parametrize('fmt', FORMATS)
def test_forward_logits_match_jax(ckpt, fmt):
    """Prefill of two rows (one chunked: its second chunk reads the cache), then 3
    decode steps, f32, both packages on the JAX loader's tree (the port's fused)."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, params_from_jax
    jm, jp, tm, _ = _models(ckpt[fmt])
    tp = tm.fuse_projections(params_from_jax(jp, dtype=torch.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    cfg = jm.config
    L, BS, NB, hkv, D = cfg.num_layers, 16, 12, cfg.num_key_value_heads, cfg.head_dim
    _, hdp = kv_row_width(hkv, D)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), hkv, D)
    jcos, jsin = jrope(D, 256, cfg.rope_theta)
    tcos, tsin = trope(D, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    ids = np.random.RandomState(0).randint(3, cfg.vocab_size, size=(2, 80)).astype(np.int32)
    steps = [((0, 0), (40, 48), 48, True), ((40, 48), (24, 0), 24, False)] + [
        ((64 + i, 48 + i), (1, 1), 1, False) for i in range(3)]
    for hist, qlen, T, fresh in steps:
        hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
        x = np.zeros((2, T), np.int32)
        pos = np.zeros((2, T), np.int32)
        for b in range(2):
            x[b, :qlen[b]] = ids[b, hist[b]:hist[b] + qlen[b]]
            pos[b, :qlen[b]] = np.arange(hist[b], hist[b] + qlen[b])
        jl, jcache = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos), jcache,
                                JMeta(jnp.asarray(tables), jnp.asarray(hist),
                                      jnp.asarray(qlen)), jcos, jsin, fresh_prefill=fresh)
        tl = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                        TMeta(torch.from_numpy(tables), torch.from_numpy(hist),
                              torch.from_numpy(qlen)), tcos, tsin, fresh_prefill=fresh)
        valid = qlen > 0
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=0,
                                   atol=LOGIT_ATOL)


def _greedy(pkg, path, prompts, new_tokens=8):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import GenerationConfig, TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
        kw = {'device': 'cpu'}
    engine = Engine.from_pretrained(path, TpuEngineConfig(**ENGINE_KW), **kw)
    inst = engine.create_instance()
    gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True)

    async def go():
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen)
                                      for i, p in enumerate(prompts)])
    try:
        return [o.token_ids for o in asyncio.run(go())], engine
    finally:
        engine.close()


@pytest.mark.parametrize('fmt', FORMATS)
def test_engine_greedy_tokens_match_jax(ckpt, fmt):
    """Two concurrent prompts (the 70-token one in two prefill chunks), 8 greedy tokens
    each, f32: the port's Engine gives the JAX Engine's tokens, and keeps the 8-bit
    leaves resident (fused where the reference fuses them)."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, 250, size=n).tolist() for n in (30, 70)]
    ref, _ = _greedy('jax', ckpt[fmt], prompts)
    out, engine = _greedy('torch', ckpt[fmt], prompts)
    assert out == ref
    assert all(len(t) == 8 for t in out)
    layers = engine.model_agent.params['layers']
    leaf = layers['wq' if fmt == 'fp8_blocked' else 'wqkv']
    assert leaf['w8'].dtype == (torch.int8 if fmt == 'w8a8' else torch.float8_e4m3fn)
    assert (leaf['w8'].stride()[-2] == 1) is (fmt == 'w8a8')      # K-major int8 codes
