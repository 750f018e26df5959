"""The port's W4A16 path against the JAX package (CPU).

Packing, unpacking, ``prep_w4`` (gd) and ``quantize_w4`` are bit-equal.  The plain
group-dot product (``w4a16_matmul_gd_plain``, the CUDA kernel's plain version) is held
against the Pallas ``w4a16_matmul_stacked`` gd body in TPU interpret mode, as
tests/test_w4_stacked.py runs it.  ``linear`` and ``LlamaModel`` are held against the
JAX package on a W4A16 form of the tiny checkpoint, and ``pipeline()`` with an int8
KV cache against the JAX pipeline.

Tolerances:
  * group-dot vs Pallas gd: both sum exact bf16 x bf16 products in f32 and apply the
    same f32 scales and correction, in another order; each sum of K terms of size up
    to 143 * s * |x| rounds at f32's 2^-24, so 2e-5 of the largest output plus 1e-5
    relative;
  * port dense route vs JAX dense route: the same bf16 weights (bit-equal
    dequantization) and bf16 activations, f32 sums in another order: 1e-5;
  * where the port's group-dot meets the JAX dense route (the reference runs only
    its dense route on the CPU), the JAX side rounds every weight (q - z) * s to bf16
    and the port does not: relative 2^-9 per weight, ~sqrt(K) * 2^-9 * |x| * |w| on
    an output.  Linear outputs: 2e-3 of the largest output.  Model logits through 2
    layers: 3e-3 absolute (logits here reach ~0.64; this gap reads up to 1.7e-3 on
    the CPU, and below 3e-4 when the port takes its dense route for every product);
    tokens are compared under the margin rule below.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.lite import formats as jformats
from lmdeploy_tpu.ops.pallas import quant_matmul as jqm
from lmdeploy_tpu_torch.lite import formats as tformats
from lmdeploy_tpu_torch.ops import quant_matmul as tqm

LOGIT_ATOL = 3e-3


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _bf16(rng, *shape, scale=1.0):
    """bf16-representable f32 numpy values."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
    return x.bfloat16().float().numpy()


# -- layouts and preparation, bit for bit -----------------------------------------------
def test_formats_match_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    K, N, gs = 256, 64, 32
    q = rng.randint(0, 16, (K, N)).astype(np.uint8)
    awq = jformats.pack_awq_qweight(q)
    np.testing.assert_array_equal(tformats.pack_awq_qweight(q), awq)
    np.testing.assert_array_equal(tformats.unpack_awq_qweight(awq), q)
    np.testing.assert_array_equal(tformats.unpack_awq_qzeros(awq[:K // gs]),
                                  jformats.unpack_awq_qzeros(awq[:K // gs]))
    gptq = jformats.pack_gptq_qweight(q)
    np.testing.assert_array_equal(tformats.unpack_gptq_qweight(gptq), q)
    z = rng.randint(1, 16, (K // gs, N))
    gz = jformats.pack_gptq_qzeros(z)
    np.testing.assert_array_equal(tformats.unpack_gptq_qzeros(gz),
                                  jformats.unpack_gptq_qzeros(gz))
    for pad in (0, 512):
        np.testing.assert_array_equal(tformats.awq_qweight_to_kernel(awq, pad),
                                      jformats.awq_qweight_to_kernel(awq, pad))
        np.testing.assert_array_equal(tformats.gptq_qweight_to_kernel(gptq, pad),
                                      jformats.gptq_qweight_to_kernel(gptq, pad))
    np.testing.assert_array_equal(tformats.to_kernel_packed(q), jformats.to_kernel_packed(q))
    np.testing.assert_array_equal(tqm.pack_w4(q).numpy(), np.asarray(jqm.pack_w4(q)))
    assert tformats.pad_k4(11008, 128) == jformats.pad_k4(11008, 128) == 11264
    s = rng.rand(K // gs, N).astype(np.float32)
    np.testing.assert_array_equal(tformats.pad_groups(s, 12, 1.0),
                                  jformats.pad_groups(s, 12, 1.0))


def test_quantize_and_prep_match_jax_bit_for_bit():
    rng = np.random.RandomState(1)
    w = _bf16(rng, 512, 128, scale=0.02)
    jp, js, jz = jqm.quantize_w4(jnp.asarray(w, jnp.bfloat16), 128)
    tp, ts, tz = tqm.quantize_w4(torch.from_numpy(w).bfloat16(), 128)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jsb, jc = jqm.prep_w4(js, jz, mode='gd')
    tsb, tc = tqm.prep_w4(ts, tz, mode='gd')
    assert tsb.dtype == tc.dtype == torch.float32
    np.testing.assert_array_equal(tsb.numpy(), np.asarray(jsb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        tqm.dequant_w4_szc(tp, tsb, tc, 128).float().numpy(),
        np.asarray(jqm.dequant_w4_szc(jp, jsb, jc, 128), np.float32))
    np.testing.assert_array_equal(
        tqm.dequant_w4(tp, ts, tz, 128).float().numpy(),
        np.asarray(jqm.dequant_w4(jp, js, jz, 128), np.float32))


# -- the group-dot product --------------------------------------------------------------
def _quantized(rng, K, N, gs, k_valid=None):
    """A quantized [K, N] weight whose rows from ``k_valid`` on are pad_k4 padding
    (q 0, scale 1, zero 0)."""
    k_valid = k_valid or K
    w = _bf16(rng, k_valid, N, scale=0.02)
    p, s, z = tqm.quantize_w4(torch.from_numpy(w).bfloat16(), gs)
    if k_valid < K:
        q = tqm._nibbles_u8(p).numpy()
        q = np.concatenate([q, np.zeros((K - k_valid, N), np.uint8)])
        p = torch.from_numpy(tformats.to_kernel_packed(q).copy())
        s = torch.from_numpy(tformats.pad_groups(s.numpy(), K // gs, 1.0))
        z = torch.from_numpy(tformats.pad_groups(z.numpy(), K // gs, 0.0))
    return p, s, z


def _tol(ref):
    return dict(rtol=1e-5, atol=2e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize('M,K,N,gs,k_valid', [(8, 512, 128, 128, None),
                                              (64, 1024, 256, 128, None),
                                              (5, 1024, 128, 128, 640)])
def test_group_dot_plain_matches_pallas(M, K, N, gs, k_valid):
    rng = np.random.RandomState(2)
    L, layer = 2, 1
    leaves = [_quantized(rng, K, N, gs, k_valid) for _ in range(L)]
    preps = [tqm.prep_w4(s, z, mode='gd') for _, s, z in leaves]
    x = _bf16(rng, M, K)
    if k_valid:
        x[:, k_valid:] = 0              # the activation pads with zeros (pad_k4)
    jsb = jnp.stack([jnp.asarray(sb.numpy()) for sb, _ in preps])
    jc = jnp.stack([jnp.asarray(c.numpy()) for _, c in preps])
    jp = jnp.stack([jnp.asarray(p.numpy()) for p, _, _ in leaves])
    ref = np.asarray(jqm.w4a16_matmul_stacked(jnp.asarray(x), jp, jsb, jc, layer,
                                              group_size=gs), np.float32)
    p, (sb, c) = leaves[layer][0], preps[layer]
    out = tqm.w4a16_matmul_gd_plain(torch.from_numpy(x), p, sb, c, gs).numpy()
    np.testing.assert_allclose(out, ref, **_tol(ref))
    # the wrapper takes the plain version on a CPU tensor and counts no launch
    before = tqm.w4a16_matmul_gd.launches
    out2 = tqm.w4a16_matmul_gd(torch.from_numpy(x), p, sb, c, gs).numpy()
    np.testing.assert_array_equal(out2, out)
    assert tqm.w4a16_matmul_gd.launches == before


@pytest.mark.parametrize('M', [24, 300])
def test_linear_on_prepared_leaf_matches_jax(M):
    """<= 256 rows: the port's group-dot against the reference's TPU kernel and, more
    loosely, its CPU dense route; > 256 rows: both dense routes."""
    from lmdeploy_tpu.nn.linear import linear as jlinear
    from lmdeploy_tpu_torch.nn.linear import linear as tlinear
    rng = np.random.RandomState(3)
    K_in, K, N, gs = 384, 512, 256, 128
    p, s, z = _quantized(rng, K, N, gs, k_valid=K_in)
    sb, c = tqm.prep_w4(s, z, mode='gd')
    x = _bf16(rng, M, K_in)
    out = tlinear(torch.from_numpy(x), {'packed': p, 'sb': sb, 'corr': c}).numpy()
    jleaf = {'packed': jnp.asarray(p.numpy()), 'sb': jnp.asarray(sb.numpy()),
             'corr': jnp.asarray(c.numpy())}
    ref = np.asarray(jlinear(jnp.asarray(x), jleaf))
    if M > 256:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        dense = tqm.w4a16_dense_szc(torch.from_numpy(np.pad(x, ((0, 0), (0, K - K_in)))),
                                    p, sb, c, gs).numpy()
        np.testing.assert_allclose(dense, out, rtol=1e-6, atol=1e-6)
        return
    xp = np.pad(x, ((0, 0), (0, K - K_in)))
    kern = np.asarray(jqm.w4a16_matmul_stacked(
        jnp.asarray(xp), jleaf['packed'][None], jleaf['sb'][None], jleaf['corr'][None],
        0, group_size=gs))
    np.testing.assert_allclose(out, kern, **_tol(kern))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3 * float(np.abs(ref).max()))


def test_unported_leaves_raise():
    """A leaf of no known quantized form raises; every W4A16 leaf form is served (the
    unprepared and fast / precise forms are held in tests/test_torch_w4a16_modes.py),
    and so are the W8A8, fp8 and blocked-fp8 leaves (tests/test_torch_linear_quant.py)."""
    from lmdeploy_tpu_torch.nn.linear import linear
    x = torch.zeros(2, 512)
    s = torch.ones(4, 8)
    with pytest.raises(ValueError):
        linear(x, {'w4': torch.zeros(512, 8, dtype=torch.int8), 'scale': s[0]})
    p = torch.zeros(64, 8, dtype=torch.int32)
    for leaf in ({'packed': p, 'scales': s, 'zeros': s},
                 {'packed': p, 'sb': s.bfloat16(), 'corr': s},
                 {'w8': torch.zeros(512, 8, dtype=torch.int8), 'scale': s[0]},
                 {'w8': torch.zeros(512, 8, dtype=torch.float8_e4m3fn), 'scale': s[0]},
                 {'w8': torch.zeros(512, 8, dtype=torch.float8_e4m3fn), 'bscale': s[:, :1]}):
        assert linear(x, leaf).shape == (2, 8)


# the K splits of the fast / precise and unprepared kernels (the W4A16 body of
# csrc/w4a16_gemm.cuh, the one split rule) that chip_smoke.py's w4a16_modes sweep timed
# fastest on an H100 (132 SMs) for llama2-7b's fused projections and Mixtral-8x7B's wo
# (4096 x 4096) at 64 and 128 rows (group 128)
@pytest.mark.parametrize('M,K,N,want', [
    (128, 4096, 12288, 1), (128, 4096, 4096, 4), (128, 4096, 22016, 1),
    (128, 11264, 4096, 4), (64, 4096, 12288, 1), (64, 4096, 4096, 4),
    (64, 4096, 22016, 1), (64, 11264, 4096, 4)])
def test_w4a16_split_heuristic_picks_the_swept_best(M, K, N, want):
    assert tqm.w4a16_splits(M, N, K // 128, 132) == want


# the K splits of the gd kernel (csrc/w4a16_gemm.cu) that chip_smoke.py's sweep timed
# fastest on an H100 (132 SMs) for llama2-7b's fused projections at 64 and 128 rows and
# Mixtral-8x7B's fused wqkv at 64 (group 128)
@pytest.mark.parametrize('M,K,N,want', [
    (128, 4096, 12288, 1), (128, 4096, 4096, 4), (128, 4096, 22016, 1),
    (128, 11264, 4096, 4), (64, 4096, 12288, 1), (64, 4096, 4096, 4),
    (64, 4096, 22016, 1), (64, 11264, 4096, 4), (64, 4096, 6144, 2)])
def test_w4a16_gd_split_picker_picks_the_swept_best(M, K, N, want):
    assert tqm.w4a16_splits(M, N, K // 128, 132) == want


@pytest.mark.parametrize('M,tile', [(1, 16), (16, 16), (17, 64), (64, 64), (65, 128),
                                    (128, 128), (129, 128), (256, 128)])
def test_gd_token_tile(M, tile):
    """The gd kernel's token tile (its wgmma N): one tile covers every M up to 128."""
    assert tqm.token_tile(M) == tile and tile in tqm.TOKEN_TILES
    assert -(-M // tile) == (1 if M <= 128 else 2)


# -- a W4A16 form of the tiny checkpoint ------------------------------------------------
def _awq_quantize(w_out_in: np.ndarray, gs: int):
    """HF [out, in] weight -> AWQ (qweight i32[K, N/8], qzeros i32[G, N/8], scales
    f16[G, N]) with integer zero points."""
    w = np.ascontiguousarray(w_out_in.T.astype(np.float32))         # [K, N]
    K, N = w.shape
    wg = w.reshape(K // gs, gs, N)
    lo, hi = wg.min(1), wg.max(1)
    scales = ((hi - lo) / 15.0).astype(np.float16).astype(np.float32)
    scales[scales == 0] = 1.0
    zeros = np.clip(np.round(-lo / scales), 0, 15)
    q = np.clip(np.round(wg / scales[:, None] + zeros[:, None]), 0, 15)
    q = q.reshape(K, N).astype(np.uint8)
    return (tformats.pack_awq_qweight(q), tformats.pack_awq_qweight(zeros.astype(np.uint8)),
            scales.astype(np.float16))


def _write_w4_checkpoint(tiny_model_dir, path, fmt: str, gs: int = 32) -> str:
    """The tiny checkpoint with every linear in AWQ or GPTQ W4A16 form."""
    from safetensors.numpy import load_file, save_file
    for name in os.listdir(tiny_model_dir):
        if name != 'model.safetensors':
            shutil.copy(os.path.join(tiny_model_dir, name), path / name)
    with open(path / 'config.json') as f:
        cfg = json.load(f)
    cfg['quantization_config'] = {'quant_method': fmt, 'bits': 4, 'group_size': gs}
    with open(path / 'config.json', 'w') as f:
        json.dump(cfg, f)
    tensors = {}
    for name, t in load_file(os.path.join(tiny_model_dir, 'model.safetensors')).items():
        if name.endswith('_proj.weight'):
            base = name[:-len('.weight')]
            qw, qz, sc = _awq_quantize(t, gs)
            if fmt == 'gptq':
                qw = jformats.pack_gptq_qweight(tformats.unpack_awq_qweight(qw))
                qz = jformats.pack_gptq_qzeros(tformats.unpack_awq_qweight(qz))
            tensors.update({base + '.qweight': qw, base + '.qzeros': qz,
                            base + '.scales': sc})
        else:
            tensors[name] = t
    save_file(tensors, str(path / 'model.safetensors'))
    return str(path)


@pytest.fixture(scope='module')
def awq_dir(tiny_model_dir, tmp_path_factory):
    """The tiny checkpoint in AWQ W4A16 form, group 32 (so ``pad_k4`` pads the
    hidden-size K from 64 to 128)."""
    return _write_w4_checkpoint(tiny_model_dir, tmp_path_factory.mktemp('tiny_awq'), 'awq')


@pytest.fixture(scope='module')
def awq_models(awq_dir):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(awq_dir))
    tm = tbuild(TConfig.from_pretrained(awq_dir))
    return jm, load_model_params(jm, awq_dir), tm, load_params(tm, awq_dir, 'cpu')


def test_awq_loader_matches_jax(awq_models):
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    jm, jp, tm, tp = awq_models
    assert tm.quant_method == 'w4a16' and tm.group_size == 32
    conv = params_from_jax({'layers': {k: {k2: np.asarray(v2) for k2, v2 in v.items()}
                                       for k, v in jp['layers'].items()
                                       if isinstance(v, dict)}})
    for name, leaf in tp['layers'].items():
        if isinstance(leaf, dict):
            assert leaf['packed'].dtype == torch.int32 and leaf['packed'].shape[1] * 8 == 128
            for k in ('packed', 'scales', 'zeros'):
                assert torch.equal(leaf[k], conv['layers'][name][k]), (name, k)
    prepped = tm.prep_quant_leaves(tm.fuse_projections(tp), mode='gd')['layers']['wqkv']
    assert set(prepped) == {'packed', 'sb', 'corr'} and prepped['packed'].shape[-1] == 128
    back = tm.unfuse_projections(tm.fuse_projections(tp))['layers']
    assert all(torch.equal(back['wk'][k], tp['layers']['wk'][k]) for k in back['wk'])


def test_gptq_loader_matches_jax(tiny_model_dir, tmp_path):
    """GPTQ's K-packed words and z - 1 zero points load to the JAX loader's leaves."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    path = _write_w4_checkpoint(tiny_model_dir, tmp_path, 'gptq')
    jp = load_model_params(jbuild(JConfig.from_pretrained(path)), path)
    tp = load_params(tbuild(TConfig.from_pretrained(path)), path, 'cpu')
    for name, leaf in tp['layers'].items():
        if isinstance(leaf, dict):
            for k in ('packed', 'scales', 'zeros'):
                np.testing.assert_array_equal(leaf[k].numpy(),
                                              np.asarray(jp['layers'][name][k]))


def test_w4a16_kv8_logits_match_jax(awq_models):
    """Prefill and 4 decode steps with W4A16 weights and an int8 cache: logits within
    LOGIT_ATOL, and the int8 cache contents equal to the reference's."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu.ops.kv_quant import QuantKV as JQuantKV
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference
    jm, jp, tm, tp = awq_models
    jp = jm.prep_quant_leaves(jm.fuse_projections(jp), mode='gd')
    tp = tm.prep_quant_leaves(tm.fuse_projections(tp), mode='gd')
    cfg = jm.config
    L, BS, NB, Hkv = cfg.num_layers, 16, 12, cfg.num_key_value_heads
    _, hdp = kv_row_width(Hkv, cfg.head_dim)
    jcache = JQuantKV(jnp.zeros((L, NB, 2, BS, hdp), jnp.int8),
                      jnp.zeros((L, NB, 2, BS, Hkv), jnp.float32))
    tcache = cache_from_reference(jcache, Hkv, cfg.head_dim)
    jcos, jsin = jrope(cfg.head_dim, 256, cfg.rope_theta)
    tcos, tsin = trope(cfg.head_dim, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    rng = np.random.RandomState(0)
    ids = rng.randint(3, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    steps = [((0, 0), (20, 32), 32, True)] + [
        ((20 + i, 32 + i), (1, 1), 1, False) for i in range(4)]
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
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
        data, scale = cache_to_reference(tcache)
        # the K/V written in this step come from activations that differ by the
        # weights' bf16 rounding, so a few int8 values may sit one step apart
        diff = np.abs(data[:, 1:].astype(np.int32) - np.asarray(jcache.data)[:, 1:])
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02
        np.testing.assert_allclose(scale[:, 1:], np.asarray(jcache.scale)[:, 1:],
                                   rtol=1e-2)


def _margin_rule(ref_tokens, ref_top, out_tokens):
    """Tokens equal up to the first difference, and there the reference's top-2
    logprob margin below 2 * LOGIT_ATOL (a near-tie the weights' bf16 rounding on the
    JAX side can flip)."""
    for i, (a, b) in enumerate(zip(ref_tokens, out_tokens)):
        if a != b:
            top = sorted(ref_top[i].values(), reverse=True)
            assert top[0] - top[1] < 2 * LOGIT_ATOL, (i, a, b, top)
            return i
    assert len(ref_tokens) == len(out_tokens)
    return len(ref_tokens)


def test_pipeline_awq_kv8_matches_jax(awq_dir):
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu.messages import GenerationConfig as JGen
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch import pipeline as tpipeline
    from lmdeploy_tpu_torch.messages import GenerationConfig as TGen
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    prompts = ['hello world', 'this is a tiny test', 'hi']
    kw = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=8,
              session_len=256, quant_policy=4)
    runs = []
    for make, cfg, gen, extra in ((jpipeline, JCfg, JGen, {}),
                                  (tpipeline, TCfg, TGen, {'device': 'cpu'})):
        pipe = make(awq_dir, backend_config=cfg(**kw), **extra)
        try:
            runs.append(pipe(prompts, gen_config=gen(max_new_tokens=8, ignore_eos=True,
                                                     logprobs=2)))
        finally:
            pipe.close()
    ref, out = runs
    agreed = [_margin_rule(r.token_ids, r.logprobs, o.token_ids) for r, o in zip(ref, out)]
    assert all(r.input_token_len == o.input_token_len for r, o in zip(ref, out))
    assert all(len(o.token_ids) == 8 for o in out) and sum(agreed) >= 12
