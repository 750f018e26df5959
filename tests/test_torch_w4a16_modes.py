"""The port's W4A16 schedules and leaf forms against the JAX package (CPU).

``prep_w4`` (gd / fast / precise), ``dequant_w4`` (one matrix and an expert stack),
``dequant_w4_szc`` and ``dequant_w4_biased`` are bit-equal.  The plain versions of the
fast / precise kernel (``w4a16_matmul_szc_plain``) and of the unprepared kernel
(``w4a16_matmul_plain``) are held against the Pallas kernels in TPU interpret mode
(``w4a16_matmul_stacked``'s ``_w4a16_kernel_stacked`` body; ``w4a16_matmul``), at the
shapes tests/test_w4_stacked.py and tests/test_pallas_quant_matmul.py run them.  The
port's ``linear`` is held against the JAX ``linear`` on every leaf form, and the
engine switches against the JAX ``ModelAgent``'s.

Tolerances, all from f32 sums taken in another order over exact bf16 x bf16
products (no rounding of any operand differs):
  * kernels' plain versions vs Pallas: each output sums K terms whose magnitude
    reaches ~143·s·|x| before the ~30x correction cancels them (the +128 decode
    bias), so the f32 order moves an output by up to ~K·2^-24 of that running sum:
    2e-5 of the largest output plus 1e-5 relative (the readings here are 4e-7 to
    6e-5 of outputs up to 8);
  * dense routes against each other: the same bf16 weights and activations, 1e-5
    (fast's, whose main term and correction are each ~30x the output, as above);
  * where the port's kernel plain version meets the JAX dense route (the JAX package
    runs only its dense routes on the CPU): unprepared differs there by the dense
    route's rounding of each weight (q - z)·s to bf16 (relative 2^-9 a weight), 2e-3
    of the largest output, as tests/test_torch_quant_matmul.py holds the gd schedule;
    precise rounds on both routes, (q - 7)·sb in the kernel and (q - z)·s in the dense
    one, so two such noises: 3e-3 (it reads up to 2.4e-3); fast takes the same biased
    bf16 weights on both routes, so its f32 order alone, 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops.pallas import quant_matmul as jqm
from lmdeploy_tpu_torch.ops import quant_matmul as tqm

MODES = ('gd', 'fast', 'precise')


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _bf16(rng, *shape, scale=1.0):
    """bf16-representable f32 numpy values."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
    return x.bfloat16().float().numpy()


def _t(a) -> torch.Tensor:
    """A JAX array (bf16 included) as a tensor of the same dtype, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _quantized(rng, K, N, gs, scale=0.02):
    """(JAX packed, scales, zeros) of a random bf16 [K, N] weight."""
    w = jnp.asarray(rng.randn(K, N).astype(np.float32) * scale, jnp.bfloat16)
    return jqm.quantize_w4(w, gs)


def _tol(ref):
    return dict(rtol=1e-5, atol=2e-5 * float(np.abs(ref).max()))


# -- preparation and dequantization, bit for bit ----------------------------------------
@pytest.mark.parametrize('mode,precise', [(m, False) for m in MODES] + [(None, False),
                                                                         (None, True)])
def test_prep_w4_matches_jax_bit_for_bit(mode, precise):
    """Every mode, and the mode None reads from ``precise`` (fast / precise), on a
    single [G, N] table and on a stacked [L, G, N] one."""
    rng = np.random.RandomState(0)
    p, s, z = _quantized(rng, 512, 128, 128)
    for js, jz in ((s, z), (jnp.stack([s, s * 1.5]), jnp.stack([z, z + 0.25]))):
        jsb, jc = jqm.prep_w4(js, jz, precise, mode=mode)
        tsb, tc = tqm.prep_w4(_t(js), _t(jz), precise, mode=mode)
        assert str(tsb.dtype)[6:] == str(jsb.dtype) and str(tc.dtype)[6:] == str(jc.dtype)
        assert torch.equal(tsb, _t(jsb)) and torch.equal(tc, _t(jc))
        assert tqm.schedule_of(tsb, tc) == (mode or ('precise' if precise else 'fast'))


@pytest.mark.parametrize('mode', MODES)
def test_dequants_match_jax_bit_for_bit(mode):
    rng = np.random.RandomState(1)
    gs = 128
    p, s, z = _quantized(rng, 512, 256, gs)
    sb, c = jqm.prep_w4(s, z, mode=mode)
    tp = _t(p)
    assert torch.equal(tqm.dequant_w4_szc(tp, _t(sb), _t(c), gs),
                       _t(jqm.dequant_w4_szc(p, sb, c, gs)))
    if mode != 'gd':
        assert torch.equal(tqm.dequant_w4_biased(tp, _t(sb), gs),
                           _t(jqm.dequant_w4_biased(p, sb, gs)))
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert torch.equal(tqm.dequant_w4(tp, _t(s), _t(z), gs, dtype),
                           _t(jqm.dequant_w4(p, s, z, gs, jdtype)))


def test_dequant_expert_stack_matches_jax_vmap():
    """An [E, K/8, N] expert stack (K = 96: groups straddle the planes, as the tiny
    Mixtral's down projection does) widens as the reference's ``jax.vmap``."""
    import jax
    rng = np.random.RandomState(2)
    gs, E = 32, 3
    leaves = [_quantized(rng, 96, 64, gs, scale=0.1) for _ in range(E)]
    jp, js, jz = (jnp.stack([leaf[i] for leaf in leaves]) for i in range(3))
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        ref = jax.vmap(lambda p, s, z: jqm.dequant_w4(p, s, z, gs, jdtype))(jp, js, jz)
        assert torch.equal(tqm.dequant_w4(_t(jp), _t(js), _t(jz), gs, dtype), _t(ref))


# -- the kernels' plain versions against the Pallas kernels -----------------------------
@pytest.mark.parametrize('mode', ('fast', 'precise'))
@pytest.mark.parametrize('B,K,N,gs', [(8, 512, 128, 128), (64, 1024, 256, 128)])
def test_szc_plain_matches_pallas(mode, B, K, N, gs):
    """Row 8b: the fast / precise body of ``w4a16_matmul_stacked`` on layer 1 of a
    3-layer stack (x f32 with bf16 values, so both emit f32)."""
    rng = np.random.RandomState(3)
    leaves = [_quantized(rng, K, N, gs) for _ in range(3)]
    preps = [jqm.prep_w4(s, z, mode=mode) for _, s, z in leaves]
    x = _bf16(rng, B, K)
    ref = np.asarray(jqm.w4a16_matmul_stacked(
        jnp.asarray(x), jnp.stack([p for p, _, _ in leaves]),
        jnp.stack([sb for sb, _ in preps]), jnp.stack([c for _, c in preps]), 1, gs))
    p, (sb, c) = _t(leaves[1][0]), (_t(a) for a in preps[1])
    out = tqm.w4a16_matmul_szc_plain(torch.from_numpy(x), p, sb, c, gs).numpy()
    np.testing.assert_allclose(out, ref, **_tol(ref))
    # the wrapper takes the plain version on a CPU tensor and counts no launch
    before = tqm.w4a16_matmul_szc.launches
    assert np.array_equal(tqm.w4a16_matmul_szc(torch.from_numpy(x), p, sb, c, gs).numpy(), out)
    assert tqm.w4a16_matmul_szc.launches == before


@pytest.mark.parametrize('B,K,N,gs,bn,bk', [(8, 512, 128, 128, 128, 128),
                                            (16, 1024, 256, 128, 128, 256),
                                            (8, 256, 128, 64, 128, 64),
                                            (8, 2048, 256, 128, 256, 512)])
def test_unprepared_plain_matches_pallas(B, K, N, gs, bn, bk):
    """Row 7: ``w4a16_matmul`` (``_w4a16_kernel_groupdot`` plus the wrapper's f32
    correction) on raw scales and zeros; x f32, as the reference's test gives it."""
    rng = np.random.RandomState(4)
    p, s, z = jqm.quantize_w4(jnp.asarray(rng.randn(K, N).astype(np.float32) * 0.1), gs)
    x = (rng.randn(B, K) * 0.5).astype(np.float32)
    ref = np.asarray(jqm.w4a16_matmul(jnp.asarray(x), p, s, z, group_size=gs, block_n=bn,
                                      block_k=bk))
    out = tqm.w4a16_matmul_plain(torch.from_numpy(x), _t(p), _t(s), _t(z), gs).numpy()
    np.testing.assert_allclose(out, ref, **_tol(ref))
    before = tqm.w4a16_matmul.launches
    assert np.array_equal(tqm.w4a16_matmul(torch.from_numpy(x), _t(p), _t(s), _t(z), gs).numpy(),
                          out)
    assert tqm.w4a16_matmul.launches == before


@pytest.mark.parametrize('B,K', [(300, 512), (8, 384)])
def test_unprepared_dense_route_matches_jax(B, K):
    """More than 256 rows, or K % (4 gs) != 0: both packages dequantize to bf16 and
    run one dense dot."""
    rng = np.random.RandomState(5)
    gs = 128
    p, s, z = jqm.quantize_w4(jnp.asarray(rng.randn(K, 128).astype(np.float32) * 0.1), gs)
    x = (rng.randn(B, K) * 0.5).astype(np.float32)
    ref = np.asarray(jqm.w4a16_matmul(jnp.asarray(x), p, s, z, group_size=gs))
    out = tqm.w4a16_matmul(torch.from_numpy(x), _t(p), _t(s), _t(z), gs).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('mode', MODES)
def test_dense_szc_matches_jax(mode):
    rng = np.random.RandomState(6)
    gs = 128
    p, s, z = _quantized(rng, 512, 256, gs)
    sb, c = jqm.prep_w4(s, z, mode=mode)
    x = _bf16(rng, 300, 512)
    ref = np.asarray(jqm.w4a16_dense_szc(jnp.asarray(x), p, sb, c, gs))
    out = tqm.w4a16_dense_szc(torch.from_numpy(x), _t(p), _t(sb), _t(c), gs).numpy()
    # fast's main term and correction are each ~30x the output: their f32 order
    np.testing.assert_allclose(out, ref, **_tol(ref))


# -- linear on every leaf form ----------------------------------------------------------
@pytest.mark.parametrize('form', ('unprepared', 'fast', 'precise'))
@pytest.mark.parametrize('M', [24, 300])
def test_linear_on_each_leaf_form_matches_jax(form, M):
    """<= 256 rows: the port's kernel plain version against the JAX CPU dense route;
    > 256 rows: both dense routes.  K = 512 in whole groups x 4 planes and
    (K / 4) % 128 == 0, so the fast / precise kernel takes the shape."""
    from lmdeploy_tpu.nn.linear import linear as jlinear
    from lmdeploy_tpu_torch.nn.linear import linear as tlinear
    rng = np.random.RandomState(7)
    gs = 128
    p, s, z = _quantized(rng, 512, 256, gs)
    if form == 'unprepared':
        jleaf = {'packed': p, 'scales': s, 'zeros': z}
    else:
        sb, c = jqm.prep_w4(s, z, mode=form)
        jleaf = {'packed': p, 'sb': sb, 'corr': c}
    x = _bf16(rng, 2, M // 2, 512)
    ref = np.asarray(jlinear(jnp.asarray(x), jleaf))
    out = tlinear(torch.from_numpy(x), {k: _t(v) for k, v in jleaf.items()}).numpy()
    assert out.shape == ref.shape == (2, M // 2, 256)
    if M > 256 or form == 'fast':
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-5 * float(np.abs(ref).max()))
    else:
        frac = 3e-3 if form == 'precise' else 2e-3
        np.testing.assert_allclose(out, ref, rtol=0, atol=frac * float(np.abs(ref).max()))


# -- the engine's switches --------------------------------------------------------------
def _attention_leaves(params):
    lp = params['layers']
    return {name: {k: str(v.dtype).split('.')[-1] for k, v in leaf.items()}
            for name, leaf in lp.items() if isinstance(leaf, dict)}


@pytest.mark.parametrize('env', [{}, {'LMDEPLOY_TPU_W4_FAST': '1'},
                                 {'LMDEPLOY_TPU_W4_SCHED': 'precise'},
                                 {'LMDEPLOY_TPU_W4_SCHED': 'fast'},
                                 {'LMDEPLOY_TPU_W4_STACKED': '0'},
                                 {'LMDEPLOY_TPU_FUSE_PROJ': '0', 'LMDEPLOY_TPU_W4_SCHED': 'fast'}])
def test_agent_switches_match_jax(awq_w4_dir, monkeypatch, env):
    """The JAX ``ModelAgent`` and the port's, built under the same environment, hold
    W4A16 leaves of the same names, keys and dtypes (fused or not; gd, fast, precise
    or unprepared)."""
    from lmdeploy_tpu.config import EngineConfigBundle as JBundle
    from lmdeploy_tpu.engine.model_agent import ModelAgent as JAgent
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch.config import EngineConfigBundle as TBundle
    from lmdeploy_tpu_torch.engine.model_agent import ModelAgent as TAgent
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(dtype='float32', block_size=16, num_gpu_blocks=16, max_batch_size=2,
              session_len=64, max_prefill_token_num=32)
    jagent = JAgent(JBundle.build(awq_w4_dir, JCfg(**kw)), awq_w4_dir)
    tagent = TAgent(TBundle.build(awq_w4_dir, TCfg(**kw)), awq_w4_dir, device='cpu')
    want = _attention_leaves(jagent.params)
    assert _attention_leaves(tagent.params) == want
    assert ('wqkv' in want) == (env.get('LMDEPLOY_TPU_FUSE_PROJ') != '0')


@pytest.fixture(scope='module')
def awq_w4_dir(tiny_model_dir, tmp_path_factory):
    """The tiny checkpoint with every linear in AWQ W4A16 form, group 32."""
    from test_torch_quant_matmul import _write_w4_checkpoint
    return _write_w4_checkpoint(tiny_model_dir, tmp_path_factory.mktemp('tiny_awq_modes'),
                                'awq')



def _precise_trap_reading(spread: float) -> float:
    """What chip_smoke.py's check reads (error over its allowance) for precise with its
    scale on the dot outputs, at seeded weights whose groups are scaled by
    10^-U(0, spread) within each column."""
    from chip_smoke import KERNEL_TOL, _szc_trapped, compare
    gen = torch.Generator().manual_seed(1234)
    K, N, M, gs = 4096, 512, 8, 128
    w = torch.randn(K, N, generator=gen) * 0.02
    factor = 10 ** (-spread * torch.rand(K // gs, 1, N, generator=gen))
    w = (w.view(K // gs, gs, N) * factor).view(K, N)
    packed, scales, zeros = tqm.quantize_w4(w.bfloat16(), gs)
    sb, corr = tqm.prep_w4(scales, zeros, mode='precise')
    x = torch.randn(M, K, generator=gen).bfloat16()
    ref = tqm.w4a16_matmul_szc_plain(x, packed, sb, corr, gs)
    trap = _szc_trapped('scale_on_dot_outputs')(x, packed, sb, corr, gs)
    return compare(trap, ref, KERNEL_TOL['w4a16_szc'])[2]


@pytest.mark.parametrize('spread', [0.0, 3.0])
def test_precise_scale_on_dot_outputs_trap(spread):
    """Precise with its scale on the dot outputs (gd's numerics) differs from precise
    by the bf16 rounding of each weight (q - 7) * s alone.  chip_smoke.py's check
    (allowance 2e-3 + 1e-2 |ref|) reads it above the allowance at seeded weights like
    the kernel phase's, and holds it there.  Groups whose scales differ by orders of
    magnitude within a column do not make it read higher: each weight's rounding is
    relative to the weight, so the large groups set both the signal and the error."""
    reads = _precise_trap_reading(spread)
    if spread:
        assert reads < _precise_trap_reading(0.0)
    else:
        assert reads > 1.0
