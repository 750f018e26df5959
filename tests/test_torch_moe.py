"""The port's MXFP4 helpers, expert-batched product and MoE dispatch against the JAX
package (CPU, f32).

Tolerances:
  * the MXFP4 wire-format helpers, the e2m1 decode and the widened stacks are
    bit-exact;
  * ``mxfp4_bmm_plain`` vs the Pallas ``mxfp4_bmm`` (TPU interpret mode) and vs
    ``mxfp4_bmm_reference``: both sides take the same bf16 operands (x rounded to
    bf16, e2m1 * 2^k exact in bf16), so every product is exact in f32 and only the
    order of the K = 128 f32 additions differs: 1e-5 relative plus 1e-5 of the largest
    output;
  * ``moe_ffn`` routes: the same f32 products and f32 sums in another order
    (per-expert GEMMs and a per-token sum against ragged_dot / einsum), through the
    clamped activation: 1e-5 relative plus 1e-5 of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.lite import formats as jformats
from lmdeploy_tpu.ops import moe as jmoe
from lmdeploy_tpu.ops.pallas import quant_bmm as jqb
from lmdeploy_tpu_torch.lite import formats as tformats
from lmdeploy_tpu_torch.ops import moe as tmoe
from lmdeploy_tpu_torch.ops import quant_bmm as tqb

LIMIT = 7.0


def _tol(ref):
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def _mxfp4_stack(rng, E, K, N, exps=(-3, 0)):
    """Random half-split codes and power-of-two group scales (varied per group)."""
    nib = rng.randint(0, 256, size=(E, K // 2, N)).astype(np.uint8)
    scale = np.exp2(rng.randint(exps[0], exps[1] + 1, size=(E, K // 32, N))).astype(np.float32)
    return nib, scale


# -- wire formats and decode, bit for bit -------------------------------------------------
def test_mxfp4_formats_match_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    blocks = rng.randint(0, 256, size=(3, 5, 4, 16)).astype(np.uint8)
    # codes 1 (subnormal 0.5), 8 (-0.0) and 9 (-0.5) in both nibbles
    blocks[0, 0, 0, :4] = [0x18, 0x81, 0x91, 0x19]
    scales = rng.randint(118, 136, size=(3, 5, 4)).astype(np.uint8)
    codes = tformats.mxfp4_codes(blocks)
    np.testing.assert_array_equal(codes, jformats.mxfp4_codes(blocks))
    assert codes.dtype == np.uint8 and list(codes[0, 0, :8]) == [8, 1, 1, 8, 1, 9, 9, 1]
    np.testing.assert_array_equal(tformats.pack_halfsplit(codes[0, :4]),
                                  jformats.pack_halfsplit(codes[0, :4]))
    np.testing.assert_array_equal(tformats.ue8m0_to_f32(scales),
                                  jformats.ue8m0_to_f32(scales))
    got, want = tformats.mxfp4_dequant(blocks, scales), jformats.mxfp4_dequant(blocks, scales)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))   # -0.0 too
    assert got[0, 0, 0] == 0 and np.signbit(got[0, 0, 0])
    assert got[0, 0, 5] < 0 and got[0, 0, 1] > 0


def test_e2m1_decode_and_widen_match_jax_bit_for_bit():
    codes = np.arange(16, dtype=np.int32)
    got = tqb.decode_e2m1(torch.from_numpy(codes)).numpy()
    want = np.asarray(jqb._decode_e2m1(jnp.asarray(codes)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, jformats._E2M1)
    rng = np.random.RandomState(1)
    nib, scale = _mxfp4_stack(rng, 2, 128, 64)
    got = tqb.widen_mxfp4(torch.from_numpy(nib), torch.from_numpy(scale)).float().numpy()
    want = np.asarray(jqb.widen_mxfp4(jnp.asarray(nib), jnp.asarray(scale)), np.float32)
    np.testing.assert_array_equal(got, want)
    f32 = tqb.widen_mxfp4(torch.from_numpy(nib), torch.from_numpy(scale), torch.float32)
    np.testing.assert_array_equal(f32.numpy(), got)       # e2m1 * 2^k is exact in bf16


# -- the expert-batched product ---------------------------------------------------------
@pytest.mark.parametrize('N', [64, 192])
@pytest.mark.parametrize('M', [1, 5, 24])
@pytest.mark.parametrize('per_expert', [False, True])
def test_mxfp4_bmm_plain_matches_pallas(per_expert, M, N):
    rng = np.random.RandomState(2)
    E, K = 3, 128
    nib, scale = _mxfp4_stack(rng, E, K, N)
    x = rng.randn(*((E, M, K) if per_expert else (M, K))).astype(np.float32)
    out = tqb.mxfp4_bmm_plain(torch.from_numpy(x), torch.from_numpy(nib),
                              torch.from_numpy(scale)).numpy()
    assert out.shape == (E, M, N) and out.dtype == np.float32
    kern = np.asarray(jqb.mxfp4_bmm(jnp.asarray(x), jnp.asarray(nib), jnp.asarray(scale),
                                    interpret=True))
    ref = np.asarray(jqb.mxfp4_bmm_reference(jnp.asarray(x), jnp.asarray(nib),
                                             jnp.asarray(scale)))
    np.testing.assert_allclose(out, kern, **_tol(kern))
    np.testing.assert_allclose(out, ref, **_tol(ref))
    # the wrapper takes the plain version on a CPU tensor and counts no launch
    before = tqb.mxfp4_bmm.launches
    out2 = tqb.mxfp4_bmm(torch.from_numpy(x), torch.from_numpy(nib), torch.from_numpy(scale))
    np.testing.assert_array_equal(out2.numpy(), out)
    assert tqb.mxfp4_bmm.launches == before


@pytest.mark.parametrize('per_expert', [False, True])
def test_mxfp4_bmm_plain_matches_pallas_k_tail(per_expert):
    """K = 192: three scale groups a half, where the CUDA kernel's stages hold two, so
    its last stage reads past the half as zeros; the plain version it is held against
    on the card matches the Pallas kernel there too."""
    rng = np.random.RandomState(3)
    E, K, M, N = 2, 192, 9, 64
    nib, scale = _mxfp4_stack(rng, E, K, N)
    x = rng.randn(*((E, M, K) if per_expert else (M, K))).astype(np.float32)
    out = tqb.mxfp4_bmm_plain(torch.from_numpy(x), torch.from_numpy(nib),
                              torch.from_numpy(scale)).numpy()
    kern = np.asarray(jqb.mxfp4_bmm(jnp.asarray(x), jnp.asarray(nib), jnp.asarray(scale),
                                    interpret=True))
    assert out.shape == (E, M, N)
    np.testing.assert_allclose(out, kern, **_tol(kern))


def test_mxfp4_bmm_rejects_bad_shapes_and_fp8_is_queued():
    """Both expert-batched products reject bad shapes.  The blocked-fp8 half, queued
    when this test was written, is ported since: ``fp8_bmm`` and ``moe_ffn`` take
    ``{'w8', 'gscale'}`` leaves (tests/test_torch_fp8_bmm.py holds their numbers)."""
    nib = torch.zeros(2, 64, 32, dtype=torch.uint8)
    scale = torch.ones(2, 4, 32)
    with pytest.raises(ValueError):
        tqb.mxfp4_bmm(torch.zeros(3, 100), nib, scale)                # K mismatch
    with pytest.raises(ValueError):
        tqb.mxfp4_bmm(torch.zeros(3, 5, 128), nib, scale)             # E mismatch
    w8 = torch.zeros(2, 128, 32, dtype=torch.uint8).view(torch.float8_e4m3fn)
    gscale = torch.ones(2, 4, 32)
    with pytest.raises(ValueError):
        tqb.fp8_bmm(torch.zeros(3, 100), w8, gscale)                  # K mismatch
    with pytest.raises(ValueError):
        tqb.fp8_bmm(torch.zeros(2, 128), w8, torch.ones(2, 3, 32))    # 3 groups of 128
    leaf = {'w8': w8, 'gscale': gscale}
    down = {'w8': torch.zeros(2, 32, 128, dtype=torch.uint8).view(torch.float8_e4m3fn),
            'gscale': torch.ones(2, 1, 128)}
    out = tmoe.moe_ffn(torch.ones(2, 128), torch.zeros(2, 1, dtype=torch.int64),
                       torch.ones(2, 1), leaf, leaf, down, torch.float32)
    assert out.shape == (2, 128) and bool(torch.isfinite(out).all())


# -- moe_ffn on all four routes ----------------------------------------------------------
def _jact(gate, up):
    gate = jnp.minimum(gate, LIMIT)
    up = jnp.clip(up, -LIMIT, LIMIT)
    return (up + 1.0) * (gate * (1.0 / (1.0 + jnp.exp(-gate * 1.702))))


def _tact(gate, up):
    gate = gate.clamp(max=LIMIT)
    up = up.clamp(-LIMIT, LIMIT)
    return (up + 1.0) * (gate * torch.sigmoid(gate * 1.702))


@pytest.mark.parametrize('route,N', [('dense', 24), ('ragged', 130),
                                     ('mxfp4_dense', 24), ('mxfp4_ragged', 800),
                                     ('mxfp4_ragged_by_expert', 800)])
def test_moe_ffn_routes_match_jax(route, N, monkeypatch):
    """Biases, the clamped activation (gate and up reach past +-7) and a token that
    picks the same expert twice; the grouped GEMM on quantized stacks widened at once
    and, as stacks past ``_WIDEN_WHOLE_BYTES`` are, an expert at a time."""
    if route.endswith('by_expert'):
        monkeypatch.setattr(tmoe, '_WIDEN_WHOLE_BYTES', 0)
    rng = np.random.RandomState(3)
    E, k, H, Ie = 4, 2, 64, 64
    xf = (rng.randn(N, H) * 2).astype(np.float32)
    top_idx = rng.randint(0, E, size=(N, k)).astype(np.int32)
    top_idx[0] = [1, 1]
    top_w = rng.rand(N, k).astype(np.float32)
    biases = [(rng.randn(*s) * 0.5).astype(np.float32) for s in ((E, Ie), (E, Ie), (E, H))]
    if route.startswith('mxfp4'):
        stacks = [_mxfp4_stack(rng, E, K, Nn, exps=(-4, -2))
                  for K, Nn in ((H, Ie), (H, Ie), (Ie, H))]
        jst = [{'nib': jnp.asarray(n), 'scale': jnp.asarray(s)} for n, s in stacks]
        tst = [{'nib': torch.from_numpy(n), 'scale': torch.from_numpy(s)} for n, s in stacks]
    else:
        stacks = [(rng.randn(E, K, Nn) * 0.3).astype(np.float32)
                  for K, Nn in ((H, Ie), (H, Ie), (Ie, H))]
        jst = [jnp.asarray(s) for s in stacks]
        tst = [torch.from_numpy(s) for s in stacks]
    ref = np.asarray(jmoe.moe_ffn(jnp.asarray(xf), jnp.asarray(top_idx), jnp.asarray(top_w),
                                  *jst, jnp.float32,
                                  biases=tuple(jnp.asarray(b) for b in biases), act=_jact))
    out = tmoe.moe_ffn(torch.from_numpy(xf), torch.from_numpy(top_idx),
                       torch.from_numpy(top_w), *tst, torch.float32,
                       biases=tuple(torch.from_numpy(b) for b in biases), act=_tact).numpy()
    assert out.shape == (N, H) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **_tol(ref))
    # the clamp is exercised on this data
    gate = xf[:8] @ (stacks[0][1] if not route.startswith('mxfp4') else
                     tqb.widen_mxfp4(tst[0]['nib'], tst[0]['scale'], torch.float32)[1].numpy())
    assert np.abs(gate).max() > LIMIT


def test_moe_dense_routes_agree_with_ragged():
    """The three routes compute one function on bf16 operands.  The MXFP4 dense
    combine and the bf16 dense combine round the same combine-weighted activation to
    bf16, so they differ only in the order of f32 sums; the grouped GEMM rounds the
    activation before weighting it, one bf16 rounding (2^-9 relative) elsewhere, so it
    is held to 1e-2 of the largest output."""
    rng = np.random.RandomState(4)
    E, k, N, H, Ie = 4, 2, 40, 64, 64
    xf = torch.from_numpy(rng.randn(N, H).astype(np.float32))
    top_idx = torch.from_numpy(rng.randint(0, E, size=(N, k)))
    top_w = torch.from_numpy(rng.rand(N, k).astype(np.float32))
    nibs = [_mxfp4_stack(rng, E, K, Nn, exps=(-4, -3)) for K, Nn in ((H, Ie), (H, Ie), (Ie, H))]
    leaves = [{'nib': torch.from_numpy(n), 'scale': torch.from_numpy(s)} for n, s in nibs]
    dense = [tqb.widen_mxfp4(lf['nib'], lf['scale']) for lf in leaves]
    quant = tmoe.moe_ffn(xf, top_idx, top_w, *leaves, torch.bfloat16)
    ragged = tmoe._moe_ragged(xf, top_idx, top_w, *dense, torch.bfloat16)
    plain = tmoe._moe_dense(xf, top_idx, top_w, *dense, torch.bfloat16)
    np.testing.assert_allclose(quant.numpy(), plain.numpy(), **_tol(plain.numpy()))
    np.testing.assert_allclose(ragged.numpy(), plain.numpy(), rtol=0,
                               atol=1e-2 * float(plain.abs().max()))


def test_eplb_remap_is_identity_without_tables():
    top_idx = torch.tensor([[0, 3], [2, 2]])
    assert tmoe.eplb_remap({}, top_idx) is top_idx
    with pytest.raises(NotImplementedError):
        tmoe.eplb_remap({'eplb_l2p': None}, top_idx)
