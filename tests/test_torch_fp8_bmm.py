"""Blocked-fp8 expert products: the port's ``ops/quant_bmm.py`` fp8 half against the JAX
package (CPU).

Checked: the arithmetic e4m3 decode on all 256 codes (subnormals, -0.0 and the NaN
code read as +-480, bit for bit), ``widen_fp8`` bit for bit (NaN where the reference's
cast gives NaN), ``fp8_bmm_plain`` against the Pallas ``fp8_bmm`` in interpret mode and
against ``fp8_bmm_reference`` (x shared and per expert, groups 128 and 32, an f32 x
that both round to bf16), the traps the card's check holds (x left unrounded, the next
group's scale row, the native NaN decode) each moving the product beyond the allowance,
and ``moe_ffn`` on ``{'w8', 'gscale'}`` leaves against the reference's ``_moe_ffn_one``
on the dense-combine and the widen-then-grouped routes.

Tolerances: products in f32 with exact bf16 x bf16 terms on both sides, summed in
another order: 1e-5 absolute + 1e-5 relative (outputs ~1-10).  ``moe_ffn``: f32 at
1e-5 on the dense route; the grouped route at 1e-4 (its activations round to the model
dtype after the weighting, in another summation order).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lmdeploy_tpu_torch.ops import moe as tmoe
from lmdeploy_tpu_torch.ops.quant_bmm import (decode_fp8_e4m3, fp8_bmm, fp8_bmm_plain,
                                              widen_fp8)
from lmdeploy_tpu_torch.ops.quant_matmul import TOKEN_TILES, token_tile

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _w8(rng, shape, nan_codes=False):
    """Random e4m3 bytes as (numpy ml_dtypes e4m3, torch float8_e4m3fn); without
    ``nan_codes`` the codes 0x7f / 0xff are replaced by 0x7e / 0xfe."""
    b = rng.randint(0, 256, size=shape).astype(np.uint8)
    if not nan_codes:
        b = np.where((b & 0x7F) == 0x7F, b - 1, b).astype(np.uint8)
    return b.view(ml_dtypes.float8_e4m3fn), torch.from_numpy(b.copy()).view(torch.float8_e4m3fn)


def _w8_weights(rng, shape):
    """e4m3 weights as a quantizer leaves them (normal values, amax near 448), as
    (numpy ml_dtypes e4m3, torch float8_e4m3fn)."""
    w = np.clip(rng.randn(*shape) * 100, -448, 448).astype(ml_dtypes.float8_e4m3fn)
    return w, torch.from_numpy(w.view(np.uint8).copy()).view(torch.float8_e4m3fn)


def _scales(rng, shape):
    s = np.exp2(rng.randint(-9, -4, size=shape)) * (1 + 0.1 * rng.rand(*shape))
    return s.astype(np.float32)


def test_decode_all_codes_match_jax():
    from lmdeploy_tpu.ops.pallas.quant_bmm import _decode_fp8_e4m3
    codes = np.arange(256, dtype=np.int32)
    ref = np.asarray(_decode_fp8_e4m3(jnp.asarray(codes)))
    got = decode_fp8_e4m3(torch.arange(256, dtype=torch.int32).to(torch.uint8)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert got[0x7F] == 480.0 and got[0xFF] == -480.0 and got[0x7E] == 448.0
    assert got[1] == 2.0 ** -9 and np.signbit(got[0x80])
    # a float8_e4m3fn tensor decodes through its bytes
    w = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.float8_e4m3fn)
    np.testing.assert_array_equal(decode_fp8_e4m3(w).numpy().view(np.uint32),
                                  ref.view(np.uint32))


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_widen_fp8_bit_equal(dtype):
    from lmdeploy_tpu.ops.pallas.quant_bmm import widen_fp8 as jwiden
    rng = np.random.RandomState(0)
    w8n, w8t = _w8(rng, (2, 64, 48), nan_codes=True)
    s = _scales(rng, (2, 2, 48))
    ref = np.asarray(jwiden(jnp.asarray(w8n), jnp.asarray(s), getattr(jnp, dtype)))
    got = widen_fp8(w8t, torch.from_numpy(s), getattr(torch, dtype))
    bits = np.uint16 if dtype == 'bfloat16' else np.uint32
    got_bits = (got.view(torch.int16) if dtype == 'bfloat16' else got.view(torch.int32))
    ref_bits = ref.view(bits) if dtype == 'float32' else ref.astype(ml_dtypes.bfloat16).view(bits)
    # the cast keeps the reference's NaN for the NaN code (the NaN payloads differ);
    # every other element is bit for bit the reference's
    nan = (w8n.view(np.uint8) & 0x7F) == 0x7F
    assert nan.any() and np.isnan(got.float().numpy()[nan]).all()
    assert np.isnan(np.asarray(ref, np.float32)[nan]).all()
    np.testing.assert_array_equal(got_bits.numpy().view(bits)[~nan], ref_bits[~nan])


@pytest.mark.parametrize('x_kind,group,x_dtype', [
    ('shared', 128, 'bfloat16'), ('per_expert', 128, 'bfloat16'),
    ('shared', 32, 'float32'), ('per_expert', 32, 'float32')])
def test_plain_matches_pallas_and_reference(x_kind, group, x_dtype):
    from lmdeploy_tpu.ops.pallas.quant_bmm import fp8_bmm as jbmm
    from lmdeploy_tpu.ops.pallas.quant_bmm import fp8_bmm_reference as jref
    rng = np.random.RandomState(2)
    E, M, K, N = 3, 10, 256, 96
    w8n, w8t = _w8_weights(rng, (E, K, N))
    s = _scales(rng, (E, K // group, N)) * 2 ** -5
    x = rng.randn(*((M, K) if x_kind == 'shared' else (E, M, K))).astype(np.float32) * 4
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    want = np.asarray(jbmm(jx, jnp.asarray(w8n), jnp.asarray(s), block_n=32, block_k=128))
    np.testing.assert_allclose(np.asarray(jref(jx, jnp.asarray(w8n), jnp.asarray(s))),
                               want, **TOL)
    got = fp8_bmm_plain(tx, w8t, torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (E, M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # on a CPU tensor the wrapper takes the plain version and counts no launch
    before = fp8_bmm.launches
    np.testing.assert_array_equal(fp8_bmm(tx, w8t, torch.from_numpy(s)).numpy(), got.numpy())
    assert fp8_bmm.launches == before


def test_nan_code_reads_480_like_pallas():
    """The Pallas kernel (and so the port's fp8_bmm) reads 0x7f / 0xff as +-480; a
    native e4m3 cast would give NaN."""
    from lmdeploy_tpu.ops.pallas.quant_bmm import fp8_bmm as jbmm
    rng = np.random.RandomState(3)
    E, M, K, N = 2, 4, 128, 32
    b = rng.randint(0, 256, size=(E, K, N)).astype(np.uint8)
    b[0, :9, :5] = 0x7F
    b[1, 3:7, 2] = 0xFF
    w8n, w8t = b.view(ml_dtypes.float8_e4m3fn), torch.from_numpy(b).view(torch.float8_e4m3fn)
    s = _scales(rng, (E, 1, N))
    x = rng.randn(M, K).astype(np.float32)
    want = np.asarray(jbmm(jnp.asarray(x), jnp.asarray(w8n), jnp.asarray(s), block_k=128))
    got = fp8_bmm_plain(torch.from_numpy(x), w8t, torch.from_numpy(s)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **TOL)
    native = torch.matmul(torch.from_numpy(x).bfloat16().float(),
                          widen_fp8(w8t, torch.from_numpy(s)).float())
    assert torch.isnan(native).any()


def _trapped(trap):
    """fp8_bmm_plain with one of the traps the card's kernel check holds planted."""
    def bmm(x, w8, gscale):
        K = w8.shape[-2]
        if trap == 'next_group_scale':       # the scale row of the next group
            gscale = torch.roll(gscale, -1, dims=-2)
        vals = (w8.float() if trap == 'native_nan' else decode_fp8_e4m3(w8))
        g = gscale.float().repeat_interleave(K // gscale.shape[-2], dim=-2)
        w = (vals * g).to(torch.bfloat16).float()
        xr = x.float() if trap == 'x_unrounded' else x.to(torch.bfloat16).float()
        return torch.matmul(xr, w)
    return bmm


@pytest.mark.parametrize('trap', ['x_unrounded', 'next_group_scale', 'native_nan'])
def test_each_trap_exceeds_the_allowance(trap):
    """The card's check (atol 1e-4 + rtol 1e-4 against the plain version) sees every
    planted trap: an f32 x, scales that vary by group, NaN codes in w8."""
    rng = np.random.RandomState(4)
    E, M, K, N = 2, 8, 256, 64
    _, w8t = _w8(rng, (E, K, N), nan_codes=True)
    s = torch.from_numpy(_scales(rng, (E, K // 128, N)))
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    ref = fp8_bmm_plain(x, w8t, s)
    out = _trapped(trap)(x, w8t, s)
    frac = ((out - ref).abs() / (1e-4 + 1e-4 * ref.abs())).nan_to_num(nan=np.inf).max()
    assert frac > 1.0, (trap, float(frac))


@pytest.mark.parametrize('N', [12, 800])
def test_moe_ffn_fp8_leaves_match_jax(N):
    """The dense combine over resident fp8 stacks below 768 rows, widen + grouped GEMM
    at 768 and above, against the reference's ``_moe_ffn_one`` (f32 model)."""
    from lmdeploy_tpu.ops.moe import _moe_ffn_one
    rng = np.random.RandomState(5)
    E, H, Ie, k = 4, 64, 32, 2
    leaves_j, leaves_t = [], []
    for K, Nn in ((H, Ie), (H, Ie), (Ie, H)):
        w8n, w8t = _w8_weights(rng, (E, K, Nn))
        s = _scales(rng, (E, K // 32, Nn)) * 2 ** -2
        leaves_j.append({'w8': jnp.asarray(w8n), 'gscale': jnp.asarray(s)})
        leaves_t.append({'w8': w8t, 'gscale': torch.from_numpy(s)})
    xf = (rng.randn(N, H) * 2).astype(np.float32)
    top_idx = np.stack([rng.permutation(E)[:k] for _ in range(N)]).astype(np.int32)
    top_w = rng.rand(N, k).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        want = np.asarray(_moe_ffn_one(jnp.asarray(xf), jnp.asarray(top_idx),
                                       jnp.asarray(top_w), *leaves_j, jnp.float32))
    got = tmoe.moe_ffn(torch.from_numpy(xf), torch.from_numpy(top_idx),
                       torch.from_numpy(top_w), *leaves_t, torch.float32)
    tol = 1e-5 if N < tmoe.QUANT_RAGGED_MIN_TOKENS else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _kernel_weight(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """csrc/fp8_bmm.cu's weight, emulated in f32: the code's exponent and mantissa bits
    moved to f32 bits 20-26 and its sign to bit 31 read as decode(code) * 2^-120; times
    2^120, then times the scale, each product rounded to f32; then one rounding to bf16."""
    i = codes.to(torch.int64)
    bits = ((i & 0x7F) << 20) | ((i & 0x80) << 24)
    a = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)
    return ((a * 2.0 ** 120) * s).to(torch.bfloat16)


@pytest.mark.parametrize('scales', ['checkpoint', 'wide', 'edges'])
def test_kernel_decode_arithmetic_is_the_reference_decode(scales):
    """The kernel's bit-field decode times its scale gives, bit for bit, the reference's
    bf16(decode(w8) * s) for all 256 codes (subnormals, -0.0, the NaN code as +-480) and
    any f32 scale: checkpoint-like, spread over 60 decades, and the edges (the smallest
    subnormal, 256 and beyond, f32's largest).  This documents the arithmetic; the
    kernel's own decode is held against the plain version on the card by
    ``chip_smoke.fp8_groups_phase``."""
    rng = np.random.RandomState(5)
    if scales == 'checkpoint':
        s = _scales(rng, (64,))
    elif scales == 'wide':
        s = (10.0 ** rng.uniform(-30, 30, 64) * rng.choice([-1, 1], 64)).astype(np.float32)
    else:
        s = np.array([2.0 ** -149, 1e-38, 1.5e-5, 255.99, 256.0, 1e4, 3e38, -1.5],
                     dtype=np.float32)
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)[:, None]
    st = torch.from_numpy(s)[None, :]
    want = (decode_fp8_e4m3(codes) * st).to(torch.bfloat16)
    got = _kernel_weight(codes, st)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(torch.int16).numpy())
    assert got[0x7F].float().equal((480.0 * st[0]).to(torch.bfloat16).float())


@pytest.mark.parametrize('M,tile', [(1, 16), (16, 16), (17, 64), (64, 64), (65, 128),
                                    (128, 128), (767, 128)])
def test_fp8_token_tile(M, tile):
    """The fp8 kernel's token tile (its wgmma N) by M; larger M takes several tiles."""
    assert token_tile(M) == tile and tile in TOKEN_TILES
