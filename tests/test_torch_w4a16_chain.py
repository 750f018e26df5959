"""The summation order of the fast / precise W4A16 kernel (``csrc/w4a16_gemm.cuh``,
``w4a16_gemm_szc.cu``) emulated on the CPU and held against the JAX package.

On the card the fast and precise schedules run one wgmma chain over every group and
plane of a K split: each k16 step adds x times the bf16-rounded ``(128 + q) * s``
weights (precise: ``(q - 7) * s``) into one f32 accumulator, while the correction
``sum_g xg * C`` is summed in f32 registers of its own.  Every 4096 rows of K the
chain is folded into the correction (corr -= acc) and restarts from zero; the split's
partial is acc - corr, and the splits are summed in split order.  At 128 tokens
(M > 64) the correction is instead subtracted from the accumulator after each
(group, plane).  Here that order is written out in f32 torch ops and held against the
Pallas kernel (``w4a16_matmul_stacked``'s fast / precise body, TPU interpret mode) and
against ``w4a16_matmul_szc_plain`` at the kernel allowance, 2e-3 + 1e-2 (the
``chip_smoke.py`` tolerance of ``w4a16_szc``), at group sizes 32 / 64 / 128 and
Mixtral-8x7B's K = 4096 (and 8192, two chains a split), where fast's correction is
~30x the output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops.pallas import quant_matmul as jqm
from lmdeploy_tpu_torch.ops import quant_matmul as tqm

ATOL, RTOL = 2e-3, 1e-2
FOLD_ROWS = 4096          # K rows a chain runs before it is folded into the correction


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def chain_order(x, packed, sb, corr, gs, splits):
    """The card kernel's f32 order for the fast / precise schedules -> f32 [M, N]."""
    precise = tqm.schedule_of(sb, corr) == 'precise'
    xb = x.to(torch.bfloat16).float()
    M, K = xb.shape
    w = tqm.dequant_w4_biased(packed, sb, gs, tqm.C135 if precise else 0.0).float()
    xg = tqm._xg(x.to(torch.bfloat16), gs)
    if precise:
        xg = xg.to(torch.bfloat16).float()
    cz = corr.float()
    G = K // gs
    Gq, Kq = G // 4, K // 4
    fold = FOLD_ROWS // (4 * gs)
    per_plane = M > 64                   # the 128-token tile
    out = torch.zeros(M, cz.shape[1])
    for s in range(splits):
        g_lo, g_hi = Gq * s // splits, Gq * (s + 1) // splits
        acc = torch.zeros_like(out)
        cr = torch.zeros_like(out)
        for wi, g in enumerate(range(g_lo, g_hi)):
            for j in range(4):
                r0, u = j * Kq + g * gs, j * Gq + g
                for k in range(r0, r0 + gs, 16):      # one wgmma k step
                    acc = acc + xb[:, k:k + 16] @ w[k:k + 16]
                term = xg[:, u:u + 1] * cz[u:u + 1]
                if per_plane:
                    acc = acc - term
                else:
                    cr = cr + term
            if not per_plane and wi % fold == fold - 1 and g + 1 < g_hi:
                cr = cr - acc
                acc = torch.zeros_like(out)
        out = out + (acc - cr)
    return out


@pytest.mark.parametrize('mode', ('fast', 'precise'))
@pytest.mark.parametrize('gs,K,M,splits', [(32, 4096, 8, 2), (64, 4096, 8, 2),
                                           (128, 4096, 8, 2), (128, 8192, 8, 1),
                                           (128, 4096, 72, 1)])
def test_chain_order_within_allowance(mode, gs, K, M, splits):
    rng = np.random.RandomState(11)
    N = 128
    w = jnp.asarray(rng.randn(K, N).astype(np.float32) * 0.02, jnp.bfloat16)
    jp, js, jz = jqm.quantize_w4(w, gs)
    jsb, jc = jqm.prep_w4(js, jz, mode=mode)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).bfloat16().float()
    pallas = torch.from_numpy(np.array(jqm.w4a16_matmul_stacked(
        jnp.asarray(x.numpy()), jp[None], jsb[None], jc[None], 0, group_size=gs)))
    packed, sb, corr = _t(jp), _t(jsb), _t(jc)
    plain = tqm.w4a16_matmul_szc_plain(x, packed, sb, corr, gs)
    emulated = chain_order(x, packed, sb, corr, gs, splits)
    for ref in (pallas, plain):
        err = (emulated - ref).abs() / (ATOL + RTOL * ref.abs())
        assert float(err.max()) <= 1.0, float(err.max())
    if mode == 'fast':
        # the cancellation the order has to survive: xg @ corr ~30x the output
        xg = tqm._xg(x.to(torch.bfloat16), gs)
        bias = (xg[:, :, None] * corr.float()[None]).sum(1)
        assert float(bias.abs().mean() / plain.abs().mean()) > 10
