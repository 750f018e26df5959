"""Plain PyTorch versions of the port's CUDA kernels against the JAX Pallas kernels.

The Pallas kernels run in TPU interpret mode on the CPU, as the JAX package's own
tests run them (tests/test_pallas_flash_prefill.py, tests/test_pallas_paged_decode.py).
The CUDA kernels themselves are held against these plain versions on the card by
chip_smoke.py.  Tolerance: f32 allclose at 2e-5 (the Pallas kernels use an online
softmax, the plain versions a one-pass softmax); f16 at 2e-3 (one f16 ulp of outputs
~1: the plain versions compute in f32 and round once, the Pallas kernels feed f16
operands and round P to f16); bf16 at 1e-2 (the Pallas kernel rounds P to bf16, the
plain version keeps it f32, as on the card, where flash_prefill is held at the same
1e-2 + 1e-2).  Besides the head dims 32 / 64 of the first slices the cases cover the
kernels' other served dims at one kv head (96, 256, and MLA's latent 576 with 16 query
heads on it), the GQA groups the CUDA kernels tile by (flash: G = 7 and 6, whose 128-row
blocks are not a whole number of positions; decode at D = 576: G = 32 and 128, more
heads than one 16-head block, as DeepSeek-V3's 128 over its latent head), and the
instructions the CUDA sources are built on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops.attention import kv_row_width
from lmdeploy_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                  flash_prefill_attention_plain)
from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                 paged_decode_attention_plain)
from lmdeploy_tpu_torch.weight_convert import cache_from_reference

TOL = dict(rtol=2e-5, atol=2e-5)
TOLS = {'float32': TOL, 'float16': dict(rtol=2e-3, atol=2e-3),
        'bfloat16': dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize('B,T,Hq,Hkv,D,dtype', [
    pytest.param(2, 128, 4, 2, 64, 'float32', id='2-128-4-2-64'),
    pytest.param(1, 256, 8, 1, 32, 'float32', id='1-256-8-1-32'),
    pytest.param(1, 128, 4, 1, 96, 'float32', id='1-128-4-1-96'),
    pytest.param(1, 64, 4, 1, 256, 'float32', id='1-64-4-1-256'),
    pytest.param(1, 64, 16, 1, 576, 'float32', id='1-64-16-1-576'),
    pytest.param(2, 64, 4, 1, 96, 'float16', id='2-64-4-1-96-f16'),
    pytest.param(1, 64, 16, 1, 576, 'float16', id='1-64-16-1-576-f16'),
    pytest.param(1, 128, 7, 1, 64, 'float32', id='1-128-7-1-64-g7'),
    pytest.param(2, 128, 12, 2, 128, 'float32', id='2-128-12-2-128-g6'),
    pytest.param(2, 128, 8, 2, 64, 'bfloat16', id='2-128-8-2-64-bf16')])
def test_flash_prefill_plain_matches_pallas(B, T, Hq, Hkv, D, dtype):
    from lmdeploy_tpu.ops.pallas.flash_prefill import flash_prefill_attention as jflash
    rng = np.random.RandomState(0)
    # numpy has no bf16: both sides round the same f32 draws
    npdt = np.float32 if dtype == 'bfloat16' else dtype
    q = rng.randn(B, T, Hq, D).astype(npdt)
    k = rng.randn(B, T, Hkv, D).astype(npdt)
    v = rng.randn(B, T, Hkv, D).astype(npdt)
    ref = np.asarray(jflash(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)), D ** -0.5,
                            tile_q=64, tile_k=64)).astype(np.float32)
    args = (*(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)), D ** -0.5)
    out = flash_prefill_attention_plain(*args)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), ref, **TOLS[dtype])
    # on a CPU tensor the wrapper takes the plain version and counts no launch
    before = flash_prefill_attention.launches
    np.testing.assert_allclose(flash_prefill_attention(*args).float().numpy(), ref,
                               **TOLS[dtype])
    assert flash_prefill_attention.launches == before


@pytest.mark.parametrize('opts,Hkv,G,D,dtype', [
    pytest.param({}, 2, 4, 64, 'float32', id='opts0'),
    pytest.param({'window': 40}, 2, 4, 64, 'float32', id='opts1'),
    pytest.param({'logit_softcap': 4.0}, 2, 4, 64, 'float32', id='opts2'),
    pytest.param({'sinks': True}, 2, 4, 64, 'float32', id='opts3'),
    pytest.param({'window': 23, 'logit_softcap': 2.5, 'sinks': True}, 2, 4, 64, 'float32',
                 id='opts4'),
    pytest.param({}, 1, 4, 96, 'float32', id='d96-g4'),
    pytest.param({'window': 40}, 1, 4, 256, 'float32', id='d256-g4-window'),
    pytest.param({}, 1, 16, 576, 'float32', id='d576-g16'),
    pytest.param({'sinks': True}, 1, 4, 576, 'float32', id='d576-g4-sinks'),
    pytest.param({}, 2, 4, 96, 'float16', id='d96-g4-f16'),
    pytest.param({}, 1, 16, 576, 'float16', id='d576-g16-f16'),
    pytest.param({}, 1, 32, 576, 'float32', id='d576-g32'),
    pytest.param({'lens': [1, 32, 0, 17, 30]}, 1, 128, 576, 'float32', id='d576-g128-2pages'),
    pytest.param({'bs': 8, 'window': 23, 'sinks': True}, 2, 4, 64, 'float32',
                 id='bs8-window-sinks'),
    pytest.param({'bs': 8}, 2, 4, 128, 'float16', id='bs8-d128-f16'),
])
def test_paged_decode_plain_matches_pallas(opts, Hkv, G, D, dtype):
    from lmdeploy_tpu.ops.pallas.paged_decode import paged_decode_attention as jdecode
    rng = np.random.RandomState(1)
    # block size 16 (6 pages a row), or the case's (as many pages as 96 tokens take)
    BS = opts.get('bs', 16)
    B, W = 5, 96 // BS
    L, layer, NB = 3, 1, max(40, 1 + B * W)
    _, hdp = kv_row_width(Hkv, D)
    cache = rng.randn(L, NB, 2, BS, hdp).astype(dtype)
    cache[..., Hkv * D:] = 0
    tables = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W).astype(np.int32)
    kv_lens = np.array(opts.get('lens', [1, 37, 0, 96, 64]), np.int32)   # row 2 inactive
    q = rng.randn(B, Hkv * G, D).astype(dtype)
    scale = D ** -0.5
    jopts, topts = {}, {}
    if 'window' in opts:
        jopts['window'] = topts['window'] = opts['window']
    if 'logit_softcap' in opts:
        jopts['logit_softcap'] = topts['logit_softcap'] = opts['logit_softcap']
    if opts.get('sinks'):
        sinks = rng.randn(Hkv * G).astype(np.float32)
        jopts['sinks'], topts['sinks'] = jnp.asarray(sinks), torch.from_numpy(sinks)
    ref = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tables),
                             jnp.asarray(kv_lens), jnp.int32(layer), scale, Hkv,
                             **jopts)).astype(np.float32)
    port_cache = cache_from_reference(cache, Hkv, D)
    assert port_cache.dtype == getattr(torch, dtype)
    out = paged_decode_attention_plain(torch.from_numpy(q), port_cache,
                                       torch.from_numpy(tables), torch.from_numpy(kv_lens),
                                       layer, scale, Hkv, **topts).float().numpy()
    # active rows match; an inactive row (kv_len 0) is zero in the port, while the
    # reference's row-batched program leaves it finite but filled from its
    # neighbours' pages (the engine discards that row either way)
    active = kv_lens > 0
    np.testing.assert_allclose(out[active], ref[active], **TOLS[dtype])
    assert np.all(out[~active] == 0) and np.isfinite(ref).all()
    before = paged_decode_attention.launches
    out2 = paged_decode_attention(torch.from_numpy(q), port_cache, torch.from_numpy(tables),
                                  torch.from_numpy(kv_lens), layer, scale, Hkv, **topts)
    np.testing.assert_array_equal(out2.float().numpy(), out)
    assert paged_decode_attention.launches == before


@pytest.mark.parametrize('dtype,BS,opts,splits', [
    pytest.param('bfloat16', 16, {'sinks': True}, 3, id='bf16-sinks'),
    pytest.param('float32', 16, {'window': 20, 'sinks': True}, 6, id='window-covers-splits'),
    pytest.param('float32', 8, {'window': 40, 'logit_softcap': 3.0}, 4, id='bs8-window'),
    pytest.param('float8_e4m3fn', 16, {'window': 30, 'sinks': True}, 2, id='fp8-window-sinks'),
    pytest.param('float16', 16, {}, None, id='f16-kernel-split'),
])
def test_paged_decode_split_plain_matches_unsplit(dtype, BS, opts, splits):
    """The narrow paths' two passes in plain PyTorch (each split's partials over its
    positions in the window, then the fixed-order combine with the sinks) equal the
    unsplit plain decode: with sinks, a window that covers whole splits (a split that
    lies wholly before the window's start holds nothing), rows shorter than one split
    and an inactive row; ``splits`` None takes the kernel's own split."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    rng = np.random.RandomState(5)
    B, Hkv, G, D = 5, 2, 4, 64
    W = 96 // BS
    cache = torch.from_numpy(rng.randn(2, 1 + B * W, 2, BS, Hkv * D).astype(np.float32))
    cache = cache.to(getattr(torch, dtype))
    tables = torch.from_numpy(rng.permutation(np.arange(1, 1 + B * W)).reshape(B, W)
                              .astype(np.int32))
    kv_lens = torch.tensor([1, 37, 0, 96, 64], dtype=torch.int32)
    q = torch.from_numpy(rng.randn(B, Hkv * G, D).astype(np.float32))
    q = q.to(torch.float16 if dtype == 'float16' else torch.float32)
    if opts.get('sinks'):
        opts = dict(opts, sinks=torch.from_numpy(rng.randn(Hkv * G).astype(np.float32)))
    ref = pd.paged_decode_attention_plain(q, cache, tables, kv_lens, 1, D ** -0.5, Hkv,
                                          **opts)
    out = pd.paged_decode_attention_split_plain(q, cache, tables, kv_lens, 1, D ** -0.5,
                                                Hkv, splits=splits, **opts)
    tol = TOL if q.dtype == torch.float32 else TOLS['float16']
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), **tol)
    assert torch.all(out[2] == 0)
    if opts.get('window'):
        # a split wholly before row 3's window start holds no position there
        n = -(-W // (splits or pd.page_splits(W, BS, pd.SPLIT_TOKENS_NARROW)))
        assert (96 - opts['window']) // BS >= n


def test_cuda_sources_present():
    """Each wrapper's kernel source is in the package, next to its build list."""
    import os

    from lmdeploy_tpu_torch.ops import cuda_build
    for name in cuda_build.SOURCES:
        path = os.path.join(cuda_build.CSRC_DIR, name + '.cu')
        src = open(path).read()
        assert 'extern "C"' in src and 'lmdeploy_tpu/ops/pallas/' in src
        assert cuda_build.lib_path(name).startswith(cuda_build.BUILD_DIR)


def test_kernel_head_dims_match_sources():
    """The head dims each wrapper admits are the ones its CUDA source instantiates
    (the int8 / int4 decodes every served dim, MLA's 576 through their wide paths;
    TurboQuant the powers of two; the context-parallel partial the dims up to 256), and
    the dims each sends to its tensor-core narrow body are the wrapper's (the int8 /
    int4 decodes MMA_QUANT_HEAD_DIMS, the context-parallel partial CP_MMA_HEAD_DIMS)."""
    import os
    import re

    from lmdeploy_tpu_torch.ops import cuda_build
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    from lmdeploy_tpu_torch.ops.flash_prefill import HEAD_DIMS

    def dims(name):
        src = open(os.path.join(cuda_build.CSRC_DIR, name + '.cu')).read()
        found = re.findall(r'(?:case|_CASE\()\s*(\d+)', src.split('}  // namespace')[-2]
                           + src.split('}  // namespace')[-1])
        return tuple(sorted({int(d) for d in found if int(d) >= 32}))
    assert HEAD_DIMS == (64, 80, 96, 128, 192, 256, 576)
    assert dims('flash_prefill') == HEAD_DIMS
    assert dims('paged_decode') == HEAD_DIMS
    assert dims('paged_decode_int8') == dims('paged_decode_int4') == pd.QUANT_HEAD_DIMS
    assert pd.QUANT_HEAD_DIMS == HEAD_DIMS
    assert dims('paged_decode_turbo') == pd.TURBO_HEAD_DIMS == (64, 128, 256)
    assert dims('paged_decode_cp') == pd.CP_HEAD_DIMS == (64, 80, 96, 128, 192, 256)

    def mma_dims(name):
        src = open(os.path.join(cuda_build.CSRC_DIR, name + '.cu')).read()
        return tuple(sorted({int(d) for d in re.findall(r'MMA_CASE\((\d+)\)', src)}))
    assert mma_dims('paged_decode_int8') == mma_dims('paged_decode_int4') \
        == pd.MMA_QUANT_HEAD_DIMS == (64, 128, 192, 256)
    assert mma_dims('paged_decode_cp') == pd.CP_MMA_HEAD_DIMS == (64, 128)
    assert set(pd.CP_MMA_HEAD_DIMS) <= set(pd.CP_HEAD_DIMS)


@pytest.mark.parametrize('source,kernel,uses', [
    pytest.param('flash_prefill', 'flash_wgmma_kernel',
                 (('wgmma.mma_async', 'issue_s<'), ('wgmma.mma_async', 'issue_pv<'),
                  ('cp.async.bulk.tensor', 'tma_load('), ('mbarrier.try_wait', 'mbar_wait('),
                  ('setmaxnreg', 'setmaxnreg')),
                 id='flash-wgmma-tma'),
    pytest.param('paged_decode', 'paged_decode_mma',
                 (('mma.sync.aligned.m16n8k16', 'Mma<T>::run('),
                  ('cp.async.cg.shared.global', 'load('),
                  ('cp.async.wait_group', 'cp.async.wait_group')),
                 id='decode-mma-cp-async'),
    pytest.param('paged_decode_int4', 'paged_decode_int4_mma',
                 (('mma.sync.aligned.m16n8k16', 'Mma<T>::run('),
                  ('mma.sync.aligned.m16n8k16', 'Mma<__nv_bfloat16>::run('),
                  ('cp.async.cg.shared.global', 'cp_async16('),
                  ('cp.async.wait_group', 'cp_wait<')),
                 id='int4-decode-mma-cp-async'),
    pytest.param('paged_decode_turbo', 'paged_decode_turbo_mma',
                 (('mma.sync.aligned.m16n8k16', 'Mma<T>::run('),
                  ('mma.sync.aligned.m16n8k16', 'Mma<__nv_bfloat16>::run('),
                  ('cp.async.cg.shared.global', 'cp_async16('),
                  ('cp.async.wait_group', 'cp_wait<')),
                 id='turbo-decode-mma-cp-async'),
    pytest.param('w4a16_gemm', 'w4a16_gd_kernel',
                 (('wgmma.mma_async', 'wgmma_rs<'), ('cp.async.bulk.tensor', 'tma_load('),
                  ('mbarrier.try_wait', 'mbar_wait('), ('prefetch.tensormap', 'prefetch_map(')),
                 id='w4a16-gd-wgmma-tma'),
    pytest.param('w4a16_gemm_szc', 'w4a16_fast_kernel',
                 (('wgmma.mma_async', 'wgmma_rs<'), ('cp.async.bulk.tensor', 'tma_load('),
                  ('wgmma.wait_group', 'wgmma_wait<1>'), ('fma.rn.bf16x2', 'weight_pair<')),
                 id='w4a16-fast-wgmma-tma'),
    pytest.param('w4a16_gemm_szc', 'w4a16_precise_kernel',
                 (('wgmma.mma_async', 'wgmma_rs<'), ('cp.async.bulk.tensor', 'tma_load('),
                  ('wgmma.wait_group', 'wgmma_wait<1>'), ('fma.rn.bf16x2', 'weight_pair<')),
                 id='w4a16-precise-wgmma-tma'),
    pytest.param('w4a16_gemm_unprepared', 'w4a16_unprepared_kernel',
                 (('wgmma.mma_async', 'wgmma_rs<'), ('cp.async.bulk.tensor', 'tma_load('),
                  ('mbarrier.try_wait', 'mbar_wait('), ('prefetch.tensormap', 'prefetch_map(')),
                 id='w4a16-unprepared-wgmma-tma'),
    pytest.param('fp8_bmm', 'fp8_bmm_kernel',
                 (('wgmma.mma_async', 'wgmma_rs<'), ('cp.async.bulk.tensor', 'tma_load('),
                  ('mbarrier.try_wait', 'mbar_wait('), ('cvt.rn.bf16x2.f32', 'fragment<')),
                 id='fp8-wgmma-tma'),
    pytest.param('mxfp4_bmm', 'mxfp4_bmm_kernel',
                 (('wgmma.mma_async', 'wgmma_rs<'), ('cp.async.bulk.tensor', 'tma_load('),
                  ('mbarrier.try_wait', 'mbar_wait('), ('cvt.rn.bf16x2.f32', 'fragment<'),
                  ('cp.async.bulk.tensor.4d', 'tma_load(')),
                 id='mxfp4-wgmma-tma'),
    pytest.param('paged_decode', 'paged_decode_narrow',
                 (('mma.sync.aligned.m16n8k16', 'Mma<T>::run('),
                  ('mma.sync.aligned.m16n8k16', 'Mma<__nv_bfloat16>::run('),
                  ('cp.async.cg.shared.global', 'cp_async16('),
                  ('cp.async.wait_group', 'cp_wait<'), ('__syncwarp', '__syncwarp(')),
                 id='narrow-decode-mma-cp-async'),
    pytest.param('paged_decode_int8', 'paged_decode_int8_mma',
                 (('mma.sync.aligned.m16n8k16', 'Mma<T>::run('),
                  ('mma.sync.aligned.m16n8k16', 'Mma<__nv_bfloat16>::run('),
                  ('cp.async.cg.shared.global', 'cp_async16('),
                  ('cp.async.ca.shared.global', 'cp_async4('),
                  ('cp.async.wait_group', 'cp_wait<'), ('__syncwarp', '__syncwarp(')),
                 id='int8-decode-mma-cp-async'),
    pytest.param('paged_decode_cp', 'paged_decode_cp_mma',
                 (('mma.sync.aligned.m16n8k16', 'Mma<T>::run('),
                  ('cp.async.cg.shared.global', 'cp_async16('),
                  ('cp.async.wait_group', 'cp_wait<'), ('__syncwarp', '__syncwarp(')),
                 id='cp-decode-mma-cp-async')])
def test_kernel_sources_use_hopper_paths(source, kernel, uses):
    """The bf16 / f16 flash kernel at D 64 / 128 runs both products on wgmma with its
    K / V tiles streamed by TMA into an mbarrier ring (a producer warpgroup that gives
    up registers); the paged decode's wide path over 2-byte pages runs both products on
    mma.sync with a cp.async page pipeline, and so do the int4 and TurboQuant narrow
    paths for a bf16 / f16 q (each code decoded once into an operand, P.V over the
    decoded V codes), and so does the narrow body over 2-byte, e4m3 and int8 pages and
    a context-parallel rank's stripe (each warp waiting for its own copies; the body
    lives in narrow_decode.cuh, which each kernel calls); the four W4A16 schedules,
    fp8_bmm and mxfp4_bmm run wgmma with the decoded weights as the register operand
    and x, words, scales by TMA (mxfp4_bmm's x by a 4-D map of its two halves; the
    W4A16 kernels share w4a16_gemm.cuh's body, whose fast / precise chain scales each
    weight by a bf16x2 FMA and keeps a unit of wgmmas in flight).  Each instruction is
    in the source or a header it includes, and the kernel's body reaches it; the
    dispatch launches the kernel."""
    import os
    import re

    from lmdeploy_tpu_torch.ops import cuda_build
    src = open(os.path.join(cuda_build.CSRC_DIR, source + '.cu')).read()
    # the source and the headers it includes, and those they include
    text, todo, seen = src, re.findall(r'#include "(\w+\.cuh)"', src), set()
    while todo:
        h = todo.pop()
        if h not in seen:
            seen.add(h)
            head = open(os.path.join(cuda_build.CSRC_DIR, h)).read()
            text += head
            todo += re.findall(r'#include "(\w+\.cuh)"', head)
    # the kernel's body: from its signature to the first brace that closes at column 0,
    # and the shared body's where the kernel calls one
    body = re.search(r'\n' + kernel + r'\(.*?\n}\n', src, re.S).group(0)
    for call, shared in (('ndec::narrow_body<', 'narrow_body'), ('w4a16::gemm_body<', 'gemm_body')):
        if call in body:
            body += re.search(r'\n' + shared + r'\(.*?\n}\n', text, re.S).group(0)
    for instruction, call in uses:
        assert instruction in text and call in body, (instruction, call)
    assert re.search(kernel + r'<[^>]*>\s*<<<', src), f'{kernel} is never launched'


def test_gemm_token_tiles_match_sources():
    """Every (group size, token tile) the W4A16 wrappers can pick (their shared body's
    dispatch, w4a16_gemm.cuh), and every token tile of the fp8 and MXFP4 expert GEMMs, is
    instantiated in its CUDA source, which picks the tile by M with the wrapper's
    thresholds."""
    import os
    import re

    from lmdeploy_tpu_torch.ops import cuda_build
    from lmdeploy_tpu_torch.ops import quant_matmul as qm

    def read(name, ext='.cu'):
        return open(os.path.join(cuda_build.CSRC_DIR, name + ext)).read()

    def picks(src, pattern, default):
        """The source's tile for each M: its `if (M <= t) return ...<tile>` chain."""
        chain = [(int(t), int(tile)) for t, tile in re.findall(pattern, src)]
        return lambda M: next((tile for t, tile in chain if M <= t), default)

    w4 = read('w4a16_gemm', '.cuh')
    groups = {int(g) for g, h in re.findall(
        r'case (\d+):\s*return \(int\)launch_m<KERNEL, (\d+)>', w4) if g == h}
    assert groups == set(qm.GROUP_SIZES) == {32, 64, 128}
    default = int(re.search(r'\n  return launch<KERNEL, GS, (\d+)>', w4).group(1))
    tile = picks(w4, r'if \(M <= (\d+)\)\s*return launch<KERNEL, GS, (\d+)>', default)
    tiles = {int(t) for t in re.findall(r'launch<KERNEL, GS, (\d+)>', w4)}
    assert tiles == set(qm.TOKEN_TILES)
    assert all(tile(M) == qm.token_tile(M) for M in range(1, qm.GROUP_DOT_MAX_M + 1))

    for name, arg in (('fp8_bmm', 'w8'), ('mxfp4_bmm', 'nib')):
        src = read(name)
        default = int(re.search(r'\n  return \(int\)launch<(\d+)>\(x, ' + arg, src).group(1))
        tile = picks(src, r'if \(M <= (\d+)\) return \(int\)launch<(\d+)>\(x, ' + arg,
                     default)
        tiles = {int(t) for t in re.findall(r'launch<(\d+)>\(x, ' + arg, src)}
        assert tiles == set(qm.TOKEN_TILES), name
        assert all(tile(M) == qm.token_tile(M) for M in range(1, 768)), name


def test_quant_decode_splits_match_sources():
    """The int8, int4 and TurboQuant wrappers split every call by ``page_splits`` (the
    narrow paths' SPLIT_TOKENS_INT8 / _INT4 / _TURBO tokens a split, the wide paths'
    SPLIT_TOKENS), and so does the context-parallel partial (``cp_splits``),
    and so does the plain-layout wrapper (its narrow paths' SPLIT_TOKENS_NARROW),
    and their sources take that split on every narrow path: each launch's grid is
    (.., B, splits) with ceil(W / splits) pages a split, and a split launch is followed
    by the combine that reads each row's non-empty splits.  The tensor-core bodies serve
    the head dims of MMA_QUANT_HEAD_DIMS (bf16 / f16 q), the CUDA-core ones the rest;
    each split is whole sub-chunks of the ring, and no split lies past the table."""
    import os
    import re

    from lmdeploy_tpu_torch.ops import cuda_build
    from lmdeploy_tpu_torch.ops import paged_decode as pd

    def read(name):
        return open(os.path.join(cuda_build.CSRC_DIR, name)).read()
    tc = int(re.search(r'constexpr int TC = (\d+);', read('quant_decode.cuh')).group(1))
    for name in ('paged_decode_int8', 'paged_decode_int4', 'paged_decode_turbo',
                 'paged_decode_cp'):
        src = read(name + '.cu')
        for kernel in (name + '_kernel', name + '_mma'):
            assert re.search(kernel + r'<[^>]*><<<dim3\([^;]*, B, splits\)', src), kernel
        assert src.count('const int split_pages = (W + splits - 1) / splits;') >= 2
        assert re.search(r'attn::decode_split_combine_(rows<|rank<<<)', src), name
    # a context-parallel rank's combine writes its unnormalized (acc, m, l) and finds a
    # row's splits by the kernel's own slot mapping (Positions)
    assert re.search(r'attn::decode_split_combine_rank<<<[^;]*split_pages, window, pos\);',
                     read('paged_decode_cp.cu'))
    assert 'pos.window(kv_lens[blockIdx.y], window, len, ws);' in read('decode_split.cuh')
    # the narrow paths over 2-byte and e4m3 pages: both bodies take the split, whole
    # sub-chunks of the same ring, and the combine applies the window and the sinks
    src = read('paged_decode.cu')
    for kernel in ('paged_decode_narrow_simt', 'paged_decode_narrow'):
        assert re.search(kernel + r'<[^>]*><<<dim3\([^;]*, B, splits\)', src), kernel
    assert src.count('const int split_pages = (W + splits - 1) / splits;') >= 4
    assert re.search(r'attn::decode_split_combine_rows<\w+><<<[^;]*split_pages, sinks,\s*'
                     r'window\);', src)
    assert pd.SPLIT_TOKENS_NARROW % tc == 0
    # the tensor-core narrow body takes bf16 / f16 q at D 64 / 128 and every block size;
    # its loads find each row's page (qdec::WarpRows: a build with one lookup a warp for
    # block sizes that are a multiple of 16, one with a lookup a row for the others)
    assert re.search(r'if constexpr \(!std::is_same<TQ, float>::value\) \{\s*'
                     r'if \(D == 64 \|\| D == 128\)\s*return', src)
    # (the body is narrow_decode.cuh's, which the int8 decode and the context-parallel
    # partial share: each kernel calls it)
    hdr = read('narrow_decode.cuh')
    body = hdr[hdr.index('\nnarrow_body(const Args& a)'):]
    assert 'WarpRows<ONE_PAGE> rows(tables + (long long)b * W, r0, BS, NB, layer,' in body
    assert 'BS %' not in body
    for name in ('narrow_decode.cuh', 'paged_decode_int4.cu', 'paged_decode_turbo.cu'):
        assert 'WarpRows<ONE_PAGE> rows(tables + (long long)b * W, r0, BS, NB, layer,' \
            in read(name), name
    for name in ('paged_decode.cu', 'paged_decode_int8.cu', 'paged_decode_int4.cu',
                 'paged_decode_turbo.cu'):
        assert read(name).count('BS % qdec::WT == 0') == 1, name   # the build picked at launch
    assert read('paged_decode_cp.cu').count('BSl % qdec::WT == 0') == 1
    for name, kernel, policy in (('paged_decode.cu', 'paged_decode_narrow', 'NarrowPages'),
                                 ('paged_decode_int8.cu', 'paged_decode_int8_mma',
                                  'ndec::PagesInt8'),
                                 ('paged_decode_cp.cu', 'paged_decode_cp_mma',
                                  'ndec::Pages16')):
        assert re.search(r'\n' + kernel + r'\(const ndec::Args a\) \{\n  ndec::narrow_body<T, '
                         + policy, read(name)), kernel
    assert 'slot(table, r0 + t, BS, NB, layer)' in read('quant_decode.cuh')
    for D in (64, 80, 96, 128):
        for dtype in (torch.bfloat16, torch.float16, torch.float8_e4m3fn):
            assert pd.narrow_split_tokens(D, dtype, 64) == pd.SPLIT_TOKENS_NARROW
            assert (pd.narrow_split_tokens(D, dtype, pd.NARROW_SMALL_BATCH)
                    == pd.SPLIT_TOKENS_NARROW // 2) and pd.SPLIT_TOKENS_NARROW // 2 % tc == 0
    assert pd.narrow_split_tokens(576, torch.bfloat16, 16) == pd.SPLIT_TOKENS_MMA
    assert pd.narrow_split_tokens(128, torch.float32, 16) == pd.SPLIT_TOKENS
    # a window whose pages fit one split takes one split; a longer one the table's
    tokens = pd.SPLIT_TOKENS_NARROW
    for BS in (16, 128):
        per = tokens // BS
        fits = BS * (per - 1)
        assert pd.plain_layout_splits(64, torch.bfloat16, 64, 129, BS, fits) == 1
        assert (pd.plain_layout_splits(64, torch.bfloat16, 64, 129, BS, fits + 1)
                == pd.plain_layout_splits(64, torch.bfloat16, 64, 129, BS)
                == pd.page_splits(129, BS, tokens) > 1)
    # a narrow table of 2 * SPLIT_TOKENS_NARROW positions at most takes one split, at
    # any batch; a wider one and the wide paths keep theirs
    for BS in (8, 128):
        per = tokens // BS
        for B in (8, 64):
            assert pd.plain_layout_splits(64, torch.bfloat16, B, 2 * per, BS) == 1
        assert pd.plain_layout_splits(128, torch.float8_e4m3fn, 64, 2 * per + 1, BS) == 3
    assert pd.plain_layout_splits(576, torch.bfloat16, 64, 16, 128) == pd.page_splits(
        16, 128, pd.SPLIT_TOKENS_MMA) == 2
    for name in ('paged_decode_int4.cu', 'paged_decode_int8.cu'):
        mma_dims = {int(d) for d in re.findall(r'MMA_CASE\((\d+)\)', read(name))}
        assert mma_dims == set(pd.MMA_QUANT_HEAD_DIMS) == {64, 128, 192, 256}, name
    assert {int(d) for d in re.findall(r'MMA_CASE\((\d+)\)', read('paged_decode_cp.cu'))} \
        == set(pd.CP_MMA_HEAD_DIMS) == {64, 128}
    assert set(pd.TURBO_HEAD_DIMS) <= set(pd.MMA_QUANT_HEAD_DIMS)
    for tokens in (pd.SPLIT_TOKENS_INT4, pd.SPLIT_TOKENS_TURBO, pd.SPLIT_TOKENS_INT8,
                   pd.SPLIT_TOKENS_INT8_SMALL, pd.SPLIT_TOKENS_CP):
        assert tokens % tc == 0
    for W in range(1, 130):
        for BS in (16, 64, 128):
            for tokens in (256, 512, 1024, 2048):
                splits = pd.page_splits(W, BS, tokens)
                n = -(-W // splits)
                assert 1 <= splits <= W and (splits - 1) * n < W <= splits * n
            assert pd.int4_splits(W, BS, 128) == pd.page_splits(W, BS, pd.SPLIT_TOKENS_INT4)
            assert pd.int4_splits(W, BS, 576) == pd.page_splits(W, BS, pd.SPLIT_TOKENS)
            assert pd.turbo_splits(W, BS) == pd.page_splits(W, BS, pd.SPLIT_TOKENS_TURBO)
            assert pd.int8_splits(W, BS, 128, 64) == pd.page_splits(W, BS,
                                                                     pd.SPLIT_TOKENS_INT8)
            assert pd.int8_splits(W, BS, 128, pd.INT8_SMALL_BATCH) == pd.page_splits(
                W, BS, pd.SPLIT_TOKENS_INT8_SMALL)
            assert pd.int8_splits(W, BS, 576, 16) == pd.page_splits(W, BS, pd.SPLIT_TOKENS)
            assert pd.cp_splits(W, BS, 128, torch.bfloat16) == pd.page_splits(
                W, BS, pd.SPLIT_TOKENS_CP)
            assert pd.cp_splits(W, BS, 128, torch.float32) == pd.cp_splits(
                W, BS, 96, torch.float16) == pd.page_splits(W, BS, pd.SPLIT_TOKENS)


def test_gemm_bodies_left_mma_sync():
    """No W4A16 GEMM and no fp8_bmm reaches an mma.sync body: none of their sources or
    the shared W4A16 header issues mma.sync, ldmatrix or cp.async, and the three W4A16
    sources (gd, fast / precise, unprepared) each include the shared wgmma header, which
    issues wgmma and reads x by TMA."""
    import os

    from lmdeploy_tpu_torch.ops import cuda_build

    def read(name):
        return open(os.path.join(cuda_build.CSRC_DIR, name)).read()
    w4 = ('w4a16_gemm.cu', 'w4a16_gemm_szc.cu', 'w4a16_gemm_unprepared.cu')
    for name in w4 + ('w4a16_gemm.cuh', 'fp8_bmm.cu'):
        src = read(name)
        assert 'mma.sync' not in src and 'ldmatrix' not in src, name
        assert 'cp.async.' not in src and 'cp_async' not in src, name
    for name in w4:
        assert '#include "w4a16_gemm.cuh"' in read(name), name
    head = read('w4a16_gemm.cuh')
    assert '#include "hopper.cuh"' in head and 'wgmma_rs<' in head and 'tma_load(' in head
    assert 'w4a16_gemm.cuh' not in read('fp8_bmm.cu')
