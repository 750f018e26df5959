"""Time the redesigned kernels with one part of their design taken out at a time, on one
CUDA card: the int4, TurboQuant, int8, narrow (2-byte and e4m3 pages) and wide (2-byte
pages at D 192-576) paged decodes, the context-parallel partials, mxfp4_bmm, and the four
W4A16 GEMM schedules.

    python3 chip_steps.py [--kernels paged_decode_int4 paged_decode_turbo paged_decode
                           paged_decode_wide paged_decode_fp8 paged_decode_int8
                           paged_decode_cp mxfp4_bmm w4a16_gd w4a16_fast w4a16_precise
                           w4a16_unprepared]
                          [--cases CASE ...] [--q-scales X ...]

Each step but `full` and `one_split` compiles an edited copy of the kernels' sources
(`lmdeploy_tpu_torch/csrc/` copied under `work_dir/steps/<step>/`, one part removed),
loads it in place of the package's library and times the wrapper at its cases, the
decodes' split combine included (the context-parallel decode: both ranks' partials and
their combine).  The decodes run at cases of `chip_smoke.kv_decode_cases` (int4,
TurboQuant, e4m3; caches filled as `decode_kv_phase` fills them), of
`chip_smoke.decode_cases` (2-byte pages; a case's `q_scale`, or each of `--q-scales`,
multiplies its q), `int8_decode_cases` and `cp_decode_cases`;
mxfp4_bmm at rows of `chip_smoke.MX_SHAPES`.  The int8, 2-byte, e4m3 and context-parallel
decodes share narrow_decode.cuh's body, where their steps' edits are.  The decodes'
steps:
  full            the committed kernel (held against the plain version);
  one_split       no split over pages (the split length above the table: one block a
                  row and kv head walks every page, no combine);
  block_barrier   a block barrier a sub-chunk besides each warp's own wait;
  loads_only      the ring streams every sub-chunk, nothing is computed on it;
  no_loads        only the ring's first stages are loaded, every sub-chunk computed;
  no_decode       e4m3 and int8 pages: the codes go to the tensor cores undecoded;
  cvt_decode      int8 pages: the codes decoded through f32 (I2F and a pack) in place
                  of the magic numbers; its output is held against the plain version;
  no_scores       no Q K^T products (the score decode and MMAs);
  no_pv           no P.V products (the V decode and MMAs);
  p_once          2-byte pages only: P rounded once to the page type for P.V, as the
                  Pallas kernel does (pr.astype(v.dtype)), in place of hi + lo (one
                  product where there are two; the wide path's at D 192 / 256); its
                  output is held against the plain version like `full`'s.
mxfp4_bmm's steps:
  full            the committed kernel (held against the plain version);
  loads_only      the producer streams every stage, the consumers release it unread;
  no_loads        the producer issues no copy (each stage's barrier completes at once),
                  the consumers compute on the ring as it stands;
  no_decode       the code words go to the tensor cores undecoded;
  one_consumer    one consumer warpgroup a block (items of 128 columns);
  no_overlap      a ring of one stage, released after its last wgmma: the producer's
                  copy of a stage never overlaps the consumers' work.
The W4A16 GEMMs' steps, on their shared body (w4a16_gemm.cuh), each schedule through its
wrapper at rows of `chip_smoke.W4_MODE_SHAPES` (the wrapper's xg sums included):
  full            the committed kernel (held against the plain version);
  loads_only      the producers stream every stage, the consumers release it unread;
  no_loads        the producers issue no copy (each stage's barrier completes at once),
                  the consumers compute on the rings as they stand;
  no_decode       the packed words go to the tensor cores undecoded (fast / precise:
                  unscaled too);
  no_fold         gd only: no wait for a (group, plane)'s partial and no fold of it into
                  the running sum (the fragment registers' reuse still orders the wgmmas);
and, without an edit, the committed kernel's parts of a wrapper call:
  kernel_only     the C entry's launch alone, xg made before the timed call;
  xg_only         the wrapper's xg reduction alone (precise: rounded to bf16).
A `replay_floor` line first times a CUDA graph of one tiny kernel, the floor of every
time here (each is a graph replay between CUDA events, `chip_smoke.time_ms`).
The edited kernels but `p_once` and `cvt_decode` give wrong outputs; their times only
show what each part costs.
Prints one JSON line a (step, kernel, case), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# each kernel's source, the module constant of its split (None: no split), and the files
# its design's parts are in (the narrow decodes' shared body is narrow_decode.cuh's)
NARROW = 'narrow_decode.cuh'
WIDE = 'paged_decode.cu'
KERNELS = {'paged_decode_int4': ('paged_decode_int4', 'SPLIT_TOKENS_INT4',
                                 ('paged_decode_int4.cu',)),
           'paged_decode_turbo': ('paged_decode_turbo', 'SPLIT_TOKENS_TURBO',
                                  ('paged_decode_turbo.cu',)),
           'paged_decode': ('paged_decode', 'SPLIT_TOKENS_NARROW', (NARROW,)),
           'paged_decode_wide': ('paged_decode', 'SPLIT_TOKENS_MMA', (WIDE,)),
           'paged_decode_fp8': ('paged_decode', 'SPLIT_TOKENS_NARROW', (NARROW,)),
           'paged_decode_int8': ('paged_decode_int8', 'SPLIT_TOKENS_INT8', (NARROW,)),
           'paged_decode_cp': ('paged_decode_cp', 'SPLIT_TOKENS_CP', (NARROW,)),
           'mxfp4_bmm': ('mxfp4_bmm', None, ('mxfp4_bmm.cu',))}
# the W4A16 schedules: their wrapper's schedule, source and the shared body's file
W4 = 'w4a16_gemm.cuh'
W4_KERNELS = {'w4a16_gd': ('gd', 'w4a16_gemm'), 'w4a16_fast': ('fast', 'w4a16_gemm_szc'),
              'w4a16_precise': ('precise', 'w4a16_gemm_szc'),
              'w4a16_unprepared': ('unprepared', 'w4a16_gemm_unprepared')}
KERNELS.update({k: (src, None, (W4,)) for k, (_, src) in W4_KERNELS.items()})
QUANT = ('paged_decode_int4.cu', 'paged_decode_turbo.cu')
# (file, text, replacement) edits of each step; the text must be in the file
DECODE_STEPS = {
    'full': (),
    'one_split': (),
    'block_barrier': tuple((f, '    __syncwarp();\n', '    __syncwarp();\n    __syncthreads();\n')
                           for f in QUANT)
    + ((NARROW, '    __syncwarp();\n    const int nx = j + NST - 1;',
        '    __syncwarp();\n    __syncthreads();\n    const int nx = j + NST - 1;'),),
    'loads_only': tuple((f, '    const int wt = warp * WT;         // the warp\'s first row of '
                            'the sub-chunk\n',
                         '    const int wt = warp * WT;\n    if (wt >= 0) continue;\n')
                        for f in QUANT)
    + ((NARROW, '    if (lo >= hi) continue;\n    const uint8_t* stage',
        '    if (lo >= 0) continue;\n    const uint8_t* stage'),),
    'no_loads': tuple((f, 'if (nx < span.j_hi) load(nx, (nx - span.j_lo) % NST);',
                       'if (false) load(nx, (nx - span.j_lo) % NST);')
                      for f in QUANT + (NARROW,)),
    'no_decode': ((NARROW, '    return e4m3x2<T>(w >> (16 * hh));', '    return w >> (16 * hh);'),
                  (NARROW, '    return i8x2<T>(w, hh);', '    return w >> (16 * hh);')),
    'cvt_decode': tuple((NARROW, old, '  return attn::Mma<' + t + '>::pack((float)(int8_t)(w >> (16 * hh)),\n'
                                      '    (float)(int8_t)(w >> (16 * hh + 8)));\n')
                        for t, old in (
        ('__half', '  const uint32_t x = qdec::prmt(w ^ 0x80808080u, 0x64646464u, hh ? 0x4342u : '
                   '0x4140u);\n  return qdec::fma2<__half>(x, qdec::Bits<__half>::ONE, '
                   '0xE480E480u);\n'),
        ('__nv_bfloat16', '  const uint32_t x = qdec::prmt(w, 0x43434343u, hh ? 0x4342u : '
                          '0x4140u);\n  return qdec::fma2<__nv_bfloat16>(x, '
                          'qdec::lop3<qdec::AND_XOR>(x, 0x00800080u, 0x3F803F80u),\n'
                          '                                   qdec::lop3<qdec::AND_OR>(x, '
                          '0x00800080u, 0xC300C300u));\n'))),
    'no_scores': tuple((f, 'for (int jj = 0; jj < D / 32; ++jj) {\n        const uint32_t w =',
                        'for (int jj = 0; jj < 0; ++jj) {\n        const uint32_t w =')
                       for f in QUANT)
    + ((NARROW, 'for (int kc = 0; kc < D / 16; ++kc) {\n        uint32_t b0, b1;',
        'for (int kc = 0; kc < 0; ++kc) {\n        uint32_t b0, b1;'),),
    'no_pv': tuple((f, 'for (int u = 0; u < D / 64; ++u) {\n      const uint32_t x1',
                    'for (int u = 0; u < 0; ++u) {\n      const uint32_t x1') for f in QUANT)
    + ((NARROW, 'for (int u = 0; u < D / 64; ++u) {\n      if constexpr',
        'for (int u = 0; u < 0; ++u) {\n      if constexpr'),),
    'p_once': ((NARROW, '          attn::Mma<T>::run(o[u][n], va, ph[0], ph[1]);\n'
                        '          attn::Mma<T>::run(o[u][n], va, pl[0], pl[1]);\n',
                '          attn::Mma<T>::run(o[u][n], va, ph[0], ph[1]);\n'),
               (WIDE, 'constexpr bool mma_p_hi_lo() { return true; }',
                'constexpr bool mma_p_hi_lo() { return false; }')),
}
# the steps a kernel leaves out: the decode steps of the element types it does not read,
# and (int8, cp) the block barrier, which costs the narrow body 0.5-3% (PERF.md §6)
STEP_KERNELS = {'no_decode': ('paged_decode_fp8', 'paged_decode_int8'),
                'cvt_decode': ('paged_decode_int8',),
                'p_once': ('paged_decode', 'paged_decode_wide'),
                'block_barrier': ('paged_decode_int4', 'paged_decode_turbo', 'paged_decode',
                                  'paged_decode_fp8')}
MX = 'mxfp4_bmm.cu'
MXFP4_STEPS = {
    'full': (),
    'loads_only': (
        (MX, '      mbar_wait(smem_u32(&full[s]), (it / NST) & 1);\n',
         '      mbar_wait(smem_u32(&full[s]), (it / NST) & 1);\n'
         '      mbar_arrive(smem_u32(&empty[s]));\n      continue;\n'),
        (MX, '    fence_regs(acc1);\n    mbar_arrive(smem_u32(&empty[(it - 1) % NST]));\n',
         '    fence_regs(acc1);\n')),
    'no_loads': ((MX, '          mbar_expect_tx(bar, C::STAGE);\n',
                  '          mbar_arrive(bar);\n          continue;\n'),),
    'no_decode': ((MX, '  a[0] = scaled(e2m1x2<H>(pair<2 * T>(w[0], w[1])), s0);\n'
                       '  a[1] = scaled(e2m1x2<H>(pair<2 * T + 1>(w[0], w[1])), s1);\n'
                       '  a[2] = scaled(e2m1x2<H>(pair<2 * T>(w[2], w[3])), s0);\n'
                       '  a[3] = scaled(e2m1x2<H>(pair<2 * T + 1>(w[2], w[3])), s1);\n',
                   '  a[0] = pair<2 * T>(w[0], w[1]) >> (4 * H);\n'
                   '  a[1] = pair<2 * T + 1>(w[0], w[1]) >> (4 * H);\n'
                   '  a[2] = pair<2 * T>(w[2], w[3]) >> (4 * H);\n'
                   '  a[3] = pair<2 * T + 1>(w[2], w[3]) >> (4 * H);\n'),),
    'one_consumer': ((MX, 'constexpr int CWG = 2;', 'constexpr int CWG = 1;'),),
    'no_overlap': (
        (MX, 'static constexpr int NST = NST_FIT > 6 ? 6 : NST_FIT;',
         'static constexpr int NST = 1;'),
        (MX, '        if (kk == 0 && ks > 0) mbar_arrive(smem_u32(&empty[(it - 1) % NST]));\n'
             '      }\n    }\n    wgmma_wait<0>();\n    fence_regs(acc0);\n    fence_regs(acc1);\n'
             '    mbar_arrive(smem_u32(&empty[(it - 1) % NST]));\n',
         '      }\n      wgmma_wait<0>();\n      mbar_arrive(smem_u32(&empty[s]));\n    }\n'
         '    fence_regs(acc0);\n    fence_regs(acc1);\n')),
}
W4A16_STEPS = {
    'full': (),
    'loads_only': ((W4, '    const uint32_t wst = base + sw * C::W_STAGE;\n',
                    '    const uint32_t wst = base + sw * C::W_STAGE;\n'
                    '    if (wst) {\n      for (int j = 0; j < 4; ++j, ++xi) {\n'
                    '        mbar_wait(smem_u32(&full_x[xi % NX]), (xi / NX) & 1);\n'
                    '        release(&empty_x[xi % NX]);\n      }\n'
                    '      release(&empty_w[sw]);\n      continue;\n    }\n'),),
    'no_loads': ((W4, '        mbar_expect_tx(bw, C::W_TX);\n',
                  '        mbar_arrive(bw);\n        continue;\n'),
                 (W4, '          mbar_expect_tx(bx, C::X_TX);\n',
                  '          mbar_arrive(bx);\n          continue;\n')),
    'no_decode': ((W4, '  uint32_t v = ((w >> (4 * j)) & NIBBLES) | MAGIC;\n',
                   '  return w;\n  uint32_t v = w;\n'),),
    'no_fold': ((W4, '        wgmma_wait<0>();\n        fence_regs(part);\n'
                     '        const float s0 = ld_shared_f32(srow)',
                 '        if (false) {\n        const float s0 = ld_shared_f32(srow)'),
                (W4, '          }\n        release(&empty_x[sx]);\n',
                 '          }\n        }\n        release(&empty_x[sx]);\n')),
}
DECODE_CASES = {'paged_decode_int4': ['e2e_shape_llama31', 'bs64_7b_heads',
                                      'bs64_tinyllama_heads'],
                'paged_decode_turbo': ['e2e_shape_llama31', 'bs64_7b_heads',
                                       'bs64_tinyllama_heads'],
                'paged_decode_fp8': ['e2e_shape_llama31', 'bs64_tinyllama_heads'],
                'paged_decode': ['plain', 'e2e_long', 'gptoss_sliding',
                                 'rows_shorter_than_a_split', 'bs8'],
                'paged_decode_wide': ['gemma2_9b', 'd256_window', 'mla_v2_lite'],
                'paged_decode_int8': ['e2e_shape_7b', 'bs64_7b', 'bs64_tinyllama_heads'],
                'paged_decode_cp': ['e2e_cp2', 'e2e_cp4'],
                'mxfp4_bmm': ['gate_m64', 'down_m64', 'gate_m767']}
DECODE_CASES.update({k: ['mixtral_wqkv_m64', 'mixtral_wo_m64', '7b_wqkv_m128', '7b_w_down_m128']
                     for k in W4_KERNELS})


def steps_of(kernel: str) -> dict:
    if kernel == 'mxfp4_bmm':
        return MXFP4_STEPS
    if kernel in W4_KERNELS:
        return {k: v for k, v in W4A16_STEPS.items() if k != 'no_fold' or kernel == 'w4a16_gd'}
    files = KERNELS[kernel][2]
    return {step: tuple(e for e in edits if e[0] in files)
            for step, edits in DECODE_STEPS.items()
            if (step in ('full', 'one_split') or any(e[0] in files for e in edits))
            and kernel in STEP_KERNELS.get(step, (kernel,))}


def build_steps(root: str, kernels) -> dict:
    """{(step, source): library path}: each step's edits applied once to a copy of the
    sources, each source a kernel of the step needs compiled from it, all at once."""
    from lmdeploy_tpu_torch.ops import cuda_build
    shutil.rmtree(root, ignore_errors=True)
    wanted = {}
    for kernel in kernels:
        for step, edits in steps_of(kernel).items():
            if edits:
                sources, all_edits = wanted.setdefault(step, (set(), []))
                sources.add(KERNELS[kernel][0])
                all_edits += [e for e in edits if e not in all_edits]
    procs, libs = {}, {}
    for step, (sources, edits) in wanted.items():
        d = os.path.join(root, step)
        shutil.copytree(cuda_build.CSRC_DIR, d)
        for f, old, new in edits:
            path = os.path.join(d, f)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f'chip_steps: {step} finds no {old!r} in {f}')
            open(path, 'w').write(text.replace(old, new))
        for src in sorted(sources):
            lib = os.path.join(d, f'lib{src}.so')
            log = open(os.path.join(d, src + '.log'), 'w')
            procs[(step, src)] = (subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o', lib,
                 os.path.join(d, src + '.cu')], stdout=log, stderr=subprocess.STDOUT), log, lib)
    for (step, src), (proc, log, lib) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            raise SystemExit(f'chip_steps: nvcc failed on {step}/{src}.cu:\n'
                             + open(log.name).read()[-3000:])
        libs[(step, src)] = lib
    return libs


def kernel_cases(c, kernel, label, gen, q_scale=None):
    """(call, plain call, splits) of one case: the wrapper and its plain version on the
    case's seeded inputs, and the split of its rows' pages the wrapper takes now (None
    for mxfp4_bmm).  ``q_scale`` replaces a 2-byte decode case's own factor on q."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    from lmdeploy_tpu_torch.ops import quant_bmm as qb
    from lmdeploy_tpu_torch.ops.attention import fill_kv_cache
    from lmdeploy_tpu_torch.ops.kv_quant import hadamard_rotate
    if kernel in W4_KERNELS:
        from lmdeploy_tpu_torch.ops import quant_matmul as qm
        mode = W4_KERNELS[kernel][0]
        _, M, K, N = next(s for s in c.W4_MODE_SHAPES if s[0] == label)
        w = (torch.randn(K, N, device='cuda', generator=gen) * 0.02).bfloat16()
        packed, scales, zeros = qm.quantize_w4(w, 128)
        x = torch.randn(M, K, device='cuda', generator=gen).bfloat16()
        if mode == 'unprepared':
            ta, tb, kern, plain = scales, zeros, qm.w4a16_matmul, qm.w4a16_matmul_plain
        else:
            ta, tb = qm.prep_w4(scales, zeros, mode=mode)
            kern, plain = ((qm.w4a16_matmul_gd, qm.w4a16_matmul_gd_plain) if mode == 'gd'
                           else (qm.w4a16_matmul_szc, qm.w4a16_matmul_szc_plain))
        source = W4_KERNELS[kernel][1]
        symbol = 'w4a16_gemm_' + mode if source != 'w4a16_gemm_unprepared' else source

        def xg_of():
            return (qm._xg(x, 128, torch.bfloat16).float() if mode == 'precise'
                    else qm._xg(x, 128))
        xg = xg_of()

        def call():
            return kern(x, packed, ta, tb, 128)
        call.parts = {'kernel_only': lambda: qm._launch(source, symbol, x, packed, ta, tb, xg,
                                                        128, None),
                      'xg_only': xg_of}
        return (call, lambda: plain(x, packed, ta, tb, 128),
                lambda: qm.w4a16_splits(M, N, K // 128, torch.cuda.get_device_properties(0)
                                        .multi_processor_count))
    if kernel == 'mxfp4_bmm':
        _, kind, M, K = next(s for s in c.MX_SHAPES if s[0] == label)
        E, N = c.MX_E, c.MX_H
        nib = torch.randint(0, 256, (E, K // 2, N), generator=gen, device='cuda',
                            dtype=torch.uint8)
        scale = torch.exp2(torch.randint(-9, -4, (E, K // 32, N), generator=gen,
                                         device='cuda').float())
        x = torch.randn((M, K) if kind == 'gate' else (E, M, K), device='cuda',
                        generator=gen).bfloat16()
        return (lambda: qb.mxfp4_bmm(x, nib, scale),
                lambda: qb.mxfp4_bmm_plain(x, nib, scale), None)
    if kernel == 'paged_decode_int8':
        _, B, Hq, Hkv, D, lens, W, softcap, dtype = next(s for s in c.int8_decode_cases()
                                                        if s[0] == label)
        q, cache, tables, kv_lens = c._int8_decode_inputs(gen, B, Hq, Hkv, D, 128, W, lens,
                                                          dtype=dtype)
        return (lambda: pd.paged_decode_attention_int8(q, cache, tables, kv_lens, 1,
                                                       D ** -0.5, Hkv, logit_softcap=softcap),
                lambda: pd.paged_decode_attention_int8_plain(q, cache, tables, kv_lens, 1,
                                                             D ** -0.5, Hkv,
                                                             logit_softcap=softcap),
                lambda: pd.int8_splits(W, 128, D, B))
    if kernel == 'paged_decode_cp':
        from lmdeploy_tpu_torch.parallel.mesh import StripedKV, build_mesh
        _, cp, B, Hq, Hkv, D, lens, W, opts = next(s for s in c.cp_decode_cases()
                                                   if s[0] == label)
        opts = dict(opts)
        dtype = opts.pop('dtype', torch.bfloat16)
        q, cache, tables, kv_lens = c._decode_inputs(gen, B, Hq, Hkv, D, 128, W, lens,
                                                     dtype=dtype)
        if opts.get('sinks'):
            opts['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
        mesh = build_mesh(cp=cp, devices=['cuda:0'] * cp)
        kv = StripedKV.from_reference_layout(cache, mesh.cp_devices)
        return (lambda: pd.paged_decode_attention_cp(q, kv, tables, kv_lens, 1, D ** -0.5,
                                                     Hkv, mesh, **opts),
                lambda: c._cp_plain()(q, kv, tables, kv_lens, 1, D ** -0.5, Hkv, mesh,
                                      **opts),
                lambda: pd.cp_splits(W, 128 // cp, D, dtype))
    if kernel in ('paged_decode', 'paged_decode_wide'):
        _, B, Hq, Hkv, D, lens, W, opts = next(s for s in c.decode_cases() if s[0] == label)
        opts = dict(opts)
        BS = opts.pop('block_size', 128)
        dtype = opts.pop('dtype', torch.bfloat16)
        own_q_scale = opts.pop('q_scale', 1.0)
        scale_q = own_q_scale if q_scale is None else q_scale
        opts.pop('held_traps', None)
        q, cache, tables, kv_lens = c._decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens,
                                                     dtype=dtype)
        q = (q.float() * scale_q).to(dtype)
        if opts.get('sinks'):
            opts['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
        return (lambda: pd.paged_decode_attention(q, cache, tables, kv_lens, 1, D ** -0.5,
                                                  Hkv, **opts),
                lambda: pd.paged_decode_attention_plain(q, cache, tables, kv_lens, 1,
                                                        D ** -0.5, Hkv, **opts),
                lambda: pd.plain_layout_splits(D, cache.dtype, B, W, BS, opts.get('window')))
    _, B, Hq, Hkv, D, lens, W, softcap, opts = next(s for s in c.kv_decode_cases()
                                                    if s[0] == label)
    BS = opts.get('block_size', 128)
    NB = 1 + B * W
    tables = (torch.randperm(NB - 1, device='cuda', generator=gen) + 1)[:B * W]
    tables = tables.reshape(B, W).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
    tables[kv_lens < 0] = 0            # padding rows: block 0, one token
    kv_lens[kv_lens < 0] = 1
    tables = tables.contiguous()
    q0 = torch.randn(B, Hq, D, device='cuda', generator=gen)
    model = ModelConfig(num_layers=2, num_attention_heads=Hq, num_key_value_heads=Hkv,
                        hidden_size=Hq * D, intermediate_size=128, vocab_size=128,
                        head_dim=D, dtype='bfloat16')
    slots = torch.arange(BS, NB * BS, device='cuda')
    policy = {'paged_decode_int4': 8, 'paged_decode_turbo': 42, 'paged_decode_fp8': 16}[kernel]
    cache = c.new_kv_cache(model, NB, BS, policy, 'cuda')
    for lay in range(2):
        fill_kv_cache(cache, torch.randn(len(slots), Hkv, D, device='cuda',
                                         generator=gen).bfloat16(),
                      torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16(),
                      slots, lay)
    q = (hadamard_rotate(q0) if policy == 42 else q0).to(opts.get('dtype', torch.bfloat16))
    wrapper, plain = c._kv_decode_fns(kernel)

    def splits():
        if kernel == 'paged_decode_fp8':
            return pd.plain_layout_splits(D, cache.dtype, B, W, BS)
        return pd.page_splits(W, BS, getattr(pd, KERNELS[kernel][1]))
    return (lambda: wrapper(q, cache, tables, kv_lens, 1, D ** -0.5, Hkv,
                            logit_softcap=softcap),
            lambda: plain(q, cache, tables, kv_lens, 1, D ** -0.5, Hkv, logit_softcap=softcap),
            splits)


def _q_scales(c, kernel, label, scales):
    """The q factors a case runs at: each of ``scales`` for a 2-byte decode case that
    scales its q, else the case's own (None)."""
    if scales and kernel in ('paged_decode', 'paged_decode_wide') and 'q_scale' in next(
            s for s in c.decode_cases() if s[0] == label)[7]:
        return scales
    return [None]


def main() -> int:
    import chip_smoke as c
    from lmdeploy_tpu_torch.ops import cuda_build
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--kernels', nargs='+', choices=list(KERNELS), default=list(KERNELS))
    ap.add_argument('--cases', nargs='+', help='the cases of every kernel named (default: '
                    'each kernel\'s own list)')
    ap.add_argument('--q-scales', nargs='+', type=float,
                    help='2-byte decode cases with a q_scale of their own run at each of '
                    'these instead')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_steps: no CUDA device available', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build(sorted({KERNELS[k][0] for k in args.kernels}))
    libs = build_steps(os.path.join(ROOT, 'work_dir', 'steps'), args.kernels)
    gen = torch.Generator(device='cuda').manual_seed(c.SEED)
    tiny = torch.zeros(8, device='cuda')
    print(json.dumps({'step': 'replay_floor', 'ms': c.time_ms(lambda: tiny.add_(1))}), flush=True)
    for kernel in args.kernels:
        source, const, _ = KERNELS[kernel]
        tol = c.KERNEL_TOL[c.W4_KERNEL_OF[W4_KERNELS[kernel][0]] if kernel in W4_KERNELS
                           else source if kernel == 'paged_decode_wide' else kernel]
        package_lib = cuda_build.load(source)
        for label, q_scale in [(label, q) for label in args.cases or DECODE_CASES[kernel]
                               for q in _q_scales(c, kernel, label, args.q_scales)]:
            kern, plain, splits = kernel_cases(c, kernel, label, gen, q_scale)
            chosen = getattr(pd, const) if const else None
            for step in steps_of(kernel):
                cuda_build._libs[source] = (ctypes.CDLL(libs[(step, source)])
                                            if (step, source) in libs else package_lib)
                if step == 'one_split':
                    setattr(pd, const, 1 << 30)
                row = {'step': step, 'kernel': kernel, 'case': label, 'ms': c.time_ms(kern)}
                if q_scale is not None:
                    row['q_scale'] = q_scale
                if splits:
                    row['splits'] = splits()
                if step in ('full', 'one_split', 'p_once', 'cvt_decode'):
                    row['err_over_tol'] = c.compare(kern(), plain(), tol)[2]
                if const:
                    setattr(pd, const, chosen)
                print(json.dumps(row), flush=True)
            cuda_build._libs[source] = package_lib
            for part, fn in getattr(kern, 'parts', {}).items():
                print(json.dumps({'step': part, 'kernel': kernel, 'case': label,
                                  'ms': c.time_ms(fn)}), flush=True)
            del kern, plain
            torch.cuda.empty_cache()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
