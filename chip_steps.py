"""Time the int4 and TurboQuant narrow paged decodes with one part of their design taken
out at a time, on one CUDA card.

    python3 chip_steps.py [--cases e2e_shape_llama31 bs64_7b_heads bs64_tinyllama_heads]

Each step but `full` and `one_split` compiles an edited copy of the kernels' sources
(`lmdeploy_tpu_torch/csrc/` copied under `work_dir/steps/<step>/`, one part removed),
loads it in place of the package's library and times the wrappers
(`paged_decode_attention_int4` / `_turbo`, the split's combine included) at the named
cases of `chip_smoke.kv_decode_cases`, on caches filled as `decode_kv_phase` fills them:
  full            the committed kernels (held against the plain version);
  one_split       no split over pages (the split length above the table: one block a
                  row and kv head walks every page, no combine);
  block_barrier   a block barrier a sub-chunk besides each warp's own wait;
  loads_only      the ring streams every sub-chunk, nothing is computed on it;
  no_loads        only the ring's first stages are loaded, every sub-chunk computed;
  no_scores       no Q K^T products (the score decode and MMAs);
  no_pv           no P.V products (the V decode and MMAs).
The edited kernels give wrong outputs; their times only show what each part costs.
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

SOURCES = ('paged_decode_int4', 'paged_decode_turbo')
BOTH = tuple(s + '.cu' for s in SOURCES)
# (file, text, replacement) edits of each step; the text must be in the file
STEPS = {
    'full': (),
    'one_split': (),
    'block_barrier': tuple((f, '    __syncwarp();\n', '    __syncwarp();\n    __syncthreads();\n')
                           for f in BOTH),
    'loads_only': tuple((f, '    const int wt = warp * WT;         // the warp\'s first row of '
                            'the sub-chunk\n',
                         '    const int wt = warp * WT;\n    if (wt >= 0) continue;\n')
                        for f in BOTH),
    'no_loads': tuple((f, 'if (nx < ck.i_hi) load(nx, (nx - ck.i_lo) % NST);',
                       'if (false) load(nx, (nx - ck.i_lo) % NST);') for f in BOTH),
    'no_scores': tuple((f, 'for (int jj = 0; jj < D / 32; ++jj) {\n        const uint32_t w =',
                        'for (int jj = 0; jj < 0; ++jj) {\n        const uint32_t w =')
                       for f in BOTH),
    'no_pv': tuple((f, 'for (int u = 0; u < D / 64; ++u) {\n      const uint32_t x1',
                    'for (int u = 0; u < 0; ++u) {\n      const uint32_t x1') for f in BOTH),
}
SPLIT_CONST = {'paged_decode_int4': 'SPLIT_TOKENS_INT4',
               'paged_decode_turbo': 'SPLIT_TOKENS_TURBO'}


def build_steps(root: str) -> dict:
    """{step: {source: library path}}: each edited step compiled, all at once."""
    from lmdeploy_tpu_torch.ops import cuda_build
    shutil.rmtree(root, ignore_errors=True)
    procs, libs = {}, {}
    for step, edits in STEPS.items():
        if not edits:
            continue
        d = os.path.join(root, step)
        shutil.copytree(cuda_build.CSRC_DIR, d)
        for f, old, new in edits:
            path = os.path.join(d, f)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f'chip_steps: {step} finds no {old!r} in {f}')
            open(path, 'w').write(text.replace(old, new))
        for src in SOURCES:
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
        libs.setdefault(step, {})[src] = lib
    return libs


def main() -> int:
    import chip_smoke as c
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.ops import cuda_build
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    from lmdeploy_tpu_torch.ops.attention import fill_kv_cache
    from lmdeploy_tpu_torch.ops.kv_quant import hadamard_rotate
    cases = {case[0]: case for case in c.kv_decode_cases()}
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cases', nargs='+', choices=list(cases),
                    default=['e2e_shape_llama31', 'bs64_7b_heads', 'bs64_tinyllama_heads'])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_steps: no CUDA device available', file=sys.stderr)
        return 1
    cuda_build.build(SOURCES)
    libs = build_steps(os.path.join(ROOT, 'work_dir', 'steps'))
    gen = torch.Generator(device='cuda').manual_seed(c.SEED)
    BS, layer = 128, 1
    for label in args.cases:
        _, B, Hq, Hkv, D, lens, W, softcap, opts = cases[label]
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
        kvs = [(torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16(),
                torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16())
               for _ in range(2)]
        for policy, kernel in zip((8, 42), SOURCES):
            cache = c.new_kv_cache(model, NB, BS, policy, 'cuda')
            for lay, (k, v) in enumerate(kvs):
                fill_kv_cache(cache, k, v, slots, lay)
            q = (hadamard_rotate(q0) if policy == 42 else q0).to(opts.get('dtype', torch.bfloat16))
            wrapper, plain = c._kv_decode_fns(kernel)

            def kern():
                return wrapper(q, cache, tables, kv_lens, layer, D ** -0.5, Hkv,
                               logit_softcap=softcap)
            chosen = getattr(pd, SPLIT_CONST[kernel])
            package_lib = cuda_build.load(kernel)
            for step in STEPS:
                cuda_build._libs[kernel] = (ctypes.CDLL(libs[step][kernel]) if step in libs
                                            else package_lib)
                if step == 'one_split':
                    setattr(pd, SPLIT_CONST[kernel], 1 << 30)
                row = {'step': step, 'kernel': kernel, 'case': label,
                       'splits': pd.page_splits(W, BS, getattr(pd, SPLIT_CONST[kernel])),
                       'ms': c.time_ms(kern)}
                if step in ('full', 'one_split'):
                    ref = plain(q, cache, tables, kv_lens, layer, D ** -0.5, Hkv,
                                logit_softcap=softcap)
                    row['err_over_tol'] = c.compare(kern(), ref, c.KERNEL_TOL[kernel])[2]
                setattr(pd, SPLIT_CONST[kernel], chosen)
                print(json.dumps(row), flush=True)
            cuda_build._libs[kernel] = package_lib
            del cache
        del kvs
        torch.cuda.empty_cache()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
