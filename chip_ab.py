"""Compare two trees of this repository end to end, or kernel by kernel, on one card, in
turns.

    python3 chip_ab.py PARENT_DIR [--cells deepseek w4a16_kv8 tinyllama gemma2_9b] [--pairs 2]
    python3 chip_ab.py PARENT_DIR --kernels [--kernel-sets w4a16_gemm w4a16_modes fp8_bmm
                       kv_decode mxfp4_bmm narrow_decode cp_decode] [--pairs 1]

PARENT_DIR is an unpacked copy of another commit (for example `git archive <commit> |
tar -x -C work_dir/parent`) or a copy of this tree with one edit, under a directory
.gitignore lists.  Each pair runs the
parent, then this tree, then this tree, then the parent (one process each, so each
builds and loads its own kernels) and prints one JSON line per run with each cell's
decode tok/s, TTFT and device busy share, then the card's name and power limit.  The
cells are `chip_smoke.py`'s e2e phases: 'deepseek' (e2e_deepseek_v2_lite_fp8),
'w4a16_kv8' (e2e_w4a16_kv8: llama2-7b W4A16 gd with the int8 KV cache) and 'tinyllama'
(e2e), the default three, and 'gemma2_9b' (e2e_gemma2_9b, untraced; both trees need the
dense cells' `chip_smoke.dense_config`).  With --kernels each run instead times its
tree's w4a16_gemm (gd), fp8_bmm and
mxfp4_bmm wrappers at every row shape of this tree's `chip_smoke.py` (W4_SHAPES,
FP8_SHAPES, MX_SHAPES), its fast / precise (w4a16_matmul_szc) and unprepared
(w4a16_matmul) W4A16 wrappers at every W4_MODE_SHAPES case (`w4a16_modes`), its paged_decode_attention_int4 / _turbo wrappers at every case
of this tree's `chip_smoke.kv_decode_cases` and its paged_decode_attention_int8 at every
case of `int8_decode_cases` (`kv_decode`; caches filled by the tree's own fill, from
the same seeded K / V), its narrow paged decode (`narrow_decode`:
paged_decode_attention over 2-byte pages at `chip_smoke.decode_cases`' cases up to D 128,
paged_decode_attention_fp8 at the e4m3 cases of `kv_decode_cases`, each e4m3 cache
filled by the tree's own fill) and its context-parallel decode (`cp_decode`:
paged_decode_attention_cp, both ranks' partials and the combine, at
`chip_smoke.cp_decode_cases`), on the same seeded data (--kernel-sets picks among the
seven), and the last JSON line holds each side's mean per row.  Needs a
CUDA card; host-side numbers of one cell spread between calls, so compare only runs of
one call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CELLS = {
    'deepseek': 'c.deepseek_e2e_phase(card)',
    'w4a16_kv8': ("c.e2e_phase('e2e_w4a16_kv8', c.llama7b_w4_config(), 128, 4, 64, "
                  "{'flash_prefill': (32, 0), 'paged_decode_int8': (0, 32), "
                  "'w4a16_gemm': (0, 128)}, card)"),
    'tinyllama': ("c.e2e_phase('e2e', c.tinyllama_config(), 64, 0, 8, {'flash_prefill': "
                  "(22, 0), 'paged_decode': (0, 22)}, card)"),
    'gemma2_9b': ("c.e2e_phase('e2e_gemma2_9b', c.dense_config('gemma2_9b', c.LDENSE), 64, 0, "
                  "63, {'paged_decode': (0, c.LDENSE)}, card, short_len=256, long_len=6144, "
                  "exact=True, new_tokens=32, forbid=('flash_prefill',), trace=False)"),
}
DEFAULT_CELLS = ('deepseek', 'w4a16_kv8', 'tinyllama')
RUN = '''
import json, sys, chip_smoke as c
info = c.device_phase()
card = info['nvidia_smi']
c.build_phase()
out = {}
for name, call in %r.items():
    row = eval(call)
    out[name] = {k: row[k] for k in ('decode_tok_s', 'ttft_ms', 'wall_s')}
print('AB ' + json.dumps(out), flush=True)
'''
KERNEL_RUN = '''
import json, numpy as np, torch, chip_smoke as c
from lmdeploy_tpu_torch.config import ModelConfig
from lmdeploy_tpu_torch.models.llama import init_fp8_leaf
from lmdeploy_tpu_torch.ops import paged_decode as pd, quant_bmm as qb, quant_matmul as qm
from lmdeploy_tpu_torch.ops.attention import fill_kv_cache
from lmdeploy_tpu_torch.ops.kv_quant import hadamard_rotate
gen = torch.Generator(device='cuda').manual_seed(c.SEED)
sets = %r
out = {k: {} for k in sets}
for label, M, K, N in (%r if 'w4a16_gemm' in sets else ()):
    w = (torch.randn(K, N, device='cuda', generator=gen) * 0.02).bfloat16()
    packed, scales, zeros = qm.quantize_w4(w, 128)
    sb, corr = qm.prep_w4(scales, zeros, mode='gd')
    x = torch.randn(M, K, device='cuda', generator=gen).bfloat16()
    out['w4a16_gemm'][label] = c.time_ms(lambda: qm.w4a16_matmul_gd(x, packed, sb, corr, 128))
for label, M, K, N in (%r if 'w4a16_modes' in sets else ()):
    w = (torch.randn(K, N, device='cuda', generator=gen) * 0.02).bfloat16()
    packed, scales, zeros = qm.quantize_w4(w, 128)
    x = torch.randn(M, K, device='cuda', generator=gen).bfloat16()
    for mode in ('fast', 'precise'):
        sb, corr = qm.prep_w4(scales, zeros, mode=mode)
        out['w4a16_modes'][mode + '/' + label] = c.time_ms(
            lambda: qm.w4a16_matmul_szc(x, packed, sb, corr, 128))
    out['w4a16_modes']['unprepared/' + label] = c.time_ms(
        lambda: qm.w4a16_matmul(x, packed, scales, zeros, 128))
    del w, packed, scales, zeros
stacks = {}
for label, (E, H, Ie), kind, M in (%r if 'fp8_bmm' in sets else ()):
    K, N = (H, Ie) if kind == 'gate' else (Ie, H)
    if (E, K, N) not in stacks:
        stacks.clear()
        torch.cuda.empty_cache()
        stacks[(E, K, N)] = (init_fp8_leaf('w8', (E, K, N), gen, 'cuda'),
                             init_fp8_leaf('gscale', (E, K // 128, N), gen, 'cuda'))
    w8, gs = stacks[(E, K, N)]
    x = torch.randn((M, K) if kind == 'gate' else (E, M, K), device='cuda',
                    generator=gen).bfloat16()
    out['fp8_bmm'][label] = c.time_ms(lambda: qb.fp8_bmm(x, w8, gs))
stacks.clear()
BS = 128
for label, B, Hq, Hkv, D, lens, W, softcap, dtype, kernels in (%r if 'kv_decode' in sets
                                                              else ()):
    NB = 1 + B * W
    perm = torch.randperm(NB - 1, device='cuda', generator=gen) + 1
    tables = perm[:B * W].reshape(B, W).int()
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
    for policy, kernel in ((4, 'int8'), (8, 'int4'), (42, 'turbo')):
        if 'paged_decode_' + kernel not in kernels:
            continue
        cache = c.new_kv_cache(model, NB, BS, policy, 'cuda')
        for lay, (k, v) in enumerate(kvs):
            fill_kv_cache(cache, k, v, slots, lay)
        q = (hadamard_rotate(q0) if policy == 42 else q0).to(getattr(torch, dtype))
        fn = getattr(pd, 'paged_decode_attention_' + kernel)
        out['kv_decode'][f'{kernel}/{label}'] = c.time_ms(
            lambda: fn(q, cache, tables, kv_lens, 1, D ** -0.5, Hkv, logit_softcap=softcap))
        del cache
    del kvs
    torch.cuda.empty_cache()
for label, kind, M, K in (%r if 'mxfp4_bmm' in sets else ()):
    E, N = c.MX_E, c.MX_H
    if K not in stacks:
        stacks.clear()
        torch.cuda.empty_cache()
        stacks[K] = (torch.randint(0, 256, (E, K // 2, N), generator=gen, device='cuda',
                                   dtype=torch.uint8),
                     torch.exp2(torch.randint(-9, -4, (E, K // 32, N), generator=gen,
                                              device='cuda').float()))
    nib, scale = stacks[K]
    x = torch.randn((M, K) if kind == 'gate' else (E, M, K), device='cuda',
                    generator=gen).bfloat16()
    out['mxfp4_bmm'][label] = c.time_ms(lambda: qb.mxfp4_bmm(x, nib, scale))
stacks.clear()
for label, B, Hq, Hkv, D, lens, W, opts in (%r if 'narrow_decode' in sets else ()):
    opts = dict(opts)
    BS = opts.pop('block_size', 128)
    q, cache, tables, kv_lens = c._decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens,
                                                 dtype=getattr(torch, opts.pop('dtype')))
    if opts.pop('sinks', False):
        opts['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
    out['narrow_decode'][label] = c.time_ms(
        lambda: pd.paged_decode_attention(q, cache, tables, kv_lens, 1, D ** -0.5, Hkv,
                                          **opts))
    del q, cache
for label, B, Hq, Hkv, D, lens, W, softcap, opts in (%r if 'narrow_decode' in sets
                                                     else ()):
    BS = opts.get('block_size', 128)
    NB = 1 + B * W
    tables = (torch.randperm(NB - 1, device='cuda', generator=gen) + 1)[:B * W]
    tables = tables.reshape(B, W).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
    tables[kv_lens < 0] = 0            # padding rows: block 0, one token
    kv_lens[kv_lens < 0] = 1
    tables = tables.contiguous()
    q = torch.randn(B, Hq, D, device='cuda', generator=gen).to(getattr(torch, opts['dtype']))
    extra = {'window': opts['window']} if 'window' in opts else {}
    if opts.get('sinks'):
        extra['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
    model = ModelConfig(num_layers=2, num_attention_heads=Hq, num_key_value_heads=Hkv,
                        hidden_size=Hq * D, intermediate_size=128, vocab_size=128,
                        head_dim=D, dtype='bfloat16')
    slots = torch.arange(BS, NB * BS, device='cuda')
    cache = c.new_kv_cache(model, NB, BS, 16, 'cuda')
    for lay in range(2):
        fill_kv_cache(cache, torch.randn(len(slots), Hkv, D, device='cuda',
                                         generator=gen).bfloat16(),
                      torch.randn(len(slots), Hkv, D, device='cuda', generator=gen).bfloat16(),
                      slots, lay)
    out['narrow_decode']['fp8/' + label] = c.time_ms(
        lambda: pd.paged_decode_attention_fp8(q, cache, tables, kv_lens, 1, D ** -0.5, Hkv,
                                              logit_softcap=softcap, **extra))
    del cache
    torch.cuda.empty_cache()
for label, cp, B, Hq, Hkv, D, lens, W, opts in (%r if 'cp_decode' in sets else ()):
    from lmdeploy_tpu_torch.parallel.mesh import StripedKV, build_mesh
    opts = dict(opts)
    q, cache, tables, kv_lens = c._decode_inputs(gen, B, Hq, Hkv, D, 128, W, lens,
                                                 dtype=getattr(torch, opts.pop('dtype')))
    if opts.pop('sinks', False):
        opts['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
    mesh = build_mesh(cp=cp, devices=['cuda:0'] * cp)
    kv = StripedKV.from_reference_layout(cache, mesh.cp_devices)
    out['cp_decode'][label] = c.time_ms(
        lambda: pd.paged_decode_attention_cp(q, kv, tables, kv_lens, 1, D ** -0.5, Hkv, mesh,
                                             **opts))
    del q, cache, kv
    torch.cuda.empty_cache()
print('AB ' + json.dumps(out), flush=True)
'''
KERNEL_SETS = ('w4a16_gemm', 'w4a16_modes', 'fp8_bmm', 'kv_decode', 'mxfp4_bmm',
               'narrow_decode', 'cp_decode')


def run(tree: str, code: str) -> dict:
    proc = subprocess.run([sys.executable, '-c', code], cwd=tree,
                          capture_output=True, text=True)
    busy = [json.loads(ln)['device_busy_share'] for ln in proc.stdout.splitlines()
            if ln.startswith('{') and '"device_busy_share"' in ln]
    for ln in proc.stdout.splitlines():
        if ln.startswith('AB '):
            res = json.loads(ln[3:])
            for name, b in zip(res, busy):
                res[name]['device_busy_share'] = b
            return res
    raise SystemExit(f'{tree}: run failed (exit {proc.returncode})\n'
                     f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('parent')
    ap.add_argument('--cells', nargs='+', default=list(DEFAULT_CELLS), choices=list(CELLS))
    ap.add_argument('--kernels', action='store_true')
    ap.add_argument('--kernel-sets', nargs='+', default=list(KERNEL_SETS),
                    choices=list(KERNEL_SETS))
    ap.add_argument('--pairs', type=int, default=1)
    args = ap.parse_args()
    if args.kernels:
        import chip_smoke
        kv_cases = [(label, B, Hq, Hkv, D, [int(n) for n in lens], W, softcap,
                     str(opts.get('dtype', 'torch.bfloat16')).split('.')[-1],
                     list(opts.get('kernels', ('paged_decode_int4', 'paged_decode_turbo'))))
                    for label, B, Hq, Hkv, D, lens, W, softcap, opts
                    in chip_smoke.kv_decode_cases()]
        # the int8 decode at its own cases
        kv_cases += [(label, B, Hq, Hkv, D, [int(n) for n in lens], W, softcap,
                      str(dtype).split('.')[-1], ['paged_decode_int8'])
                     for label, B, Hq, Hkv, D, lens, W, softcap, dtype
                     in chip_smoke.int8_decode_cases()]
        cp = [(label, cp, B, Hq, Hkv, D, [int(n) for n in lens], W,
               dict(opts, dtype=str(opts.get('dtype', 'torch.bfloat16')).split('.')[-1]))
              for label, cp, B, Hq, Hkv, D, lens, W, opts in chip_smoke.cp_decode_cases()]
        # the narrow decode's cases: decode_phase's over 2-byte pages up to D 128 (bf16 /
        # f16 q), decode_kv_phase's e4m3 ones
        narrow = []
        for label, B, Hq, Hkv, D, lens, W, opts in chip_smoke.decode_cases():
            dtype = str(opts.get('dtype', 'torch.bfloat16')).split('.')[-1]
            if D <= 128 and dtype != 'float32':
                narrow.append((label, B, Hq, Hkv, D, [int(n) for n in lens], W,
                               dict(opts, dtype=dtype)))
        fp8 = [(label, B, Hq, Hkv, D, [int(n) for n in lens], W, softcap,
                {k: v for k, v in dict(opts, dtype=str(opts.get('dtype', 'torch.bfloat16'))
                                       .split('.')[-1]).items() if k != 'kernels'})
               for label, B, Hq, Hkv, D, lens, W, softcap, opts in chip_smoke.kv_decode_cases()
               if 'paged_decode_fp8' in opts.get('kernels', ('paged_decode_fp8',))]
        code = KERNEL_RUN % (tuple(args.kernel_sets), chip_smoke.W4_SHAPES,
                             chip_smoke.W4_MODE_SHAPES, chip_smoke.FP8_SHAPES, kv_cases, chip_smoke.MX_SHAPES, narrow,
                             fp8, cp)
    else:
        code = RUN % {name: CELLS[name] for name in args.cells}
    runs = []
    for pair in range(args.pairs):
        for side, tree in (('parent', args.parent), ('change', ROOT), ('change', ROOT),
                           ('parent', args.parent)):
            runs.append({'pair': pair, 'side': side, **run(tree, code)})
            print(json.dumps(runs[-1]), flush=True)
    if args.kernels:
        mean = {side: {k: {label: sum(r[k][label] for r in runs if r['side'] == side)
                           / sum(r['side'] == side for r in runs) for label in rows}
                       for k, rows in runs[0].items() if k not in ('pair', 'side')}
                for side in ('parent', 'change')}
        print(json.dumps({'mean_ms': mean}), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
