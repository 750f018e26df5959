"""Compare two trees of this repository end to end on one card, in turns.

    python3 chip_ab.py PARENT_DIR [--cells deepseek tinyllama] [--pairs 2]

PARENT_DIR is an unpacked copy of another commit (for example `git archive <commit> |
tar -x -C work_dir/parent`, under a directory .gitignore lists).  Each pair runs the
parent, then this tree, then this tree, then the parent (one process each, so each
builds and loads its own kernels) and prints one JSON line per run with each cell's
decode tok/s, TTFT and device busy share, then the card's name and power limit.  The
cells are `chip_smoke.py`'s e2e phases: 'deepseek' (e2e_deepseek_v2_lite_fp8) and
'tinyllama' (e2e).  Needs a CUDA card; host-side numbers of one cell spread between
calls, so compare only runs of one call.
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
    'tinyllama': ("c.e2e_phase('e2e', c.tinyllama_config(), 64, 0, 8, {'flash_prefill': "
                  "(22, 0), 'paged_decode': (0, 22)}, card)"),
}
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


def run(tree: str, cells: dict) -> dict:
    proc = subprocess.run([sys.executable, '-c', RUN % cells], cwd=tree,
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
    ap.add_argument('--cells', nargs='+', default=list(CELLS), choices=list(CELLS))
    ap.add_argument('--pairs', type=int, default=1)
    args = ap.parse_args()
    cells = {name: CELLS[name] for name in args.cells}
    for pair in range(args.pairs):
        for side, tree in (('parent', args.parent), ('change', ROOT), ('change', ROOT),
                           ('parent', args.parent)):
            print(json.dumps({'pair': pair, 'side': side, **run(tree, cells)}), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
