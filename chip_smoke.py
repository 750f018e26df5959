"""Smoke test of the PyTorch/CUDA port (lmdeploy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py       # needs one CUDA card

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   -- card name, power limit and count;
  2. build    -- nvcc builds every kernel of the port from csrc/ (one process per source);
  3. kernels  -- each kernel against its plain PyTorch version on the card, in bf16,
                 with its time, the plain version's time, the card's bound for the
                 same work and, where one PyTorch call computes the same function,
                 that call's time;
  4. e2e      -- the port's Engine at TinyLlama-1.1B width and depth (random seeded
                 bf16 weights): 8 concurrent 128-token prompts plus one 2048-token
                 prompt, 64 greedy tokens each, run twice; every kernel's launch count
                 is read from the first run; then a traced run (device busy share);
  5. parity   -- full width, 2 layers: prefill logits and 8 decode steps on the card
                 (bf16, kernels) against the port on the CPU (f32, plain paths).
The line before the last lists every kernel; the last line is the result.
It imports nothing of jax or lmdeploy_tpu.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data sheet (dense): bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# kernel vs plain, elementwise |out - ref| <= atol + rtol * |ref|, per kernel.  Both
# sides accumulate in f32 and write bf16, so they may differ by one bf16 ulp (2^-8 to
# 2^-7 of |ref|): paged_decode allows just that.  flash_prefill also rounds P to bf16
# for the P.V product, as the TPU kernel does (_flash_kernel's p.astype(v.dtype)),
# where the plain version keeps P in f32: its outputs (|ref| up to ~2) differ by up
# to two ulps, and the allowance is 1e-2 absolute on top
KERNEL_TOL = {'flash_prefill': {'atol': 1e-2, 'rtol': 1e-2},
              'paged_decode': {'atol': 1e-3, 'rtol': 1e-2}}
LOGIT_TOL = 0.1          # bf16 activations through 2 full-width layers vs f32
SEED = 1234


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 10) -> float:
    """Device time of one ``fn`` call: ``fn`` is captured once into a CUDA graph
    (after ``warmup`` eager calls), the graph is replayed ``reps`` times between
    two CUDA events, and the median over ``iters`` such timings, divided by
    ``reps``, is returned.  Replaying a graph keeps the host's per-call launch
    overhead (Python, ctypes, allocator) out of the kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def compare(out: torch.Tensor, ref: torch.Tensor, tol: dict):
    """(max abs error, max error relative to |ref| where |ref| >= atol, worst error
    as a fraction of the allowance ``tol``)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    allow = tol['atol'] + tol['rtol'] * ref.abs()
    rel = err / ref.abs().clamp_min(tol['atol'])
    return err.max().item(), rel.max().item(), (err / allow).max().item()


def bound(flops: float, nbytes: float):
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes')


def tinyllama_config(num_layers: int = 22, max_len: int = 2304):
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig(num_layers=num_layers, num_attention_heads=32,
                       num_key_value_heads=4, hidden_size=2048, intermediate_size=5632,
                       vocab_size=32000, head_dim=64, max_position_embeddings=max_len,
                       dtype='bfloat16', eos_token_id=[2])


# -- phase 1 + 2 ---------------------------------------------------------------------
def device_phase():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    info = {'phase': 'device', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(), 'nvidia_smi': smi,
            'torch': torch.__version__, 'cuda': torch.version.cuda}
    emit(info)
    return info


def build_phase():
    from lmdeploy_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    seconds = cuda_build.build()
    regs = {}
    for name in cuda_build.SOURCES:
        with open(cuda_build.log_path(name)) as f:
            regs[name] = [ln.strip() for ln in f if 'registers' in ln or 'spill' in ln]
    emit({'phase': 'build', 'wall_s': time.perf_counter() - t0, 'per_source_s': seconds,
          'ptxas': regs})


# -- phase 3 -------------------------------------------------------------------------
def flash_phase():
    from lmdeploy_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                      flash_prefill_attention_plain)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    results = []
    # TinyLlama at T=2048 (the main path's long prompt), a ragged T with D=128 and
    # G=1 (llama2-7b heads), and the 8x128 prefill batch of the e2e phase
    for B, T, Hq, Hkv, D in ((1, 2048, 32, 4, 64), (1, 1000, 32, 32, 128),
                             (8, 128, 32, 4, 64)):
        q = torch.randn(B, T, Hq, D, device='cuda', generator=gen).bfloat16()
        k = torch.randn(B, T, Hkv, D, device='cuda', generator=gen).bfloat16()
        v = torch.randn(B, T, Hkv, D, device='cuda', generator=gen).bfloat16()
        scale = D ** -0.5
        out = flash_prefill_attention(q, k, v, scale)
        ref = flash_prefill_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        tol = KERNEL_TOL['flash_prefill']
        err, rel, frac = compare(out, ref, tol)
        ok = bool(torch.isfinite(out.float()).all()) and frac <= 1.0
        flops = 2 * 2 * B * Hq * D * T * (T + 1) / 2           # QK^T and PV, causal
        nbytes = 2 * (2 * B * T * Hq * D + 2 * B * T * Hkv * D)  # q, o, k, v in bf16
        bound_ms, bound_by = bound(flops, nbytes)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = torch.nn.functional.scaled_dot_product_attention
        row = {'phase': 'kernel', 'kernel': 'flash_prefill', 'shape': [B, T, Hq, Hkv, D],
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol, 'ok': ok,
               'kernel_ms': time_ms(lambda: flash_prefill_attention(q, k, v, scale)),
               'plain_ms': time_ms(lambda: flash_prefill_attention_plain(q, k, v, scale),
                                   iters=5),
               'library_ms': time_ms(lambda: lib(qt, kt, vt, is_causal=True, scale=scale,
                                                 enable_gqa=True)),
               'bound_ms': bound_ms, 'bound_by': bound_by, 'gflop': flops / 1e9}
        emit(row)
        results.append(row)
        if not ok:
            raise SystemExit(f'flash_prefill disagrees with its plain version: {row}')
    return results


def _decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens, L=2):
    """A 2-layer cache with ragged rows on disjoint random pages, trailing padding
    rows on block 0 (kv_len 1, as the engine pads), and kv_len 0 where ``lens`` says."""
    NB = 1 + B * W
    cache = torch.randn(L, NB, 2, BS, Hkv * D, device='cuda', generator=gen).bfloat16()
    perm = torch.randperm(NB - 1, device='cuda', generator=gen) + 1
    tables = perm[:B * W].reshape(B, W).int()
    kv_lens = torch.tensor(lens, dtype=torch.int32, device='cuda')
    pad_rows = kv_lens < 0
    tables[pad_rows] = 0
    kv_lens[pad_rows] = 1
    q = torch.randn(B, Hq, D, device='cuda', generator=gen).bfloat16()
    return q, cache, tables.contiguous(), kv_lens


def decode_phase():
    from lmdeploy_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                     paged_decode_attention_plain)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    results = []
    BS = 128
    # bs64 TinyLlama heads, ragged lengths averaging ~384, one inactive row and
    # four padding rows (marked -1); then a D=128, G=1 (llama2-7b heads) case
    lens64 = rng.randint(1, 768, size=64)
    lens64[5] = 0
    lens64[-4:] = -1
    lens8 = rng.randint(1, 1024, size=8)
    # the e2e phase's decode shape: a 16-row bucket, 8 rows of ~200 tokens, one of
    # ~2,100, 7 padding rows, the full session-wide table width
    lens16 = np.concatenate([rng.randint(130, 200, size=8), [2100], -np.ones(7, int)])
    cases = [
        ('plain', 64, 32, 4, 64, lens64, {}),
        ('window', 64, 32, 4, 64, lens64, {'window': 200}),
        ('softcap', 64, 32, 4, 64, lens64, {'logit_softcap': 30.0}),
        ('sinks', 64, 32, 4, 64, lens64, {'sinks': True}),
        ('all', 64, 32, 4, 64, lens64, {'window': 100, 'logit_softcap': 20.0,
                                        'sinks': True}),
        ('d128_g1', 8, 32, 32, 128, lens8, {}),
        ('e2e_long', 16, 32, 4, 64, lens16, {}),
    ]
    for label, B, Hq, Hkv, D, lens, opts in cases:
        W = 17 if label == 'e2e_long' else 8
        q, cache, tables, kv_lens = _decode_inputs(gen, B, Hq, Hkv, D, BS, W, lens)
        opts = dict(opts)
        if opts.get('sinks'):
            opts['sinks'] = torch.randn(Hq, device='cuda', generator=gen) * 2
        scale = D ** -0.5
        layer = 1

        def kern():
            return paged_decode_attention(q, cache, tables, kv_lens, layer, scale, Hkv,
                                          **opts)

        def plain():
            return paged_decode_attention_plain(q, cache, tables, kv_lens, layer, scale,
                                                Hkv, **opts)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        tol = KERNEL_TOL['paged_decode']
        err, rel, frac = compare(out, ref, tol)
        zero_ok = bool((out[kv_lens == 0] == 0).all())
        ok = bool(torch.isfinite(out.float()).all()) and frac <= 1.0 and zero_ok
        # bytes this data needs: each row's in-window K and V rows, q and out
        lens_np = kv_lens.cpu().numpy().astype(np.int64)
        win = opts.get('window') or 0
        toks = np.minimum(lens_np, win) if win else lens_np
        nbytes = toks.sum() * Hkv * D * 2 * 2 + 2 * (2 * B * Hq * D)
        flops = 4 * Hq * D * toks.sum()
        bound_ms, bound_by = bound(flops, nbytes)
        row = {'phase': 'kernel', 'kernel': 'paged_decode', 'case': label,
               'shape': [B, Hq, Hkv, D, BS, W], 'mean_kv_len': float(lens_np.mean()),
               'max_abs_err': err, 'max_rel_err': rel, 'err_over_tol': frac, 'tol': tol,
               'zero_rows_ok': zero_ok, 'ok': ok,
               'kernel_ms': time_ms(kern), 'plain_ms': time_ms(plain, iters=5),
               'library_ms': None, 'bound_ms': bound_ms, 'bound_by': bound_by,
               'kv_mbytes': nbytes / 1e6}
        emit(row)
        results.append(row)
        if not ok:
            raise SystemExit(f'paged_decode disagrees with its plain version: {row}')
    return results


# -- phase 4 -------------------------------------------------------------------------
def build_engine():
    from lmdeploy_tpu_torch.config import (CacheConfig, EngineConfigBundle, MiscConfig,
                                           SchedulerConfig)
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    bundle = EngineConfigBundle(
        model=tinyllama_config(),
        cache=CacheConfig(block_size=128, num_gpu_blocks=0, cache_max_entry_count=0.5,
                          max_prefill_token_num=8192),
        scheduler=SchedulerConfig(max_batch_size=64, max_session_len=2048 + 128,
                                  max_prefill_token_num=8192, max_prefill_batch=16),
        misc=MiscConfig(empty_init=True))
    return Engine(None, TpuEngineConfig(), configs=bundle)


def run_requests(engine, prompts, new_tokens):
    from lmdeploy_tpu_torch.messages import GenerationConfig
    inst = engine.create_instance()

    async def go():
        gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True, logprobs=0)
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen)
                                      for i, p in enumerate(prompts)])
    t0 = time.time()
    outs = asyncio.run(go())
    torch.cuda.synchronize()
    return outs, t0, time.time()


def serving_numbers(run) -> dict:
    """TTFT (arrival to first token), decode tok/s (tokens after each request's
    first, over the time from the last first token to the end) and output tok/s."""
    m = [o.req_metrics for o in run['outs']]
    ttft = sorted(x.first_token_time - x.arrival_time for x in m)
    t_first_all = max(x.first_token_time for x in m)
    tokens = [o.token_ids for o in run['outs']]
    return {'ttft_ms': {'min': ttft[0] * 1e3, 'p50': ttft[len(ttft) // 2] * 1e3,
                        'max': ttft[-1] * 1e3},
            'decode_tok_s': sum(len(t) - 1 for t in tokens) / (run['t1'] - t_first_all),
            'output_tok_s': sum(len(t) for t in tokens) / (run['t1'] - run['t0']),
            'wall_s': run['t1'] - run['t0']}


def e2e_phase(kernels, card: str):
    from lmdeploy_tpu_torch.ops.flash_prefill import flash_prefill_attention
    from lmdeploy_tpu_torch.ops.paged_decode import paged_decode_attention
    new_tokens = 64
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(3, 32000, size=128).tolist() for _ in range(8)]
    prompts.append(rng.randint(3, 32000, size=2048).tolist())
    t_build = time.perf_counter()
    engine = build_engine()
    build_s = time.perf_counter() - t_build
    agent = engine.model_agent
    steps = {'prefill': 0, 'decode': 0}
    prefill, decode_run = agent.prefill, agent.decode_run

    def counted_prefill(chunks):
        steps['prefill'] += 1
        return prefill(chunks)

    def counted_decode_run(num_rows, k=None, *args):
        steps['decode'] += k or agent.decode_run_steps
        return decode_run(num_rows, k, *args)
    agent.prefill, agent.decode_run = counted_prefill, counted_decode_run

    runs = []
    for _ in range(2):
        steps.update(prefill=0, decode=0)
        flash_prefill_attention.launches = 0
        paged_decode_attention.launches = 0
        outs, t0, t1 = run_requests(engine, prompts, new_tokens)
        runs.append({'tokens': [o.token_ids for o in outs], 'outs': outs, 't0': t0,
                     't1': t1, 'steps': dict(steps),
                     'launches': {'flash_prefill': flash_prefill_attention.launches,
                                  'paged_decode': paged_decode_attention.launches}})
    profile_phase(engine, prompts, new_tokens)
    engine.close()
    first, second = runs
    L = engine.configs.model.num_layers
    lengths_ok = all(len(t) == new_tokens for r in runs for t in r['tokens'])
    finite = all(np.isfinite(lp[tok].logprob)
                 for o in first['outs'] for lp, tok in zip(o.logprobs, o.token_ids))
    deterministic = first['tokens'] == second['tokens']
    need = {'flash_prefill': L * first['steps']['prefill'],
            'paged_decode': L * first['steps']['decode']}
    launches_ok = all(first['launches'][n] >= need[n] > 0 for n in need)
    row = {'phase': 'e2e', 'model': 'tinyllama-1.1b geometry, bf16, random seeded weights',
           'card': card,
           'requests': len(prompts), 'new_tokens': new_tokens,
           'engine_build_s': build_s, 'lengths_ok': lengths_ok, 'logprobs_finite': finite,
           'deterministic': deterministic, 'steps': first['steps'],
           'launches': first['launches'], 'launches_needed': need,
           'launches_ok': launches_ok,
           'num_blocks': agent.num_blocks,
           # card numbers from the second run (cuBLAS and allocator warmed by the first)
           **serving_numbers(second)}
    emit(row)
    for k in kernels:
        k['launches'] = first['launches'][k['name']]
    if not (lengths_ok and finite and deterministic and launches_ok):
        raise SystemExit(f'e2e phase failed: {row}')


def profile_phase(engine, prompts, new_tokens):
    """A traced run of the same requests: the device's busy share of the wall time
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t0, t1 = run_requests(engine, prompts, new_tokens)
    averages = prof.key_averages()
    events = [e for e in averages if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    host = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:8]
    emit({'phase': 'profile', 'wall_ms': (t1 - t0) * 1e3, 'device_busy_ms': busy_us / 1e3,
          'device_busy_share': busy_us / 1e3 / ((t1 - t0) * 1e3) if busy_us else None,
          'top_device_ms': {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
          'top_calls': {e.key[:60]: e.count for e in top},
          'top_host_self_ms': {e.key[:60]: e.self_cpu_time_total / 1e3 for e in host},
          'top_host_calls': {e.key[:60]: e.count for e in host}})


# -- phase 5 -------------------------------------------------------------------------
def parity_phase():
    import dataclasses

    from lmdeploy_tpu_torch.models.llama import AttnMeta, LlamaModel
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg16 = tinyllama_config(num_layers=2)
    cfg32 = dataclasses.replace(cfg16, dtype='float32')
    m16, m32 = LlamaModel(cfg16), LlamaModel(cfg32)

    def tree(params, fn):
        return {k: tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in params.items()}
    # identical bf16-representable weights on both sides
    w = m32.init_params(SEED, device='cpu', dtype=torch.float32)
    w_cpu = m32.fuse_projections(tree(w, lambda t: t.bfloat16().float()))
    w_gpu = m16.fuse_projections(tree(w, lambda t: t.to('cuda', torch.bfloat16)))
    B, T, BS, steps = 2, 256, 128, 8
    pages = (T + steps + BS - 1) // BS
    NB = 1 + B * pages
    shape = (2, NB, 2, BS, cfg16.num_key_value_heads * cfg16.head_dim)
    cache = {'cpu': torch.zeros(shape), 'cuda': torch.zeros(shape, dtype=torch.bfloat16,
                                                             device='cuda')}
    tables = (1 + torch.arange(B * pages)).reshape(B, pages).int()
    cos, sin = make_rope_table(cfg16.head_dim, 1024, cfg16.rope_theta)
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(3, 32000, size=(B, T))).int()

    def step(dev, model, params, tok, hist, q_len, fresh):
        meta = AttnMeta(tables.to(dev), torch.full((B,), hist, dtype=torch.int32).to(dev),
                        torch.full((B,), q_len, dtype=torch.int32).to(dev))
        pos = (hist + torch.arange(tok.shape[1]))[None].expand(B, -1).int()
        return model.forward(params, tok.to(dev), pos.to(dev), cache[dev], meta,
                             cos.to(dev), sin.to(dev), fresh_prefill=fresh).float().cpu()
    errs, agree, decided = [], 0, 0
    lc = step('cpu', m32, w_cpu, ids, 0, T, True)
    lg = step('cuda', m16, w_gpu, ids, 0, T, True)
    for i in range(steps + 1):
        errs.append((lg - lc).abs().max().item())
        top2 = lc.topk(2, dim=-1).values
        margin_ok = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
        same = lc.argmax(-1) == lg.argmax(-1)
        agree += int(same.sum())
        decided += int(margin_ok.sum())
        if not bool(same[margin_ok].all()):
            raise SystemExit(f'parity: argmax differs where the f32 margin exceeds '
                             f'2 x {LOGIT_TOL} at step {i}')
        if i == steps:
            break
        tok = lc.argmax(-1, keepdim=True).int()          # teacher-force the f32 tokens
        lc = step('cpu', m32, w_cpu, tok, T + i, 1, False)
        lg = step('cuda', m16, w_gpu, tok, T + i, 1, False)
    row = {'phase': 'parity', 'layers': 2, 'width': 'tinyllama-1.1b', 'batch': B,
           'prompt': T, 'decode_steps': steps, 'max_abs_logit_err': max(errs),
           'per_step_err': errs, 'tol': LOGIT_TOL,
           'argmax_agree': agree, 'positions': B * (steps + 1),
           'positions_with_margin': decided, 'ok': max(errs) <= LOGIT_TOL}
    emit(row)
    if not row['ok']:
        raise SystemExit(f'parity failed: {row}')


def kernel_line(flash, decode):
    f, d = flash[0], decode[0]
    return [
        {'name': 'flash_prefill', 'route': 'cuda',
         'source': 'lmdeploy_tpu_torch/csrc/flash_prefill.cu',
         'replaces': 'lmdeploy_tpu/ops/pallas/flash_prefill.py:76', 'launches': None,
         'max_abs_err': max(r['max_abs_err'] for r in flash), 'ms': f['kernel_ms'],
         'plain_ms': f['plain_ms'], 'bound_ms': f['bound_ms'], 'bound_by': f['bound_by'],
         'library_ms': f['library_ms']},
        {'name': 'paged_decode', 'route': 'cuda',
         'source': 'lmdeploy_tpu_torch/csrc/paged_decode.cu',
         'replaces': 'lmdeploy_tpu/ops/pallas/paged_decode.py:866', 'launches': None,
         'max_abs_err': max(r['max_abs_err'] for r in decode), 'ms': d['kernel_ms'],
         'plain_ms': d['plain_ms'], 'bound_ms': d['bound_ms'], 'bound_by': d['bound_by'],
         'library_ms': None},
    ]


def main():
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    info = device_phase()
    build_phase()
    kernels = kernel_line(flash_phase(), decode_phase())
    parity_phase()
    e2e_phase(kernels, info['nvidia_smi'])
    emit({'kernels': kernels})
    print(info['nvidia_smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': info['kind'],
                                 'count': info['count']}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
