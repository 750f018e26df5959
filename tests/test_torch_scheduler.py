"""The port's scheduler (a copy of the reference's Python backend) against the JAX
package's on one request trace: every step's decisions must be identical."""
import numpy as np
import pytest


def make(pkg, prefix_caching):
    if pkg == 'jax':
        from lmdeploy_tpu.config import CacheConfig, SchedulerConfig
        from lmdeploy_tpu.paging.scheduler import Scheduler
        from lmdeploy_tpu.paging.seq import SamplingParams
        kw = {'use_native': False}
    else:
        from lmdeploy_tpu_torch.config import CacheConfig, SchedulerConfig
        from lmdeploy_tpu_torch.paging.scheduler import Scheduler
        from lmdeploy_tpu_torch.paging.seq import SamplingParams
        kw = {}
    cache = CacheConfig(block_size=16, num_gpu_blocks=14,
                        enable_prefix_caching=prefix_caching)
    cfg = SchedulerConfig(max_batch_size=6, max_session_len=512, max_prefill_token_num=48,
                          max_prefill_batch=3, prefill_reorder=False)
    return Scheduler(cfg, cache, **kw), SamplingParams


def trace(pkg, prefix_caching):
    """Arrivals, chunked prefill, multi-token decode with capacity extension and
    preemption, finishes; returns the log of every decision."""
    sched, SamplingParams = make(pkg, prefix_caching)
    rng = np.random.RandomState(0)
    shared = list(rng.randint(3, 200, 40))
    seqs, log = {}, []
    for step in range(60):
        if step < 8:
            sid = step + 1
            sched.add_session(sid)
            ids = shared + list(rng.randint(3, 200, 5 + 7 * step)) if step % 2 else \
                list(rng.randint(3, 200, 10 + 5 * step))
            seqs[sid] = sched.seq_manager.get_session(sid).add_sequence(
                ids, SamplingParams(max_new_tokens=30))
        out = sched.schedule()
        if out.is_prefill:
            log.append(('prefill', [(c.seq.session.session_id, c.start, c.length, c.is_last)
                                    for c in out.prefill_chunks]))
            for c in out.prefill_chunks:
                sched.on_prefill_done(c, 7 if c.is_last else None)
        else:
            ok = [sched.extend_decode_capacity(s, 4) for s in out.decode_seqs]
            log.append(('decode', [s.session.session_id for s in out.decode_seqs], ok))
            for s, good in zip(out.decode_seqs, ok):
                if good and s.status.name == 'RUNNING':
                    sched.on_decode_tokens(s, [9, 9, 9, 9])
                    if len(s.output_ids) >= 13:
                        sched.stop_seq(s)
            sched.release_stopped()
        log.append(('state', sorted((s.session.session_id, s.status.name,
                                     s.num_computed_tokens, tuple(s.logical_blocks))
                                    for s in sched.seq_manager.all_sequences()),
                    sched.block_manager.num_free_blocks, sched.num_preemptions))
    return log


@pytest.mark.parametrize('prefix_caching', [False, True])
def test_same_trace_same_decisions(prefix_caching):
    jax_log = trace('jax', prefix_caching)
    port_log = trace('torch', prefix_caching)
    assert any(entry[-1] > 0 for entry in jax_log if entry[0] == 'state')   # preempted
    assert port_log == jax_log
