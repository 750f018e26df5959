"""The port's gated-DeltaNet ops (``lmdeploy_tpu_torch/ops/gated_delta.py``) against the
JAX package's on the same seeded f32 inputs (atol 1e-5): l2norm, gate_decay,
causal_conv1d with rows shorter than the chunk, the per-token scan, the chunked form
(which both packages take from 64 tokens), chunks against one shot, and padding steps,
which must leave the state bit for bit unchanged; the scheduler's state-checkpoint
decisions against the JAX scheduler's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops import gated_delta as jgd
from lmdeploy_tpu_torch.ops import gated_delta as tgd

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B=2, T=16, Hv=4, dk=16, dv=8):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, Hv, dk).astype(np.float32)
    k = rng.randn(B, T, Hv, dk).astype(np.float32)
    v = rng.randn(B, T, Hv, dv).astype(np.float32)
    a = rng.randn(B, T, Hv).astype(np.float32)
    b = rng.randn(B, T, Hv).astype(np.float32)
    a_log = np.log(rng.uniform(0.5, 4.0, Hv)).astype(np.float32)
    dt_bias = (1.0 + 0.2 * rng.randn(Hv)).astype(np.float32)
    s0 = (0.3 * rng.randn(B, Hv, dk, dv)).astype(np.float32)
    return q, k, v, a, b, a_log, dt_bias, s0


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _gates(a, b, a_log, dt_bias):
    g, beta = jgd.gate_decay(jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_log),
                             jnp.asarray(dt_bias))
    return np.asarray(g), np.asarray(beta)


def test_l2norm_and_gate_decay():
    q, _, _, a, b, a_log, dt_bias, _ = _inputs(0)
    np.testing.assert_allclose(tgd.l2norm(torch.from_numpy(q)).numpy(),
                               np.asarray(jgd.l2norm(jnp.asarray(q))), **TOL)
    g, beta = tgd.gate_decay(*_t(a, b, a_log, dt_bias))
    jg, jbeta = _gates(a, b, a_log, dt_bias)
    np.testing.assert_allclose(g.numpy(), jg, **TOL)
    np.testing.assert_allclose(beta.numpy(), jbeta, **TOL)


@pytest.mark.parametrize('bias', [False, True])
def test_causal_conv1d_rows_shorter_than_chunk(bias):
    """Output and new state (the last K-1 VALID inputs, not the padded chunk's tail)
    for rows of 16, 5, 1 and 0 valid tokens of a 16-token chunk."""
    rng = np.random.RandomState(1)
    B, T, C, K = 4, 16, 24, 4
    x = rng.randn(B, T, C).astype(np.float32)
    st = rng.randn(B, K - 1, C).astype(np.float32)
    w = (0.4 * rng.randn(C, K)).astype(np.float32)
    bb = rng.randn(C).astype(np.float32) if bias else None
    lens = np.array([16, 5, 1, 0], np.int32)
    y, ns = tgd.causal_conv1d(*_t(x, st, w), None if bb is None else torch.from_numpy(bb),
                              torch.from_numpy(lens))
    jy, jns = jgd.causal_conv1d(jnp.asarray(x), jnp.asarray(st), jnp.asarray(w),
                                None if bb is None else jnp.asarray(bb), jnp.asarray(lens))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    # a row of 5 valid tokens keeps inputs 2..4; a row of none keeps its old state
    np.testing.assert_array_equal(ns[1].numpy(), x[1, 2:5])
    np.testing.assert_array_equal(ns[3].numpy(), st[3])


@pytest.mark.parametrize('T', [16, 64, 130])
def test_scan_and_chunked_match_jax(T):
    """Below 64 tokens both packages run the scan, from 64 the chunked form (T 64: one
    chunk; T 130: three, the last padded), with a valid mask cutting row 1 short."""
    q, k, v, a, b, a_log, dt_bias, s0 = _inputs(2, T=T)
    g, beta = _gates(a, b, a_log, dt_bias)
    valid = np.ones((2, T), bool)
    valid[1, T - 7:] = False
    out, st = tgd.gated_delta_scan(*_t(q, k, v, g, beta, s0), valid=torch.from_numpy(valid))
    jout, jst = jgd.gated_delta_scan(*(jnp.asarray(x) for x in (q, k, v, g, beta, s0)),
                                     valid=jnp.asarray(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_chunked_equals_scan_and_chunks_equal_one_shot(monkeypatch):
    """The chunked form against the scan on the same 130 tokens, and 130 tokens in
    chunks of 40 / 26 / 64 (the state carried) against one shot."""
    T = 130
    q, k, v, a, b, a_log, dt_bias, s0 = _inputs(3, T=T)
    g, beta = _gates(a, b, a_log, dt_bias)
    args = _t(q, k, v, g, beta, s0)
    one, one_st = tgd.gated_delta_scan(*args)
    monkeypatch.setenv('LMDEPLOY_TPU_GDN_CHUNKED', '0')
    scan, scan_st = tgd.gated_delta_scan(*args)
    monkeypatch.delenv('LMDEPLOY_TPU_GDN_CHUNKED')
    np.testing.assert_allclose(one.numpy(), scan.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(one_st.numpy(), scan_st.numpy(), rtol=1e-4, atol=1e-4)
    outs, st = [], args[5]
    for lo, hi in ((0, 40), (40, 66), (66, 130)):
        o, st = tgd.gated_delta_scan(*(x[:, lo:hi] for x in args[:5]), st)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), one.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), one_st.numpy(), rtol=1e-4, atol=1e-4)


def test_tri_inv_unit_lower():
    rng = np.random.RandomState(4)
    A = np.tril(rng.randn(3, 64, 64).astype(np.float32) * 0.1, -1)
    inv = tgd._tri_inv_unit_lower(torch.from_numpy(A))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jgd._tri_inv_unit_lower(
        jnp.asarray(A))), **TOL)
    eye = np.eye(64, dtype=np.float32)
    np.testing.assert_allclose(inv.numpy() @ (eye + A), np.broadcast_to(eye, A.shape),
                               atol=1e-5)


def test_padding_steps_leave_state_bit_equal():
    """A row's state after its 9 valid steps equals, byte for byte, its state after
    the same steps followed by 7 padding steps (g = beta = 0), and a row with no valid
    step keeps state0; the chunked form on a padded 64-token chunk agrees with the
    9-step scan within the f32 tolerance."""
    q, k, v, a, b, a_log, dt_bias, s0 = _inputs(5, T=16)
    g, beta = _gates(a, b, a_log, dt_bias)
    args = _t(q, k, v, g, beta, s0)
    valid = torch.zeros(2, 16, dtype=torch.bool)
    valid[0, :9] = True
    _, st = tgd.gated_delta_scan(*args, valid=valid)
    _, st9 = tgd.gated_delta_scan(*(x[:, :9] for x in args[:5]), args[5])
    assert torch.equal(st[0], st9[0])
    assert torch.equal(st[1], args[5][1])
    pad = [torch.cat([x, torch.zeros((2, 48) + x.shape[2:])], 1) for x in args[:5]]
    valid64 = torch.cat([valid, torch.zeros(2, 48, dtype=torch.bool)], 1)
    _, stc = tgd.gated_delta_chunked(*pad, args[5], valid=valid64)
    np.testing.assert_allclose(stc[0].numpy(), st9[0].numpy(), **TOL)
    np.testing.assert_allclose(stc[1].numpy(), s0[1], **TOL)


def test_chunked_form_from_64_tokens(monkeypatch):
    """The port takes the chunked form from ``CHUNK_MIN_T`` = 64 tokens, the
    reference's switch, and the scan below."""
    assert tgd.CHUNK_MIN_T == jgd.CHUNK_MIN_T == 64 and tgd.CHUNK == jgd.CHUNK
    calls = []
    chunked = tgd.gated_delta_chunked
    monkeypatch.setattr(tgd, 'gated_delta_chunked',
                        lambda *a, **k: calls.append(a[0].shape[1]) or chunked(*a, **k))
    for T in (63, 64):
        q, k, v, a, b, a_log, dt_bias, s0 = _inputs(6, B=1, T=T, Hv=1, dk=4, dv=4)
        g, beta = _gates(a, b, a_log, dt_bias)
        tgd.gated_delta_scan(*_t(q, k, v, g, beta, s0))
    assert calls == [64]


def _ssm_scheduler(pkg, **sched):
    """A prefix-caching scheduler of ``pkg`` (block 16) with an SSM checkpoint store of
    4 snapshots; returns (scheduler, store, SamplingParams)."""
    if pkg == 'jax':
        from lmdeploy_tpu.config import CacheConfig, SchedulerConfig
        from lmdeploy_tpu.engine.ssm_ckpt import SsmCkptStore
        from lmdeploy_tpu.paging.scheduler import Scheduler
        from lmdeploy_tpu.paging.seq import SamplingParams
        kw = {'use_native': False}
    else:
        from lmdeploy_tpu_torch.config import CacheConfig, SchedulerConfig
        from lmdeploy_tpu_torch.engine.ssm_ckpt import SsmCkptStore
        from lmdeploy_tpu_torch.paging.scheduler import Scheduler
        from lmdeploy_tpu_torch.paging.seq import SamplingParams
        kw = {}
    s = Scheduler(SchedulerConfig(max_session_len=512, **sched),
                  CacheConfig(block_size=16, num_gpu_blocks=64, enable_prefix_caching=True),
                  **kw)
    s.ssm_ckpt = store = SsmCkptStore(capacity=4)
    return s, store, SamplingParams


def _prefill_done(sched, store, chunks):
    """Finish ``chunks`` as the engine does: a snapshot published at each block-aligned
    chunk end; returns the chunks' (session, start, length, is_last, restored)."""
    out = []
    for c in chunks:
        out.append((c.seq.session.session_id, c.start, c.length, c.is_last,
                    c.seq._ssm_restore is not None))
        c.seq._ssm_restore = None
        sched.on_prefill_done(c, 7 if c.is_last else None)
        end = c.start + c.length
        if end % 16 == 0 and not store.has(c.seq.history_ids, end):
            store.put(c.seq.history_ids, end, {'slot': c.seq.session.session_id})
    return out


def _ssm_trace(pkg):
    """Arrivals sharing prefixes, chunked prefill whose chunk ends align to blocks,
    matches trimmed to the deepest checkpoint; returns every decision with the store's
    puts and hits.  Blocks are enough that a matched sequence is admitted in the pass
    that matched it: the JAX scheduler asserts otherwise (the trace of
    ``test_scheduler_trimmed_match_not_admitted_serves_on``)."""
    sched, store, SamplingParams = _ssm_scheduler(
        pkg, max_batch_size=6, max_prefill_token_num=48, max_prefill_batch=3,
        prefill_reorder=False)
    rng = np.random.RandomState(1)
    shared = list(rng.randint(3, 200, 37))
    log = []
    for step in range(40):
        if step < 6:
            sched.add_session(step + 1)
            ids = (shared[:16 + 7 * step] if step % 2 else shared) \
                + list(rng.randint(3, 200, 3 + 5 * step))
            sched.seq_manager.get_session(step + 1).add_sequence(
                ids, SamplingParams(max_new_tokens=6))
        out = sched.schedule()
        if out.is_prefill:
            log.append(('prefill', _prefill_done(sched, store, out.prefill_chunks)))
        else:
            for s in out.decode_seqs:
                if sched.extend_decode_capacity(s, 2) and s.status.name == 'RUNNING':
                    sched.on_decode_tokens(s, [9, 9])
                    if len(s.output_ids) >= 6:
                        sched.stop_seq(s)
            sched.release_stopped()
        log.append(('store', store.puts, store.hits, len(store)))
    return log


def test_scheduler_ssm_checkpoint_decisions_match_jax():
    """``_ssm_align_chunk`` / ``_ssm_trim_match`` decide as the JAX scheduler's do, step
    by step, on a trace with checkpoint hits and trimmed matches."""
    ref = _ssm_trace('jax')
    got = _ssm_trace('torch')
    assert got == ref
    assert ref[-1][2] > 0 and any(any(c[4] for c in e[1]) for e in ref if e[0] == 'prefill')


def _deferred_trace(pkg):
    """A 40-token prompt served to its end (its blocks 0-1 stay in the trie, a snapshot
    at 32 only), then a 2-token prompt and one sharing the first 20 tokens: the latter
    matches block 0, which has no snapshot, so the match is trimmed to 0; its 48-token
    chunk then passes the padding cap beside the 2-token one and waits for the next
    pass, holding block 0.  Returns the decisions (the waiting rows' computed tokens and
    blocks after each prefill pass) and whether the scheduler raised."""
    sched, store, SamplingParams = _ssm_scheduler(pkg, max_batch_size=4,
                                                  max_prefill_token_num=64)
    rng = np.random.RandomState(1)
    first = list(rng.randint(3, 200, 40))
    arrivals = {0: [first], 6: [list(rng.randint(3, 200, 2)),
                                first[:20] + list(rng.randint(3, 200, 30))]}
    log, sid = [], 0
    for step in range(16):
        for ids in arrivals.get(step, []):
            sid += 1
            sched.add_session(sid)
            sched.seq_manager.get_session(sid).add_sequence(
                ids, SamplingParams(max_new_tokens=4))
        try:
            out = sched.schedule()
        except AssertionError:
            return log, True
        if out.is_prefill:
            admitted = {c.seq.session.session_id for c in out.prefill_chunks}
            log.append(('prefill', _prefill_done(sched, store, out.prefill_chunks),
                        [(s.session.session_id, s.num_computed_tokens, len(s.logical_blocks))
                         for s in sched.waiting if s.session.session_id not in admitted]))
        else:
            log.append(('decode', [s.session.session_id for s in out.decode_seqs]))
            for s in out.decode_seqs:
                sched.on_decode_done(s, 9)
                if len(s.output_ids) >= 4:
                    sched.stop_seq(s)
            sched.release_stopped()
    return log, False


def test_scheduler_trimmed_match_not_admitted_serves_on():
    """A match trimmed to 0 whose sequence is not admitted in the pass that matched it
    keeps its block and is not matched again: the JAX scheduler's ``match_prefix``
    asserts at the next pass; the port's decides as JAX's up to there, then prefills
    the sequence from 0 over the block it holds and serves every sequence to its end."""
    ref, ref_raised = _deferred_trace('jax')
    got, raised = _deferred_trace('torch')
    assert ref_raised and not raised
    assert got[:len(ref)] == ref
    deferred = ('prefill', [(2, 0, 2, True, False)], [(3, 0, 1)])
    assert ref[-1] == deferred
    rest = got[len(ref):]
    assert rest[0] == ('prefill', [(3, 0, 48, False, False)], [])
    assert rest[1] == ('prefill', [(3, 48, 2, True, False)], [])
    assert ('decode', []) in rest
