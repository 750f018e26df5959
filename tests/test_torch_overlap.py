"""The port's prefill/decode overlap and pipelined decode-run chain, after
tests/test_overlap.py (the JAX engine's).

Correctness contract: with overlap and pipelining on (the defaults), a request arriving
while another decodes produces the same tokens as a solo run, and the JAX engine's;
the decoding request is unaffected; each switch at 0 gives the same tokens.
"""
import asyncio

import numpy as np
import pytest

ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=8,
                 session_len=256, max_prefill_token_num=64)


def _engine(pkg, model_dir, **over):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import TpuEngineConfig
        kw = {'device': 'cpu'}
    return Engine.from_pretrained(model_dir, TpuEngineConfig(**dict(ENGINE_KW, **over)),
                                  **kw)


def _gen(pkg, n):
    if pkg == 'jax':
        from lmdeploy_tpu.messages import GenerationConfig
    else:
        from lmdeploy_tpu_torch.messages import GenerationConfig
    return GenerationConfig(max_new_tokens=n, ignore_eos=True)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _solo(pkg, eng, sid, prompt, n):
    async def run():
        inst = eng.create_instance()
        out = await inst.async_infer(sid, prompt, _gen(pkg, n))
        await inst.async_end(sid)
        return list(out.token_ids)
    return _run(run())


def _staggered(eng, prompts):
    """The first request streams; the others arrive once it has a token, while it
    decodes."""
    (p1, n1), *rest = prompts

    async def staggered():
        insts = [eng.create_instance() for _ in prompts]
        decoding = asyncio.Event()

        async def streamer():
            toks = []
            async for out in insts[0].async_stream_infer(1, p1, _gen('torch', n1)):
                toks = list(out.token_ids)
                if toks:
                    decoding.set()
            await insts[0].async_end(1)
            return toks

        async def one(inst, sid, prompt, n):
            await decoding.wait()
            out = await inst.async_infer(sid, prompt, _gen('torch', n))
            await inst.async_end(sid)
            return list(out.token_ids)

        return await asyncio.gather(streamer(), *[
            one(inst, i + 2, p, n) for i, (inst, (p, n)) in enumerate(zip(insts[1:], rest))])
    return _run(staggered())


def _prompts():
    rng = np.random.RandomState(21)
    return [(rng.randint(3, 250, size=40).tolist(), 96),
            (rng.randint(3, 250, size=35).tolist(), 16),
            (rng.randint(3, 250, size=20).tolist(), 12)]


@pytest.fixture(scope='module')
def solo_tokens(tiny_model_dir):
    """Each request alone, on the JAX engine and on the port's."""
    out = {}
    for pkg in ('jax', 'torch'):
        eng = _engine(pkg, tiny_model_dir)
        try:
            out[pkg] = [_solo(pkg, eng, 101 + i, p, n) for i, (p, n) in enumerate(_prompts())]
        finally:
            eng.close()
    return out


def test_staggered_arrival_exact(tiny_model_dir, solo_tokens):
    """Under the defaults the arrivals ride the overlap path and the lone request the
    chain, and every request gets its solo tokens, which are the JAX engine's."""
    assert solo_tokens['torch'] == solo_tokens['jax']
    eng = _engine('torch', tiny_model_dir)
    try:
        assert eng._overlap and eng._pipeline
        got = _staggered(eng, _prompts())
        assert got == solo_tokens['jax']
        assert eng._overlap_dispatches > 0
        assert eng._pipelined_runs > 0
    finally:
        eng.close()


@pytest.mark.parametrize('switch', ['LMDEPLOY_TPU_OVERLAP', 'LMDEPLOY_TPU_PIPELINE'])
def test_each_switch_off_same_tokens(tiny_model_dir, solo_tokens, monkeypatch, switch):
    """Either switch at 0 turns its path off and leaves the tokens as they were."""
    monkeypatch.setenv(switch, '0')
    eng = _engine('torch', tiny_model_dir)
    try:
        got = _staggered(eng, _prompts())
        assert got == solo_tokens['jax']
        if switch == 'LMDEPLOY_TPU_OVERLAP':
            assert not eng._overlap and eng._overlap_dispatches == 0
            assert eng._pipelined_runs > 0
        else:
            assert not eng._pipeline and eng._pipelined_runs == 0
            assert eng._overlap_dispatches > 0
    finally:
        eng.close()


def test_overlap_scheduler_pass_never_preempts(tiny_model_dir):
    """With blocks held by a running sequence, the overlap pass admits nothing where
    the normal pass preempts the younger runner for an older waiting request."""
    from lmdeploy_tpu_torch.paging.seq import MessageStatus, SamplingParams
    eng = _engine('torch', tiny_model_dir, num_gpu_blocks=8, max_batch_size=4)
    try:
        sched = eng.scheduler
        sched.add_session(1)
        runner = sched.seq_manager.get_session(1).add_sequence(
            list(range(3, 83)), SamplingParams(max_new_tokens=8))   # 5 of 8 blocks
        while runner.status != MessageStatus.RUNNING:      # two 64-token chunks
            chunk = sched.schedule().prefill_chunks[0]
            sched.on_prefill_done(chunk, 7 if chunk.is_last else None)
        sched.add_session(2)
        waiting = sched.seq_manager.get_session(2).add_sequence(
            list(range(3, 120)), SamplingParams(max_new_tokens=4))
        waiting.metrics.arrival_time = runner.metrics.arrival_time - 1.0   # older
        out = sched.schedule_overlap_prefill()
        assert out.prefill_chunks == []
        assert sched.num_preemptions == 0 and runner.status == MessageStatus.RUNNING
        out = sched.schedule()
        assert [c.seq for c in out.prefill_chunks] == [waiting]
        assert sched.num_preemptions == 1 and runner.status == MessageStatus.WAITING
    finally:
        eng.close()
