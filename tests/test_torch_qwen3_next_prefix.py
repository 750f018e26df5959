"""Qwen3-Next's Engine in the port against the JAX Engine on a tiny seeded checkpoint
(``hybrid_cases``; 4 layers in two blocks of one gated-DeltaNet and one full-attention
layer): exact greedy tokens and equal scheduling (preemptions, prefill tokens computed,
state checkpoints) over one engine of each package, which serves prefix-cache hits
restored from state checkpoints.  An engine of the port without prefix caching confirms
the tokens; it also does where a match trimmed to 0 waits a pass (the JAX engine's
scheduler asserts there).  test_torch_qwen3_next_preempt.py holds preemption."""
import pytest

import hybrid_cases as hc


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return hc.write_qwen3_next(str(tmp_path_factory.mktemp('qwen3_next_prefix') / 'ckpt'),
                               interval=2)


@pytest.fixture(scope='module')
def engines(ckpt):
    built = hc.engine_pair(ckpt)
    yield built
    for e in built.values():
        e.close()


def test_prefix_caching_restores_state_checkpoints(ckpt, engines):
    """An 80-token prompt, the same again (a hit at its 64-token checkpoint: the state
    restored, 16 tokens computed), then a prompt sharing 32 tokens (no checkpoint at 32:
    computed from 0) twice.  Tokens and checkpoint decisions equal the JAX engine's;
    tokens equal an engine's without prefix caching, which computes more tokens."""
    p = hc.prompts(5, (80,))[0]
    p3 = p[:32] + hc.prompts(6, (50,))[0]
    waves = [[p], [p], [p3], [p3]]
    before = hc.stats(engines['torch'])
    got = hc.both(engines, waves, 8)
    after = hc.stats(engines['torch'])
    assert after['ckpt'][1] - before['ckpt'][1] >= 2
    plain, pstats = hc.run('torch', ckpt, waves, 8, **hc.ROOMY)
    assert got == plain
    assert after['computed'] - before['computed'] < pstats['computed']


def _deferrals(scheduler) -> list:
    """Record the sequences that each prefill pass of ``scheduler`` left waiting with
    matched blocks and nothing computed: a match trimmed to 0, not admitted."""
    seen = []
    inner = scheduler._schedule_prefill_pass

    def recorded(candidates, *args, **kwargs):
        out = inner(candidates, *args, **kwargs)
        admitted = {id(c.seq) for c in out.prefill_chunks}
        seen.extend(s.seq_id for s in candidates if id(s) not in admitted
                    and s.logical_blocks and s.num_computed_tokens == 0)
        return out
    scheduler._schedule_prefill_pass = recorded
    return seen


def test_trimmed_match_not_admitted_serves_on(ckpt):
    """A 40-token prompt (its snapshot at 32 only), then a 2-token prompt beside one
    sharing its first 20 tokens (block size 16): the latter's match of block 0 is
    trimmed to 0 and its 48-token chunk waits a pass (the padding cap), holding the
    block.  The engine serves on; tokens equal an engine's without prefix caching."""
    p = hc.prompts(7, (40,))[0]
    short, rest = hc.prompts(8, (2, 30))
    waves = [[p], [short, p[:20] + rest]]
    engine = hc.build('torch', ckpt, enable_prefix_caching=True)
    deferred = _deferrals(engine.scheduler)
    try:
        got = hc.serve_waves(engine, waves, 8)
    finally:
        engine.close()
    assert deferred
    plain, _ = hc.run('torch', ckpt, waves, 8)
    assert got == plain
