"""Qwen3-Next's Engine in the port against the JAX Engine on a tiny seeded checkpoint
(``hybrid_cases``; 4 layers in two blocks of one gated-DeltaNet and one full-attention
layer): exact greedy tokens and equal scheduling (preemptions, prefill tokens computed,
state checkpoints) over one engine of each package, which serves a wave that preempts by
recompute.  An engine of the port with more blocks and no prefix caching confirms the
tokens; test_torch_qwen3_next_prefix.py holds prefix-cache hits."""
import pytest

import hybrid_cases as hc


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return hc.write_qwen3_next(str(tmp_path_factory.mktemp('qwen3_next_preempt') / 'ckpt'),
                               interval=2)


@pytest.fixture(scope='module')
def engines(ckpt):
    built = hc.engine_pair(ckpt)
    yield built
    for e in built.values():
        e.close()


def test_recompute_preemption(ckpt, engines):
    """Four 50-token prompts generating 24 tokens each need eight blocks of 64 slots; in
    four, decode preempts by recompute (the victim's first chunk zeroes its state again).
    Tokens equal the JAX engine's and a roomy engine's."""
    before = hc.stats(engines['torch'])['preemptions']
    ps = hc.prompts(13, (50, 50, 50, 50))
    got = hc.both(engines, [ps], 24)
    assert hc.stats(engines['torch'])['preemptions'] > before
    roomy, st = hc.run('torch', ckpt, [ps], 24, **hc.ROOMY)
    assert got == roomy and st['preemptions'] == 0
