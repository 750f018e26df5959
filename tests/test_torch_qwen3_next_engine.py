"""Qwen3-Next's Engine in the port against the JAX Engine on a tiny seeded checkpoint
(``hybrid_cases``; 4 layers in two blocks of one gated-DeltaNet and one full-attention
layer): exact greedy tokens and equal scheduling (preemptions, prefill tokens computed,
state checkpoints) over one engine of each package, which serves concurrent sessions over
reused batch slots with chunked prefill and prompts of 64 tokens and more (prefix
caching on, no hit).  An engine of the port that prefills each prompt at once confirms
the tokens; test_torch_qwen3_next_preempt.py and _prefix.py hold preemption and
prefix-cache hits."""
import pytest

import hybrid_cases as hc


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return hc.write_qwen3_next(str(tmp_path_factory.mktemp('qwen3_next_engine') / 'ckpt'),
                               interval=2)


@pytest.fixture(scope='module')
def engines(ckpt):
    built = hc.engine_pair(ckpt)
    yield built
    for e in built.values():
        e.close()


def test_concurrent_sessions_and_chunked_prefill(ckpt, engines):
    """Six concurrent prompts of 5 to 100 tokens over four batch slots (finished rows'
    slots reused, each first chunk zeroing its slot's state); the 70- and 100-token
    prompts prefill in two chunks of the 64-token budget, the state carried between them.
    Tokens equal the JAX engine's and a roomy engine's whose 128-token budget prefills
    each prompt at once."""
    ps = hc.prompts(11, (8, 19, 70, 33, 5, 100))
    got = hc.both(engines, [ps], 8)
    one, _ = hc.run('torch', ckpt, [ps], 8, **dict(hc.ROOMY, max_prefill_token_num=128,
                                                   prefill_buckets=[128]))
    assert got == one
