"""DeepSeek-V3.2's DSA engine against the JAX engine (CPU, f32): greedy tokens at
top-4 on a concurrent batch (chunked prefill is held at the forward in
test_torch_dsa.py)."""
import pytest

import mtp_dsa_cases as mc
import spec_cases as sc


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return mc.write_checkpoint(str(tmp_path_factory.mktemp('dsa_engine') / 'v32'), 'v32',
                               index_topk=4)


def test_dsa_engine_greedy_tokens_match_jax(ckpt):
    """Three concurrent prompts (14 tokens at most: the top-4 picks are sparse), greedy:
    the port's Engine gives the JAX Engine's tokens."""
    ps = mc.prompts()
    ref = sc.tokens('jax', ckpt, ps, mc.NEW)
    got = sc.tokens('torch', ckpt, ps, mc.NEW)
    assert got == ref and all(len(t) == mc.NEW for t in got)
