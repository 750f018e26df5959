"""The port's deepseek_mtp engine on the DeepSeek MTP checkpoint (the reference's
tests/test_mtp.py fixture) against the JAX speculative engine (CPU, f32): greedy tokens
and per-step emitted counts on a concurrent batch, over a plain and an int8 target
cache (``mtp_dsa_cases.check_mtp_engine``)."""
import pytest

import mtp_dsa_cases as mc


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return mc.write_checkpoint(str(tmp_path_factory.mktemp('mtp_ds') / 'ds'), 'ds', mtp=True)


@pytest.mark.parametrize('policy', [0, 4])
def test_engine_matches_jax(ckpt, policy):
    mc.check_mtp_engine('ds', ckpt, policy)
