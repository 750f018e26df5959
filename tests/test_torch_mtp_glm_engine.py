"""The port's deepseek_mtp engine on the GLM-4.5 and GLM-MoE-DSA MTP checkpoints (the
reference's tests/test_mtp.py and test_glm_moe_dsa.py fixtures) against the JAX
speculative engine (CPU, f32): greedy tokens and each step's emitted counts
(``mtp_dsa_cases.check_mtp_engine``)."""
import pytest

import mtp_dsa_cases as mc


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp('mtp_glm')
    return {'glm4': mc.write_checkpoint(str(root / 'glm4'), 'glm4', mtp=True),
            'glm_dsa': mc.write_checkpoint(str(root / 'glm_dsa'), 'glm_dsa', mtp=True,
                                           index_topk=8)}


@pytest.mark.parametrize('name', ['glm4', 'glm_dsa'])
def test_engine_matches_jax(ckpt, name):
    mc.check_mtp_engine(name, ckpt[name], 0)
