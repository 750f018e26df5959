"""The dense llama variants through the engine: exact greedy tokens of the port's
``Engine`` against the JAX engine's (CPU, f32) for Gemma-2 (softcaps, windows on the
even layers, the tied head), GLM-4-0414 (pair-order partial rope, sandwich norms) and
StarCoder2 (LayerNorm, biases, one window on every layer, so the scheduler frees the
blocks that leave it), on the checkpoints of ``dense_family_cases.py``.
"""
import pytest

from dense_family_cases import check_engine_tokens, write_checkpoint


@pytest.mark.parametrize('name', ['gemma2', 'glm4', 'starcoder2'])
def test_engine_greedy_tokens_match_jax(tmp_path, name):
    check_engine_tokens(write_checkpoint(tmp_path, name))
