"""The dense llama variants, part 2: Phi-3, GLM-4 / GLM, ChatGLM, InternLM2, Baichuan
and InternLM v1, the port against the JAX package (CPU, f32).

The checkpoints (``dense_family_cases.py``) keep each family's fused tensors: Phi-3's
``qkv_proj`` / ``gate_up_proj``, GLM's ``gate_up_proj`` and sandwich norms, ChatGLM's
``query_key_value`` (with its bias) and ``dense_h_to_4h`` under the legacy names,
InternLM2's ``wqkv`` grouped per kv head, Baichuan's ``W_pack``, InternLM v1's biases.
Checked: the rope pair-order helpers against the reference's, the loaded trees against
``load_params_np`` bit for bit, and f32 logits of a chunked prefill and decode steps
within 1e-4 of the JAX model's.
"""
import numpy as np
import pytest
import torch

from dense_family_cases import check_logits, models, tree_equal, write_checkpoint

FAMILIES = ('phi3', 'glm4', 'glm', 'chatglm', 'internlm2', 'baichuan', 'internlm')


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return {name: write_checkpoint(tmp_path_factory.mktemp(f'tiny_{name}'), name)
            for name in FAMILIES}


def test_pair_order_helpers_match_reference():
    """GLM's rope layout: the port's pairs_to_halves / halves_to_pairs are the
    reference's _deinterleave / _interleave, and inverse to each other."""
    import jax.numpy as jnp
    from lmdeploy_tpu.models.glm4 import _deinterleave, _interleave
    from lmdeploy_tpu_torch.nn.layers import halves_to_pairs, pairs_to_halves
    x = np.random.RandomState(0).randn(2, 3, 4, 16).astype(np.float32)
    np.testing.assert_array_equal(pairs_to_halves(torch.from_numpy(x)).numpy(),
                                  np.asarray(_deinterleave(jnp.asarray(x))))
    np.testing.assert_array_equal(halves_to_pairs(torch.from_numpy(x)).numpy(),
                                  np.asarray(_interleave(jnp.asarray(x))))
    np.testing.assert_array_equal(halves_to_pairs(pairs_to_halves(torch.from_numpy(x))).numpy(),
                                  x)


@pytest.mark.parametrize('name', FAMILIES)
def test_loader_matches_jax(ckpt, name):
    """The loaded tree equals load_params_np's: each fused tensor split into its
    leaves (bias rows too), GLM-4's sandwich norms, InternLM v1's bo."""
    _, jp, _, tp = models(ckpt[name])
    tree_equal(tp, jp)


@pytest.mark.parametrize('name', FAMILIES)
def test_forward_logits_match_jax(ckpt, name):
    """Prefill (one row in two chunks), then decode steps, f32."""
    check_logits(ckpt[name])
