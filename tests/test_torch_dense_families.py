"""The dense llama variants, part 1: configs, and Gemma 1-3, StarCoder2 and MiniCPM,
the port against the JAX package (CPU, f32).

Configs: the port's tied-embedding table against ``transformers.CONFIG_MAPPING``, and
each family's ``ModelConfig`` (ChatGLM's legacy field names included) against the
reference's ``from_hf_config``; the public geometries ``chip_smoke.py`` serves
(Gemma-2-9B, GLM-4-9B-0414, StarCoder2-7B) build the reference's parameter shapes;
Baichuan-13B raises as in the reference, and the families whose assign plans are dense
only refuse quantized checkpoints.  Models (``dense_family_cases.py`` writes the
checkpoints): the loaded trees equal ``load_params_np``'s bit for bit (Gemma's ``+1``
folded in f32, StarCoder2's LayerNorm biases and ``c_fc`` / ``c_proj``), and f32
logits of a chunked prefill and decode steps, past the 24-token window for Gemma-2 /
3 and StarCoder2, within 1e-4 of the JAX model's.
"""
import dataclasses
import json

import jax
import pytest

from chip_smoke import GEMMA2_9B, GLM4_9B, STARCODER2_7B
from dense_family_cases import CFGS, WINDOW, WINDOWED, check_logits, models, tree_equal, \
    write_checkpoint

FAMILIES = ('gemma', 'gemma2', 'gemma3', 'starcoder2', 'minicpm')


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return {name: write_checkpoint(tmp_path_factory.mktemp(f'tiny_{name}'), name)
            for name in FAMILIES}


def test_tied_embedding_table_matches_transformers():
    """Each model type of the port's table has its transformers config class's
    tie_word_embeddings default, and every model type the port serves that
    transformers defines is in the table."""
    from transformers import CONFIG_MAPPING
    from lmdeploy_tpu_torch.config import TIED_EMBEDDING_DEFAULT
    served = {c['model_type'] for c in CFGS.values()} | {
        'llama', 'mistral', 'qwen2', 'qwen3', 'mixtral', 'qwen2_moe', 'qwen3_moe',
        'gpt_oss', 'deepseek_v2', 'deepseek_v3', 'deepseek', 'glm4_moe', 'phimoe', 'gemma3',
        'qwen3_next'}
    assert served & set(CONFIG_MAPPING) == set(TIED_EMBEDDING_DEFAULT)
    for mt, tied in TIED_EMBEDDING_DEFAULT.items():
        assert bool(getattr(CONFIG_MAPPING[mt](), 'tie_word_embeddings', False)) is tied, mt


@pytest.mark.parametrize('name', list(CFGS))
@pytest.mark.parametrize('drop_tie', [False, True])
def test_model_config_matches_reference(name, drop_tie):
    """Every field of ModelConfig the port keeps equals the reference's, for each
    family's config as written and without its tie_word_embeddings (the transformers
    default then holds): ChatGLM's legacy names, the rope dim, windows, epsilons."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu_torch.config import ModelConfig
    cfg = {k: v for k, v in CFGS[name].items() if not (drop_tie and k == 'tie_word_embeddings')}
    tc = ModelConfig.from_hf_config(json.loads(json.dumps(cfg)))
    jc = JConfig.from_hf_config(json.loads(json.dumps(cfg)))
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.rope_dim == jc.rope_dim
    if name == 'chatglm':
        assert (tc.num_layers, tc.num_key_value_heads, tc.intermediate_size, tc.head_dim,
                tc.rope_theta, tc.rope_dim, tc.attention_bias, tc.tie_word_embeddings) == \
            (2, 2, 96, 16, 20000.0, 8, True, False)


@pytest.mark.parametrize('geometry', [GEMMA2_9B, GLM4_9B, STARCODER2_7B],
                         ids=['gemma2_9b', 'glm4_9b', 'starcoder2_7b'])
def test_public_configs(geometry):
    """The published geometries chip_smoke.py serves build on both packages with the
    same parameter shapes and the same per-layer windows; StarCoder2-7B names no
    tie_word_embeddings and is tied, as its transformers default says."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    cfg = dict(geometry, num_hidden_layers=4)
    jm = jbuild(JConfig.from_hf_config(json.loads(json.dumps(cfg))))
    tm = build_model(ModelConfig.from_hf_config(cfg))
    jshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape) if hasattr(s, 'shape') else s,
                                     jm.param_shapes(), is_leaf=lambda s: isinstance(s, tuple))
    jshapes['layers'].pop('layer_window', None)
    assert jshapes == tm.param_shapes()
    jw = getattr(jm, 'layer_windows', None)
    assert tm.layer_windows == (None if jw is None else [int(w) for w in jw])
    assert tm.config.window_uniform == jm.config.window_uniform
    assert (tm.attn_scale, tm.attn_logit_softcap, tm.final_logit_softcap, tm.embed_scale) == \
        (jm.attn_scale, jm.attn_logit_softcap, jm.final_logit_softcap, jm.embed_scale)
    if geometry is STARCODER2_7B:
        assert tm.config.tie_word_embeddings and 'lm_head' not in tm.param_shapes()
    if geometry is GEMMA2_9B:
        assert tm.layer_windows == [4096, 0, 4096, 0] and tm.attn_scale == 1 / 16


def test_baichuan_13b_raises_and_dense_plans_refuse_quantized():
    """Baichuan-13B (ALiBi) raises as in the reference; a family whose assign plan is
    dense only refuses an AWQ checkpoint."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    with pytest.raises(ValueError, match='ALiBi'):
        build_model(ModelConfig.from_hf_config(dict(
            CFGS['baichuan'], num_attention_heads=40, num_key_value_heads=40,
            hidden_size=5120, head_dim=128)))
    awq = {'quant_method': 'awq', 'group_size': 32, 'bits': 4}
    for name in ('phi3', 'glm4', 'chatglm', 'internlm2', 'baichuan', 'starcoder2'):
        with pytest.raises(NotImplementedError, match='dense only'):
            build_model(ModelConfig.from_hf_config(dict(CFGS[name], quantization_config=awq)))


@pytest.mark.parametrize('name', FAMILIES)
def test_loader_matches_jax(ckpt, name):
    """The loaded tree equals load_params_np's: Gemma's norms 1 + w (f32), its sandwich
    and qk norms; StarCoder2's norm biases, bo, c_fc / c_proj and their biases, its
    tied embedding; MiniCPM's tied embedding."""
    _, jp, _, tp = models(ckpt[name])
    tree_equal(tp, jp)


@pytest.mark.parametrize('name', FAMILIES)
def test_forward_logits_match_jax(ckpt, name):
    """Prefill (one row in two chunks), then decode steps, f32; the windowed families'
    prompts run past the window, so the window masks keys in prefill and decode."""
    check_logits(ckpt[name], prompt_len=WINDOW + 16 if name in WINDOWED else 32)
