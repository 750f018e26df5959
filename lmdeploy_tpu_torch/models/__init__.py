"""Model registry: HF architecture name -> model builder.

Port of ``lmdeploy_tpu/models/__init__.py`` for the families ported so far: the dense
llama builders (``_llama``, ``_qwen2``, ``_qwen3``), the sparse-MoE ones (``_mixtral``,
``_qwen2_moe``, ``_qwen3_moe``), ``_gpt_oss`` and ``_deepseek`` (DeepSeek-V2 / V3 with
MLA); the other families are later slices.
"""
from __future__ import annotations

from typing import Callable, Dict

from ..config import ModelConfig
from .llama import LlamaModel

_REGISTRY: Dict[str, Callable[[ModelConfig], LlamaModel]] = {}


def register_model(*hf_archs):
    def wrap(builder):
        for arch in hf_archs:
            _REGISTRY[arch] = builder
        return builder
    return wrap


@register_model('LlamaForCausalLM', 'MistralForCausalLM')
def _llama(config: ModelConfig) -> LlamaModel:
    return LlamaModel(config)


@register_model('Qwen2ForCausalLM')
def _qwen2(config: ModelConfig) -> LlamaModel:
    config.attention_bias = True
    return LlamaModel(config)


@register_model('Qwen3ForCausalLM')
def _qwen3(config: ModelConfig) -> LlamaModel:
    config.qk_norm = True
    return LlamaModel(config)


@register_model('MixtralForCausalLM')
def _mixtral(config: ModelConfig) -> LlamaModel:
    from .mixtral import MixtralModel
    return MixtralModel(config)


@register_model('Qwen2MoeForCausalLM')
def _qwen2_moe(config: ModelConfig) -> LlamaModel:
    from .mixtral import MixtralModel
    config.attention_bias = True
    return MixtralModel(config)


@register_model('Qwen3MoeForCausalLM')
def _qwen3_moe(config: ModelConfig) -> LlamaModel:
    from .mixtral import MixtralModel
    config.qk_norm = True
    return MixtralModel(config)


@register_model('GptOssForCausalLM')
def _gpt_oss(config: ModelConfig) -> LlamaModel:
    from .gpt_oss import GptOssModel
    config.attention_bias = True
    return GptOssModel(config)


@register_model('DeepseekV2ForCausalLM', 'DeepseekV3ForCausalLM')
def _deepseek(config: ModelConfig) -> LlamaModel:
    from .deepseek import DeepseekV2Model
    # MLA: one latent kv head; the cache row width comes from cache_head_dim
    config.num_key_value_heads = 1
    return DeepseekV2Model(config)


def build_model(config: ModelConfig) -> LlamaModel:
    builder = _REGISTRY.get(config.hf_arch)
    if builder is None:
        raise ValueError(f'unsupported architecture {config.hf_arch!r}; '
                         f'supported: {sorted(_REGISTRY)}')
    return builder(config)

