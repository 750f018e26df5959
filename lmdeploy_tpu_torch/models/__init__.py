"""Model registry: HF architecture name -> model builder.

Port of the dense-llama part of ``lmdeploy_tpu/models/__init__.py`` (the ``_llama``,
``_qwen2`` and ``_qwen3`` builders), its sparse-MoE ``_mixtral``, ``_qwen2_moe`` and
``_qwen3_moe`` builders and its ``_gpt_oss`` entry; the other families are later
slices.
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


def build_model(config: ModelConfig) -> LlamaModel:
    builder = _REGISTRY.get(config.hf_arch)
    if builder is None:
        raise ValueError(f'unsupported architecture {config.hf_arch!r}; '
                         f'supported: {sorted(_REGISTRY)}')
    return builder(config)

