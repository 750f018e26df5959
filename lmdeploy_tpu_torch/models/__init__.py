"""Model registry: HF architecture name -> model builder.

Port of ``lmdeploy_tpu/models/__init__.py`` for the families ported so far: the dense
llama builders (``_llama``, ``_qwen2``, ``_qwen3``), the dense variants (``_gemma``,
``_phi3``, ``_glm4``, ``_chatglm``, ``_internlm2``, ``_baichuan``, ``_internlm_v1``,
``_starcoder2``, ``_minicpm``), the sparse-MoE ones (``_mixtral``, ``_qwen2_moe``,
``_qwen3_moe``, ``_phimoe``), ``_gpt_oss``, ``_deepseek`` (DeepSeek-V2 / V3 with MLA),
DeepSeek's MoE with GQA attention (``_glm4_moe``, ``_deepseek_v1``), the DSA models
(``_deepseek_v32``, ``_glm_moe_dsa``) and the hybrid linear-attention models
(``_qwen3_next``, ``_qwen3_5``) and the reward models (``_qwen2_reward``,
``_internlm2_reward``): 39 of the reference's 69 registry names; the other families are
not ported yet.
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


@register_model('DeepseekV32ForCausalLM')
def _deepseek_v32(config: ModelConfig) -> LlamaModel:
    from .deepseek_v32 import DeepseekV32Model
    # one latent kv head of kv_lora_rank + qk_rope + index_head_dim; the reference keeps
    # the checkpoint's num_key_value_heads and reads the first such row (ROADMAP.md
    # section 3)
    config.num_key_value_heads = 1
    return DeepseekV32Model(config)


@register_model('GlmMoeDsaForCausalLM')
def _glm_moe_dsa(config: ModelConfig) -> LlamaModel:
    from .glm_moe_dsa import GlmMoeDsaModel
    # a qk_head_dim other than nope + rope sets the rope share to the remainder
    # (reference models/__init__.py:375-386)
    qk_head_dim = (config.hf_config or {}).get('qk_head_dim')
    if qk_head_dim and qk_head_dim != config.qk_nope_head_dim + config.qk_rope_head_dim:
        config.qk_rope_head_dim = qk_head_dim - config.qk_nope_head_dim
    config.num_key_value_heads = 1
    return GlmMoeDsaModel(config)


@register_model('DeepseekForCausalLM')
def _deepseek_v1(config: ModelConfig) -> LlamaModel:
    # DeepSeek-MoE 16B: GQA attention with full rotary and softmax-routed MoE with
    # shared experts and dense first-k layers, the Glm4Moe geometry
    from .glm4_moe import Glm4MoeModel
    if (config.hf_config or {}).get('moe_layer_freq', 1) != 1:
        raise ValueError('sparse moe_layer_freq != 1 is not supported')
    return Glm4MoeModel(config)


@register_model('Glm4MoeForCausalLM')
def _glm4_moe(config: ModelConfig) -> LlamaModel:
    from .glm4_moe import Glm4MoeModel
    config.scoring_func = 'sigmoid'        # Glm4MoeTopkRouter is sigmoid
    return Glm4MoeModel(config)


@register_model('PhiMoEForCausalLM', 'PhimoeForCausalLM')
def _phimoe(config: ModelConfig) -> LlamaModel:
    from .phimoe import PhiMoeModel
    return PhiMoeModel(config)


@register_model('GemmaForCausalLM', 'Gemma2ForCausalLM', 'Gemma3ForCausalLM',
                'Gemma3TextForCausalLM')
def _gemma(config: ModelConfig) -> LlamaModel:
    from .gemma import GemmaModel
    config.tie_word_embeddings = True
    return GemmaModel(config)


@register_model('Phi3ForCausalLM', 'Phi3SmallForCausalLM', 'Phi4MMForCausalLM')
def _phi3(config: ModelConfig) -> LlamaModel:
    from .phi3 import Phi3Model
    return Phi3Model(config)


@register_model('Glm4ForCausalLM', 'GlmForCausalLM')
def _glm4(config: ModelConfig) -> LlamaModel:
    from .glm4 import Glm4Model
    model = Glm4Model(config)
    if config.hf_arch == 'GlmForCausalLM':      # glm-4-9b-hf: no sandwich norms
        model.sandwich_norms = False
    return model


@register_model('ChatGLMModel', 'ChatGLMForConditionalGeneration')
def _chatglm(config: ModelConfig) -> LlamaModel:
    from .chatglm import ChatGLMModel
    return ChatGLMModel(config)


@register_model('InternLM2ForCausalLM', 'InternLM3ForCausalLM')
def _internlm2(config: ModelConfig) -> LlamaModel:
    from .internlm2 import InternLM2Model
    return InternLM2Model(config)


@register_model('Qwen2ForRewardModel')
def _qwen2_reward(config: ModelConfig) -> LlamaModel:
    from .reward import Qwen2RewardModel
    return Qwen2RewardModel(config)


@register_model('InternLM2ForRewardModel')
def _internlm2_reward(config: ModelConfig) -> LlamaModel:
    from .reward import InternLM2RewardModel
    return InternLM2RewardModel(config)


@register_model('BaiChuanForCausalLM', 'BaichuanForCausalLM')
def _baichuan(config: ModelConfig) -> LlamaModel:
    from .baichuan import BaichuanModel
    if config.num_attention_heads == 40 and config.hidden_size == 5120:
        raise ValueError('Baichuan-13B uses ALiBi positional bias, which is not supported '
                         'yet')
    return BaichuanModel(config)


@register_model('InternLMForCausalLM')
def _internlm_v1(config: ModelConfig) -> LlamaModel:
    from .baichuan import InternLMv1Model
    return InternLMv1Model(config)


@register_model('Starcoder2ForCausalLM')
def _starcoder2(config: ModelConfig) -> LlamaModel:
    from .starcoder2 import Starcoder2Model
    return Starcoder2Model(config)


@register_model('MiniCPMForCausalLM')
def _minicpm(config: ModelConfig) -> LlamaModel:
    from .minicpm import MiniCPMModel
    return MiniCPMModel(config)


@register_model('Qwen3NextForCausalLM')
def _qwen3_next(config: ModelConfig) -> LlamaModel:
    from .qwen3_next import Qwen3NextModel, layer_interval
    # only the full-attention layers hold paged KV
    config.num_cache_layers = config.num_layers // layer_interval(config.hf_config or {})
    return Qwen3NextModel(config)


@register_model('Qwen3_5ForConditionalGeneration', 'Qwen3_5MoeForConditionalGeneration')
def _qwen3_5(config: ModelConfig) -> LlamaModel:
    from .qwen3_5 import Qwen3_5TextModel
    from .qwen3_next import layer_interval
    config.num_cache_layers = config.num_layers // layer_interval(config.hf_config or {})
    return Qwen3_5TextModel(config)


@register_model('MetaMoeForConditionalGeneration', 'InternS2MobiusForConditionalGeneration',
                'InternS2MobiusForCausalLM')
def _meta_moe(config: ModelConfig) -> LlamaModel:
    raise NotImplementedError(f'{config.hf_arch}: the Qwen3.5 meta-MoE expert sharing is '
                              f'not ported yet (ROADMAP.md item 14)')


def build_model(config: ModelConfig) -> LlamaModel:
    builder = _REGISTRY.get(config.hf_arch)
    if builder is None:
        raise ValueError(f'unsupported architecture {config.hf_arch!r}; '
                         f'supported: {sorted(_REGISTRY)}')
    return builder(config)


def supported_archs():
    return sorted(_REGISTRY)
