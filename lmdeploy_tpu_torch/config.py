"""Internal engine configuration derived from user configs + HF model configs.

Port of ``lmdeploy_tpu/config.py`` for the families the port serves (the dense llama
family and its variants, ChatGLM's legacy field names included, the Mixtral / Qwen-MoE
/ PhiMoE family, gpt-oss, DeepSeek-V2 / V3 / V3.2, GLM-4.5 MoE, GLM-MoE-DSA,
DeepSeek-MoE and the hybrid linear-attention Qwen3-Next / Qwen3.5), with the reference's
MoE and MLA fields (and the DSA cache sidecar), its ``num_cache_layers`` (a hybrid
model's paged layers) and its mesh geometry (``DistConfig``).  Dtypes are torch dtypes.
A Qwen3.5 config nests its language model under ``text_config`` beside a
``vision_config``; the LM's fields are read from there, as the reference does, and the
vision tower's are not carried (multimodal inputs raise: ROADMAP.md item 15).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from .messages import QuantPolicy, TpuEngineConfig

_DTYPES = {
    'float16': torch.float16,
    'bfloat16': torch.bfloat16,
    'float32': torch.float32,
}


# ``tie_word_embeddings`` of the transformers config class of each model type the port
# serves that transformers defines (the others run remote code, and the reference
# then keeps False); tests/test_torch_dense_families.py checks it against
# ``transformers.CONFIG_MAPPING``
TIED_EMBEDDING_DEFAULT = {
    'llama': False, 'mistral': False, 'qwen2': False, 'qwen3': False, 'mixtral': False,
    'qwen2_moe': False, 'qwen3_moe': False, 'gpt_oss': False, 'deepseek_v2': False,
    'deepseek_v3': False, 'glm4_moe': False, 'phimoe': False, 'phi3': False,
    'glm4': False, 'glm': False, 'gemma': True, 'gemma2': True, 'gemma3_text': True,
    'gemma3': True, 'starcoder2': True, 'qwen3_next': False,
}
# composite configs whose language model's fields nest under ``text_config`` (reference
# config.py:147-181, for the model types the port serves)
NESTED_TEXT_TYPES = ('qwen3_5', 'qwen3_5_moe')


@dataclass
class ModelConfig:
    """Normalized transformer geometry parsed from a HF config.json
    (reference: ``lmdeploy_tpu/config.py ModelConfig``)."""

    num_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    hidden_size: int
    intermediate_size: int
    vocab_size: int
    head_dim: int
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    bos_token_id: Optional[int] = 1
    eos_token_id: List[int] = field(default_factory=lambda: [2])
    dtype: str = 'bfloat16'
    hf_arch: str = 'LlamaForCausalLM'
    model_type: str = 'llama'
    attention_bias: bool = False
    qk_norm: bool = False
    partial_rotary_factor: float = 1.0
    sliding_window: Optional[int] = None
    # see lmdeploy_tpu/config.py: True when every layer shares the window
    window_uniform: bool = True
    # MoE (reference config.py:271-275)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    # top-k on the router logits, then a softmax over the k (True); or a softmax over
    # all experts, then top-k (False).  DeepSeek reads it as: renormalize the k chosen
    # scores to sum 1 (True) or keep them (False)
    norm_topk_prob: bool = True
    # always-on shared experts (DeepSeek), each of moe_intermediate_size
    num_shared_experts: int = 0
    # MLA (DeepSeek-V2/V3, reference config.py:67-80): attention over a compressed
    # latent; the cache holds [c_kv | k_rope] under one kv head, and the rope tables are
    # built for the rope sub-dimension
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_k_dense_replace: int = 0
    # a per-token sidecar cached after the K row (reference config.py:76): the DSA
    # lightning indexer's key of DeepSeek-V3.2 / GLM-MoE-DSA, set by their models
    cache_extra_dim: int = 0
    # DeepSeek-MoE routing: scores (softmax or sigmoid), group-limited top-k over n_group
    # groups of which topk_group are kept, and a factor on the routed weights
    routed_scaling_factor: float = 1.0
    scoring_func: str = 'softmax'
    n_group: int = 0
    topk_group: int = 0
    hf_config: Optional[Dict[str, Any]] = None
    # paged-cache layer count where it differs from num_layers (hybrid models: only the
    # full-attention layers hold pages; reference config.py:83-85)
    num_cache_layers: Optional[int] = None
    quantization_config: Optional[Dict[str, Any]] = None

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def cache_head_dim(self) -> int:
        """Per-head KV-cache row width: the latent plus the rope dims under MLA
        (512 + 64 = 576 on DeepSeek-V2/V3), else head_dim; plus ``cache_extra_dim``
        (DeepSeek-V3.2's 576 + 128 = 704)."""
        if self.is_mla:
            return self.kv_lora_rank + self.qk_rope_head_dim + self.cache_extra_dim
        return self.head_dim + self.cache_extra_dim

    @property
    def cache_layers(self) -> int:
        """The paged cache's layer count: ``num_cache_layers`` where set, else every
        layer."""
        return self.num_cache_layers or self.num_layers

    @property
    def rope_dim(self) -> int:
        """The dimension the rotary tables are built for: the rope sub-dimension under
        MLA, the partial-rotary fraction of head_dim otherwise."""
        if self.is_mla:
            return self.qk_rope_head_dim
        return int(self.head_dim * self.partial_rotary_factor)

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any], dtype: str = 'auto') -> 'ModelConfig':
        archs = cfg.get('architectures') or ['LlamaForCausalLM']
        if ('vision_config' in cfg or 'text_config' in cfg) and \
                cfg.get('model_type') in NESTED_TEXT_TYPES:
            inner = cfg.get('text_config') or {
                k: v for k, v in cfg.items() if k != 'vision_config'}
            qcfg = dict(inner, architectures=archs)
            qcfg.setdefault('model_type', 'qwen2')
            qcfg.setdefault('torch_dtype', cfg.get('torch_dtype', 'bfloat16'))
            cfg = qcfg
        if cfg.get('model_type') == 'chatglm' or 'multi_query_group_num' in cfg:
            # the legacy THUDM ChatGLM2 / 3 and GLM-4 configs name their fields their
            # own way (reference config.py:128-144)
            cfg = dict(cfg)
            cfg.setdefault('num_hidden_layers', cfg.get('num_layers', 28))
            if cfg.get('multi_query_attention'):
                cfg.setdefault('num_key_value_heads', cfg['multi_query_group_num'])
            cfg.setdefault('intermediate_size', cfg.get('ffn_hidden_size'))
            cfg.setdefault('vocab_size', cfg.get('padded_vocab_size', 65024))
            cfg.setdefault('head_dim', cfg.get('kv_channels'))
            cfg.setdefault('rms_norm_eps', cfg.get('layernorm_epsilon', 1e-5))
            cfg.setdefault('max_position_embeddings', cfg.get('seq_length', 8192))
            cfg.setdefault('rope_theta', 10000.0 * cfg.get('rope_ratio', 1.0))
            cfg.setdefault('partial_rotary_factor', 0.5)
            cfg.setdefault('attention_bias', cfg.get('add_qkv_bias', False))
            cfg.setdefault('tie_word_embeddings', False)
        if 'tie_word_embeddings' not in cfg and cfg.get('model_type') in TIED_EMBEDDING_DEFAULT:
            # a config.json omits a value equal to its transformers class's default,
            # which is True for some families (reference config.py:224-236 asks
            # transformers.CONFIG_MAPPING; the port keeps its own table)
            cfg = dict(cfg, tie_word_embeddings=TIED_EMBEDDING_DEFAULT[cfg['model_type']])
        num_heads = cfg.get('num_attention_heads', 32)
        hidden = cfg.get('hidden_size', 4096)
        head_dim = cfg.get('head_dim') or hidden // num_heads
        eos = cfg.get('eos_token_id', 2)
        if eos is None:
            eos = []
        if isinstance(eos, int):
            eos = [eos]
        torch_dtype = cfg.get('torch_dtype', 'bfloat16')
        if dtype == 'auto':
            # same mapping as the reference: half precision serves in bf16
            dtype = 'bfloat16' if torch_dtype in ('float16', 'bfloat16') else 'float32'
        return cls(
            num_layers=cfg.get('num_hidden_layers', 32),
            num_attention_heads=num_heads,
            num_key_value_heads=cfg.get('num_key_value_heads') or num_heads,
            hidden_size=hidden,
            intermediate_size=cfg.get('intermediate_size', 11008),
            vocab_size=cfg.get('vocab_size', 32000),
            head_dim=head_dim,
            max_position_embeddings=cfg.get('max_position_embeddings', 4096),
            rope_theta=cfg.get('rope_theta', 10000.0),
            rope_scaling=cfg.get('rope_scaling'),
            rms_norm_eps=cfg.get('rms_norm_eps',
                                 cfg.get('norm_epsilon',
                                         cfg.get('layer_norm_eps', 1e-6))),
            tie_word_embeddings=cfg.get('tie_word_embeddings', False),
            bos_token_id=cfg.get('bos_token_id', 1),
            eos_token_id=eos,
            dtype=dtype,
            hf_arch=archs[0],
            model_type=cfg.get('model_type', 'llama'),
            num_experts=cfg.get('num_local_experts') or cfg.get('num_experts')
            or cfg.get('n_routed_experts') or 0,
            num_experts_per_tok=cfg.get('num_experts_per_tok', 0),
            moe_intermediate_size=cfg.get('moe_intermediate_size', 0),
            norm_topk_prob=cfg.get('norm_topk_prob', True),
            attention_bias=cfg.get('attention_bias', False)
            or cfg.get('qkv_bias', False),
            partial_rotary_factor=cfg.get('partial_rotary_factor', 1.0),
            sliding_window=cfg.get('sliding_window'),
            window_uniform=(
                not (cfg.get('layer_types')
                     and len(set(cfg['layer_types'])) > 1)
                and cfg.get('model_type') not in ('gemma2', 'gpt_oss')),
            hf_config=cfg,
            quantization_config=cfg.get('quantization_config'),
            num_shared_experts=cfg.get('n_shared_experts', 0) or 0,
            q_lora_rank=cfg.get('q_lora_rank'),
            kv_lora_rank=cfg.get('kv_lora_rank'),
            qk_nope_head_dim=cfg.get('qk_nope_head_dim', 0),
            qk_rope_head_dim=cfg.get('qk_rope_head_dim', 0),
            v_head_dim=cfg.get('v_head_dim', 0),
            first_k_dense_replace=cfg.get('first_k_dense_replace', 0),
            routed_scaling_factor=cfg.get('routed_scaling_factor', 1.0),
            scoring_func=cfg.get('scoring_func', 'softmax'),
            n_group=cfg.get('n_group', 0) or 0,
            topk_group=cfg.get('topk_group', 0) or 0,
        )

    @classmethod
    def from_pretrained(cls, model_path: str, dtype: str = 'auto',
                        hf_overrides: Optional[Dict[str, Any]] = None) -> 'ModelConfig':
        with open(os.path.join(model_path, 'config.json')) as f:
            cfg = json.load(f)
        if hf_overrides:
            cfg.update(hf_overrides)
        return cls.from_hf_config(cfg, dtype=dtype)

    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclass
class CacheConfig:
    """Paged KV-cache geometry (reference: lmdeploy_tpu/config.py CacheConfig)."""

    block_size: int = 64
    num_gpu_blocks: int = 0          # 0 = derive from free device memory
    cache_max_entry_count: float = 0.8
    quant_policy: QuantPolicy = QuantPolicy.NONE
    max_prefill_token_num: int = 8192
    enable_prefix_caching: bool = False
    window_size: Optional[int] = None


@dataclass
class SchedulerConfig:
    """Continuous-batching scheduler knobs (reference: lmdeploy_tpu/config.py)."""

    max_batch_size: int = 128
    max_session_len: int = 4096
    max_prefill_token_num: int = 8192
    max_prefill_batch: int = 8
    prefill_reorder: bool = True
    prefill_aging_s: float = 10.0


@dataclass
class DistConfig:
    """Mesh geometry, axes ('dp', 'ep', 'cp', 'tp') (reference: lmdeploy_tpu/config.py
    ``DistConfig``).  The port serves context parallelism (``cp``: every page's token
    slots striped over the ranks, ``parallel/mesh.py``); the other axes raise in
    ``check_ported``."""

    dp: int = 1
    tp: int = 1
    ep: int = 1
    cp: int = 1
    attn_tp: Optional[int] = None
    mlp_tp: Optional[int] = None

    def __post_init__(self):
        if self.attn_tp is None:
            self.attn_tp = self.tp
        if self.mlp_tp is None:
            self.mlp_tp = self.tp

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.ep * self.cp

    def mesh_shape(self):
        return {'dp': self.dp, 'ep': self.ep, 'cp': self.cp, 'tp': self.tp}


@dataclass
class MiscConfig:
    empty_init: bool = False
    prefill_buckets: Optional[List[int]] = None
    decode_buckets: Optional[List[int]] = None
    eager_mode: bool = False         # decode runs eagerly on the card (no CUDA graphs)


# TpuEngineConfig fields the port does not read yet: a value other than the default
# would ask for tensor, data or expert parallelism, KV roles, swap, diffusion decoding,
# MemDecode or model download, none of which the port does ('cp' is served, within the
# limits check_ported names; 'adapters', the S-LoRA slots, is served by Engine)
_UNPORTED_FIELDS = ('tp', 'dp', 'ep', 'attn_tp_size', 'mlp_tp_size',
                    'num_cpu_blocks', 'role',
                    'dllm_block_length', 'memdecode', 'revision', 'download_dir')
# the KV cache policies and checkpoint formats the port serves: every KV policy
# (plain, int8, int4, fp8, TurboQuant), dense, AWQ / GPTQ W4A16, SmoothQuant W8A8 and fp8
# weights (the format comes from the checkpoint's quantization_config; model_format
# only names it, as the reference's _detect_model_format does)
_PORTED_VALUES = {'quant_policy': tuple(QuantPolicy),
                  'model_format': (None, 'awq', 'gptq', 'w8a8', 'fp8')}


def cp_unported(cp: int, quant_policy, block_size: int,
                model: Optional[ModelConfig] = None) -> List[str]:
    """What of a context-parallel (``cp`` > 1) configuration the port does not serve
    yet: a quantized KV cache, an MLA model (the reference takes its gather path for
    both; ROADMAP.md section 1, item 16), a hybrid linear-attention model (item 16) or a
    block size the ranks do not divide."""
    if cp <= 1:
        return []
    out = []
    if quant_policy != QuantPolicy.NONE:
        out.append(f'cp={cp} with quant_policy={int(quant_policy)}')
    if model is not None and model.is_mla:
        out.append(f'cp={cp} with an MLA model ({model.hf_arch})')
    if model is not None and model.num_cache_layers:     # set by the hybrid builders
        out.append(f'cp={cp} with a hybrid linear-attention model ({model.hf_arch})')
    if block_size % cp:
        out.append(f'cp={cp} with block_size={block_size} (the ranks split each '
                   f'page\'s slots evenly)')
    return out


def check_ported(engine_config: TpuEngineConfig, model: Optional[ModelConfig] = None):
    """Validate ``engine_config`` and raise ``NotImplementedError`` for each field
    set to a value the port does not serve yet, context parallelism within the limits
    of ``cp_unported`` (whose MLA check needs ``model``)."""
    engine_config.validate()
    default = TpuEngineConfig()
    unported = [f'{name}={getattr(engine_config, name)!r}' for name in _UNPORTED_FIELDS
                if getattr(engine_config, name) != getattr(default, name)]
    unported += [f'{name}={getattr(engine_config, name)!r}'
                 for name, ok in _PORTED_VALUES.items()
                 if getattr(engine_config, name) not in ok]
    unported += cp_unported(engine_config.cp, engine_config.quant_policy,
                            engine_config.block_size, model)
    if unported:
        raise NotImplementedError(f'not ported yet: {", ".join(unported)}')


@dataclass
class EngineConfigBundle:
    """All internal configs for one engine."""

    model: ModelConfig
    cache: CacheConfig
    scheduler: SchedulerConfig
    misc: MiscConfig
    dist: DistConfig = field(default_factory=DistConfig)

    @classmethod
    def build(cls, model_path: str, engine_config: TpuEngineConfig) -> 'EngineConfigBundle':
        model = ModelConfig.from_pretrained(model_path, dtype=engine_config.dtype,
                                            hf_overrides=engine_config.hf_overrides)
        check_ported(engine_config, model)
        session_len = engine_config.session_len or model.max_position_embeddings
        cache = CacheConfig(
            block_size=engine_config.block_size,
            num_gpu_blocks=engine_config.num_gpu_blocks,
            cache_max_entry_count=engine_config.cache_max_entry_count,
            quant_policy=QuantPolicy(engine_config.quant_policy),
            max_prefill_token_num=engine_config.max_prefill_token_num,
            enable_prefix_caching=engine_config.enable_prefix_caching,
            window_size=model.sliding_window if model.window_uniform else None,
        )
        sched = SchedulerConfig(
            max_batch_size=engine_config.max_batch_size or 128,
            max_session_len=session_len,
            max_prefill_token_num=engine_config.max_prefill_token_num,
            max_prefill_batch=engine_config.max_prefill_batch,
        )
        misc = MiscConfig(empty_init=engine_config.empty_init,
                          prefill_buckets=engine_config.prefill_buckets,
                          decode_buckets=engine_config.decode_buckets,
                          eager_mode=engine_config.eager_mode)
        dist = DistConfig(dp=engine_config.dp, tp=engine_config.tp, ep=engine_config.ep,
                          cp=engine_config.cp, attn_tp=engine_config.attn_tp_size,
                          mlp_tp=engine_config.mlp_tp_size)
        return cls(model=model, cache=cache, scheduler=sched, misc=misc, dist=dist)


def make_buckets(max_value: int, minimum: int = 1) -> List[int]:
    """Power-of-two bucket schedule up to max_value (the reference's jit buckets;
    the port keeps them so both engines see the same padded shapes)."""
    buckets = []
    b = minimum
    while b < max_value:
        buckets.append(b)
        b *= 2
    buckets.append(max_value)
    return sorted(set(buckets))


def bucketize(value: int, buckets: List[int]) -> int:
    """Smallest bucket >= value."""
    for b in buckets:
        if b >= value:
            return b
    return buckets[-1]
