"""Internal engine configuration derived from user configs + HF model configs.

Port of ``lmdeploy_tpu/config.py`` for the dense llama family the port serves
(``LlamaForCausalLM``, ``MistralForCausalLM``, ``Qwen2ForCausalLM``,
``Qwen3ForCausalLM``).  Dtypes are torch dtypes; the multimodal / MoE / MLA
config fields of the reference are not carried until a slice ports those models.
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
    hf_config: Optional[Dict[str, Any]] = None
    quantization_config: Optional[Dict[str, Any]] = None

    @property
    def rope_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any], dtype: str = 'auto') -> 'ModelConfig':
        archs = cfg.get('architectures') or ['LlamaForCausalLM']
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
class MiscConfig:
    empty_init: bool = False
    prefill_buckets: Optional[List[int]] = None
    decode_buckets: Optional[List[int]] = None


# TpuEngineConfig fields the port does not read yet: a value other than the default
# would ask for parallelism, a quantized cache or checkpoint, KV roles, swap, LoRA,
# diffusion decoding, MemDecode or model download, none of which the port does
_UNPORTED_FIELDS = ('tp', 'dp', 'ep', 'cp', 'attn_tp_size', 'mlp_tp_size',
                    'num_cpu_blocks', 'quant_policy', 'model_format', 'eager_mode',
                    'role', 'adapters', 'dllm_block_length', 'memdecode', 'revision',
                    'download_dir')


def check_ported(engine_config: TpuEngineConfig):
    """Validate ``engine_config`` and raise ``NotImplementedError`` for each field
    set away from its default that the port does not serve yet."""
    engine_config.validate()
    default = TpuEngineConfig()
    unported = [f'{name}={getattr(engine_config, name)!r}' for name in _UNPORTED_FIELDS
                if getattr(engine_config, name) != getattr(default, name)]
    if unported:
        raise NotImplementedError(f'not ported yet: {", ".join(unported)}')


@dataclass
class EngineConfigBundle:
    """All internal configs for one engine."""

    model: ModelConfig
    cache: CacheConfig
    scheduler: SchedulerConfig
    misc: MiscConfig

    @classmethod
    def build(cls, model_path: str, engine_config: TpuEngineConfig) -> 'EngineConfigBundle':
        check_ported(engine_config)
        model = ModelConfig.from_pretrained(model_path, dtype=engine_config.dtype,
                                            hf_overrides=engine_config.hf_overrides)
        session_len = engine_config.session_len or model.max_position_embeddings
        cache = CacheConfig(
            block_size=engine_config.block_size,
            num_gpu_blocks=engine_config.num_gpu_blocks,
            cache_max_entry_count=engine_config.cache_max_entry_count,
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
                          decode_buckets=engine_config.decode_buckets)
        return cls(model=model, cache=cache, scheduler=sched, misc=misc)


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
