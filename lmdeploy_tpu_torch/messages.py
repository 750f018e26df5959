"""User-facing configuration dataclasses and engine I/O types.

Copy of ``lmdeploy_tpu/messages.py`` for the PyTorch/CUDA port, kept separate because
importing any ``lmdeploy_tpu`` module loads jax.  The user-facing surface is identical, so
a caller can switch packages without relearning knobs; the parallelism fields (tp/dp/ep/cp)
are accepted but the port serves on one device only.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Literal, Optional


class QuantPolicy(enum.IntEnum):
    """Online KV-cache quantization policy (reference: messages.py:20)."""

    NONE = 0
    KV_INT8 = 4
    KV_INT4 = 8
    KV_FP8 = 16
    TURBO_QUANT = 42    # K = 4-bit QJL (3-bit Lloyd-Max + sign), V = 2-bit MSE


@dataclass
class GenerationConfig:
    """Per-request sampling / generation parameters.

    Mirrors the surface of the reference GenerationConfig (messages.py:36) so users can
    switch frameworks without relearning knobs.
    """

    n: int = 1
    max_new_tokens: int = 512
    do_sample: bool = False
    top_p: float = 1.0
    top_k: int = 50
    min_p: float = 0.0
    temperature: float = 0.8
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    ignore_eos: bool = False
    random_seed: Optional[int] = None
    stop_words: Optional[List[str]] = None
    bad_words: Optional[List[str]] = None
    stop_token_ids: Optional[List[int]] = None
    bad_token_ids: Optional[List[int]] = None
    min_new_tokens: Optional[int] = None
    skip_special_tokens: bool = True
    spaces_between_special_tokens: bool = True
    logprobs: Optional[int] = None
    response_format: Optional[Dict[str, Any]] = None
    logits_processors: Optional[List[Any]] = None
    output_logits: Optional[Literal['all', 'generation']] = None
    output_last_hidden_state: Optional[Literal['all', 'generation']] = None
    include_stop_str_in_output: bool = False
    adapter_name: Optional[str] = None      # S-LoRA: per-request adapter

    def convert_stop_bad_words_to_ids(self, tokenizer) -> 'GenerationConfig':
        """Resolve stop/bad word strings into token-id lists (reference: messages.py:139)."""
        if self.stop_words:
            ids = self.stop_token_ids or []
            for word in self.stop_words:
                tok = tokenizer.indexes_containing_token(word)
                ids.extend(tok)
            self.stop_token_ids = sorted(set(ids))
        if self.bad_words:
            ids = self.bad_token_ids or []
            for word in self.bad_words:
                ids.extend(tokenizer.indexes_containing_token(word))
            self.bad_token_ids = sorted(set(ids))
        return self

    def validate(self):
        assert self.n == 1, 'only n==1 supported for now'
        assert 0 < self.top_p <= 1.0, f'top_p must be in (0, 1], got {self.top_p}'
        assert self.top_k >= 0, f'top_k must be >= 0, got {self.top_k}'
        assert 0 <= self.min_p <= 1.0, f'min_p must be in [0, 1], got {self.min_p}'
        assert self.temperature >= 0, f'temperature must be >= 0, got {self.temperature}'


@dataclass
class TpuEngineConfig:
    """Engine configuration (analog of PytorchEngineConfig, reference messages.py:371).

    Parallelism maps to a jax Mesh with axes (dp, tp, ep, cp); on a single host these are
    chips, on multi-host they span the pod slice via jax.distributed.
    """

    dtype: str = 'auto'                      # 'auto' | 'float16' | 'bfloat16' | 'float32'
    tp: int = 1                              # tensor-parallel size (mesh axis 'tp')
    dp: int = 1                              # data/attention-DP size (mesh axis 'dp')
    ep: int = 1                              # expert-parallel size (mesh axis 'ep', MoE)
    cp: int = 1                              # context-parallel size (KV striping over 'cp')
    attn_tp_size: Optional[int] = None       # per-layer-type TP override (attention)
    mlp_tp_size: Optional[int] = None        # per-layer-type TP override (mlp)
    session_len: Optional[int] = None        # max total sequence length
    max_batch_size: Optional[int] = None
    cache_max_entry_count: float = 0.8       # fraction of free HBM for KV cache
    block_size: int = 128                    # paged-KV block granularity (tokens);
                                             # 128 = one TPU lane tile, zero padding
    num_cpu_blocks: int = 0                  # host-offload swap pool
    num_gpu_blocks: int = 0                  # 0 = derive from free HBM
    quant_policy: int = 0                    # QuantPolicy for online KV quant
    model_format: Optional[str] = None       # None | 'awq' | 'gptq' | 'fp8' | 'mxfp4'
    enable_prefix_caching: bool = False
    max_prefill_token_num: int = 8192        # chunked-prefill token budget per step
    eager_mode: bool = False                 # disable bucketing/jit warmup (debug)
    prefill_buckets: Optional[List[int]] = None   # token-count buckets for prefill jit
    decode_buckets: Optional[List[int]] = None    # batch-size buckets for decode jit
    max_prefill_batch: int = 8               # max sequences prefilled in one step
    empty_init: bool = False                 # random-init weights (benchmarks/tests)
    hf_overrides: Optional[Dict[str, Any]] = None
    revision: Optional[str] = None
    download_dir: Optional[str] = None
    role: str = 'hybrid'                     # 'hybrid' | 'prefill' | 'decode' (PD)
    adapters: Optional[Dict[str, str]] = None  # S-LoRA: {name: peft_path} slots
    # diffusion-LLM decoding (SDAR-style block denoising; reference
    # strategies/dllm + config.py DLLMConfig).  block_length 0 = disabled.
    dllm_block_length: int = 0
    dllm_unmasking_strategy: str = 'low_confidence_dynamic'
    dllm_denoising_steps: Optional[int] = None
    dllm_confidence_threshold: float = 0.85
    dllm_mask_token: int = 151669
    # MemDecode: auxiliary memory model whose log-probs fuse with the base
    # model's each step (reference: config.py MemDecodeConfig + memdecode/).
    # {'memory_model_path', 'lambda_value', 'adaptive_router', 'router_path',
    #  'lambda_base_only_threshold'}; None = disabled.
    memdecode: Optional[Dict[str, Any]] = None

    def validate(self):
        assert self.tp >= 1 and self.dp >= 1 and self.ep >= 1 and self.cp >= 1
        assert self.block_size > 0 and (self.block_size & (self.block_size - 1)) == 0, \
            f'block_size must be a power of two, got {self.block_size}'
        assert 0 < self.cache_max_entry_count <= 1.0


@dataclass
class SpeculativeConfig:
    """Speculative decoding (reference: messages.py:759).

    method 'draft_model': a smaller checkpoint proposes num_speculative_tokens
    per step; the target verifies them in one forward (exact output distribution
    via rejection sampling).
    method 'eagle': a 1-layer EAGLE head conditioned on the target's pre-norm
    features proposes instead (models/eagle.py); same exactness guarantee.
    method 'eagle3': EAGLE-3 head — 2H-wide attention over
    [norm(embed); norm(hidden)], fc over the target's 3 concatenated aux
    hidden layers, reduced draft vocab with d2t id translation
    method 'deepseek_mtp': the DeepSeek-V3 Multi-Token-Prediction module
    (the checkpoint's extra layer, models/deepseek.py DeepseekMTP) proposes;
    ``model`` may be omitted — the MTP weights live in the target checkpoint.
    method 'qwen3_5_mtp': the Qwen3.5 MTP layer (``mtp.`` weights in the
    target checkpoint, models/qwen3_5.py Qwen3_5MTP); the hybrid target's
    conv/recurrent state is rolled back to the last accepted position via
    per-position snapshots during verification.
    The port serves 'draft_model', 'eagle' and 'eagle3' (``engine/spec_agent.py``); the
    two MTP methods raise until ROADMAP.md items 6 and 14 bring their heads.
    """

    method: str = 'draft_model'
    model: Optional[str] = None              # draft checkpoint path
    num_speculative_tokens: int = 4


# Back-compat alias matching the reference name users know.
PytorchEngineConfig = TpuEngineConfig


class ResponseType(enum.IntEnum):
    """Engine response status codes (reference: messages.py:540)."""

    SUCCESS = 0
    FINISH = 1
    ENGINE_STOP_ERROR = 2
    SESSION_REPEAT = 3
    SESSION_NOT_EXIST = 4
    HANDLER_NOT_EXIST = 5
    INPUT_LENGTH_ERROR = 6
    INPUT_EMBEDDING_ERROR = 7
    INTERNAL_ENGINE_ERROR = 8
    CANCEL = 9
    OUT_OF_MEMORY = 10


@dataclass
class Logprob:
    logprob: float
    rank: Optional[int] = None
    decoded_token: Optional[str] = None


@dataclass
class Response:
    """Final user-visible inference result (reference: messages.py:572)."""

    text: str
    generate_token_len: int
    input_token_len: int
    finish_reason: Optional[Literal['stop', 'length', 'error', 'abort']] = None
    token_ids: List[int] = field(default_factory=list)
    logprobs: Optional[List[Dict[int, Logprob]]] = None
    logits: Any = None
    last_hidden_state: Any = None
    index: int = 0

    def __repr__(self):
        return (f'Response(text={self.text!r}, generate_token_len='
                f'{self.generate_token_len}, input_token_len={self.input_token_len}, '
                f'finish_reason={self.finish_reason!r})')


@dataclass
class EngineOutput:
    """One streamed step output from the backend engine (reference: messages.py:717)."""

    status: ResponseType
    token_ids: List[int]
    num_token: int
    logprobs: Optional[List[Dict[int, Logprob]]] = None
    cache_block_ids: Optional[List[int]] = None
    req_metrics: Optional['RequestMetrics'] = None


@dataclass
class RequestMetrics:
    """Per-request timing metrics surfaced alongside engine outputs."""

    arrival_time: float = 0.0
    first_scheduled_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0


@dataclass
class ScheduleMetrics:
    """Scheduler snapshot (reference: messages.py:694)."""

    num_running: int = 0
    num_waiting: int = 0
    num_free_blocks: int = 0
    num_total_blocks: int = 0

    @property
    def cache_usage(self) -> float:
        if self.num_total_blocks == 0:
            return 0.0
        return 1.0 - self.num_free_blocks / self.num_total_blocks
