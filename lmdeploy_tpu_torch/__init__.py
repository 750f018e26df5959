"""lmdeploy_tpu_torch: the PyTorch / CUDA port of lmdeploy_tpu for one NVIDIA Hopper GPU.

A second package beside the JAX reference ``lmdeploy_tpu``, with the same module names
and user surface.  Plain tensor code is PyTorch; every TPU Pallas kernel on a ported
path becomes a CUDA kernel written for ``sm_90a`` (``csrc/``, built at first use by
``ops/cuda_build.py``).  It never imports jax or ``lmdeploy_tpu``.
"""
from .api import pipeline  # noqa: F401
from .chat_template import ChatTemplateConfig  # noqa: F401
from .messages import (EngineOutput, GenerationConfig, PytorchEngineConfig,  # noqa: F401
                       QuantPolicy, Response, ResponseType, TpuEngineConfig)
from .tokenizer import Tokenizer  # noqa: F401

__version__ = '0.1.0'
