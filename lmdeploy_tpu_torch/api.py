"""Public factory function (port of ``lmdeploy_tpu/api.py``: ``pipeline()``).

The OpenAI server (``serve()``) comes with the slice that ports ``serve/api_server``.
"""
from __future__ import annotations

from typing import Optional

from .chat_template import ChatTemplateConfig
from .messages import SpeculativeConfig, TpuEngineConfig
from .pipeline import Pipeline


def pipeline(model_path: str,
             backend_config: Optional[TpuEngineConfig] = None,
             chat_template_config: Optional[ChatTemplateConfig] = None,
             log_level: str = 'WARNING',
             device=None,
             speculative_config: Optional[SpeculativeConfig] = None,
             **kwargs) -> Pipeline:
    """Build an inference pipeline over the PyTorch engine.

    ``device=None`` serves on the GPU and raises when there is none; pass
    ``device='cpu'`` to run on the CPU.  ``speculative_config`` turns speculative
    decoding on (a draft model, an EAGLE or an EAGLE-3 head).  Example::

        from lmdeploy_tpu_torch import pipeline
        pipe = pipeline('TinyLlama/TinyLlama-1.1B-Chat-v1.0')
        print(pipe(['Hi, pls intro yourself']))
    """
    return Pipeline(model_path, backend_config=backend_config,
                    chat_template_config=chat_template_config,
                    log_level=log_level, device=device,
                    speculative_config=speculative_config, **kwargs)
