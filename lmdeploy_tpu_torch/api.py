"""Public entry points (port of ``lmdeploy_tpu/api.py``): ``pipeline()`` and
``serve()``, the OpenAI-compatible API server."""
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


def serve(model_path: str, server_name: str = '0.0.0.0', server_port: int = 23333,
          backend_config: Optional[TpuEngineConfig] = None, device=None, **kwargs):
    """Launch the OpenAI-compatible API server (reference api.py:39-44) on the GPU, or
    on the CPU with ``device='cpu'``."""
    from .serve.api_server import serve as _serve
    return _serve(model_path, server_name=server_name, server_port=server_port,
                  backend_config=backend_config, device=device, **kwargs)
