"""Safetensors -> parameter tree loader (dense f32 / bf16 / f16 checkpoints).

Port of ``lmdeploy_tpu/weight_loader.py`` (``load_params_np``): allocate the model's
stacked parameter tree once on the host, stream every safetensors shard through the
model's assign plan (transposing linears to ``[in, out]``), then move each leaf to the
device once.  ``safetensors`` is imported only here, when a checkpoint is read.
"""
from __future__ import annotations

import glob
import os
from typing import Dict

import torch


def iter_safetensors(model_path: str):
    """Yield (name, tensor) over all safetensors shards of a checkpoint."""
    from safetensors import safe_open
    files = sorted(glob.glob(os.path.join(model_path, '*.safetensors')))
    if not files:
        raise FileNotFoundError(f'no *.safetensors under {model_path}')
    for path in files:
        with safe_open(path, framework='pt') as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def _alloc_tree(shapes: Dict, dtype: torch.dtype) -> Dict:
    return {k: _alloc_tree(v, dtype) if isinstance(v, dict)
            else torch.zeros(v, dtype=dtype) for k, v in shapes.items()}


def load_params(model, model_path: str, device) -> Dict:
    """Stream HF safetensors shards into the model's stacked tree on ``device``."""
    dtype = model.config.torch_dtype()
    params = _alloc_tree(model.param_shapes(), dtype)
    plan = model.make_assign_plan()
    for name, tensor in iter_safetensors(model_path):
        entry = plan.get(name)
        if entry is None:
            continue
        path, transpose = entry
        if transpose:
            tensor = tensor.t()
        node = params
        for part in path[:-1]:
            node = node[part]
        if isinstance(path[-1], int):
            node[path[-1]].copy_(tensor)
        else:
            node[path[-1]] = tensor.to(dtype).contiguous()
    return _to_device(params, device)


def _to_device(tree: Dict, device) -> Dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
