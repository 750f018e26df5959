"""Safetensors -> parameter tree loader (dense f32 / bf16 / f16, AWQ / GPTQ, MXFP4 and
blocked-fp8 checkpoints).

Port of ``lmdeploy_tpu/weight_loader.py`` (``load_params_np``): allocate the model's
stacked parameter tree once on the host (typed leaves keep their own dtypes: int32
``packed``, f32 ``scales`` / ``zeros`` / ``scale``, u8 ``nib``), stream every
safetensors shard through the model's assign plan (each entry's transform: transposing
linears to ``[in, out]``, repacking AWQ / GPTQ nibbles to the kernel layout, Gemma's
``1 + w`` norm fold in f32; one tensor may fill several leaves, as the fused
``qkv_proj`` / ``gate_up_proj`` / ``W_pack`` / ``query_key_value`` / grouped ``wqkv`` of
the dense variants split into row blocks, or one expert or a column slice of a stacked
layer row; a
transform's f32 result rounds once to the leaf's dtype), hand every name
the plan does not know to the model's ``load_hook`` (gpt-oss's ``*_blocks`` /
``*_scales`` pairs), then move each leaf to the device once.  A model that sets
``dequant_on_load`` (DeepSeek on a native blocked-fp8 checkpoint) reads its fp8
weights through ``_dequant_blocked_fp8``, which widens each with its
``weight_scale_inv`` grid, except the names its ``keep_fp8`` predicate lets through
(the routed expert stacks, which stay fp8-resident).  ``safetensors`` is imported only
here, when a checkpoint is read.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, Dict, Iterable, Optional

import torch

_FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


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


def _dequant_blocked_fp8(it: Iterable, keep: Optional[Callable[[str], bool]] = None):
    """Stream adapter (reference ``weight_loader._dequant_blocked_fp8``): pair each fp8
    ``X.weight`` with its ``X.weight_scale_inv`` (in either order) and yield the f32
    weight ``w8 * scale`` under ``X.weight``, the [ceil(N/bn), ceil(K/bk)] scale grid
    expanded over its blocks.  Names ``keep`` accepts pass through untouched, weight
    and scale alike; an unpaired fp8 weight or scale passes through at the end."""
    def deq(w8, s):
        n, k = w8.shape
        s = s.float()
        bn, bk = -(-n // s.shape[0]), -(-k // s.shape[1])
        sf = s.repeat_interleave(bn, 0)[:n].repeat_interleave(bk, 1)[:, :k]
        return w8.float() * sf

    pending_w: Dict[str, torch.Tensor] = {}
    pending_s: Dict[str, torch.Tensor] = {}
    for name, tensor in it:
        if keep is not None and keep(name):
            yield name, tensor
        elif name.endswith('.weight_scale_inv'):
            base = name[:-len('_scale_inv')]
            if base in pending_w:
                yield base, deq(pending_w.pop(base), tensor)
            else:
                pending_s[base] = tensor
        elif name.endswith('.weight') and tensor.dtype in _FP8_DTYPES:
            if name in pending_s:
                yield name, deq(tensor, pending_s.pop(name))
            else:
                pending_w[name] = tensor
        else:
            yield name, tensor
    yield from pending_w.items()
    for name, s in pending_s.items():
        yield name + '_scale_inv', s


def _weight_stream(model, model_path: str):
    it = iter_safetensors(model_path)
    if getattr(model, 'dequant_on_load', False):
        it = _dequant_blocked_fp8(it, keep=getattr(model, 'keep_fp8', None))
    return it


def _alloc_tree(shapes: Dict, dtype: torch.dtype) -> Dict:
    from .models.llama import Leaf
    return {k: _alloc_tree(v, dtype) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=v.dtype) if isinstance(v, Leaf)
            else torch.zeros(v, dtype=dtype) for k, v in shapes.items()}


def load_params(model, model_path: str, device) -> Dict:
    """Stream HF safetensors shards into the model's stacked tree on ``device``."""
    dtype = model.config.torch_dtype()
    params = _alloc_tree(model.param_shapes(), dtype)
    plan = model.make_assign_plan()
    hook = getattr(model, 'load_hook', None)
    for name, tensor in _weight_stream(model, model_path):
        entry = plan.get(name)
        if entry is None:
            if hook is not None:
                hook(name, tensor, params)
            continue
        for path, transform, *col in entry if isinstance(entry, list) else [entry]:
            _assign(params, path, tensor if transform is None else transform(tensor), *col)
    return _to_device(params, device)


def _assign(params: Dict, path, tensor: torch.Tensor, col=None):
    """Write ``tensor`` at ``path``; a trailing int selects the stacked layer row,
    which keeps its leaf's dtype, and a column within that row: an expert (``col.e``,
    the plan's ``models.mixtral.ExpertSlice``) or a ``slice`` of the last axis (Qwen3.5's
    ``in_proj_b`` / ``in_proj_a`` halves; reference weight_loader.py:146-153)."""
    node = params
    for part in path[:-1]:
        node = node[part]
    if isinstance(path[-1], int):
        row = node[path[-1]]
        if isinstance(col, slice):
            row = row[..., col]
        elif col is not None:
            row = row[col.e]
        row.copy_(tensor)
    else:
        node[path[-1]] = tensor.to(node[path[-1]].dtype).contiguous()


def _to_device(tree: Dict, device) -> Dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
