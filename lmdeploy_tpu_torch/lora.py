"""LoRA adapters: PEFT checkpoints, the merged single adapter, and S-LoRA slot stacks.

Port of ``lmdeploy_tpu/lora.py``.  Two ways to serve an adapter, as in the reference:
  * merged (``LoraManager``): one active adapter per engine, ``scaling * B @ A`` added
    to the base weights and subtracted again on unload.  The port writes the merged
    values in place, into the leaves the captured decode runs read (a fused ``wqkv`` /
    ``w_gateup`` leaf through its column views), so a replay after ``activate`` runs the
    merged model without a new capture.  The base is not kept: unmerging rounds,
    ``(w + d) - d`` is not ``w`` bit for bit, as in the reference;
  * S-LoRA (``build_slora_stacks``): several adapters as slot stacks, each request's
    rows picking theirs by ``adapter_ids`` inside ``LlamaModel.forward``.

PEFT tensor names read:
  base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight   [r, H]
  base_model.model.model.layers.{i}.self_attn.q_proj.lora_B.weight   [out, r]
An adapter comes as a PEFT directory (``load_peft_adapter``, which needs
``safetensors``) or as its tensors already in memory (``peft_weights``); both give the
same ``(weights, scaling)`` pair, which the functions below take in place of a path.
The host side is numpy, as the reference's, so deltas and stacks come out bit for bit.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

_HF_TO_NATIVE = {
    'self_attn.q_proj': 'wq', 'self_attn.k_proj': 'wk', 'self_attn.v_proj': 'wv',
    'self_attn.o_proj': 'wo', 'mlp.gate_proj': 'w_gate', 'mlp.up_proj': 'w_up',
    'mlp.down_proj': 'w_down',
}
_KEY_RE = re.compile(
    r'model\.layers\.(\d+)\.([a-z_]+\.[a-z_]+proj)\.lora_(A|B)\.weight')

Weights = Dict[str, Dict[int, Dict[str, np.ndarray]]]
Adapter = Union[str, 'os.PathLike', Tuple[Weights, float]]


def peft_weights(tensors: Mapping[str, np.ndarray], config: dict) -> Tuple[Weights, float]:
    """PEFT tensors by name and the adapter's config -> ({native_module: {layer:
    {'A', 'B'}}} in f32, scaling = lora_alpha / r)."""
    r = config['r']
    scaling = config.get('lora_alpha', r) / r
    weights: Weights = {}
    for name, tensor in tensors.items():
        m = _KEY_RE.search(name)
        if not m:
            continue
        layer, hf_mod, ab = int(m.group(1)), m.group(2), m.group(3)
        native = _HF_TO_NATIVE.get(hf_mod)
        if native is None:
            continue
        weights.setdefault(native, {}).setdefault(layer, {})[ab] = \
            np.asarray(tensor, np.float32)
    return weights, scaling


def load_peft_adapter(path) -> Tuple[Weights, float]:
    """Read a PEFT checkpoint directory (``adapter_config.json`` and
    ``adapter_model.safetensors``) -> ``peft_weights``'s pair."""
    from safetensors import safe_open

    with open(os.path.join(path, 'adapter_config.json')) as f:
        cfg = json.load(f)
    st = os.path.join(path, 'adapter_model.safetensors')
    with safe_open(st, framework='np') as f:
        tensors = {name: f.get_tensor(name) for name in f.keys() if _KEY_RE.search(name)}
    return peft_weights(tensors, cfg)


def adapter_weights(adapter: Adapter) -> Tuple[Weights, float]:
    """A PEFT directory, read; or a ``(weights, scaling)`` pair, as it is."""
    if isinstance(adapter, tuple):
        return adapter
    return load_peft_adapter(adapter)


def build_deltas(model, weights: Weights, scaling: float) -> Dict[str, np.ndarray]:
    """Stack per-layer ``scaling * (B @ A)^T`` deltas into [L, in, out] f32 arrays.
    Dense leaves only: a quantized linear cannot take a merge."""
    deltas: Dict[str, np.ndarray] = {}
    shapes = model.param_shapes()['layers']
    for module, per_layer in weights.items():
        shape = shapes[module]
        assert isinstance(shape, tuple), \
            f'LoRA cannot merge into quantized weights ({module})'
        delta = np.zeros(shape, np.float32)
        for layer, ab in per_layer.items():
            A, B = ab['A'], ab['B']            # [r, in], [out, r]
            # scaling * (B @ A).T, [in, out], written in place: the same products
            np.multiply((B @ A).T, scaling, out=delta[layer])
        deltas[module] = delta
    return deltas


class LoraManager:
    """The single-active-adapter manager of a ``ModelAgent``: deltas kept on the host,
    each merge a read-modify-write of the served leaves in place, on the agent's
    stream."""

    def __init__(self, agent):
        self.agent = agent
        self.adapters: Dict[str, Dict[str, np.ndarray]] = {}
        self.active: Optional[str] = None

    def load(self, name: str, adapter: Adapter):
        self.adapters[name] = build_deltas(self.agent.model, *adapter_weights(adapter))

    @torch.no_grad()
    def _apply(self, deltas: Dict[str, np.ndarray], sign: float):
        agent = self.agent
        # per-name leaves; a fused leaf's are views of its columns
        layers = agent.model.unfuse_projections(agent.params)['layers']
        with agent._on_stream():
            for module, delta in deltas.items():
                w = layers[module]
                d = torch.from_numpy(delta).to(w.device)
                w.copy_((w.float() + sign * d).to(w.dtype))

    def activate(self, name: str):
        assert name in self.adapters, f'adapter {name!r} not loaded'
        if self.active == name:
            return
        if self.active is not None:
            self._apply(self.adapters[self.active], -1.0)
        self._apply(self.adapters[name], +1.0)
        self.active = name

    def deactivate(self):
        if self.active is not None:
            self._apply(self.adapters[self.active], -1.0)
            self.active = None


# -- S-LoRA: batched multi-adapter multiplexing ------------------------------------------

SLORA_TARGETS = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')


def build_slora_stacks(model, adapters: Dict[str, Adapter], device='cpu'):
    """Load several adapters into slot stacks.

    Returns (stacks, slot_map): stacks[target] = {'a': [L, S, in, rp], 'b': [L, S, rp,
    out]} f32 tensors on ``device``, slot 0 all zeros (no adapter), ranks zero-padded to
    the largest across adapters, alpha/r folded into 'b' (reference :141-167, built in
    numpy as there, then ``weight_convert.slora_stacks_from_reference``)."""
    from .weight_convert import slora_stacks_from_reference

    cfg = model.config
    L = cfg.num_layers
    loaded = [(name, *adapter_weights(adapter)) for name, adapter in adapters.items()]
    max_rank = 1
    for _, weights, _ in loaded:
        for per_layer in weights.values():
            for ab in per_layer.values():
                max_rank = max(max_rank, ab['A'].shape[0])

    dims = {'wq': (cfg.hidden_size, model.q_out),
            'wk': (cfg.hidden_size, model.kv_out),
            'wv': (cfg.hidden_size, model.kv_out),
            'wo': (model.q_out, cfg.hidden_size),
            'w_gate': (cfg.hidden_size, cfg.intermediate_size),
            'w_up': (cfg.hidden_size, cfg.intermediate_size),
            'w_down': (cfg.intermediate_size, cfg.hidden_size)}
    S = len(loaded) + 1
    stacks = {t: {'a': np.zeros((L, S, dims[t][0], max_rank), np.float32),
                  'b': np.zeros((L, S, max_rank, dims[t][1]), np.float32)}
              for t in SLORA_TARGETS}
    slot_map = {}
    for slot, (name, weights, scaling) in enumerate(loaded, start=1):
        slot_map[name] = slot
        for target, per_layer in weights.items():
            for layer, ab in per_layer.items():
                A, B = ab['A'], ab['B']         # [r, in], [out, r]
                r = A.shape[0]
                stacks[target]['a'][layer, slot, :, :r] = A.T
                stacks[target]['b'][layer, slot, :r, :] = scaling * B.T
    return slora_stacks_from_reference(stacks, device), slot_map
