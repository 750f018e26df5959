"""Mixtral / Qwen2-MoE / Qwen3-MoE style sparse-MoE decoders.

Port of ``lmdeploy_tpu/models/mixtral.py`` (``MixtralModel``): llama attention, and in
place of the dense MLP a router (``router [L, H, E]``) over E experts, each a SiLU-gated
MLP (``we_gate`` / ``we_up [L, E, H, Ie]``, ``we_down [L, E, Ie, H]``), combined by
``ops/moe.py``'s ``moe_ffn``.  Routing (``route``): with ``norm_topk_prob``, top-k on
the f32 router logits, then a softmax over the k chosen; without it, a softmax over all
E, then top-k.  Ties go to the lower expert index, as ``jax.lax.top_k`` (a stable
descending sort; ``torch.topk`` promises no order on CUDA).

AWQ / GPTQ W4A16 checkpoints keep the expert stacks packed and resident:
``{'packed' i32 [L, E, K/8, N], 'scales', 'zeros' f32 [L, E, K/gs, N]}`` (0.56 B a
weight), and each layer's ``_mlp`` widens its three stacks to the model dtype
(``_expert_weights``: ``dequant_w4`` one expert matrix at a time, so besides the three
widened stacks the transient is one f32 matrix).  The 4-D stacks are not prepared
(``LlamaModel.prep_quant_leaves`` converts 3-D leaves only), while the attention
projections take whichever W4A16 schedule the engine selects.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..lite import formats
from ..ops.moe import eplb_remap, moe_ffn
from ..ops.quant_matmul import dequant_w4
from .llama import Leaf, LlamaModel


class ExpertSlice:
    """An assign-plan column: the expert index, the first axis after the layer
    (reference ``mixtral._ExpertSlice``)."""

    def __init__(self, e: int):
        self.e = e


class MixtralModel(LlamaModel):
    """Sparse-MoE decoder; attention identical to llama."""

    LINEAR_8BIT = ()

    @property
    def _ie(self) -> int:
        return self.config.moe_intermediate_size or self.config.intermediate_size

    # -- parameters -------------------------------------------------------------------
    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        cfg = self.config
        L, H, E, Ie = cfg.num_layers, cfg.hidden_size, cfg.num_experts, self._ie
        layers = shapes['layers']
        for name in ('w_gate', 'w_up', 'w_down'):
            layers.pop(name)
        layers['router'] = (L, H, E)
        if self.quant_method == 'w4a16':
            gs = self.group_size

            def q4(K, N):
                return {'packed': Leaf((L, E, K // 8, N), torch.int32),
                        'scales': Leaf((L, E, K // gs, N), torch.float32),
                        'zeros': Leaf((L, E, K // gs, N), torch.float32)}
            layers.update(we_gate=q4(H, Ie), we_up=q4(H, Ie), we_down=q4(Ie, H))
        else:
            layers.update(we_gate=(L, E, H, Ie), we_up=(L, E, H, Ie), we_down=(L, E, Ie, H))
        return shapes

    # -- MoE mlp ----------------------------------------------------------------------
    @staticmethod
    def _expert_weights(leaf, dtype: torch.dtype) -> torch.Tensor:
        """One layer's expert stack as a dense [E, K, N] in ``dtype``: a W4A16 leaf
        widened with its raw scales and zeros, a dense stack as it is."""
        if not isinstance(leaf, dict):
            return leaf
        gs = leaf['packed'].shape[-2] * 8 // leaf['scales'].shape[-2]
        return dequant_w4(leaf['packed'], leaf['scales'], leaf['zeros'], gs, dtype)

    def route(self, w, xf: torch.Tensor):
        """Router logits (f32), the top-k choices and their weights."""
        k = self.config.num_experts_per_tok
        logits = torch.matmul(xf.float(), w['router'].float())
        if self.config.norm_topk_prob:
            vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
            return logits, idx[:, :k], torch.softmax(vals[:, :k], dim=-1)
        vals, idx = torch.sort(torch.softmax(logits, dim=-1), dim=-1, descending=True,
                               stable=True)
        return logits, idx[:, :k], vals[:, :k]

    def _mlp(self, w, x: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape
        xf = x.reshape(B * T, H)
        _, top_idx, top_w = self.route(w, xf)
        stacks = [self._expert_weights(w[n], x.dtype) for n in ('we_gate', 'we_up', 'we_down')]
        out = moe_ffn(xf, eplb_remap(w, top_idx), top_w, *stacks, x.dtype)
        return out.reshape(B, T, H).to(x.dtype)

    # -- HF weight mapping ------------------------------------------------------------
    def make_assign_plan(self):
        """The llama plan without the dense MLP, plus the router and the experts:
        Mixtral's naming (``block_sparse_moe.gate``, ``experts.{e}.w1/w3/w2``) and, in
        bf16, the qwen-moe naming (``mlp.gate``, ``mlp.experts.{e}.gate/up/down_proj``).
        A W4A16 checkpoint loads Mixtral's naming only, as the reference does.  Qwen2-MoE's
        shared expert (``mlp.shared_expert*``) has no entry: the reference drops it."""
        plan = super().make_assign_plan()
        cfg = self.config
        for layer in range(cfg.num_layers):
            for mod in ('mlp.gate_proj', 'mlp.up_proj', 'mlp.down_proj'):
                for part in ('weight', 'qweight', 'qzeros', 'scales'):
                    plan.pop(f'model.layers.{layer}.{mod}.{part}', None)

        def transposed(t):
            return t.t()
        mixtral = (('w1', 'we_gate'), ('w3', 'we_up'), ('w2', 'we_down'))
        if self.quant_method == 'w4a16':
            gptq = (cfg.quantization_config or {}).get('quant_method') == 'gptq'
            unpack_w = formats.gptq_qweight_to_kernel if gptq else formats.awq_qweight_to_kernel
            unpack_z = formats.unpack_gptq_qzeros if gptq else formats.unpack_awq_qzeros

            def numpy_fn(fn):
                return lambda t: torch.from_numpy(np.ascontiguousarray(fn(t.numpy())))
            parts = (('qweight', 'packed', numpy_fn(unpack_w)),
                     ('scales', 'scales', lambda t: t.float()),
                     ('qzeros', 'zeros', numpy_fn(unpack_z)))
            for layer in range(cfg.num_layers):
                p = f'model.layers.{layer}.'
                plan[p + 'block_sparse_moe.gate.weight'] = (('layers', 'router', layer),
                                                            transposed)
                for e in range(cfg.num_experts):
                    for hf, leaf in mixtral:
                        for part, key, fn in parts:
                            plan[f'{p}block_sparse_moe.experts.{e}.{hf}.{part}'] = (
                                ('layers', leaf, key, layer), fn, ExpertSlice(e))
            return plan
        qwen = (('gate_proj', 'we_gate'), ('up_proj', 'we_up'), ('down_proj', 'we_down'))
        for layer in range(cfg.num_layers):
            p = f'model.layers.{layer}.'
            for gate, prefix, names in (('block_sparse_moe.gate', 'block_sparse_moe.experts',
                                         mixtral),
                                        ('mlp.gate', 'mlp.experts', qwen)):
                plan[f'{p}{gate}.weight'] = (('layers', 'router', layer), transposed)
                for e in range(cfg.num_experts):
                    for hf, leaf in names:
                        plan[f'{p}{prefix}.{e}.{hf}.weight'] = (
                            ('layers', leaf, layer), transposed, ExpertSlice(e))
        return plan
