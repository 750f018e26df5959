"""Qwen3.5 / Qwen3.5-MoE text decoders: Qwen3-Next's hybrid network with split input
projections, a dense variant and fused expert tensors.

Port of the text part of ``lmdeploy_tpu/models/qwen3_5.py`` (``Qwen3_5TextModel``):
  * split projections: ``in_proj_qkv`` as [q_all | k_all | v_all] (not Qwen3-Next's
    per-key-head groups), ``in_proj_z``, and ``in_proj_b`` / ``in_proj_a`` loaded into
    the two halves of the ``lin_in_ba`` leaf (a slice column of the assign plan);
  * the dense mlp of ``Qwen3_5ForConditionalGeneration`` (``mlp_gate`` / ``mlp_up`` /
    ``mlp_down``, f32 sums); the MoE variant keeps Qwen3-Next's router and shared expert;
  * bf16 checkpoints fuse the expert stacks: ``experts.gate_up_proj`` [E, 2I, H] (gate
    the first I rows, up the rest) and ``experts.down_proj`` [E, H, I]; per-expert names
    (fp8 checkpoints) load too;
  * the language model nests under ``model.language_model.``; the bare ``model.``
    names are kept for text-only checkpoints.
The port builds this text model also where the config nests a ``vision_config`` (the
reference then builds its VL class, whose mrope over three equal text position ids
equals the 1-D table); ``model.visual.*`` tensors are not loaded, and multimodal inputs
raise (``engine/engine.py``, ROADMAP.md item 15).  The MetaMoE / InternS2-Mobius
expert sharing (``n_meta``) and the ``Qwen3_5MTP`` proposer are not ported (item 14).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .llama import transposed
from .qwen3_next import Qwen3NextModel, _f32_dot


class Qwen3_5TextModel(Qwen3NextModel):
    """Qwen3.5 text decoder, dense or MoE by ``num_experts``."""

    # -- split input projections --------------------------------------------------------
    def _lin_in_shapes(self) -> Dict[str, int]:
        return {'in_qkv': self.key_dim * 2 + self.value_dim, 'in_z': self.value_dim,
                'in_ba': 2 * self.lin_hv}

    def _delta_proj(self, w, j: int, x: torch.Tensor):
        """qkv = [q_all | k_all | v_all], z apart, ba = [b_all | a_all]."""
        B, T, _ = x.shape
        hk, hv, dk, dv = self.lin_hk, self.lin_hv, self.lin_dk, self.lin_dv
        kd = self.key_dim
        qkv = torch.matmul(x, w['lin_in_qkv'][j])
        q = qkv[..., :kd].reshape(B, T, hk, dk)
        k = qkv[..., kd:2 * kd].reshape(B, T, hk, dk)
        v = qkv[..., 2 * kd:].reshape(B, T, hv, dv)
        z = torch.matmul(x, w['lin_in_z'][j]).reshape(B, T, hv, dv)
        ba = torch.matmul(x, w['lin_in_ba'][j])
        return q, k, v, z, ba[..., :hv], ba[..., hv:]

    def _plan_lin_in(self, plan, q: str, blk: int, j: int):
        hv = self.lin_hv
        plan[q + 'in_proj_qkv.weight'] = (('blocks', 'lin_in_qkv', blk, j), transposed)
        plan[q + 'in_proj_z.weight'] = (('blocks', 'lin_in_z', blk, j), transposed)
        plan[q + 'in_proj_b.weight'] = (('blocks', 'lin_in_ba', blk, j), transposed,
                                        slice(0, hv))
        plan[q + 'in_proj_a.weight'] = (('blocks', 'lin_in_ba', blk, j), transposed,
                                        slice(hv, 2 * hv))

    # -- dense mlp variant --------------------------------------------------------------
    def _block_mlp_shapes(self, NB: int, IV: int, H: int) -> Dict:
        if self.n_experts:
            return super()._block_mlp_shapes(NB, IV, H)
        I = self.config.intermediate_size
        return {'mlp_gate': (NB, IV, H, I), 'mlp_up': (NB, IV, H, I),
                'mlp_down': (NB, IV, I, H)}

    def _moe(self, w, j: int, x: torch.Tensor) -> torch.Tensor:
        if self.n_experts:
            return super()._moe(w, j, x)
        g = F.silu(_f32_dot(x, w['mlp_gate'][j]))
        u = _f32_dot(x, w['mlp_up'][j])
        return torch.matmul((g * u).to(x.dtype), w['mlp_down'][j])

    def _plan_mlp(self, plan, m: str, blk: int, j: int):
        if not self.n_experts:
            for hf, name in (('gate_proj', 'mlp_gate'), ('up_proj', 'mlp_up'),
                             ('down_proj', 'mlp_down')):
                plan[f'{m}{hf}.weight'] = (('blocks', name, blk, j), transposed)
            return
        super()._plan_mlp(plan, m, blk, j)
        I = self.moe_inter
        plan[m + 'experts.gate_up_proj'] = [
            (('blocks', 'we_gate', blk, j), lambda t: t[:, :I, :].transpose(-1, -2)),
            (('blocks', 'we_up', blk, j), lambda t: t[:, I:, :].transpose(-1, -2))]
        plan[m + 'experts.down_proj'] = (('blocks', 'we_down', blk, j),
                                         lambda t: t.transpose(-1, -2))

    def make_assign_plan(self):
        """The Qwen3-Next plan under ``model.language_model.`` as well as ``model.``."""
        base = super().make_assign_plan()
        plan = dict(base)
        for k, v in base.items():
            if k.startswith('model.'):
                plan['model.language_model.' + k[len('model.'):]] = v
        return plan
