"""Reward models: a scalar score head over the shared decoder.

Port of ``lmdeploy_tpu/models/reward.py`` (``Qwen2RewardModel``,
``InternLM2RewardModel``).  The model's "logits" are the per-position scores [B, T, 1];
``AsyncEngine.async_get_reward_score`` takes each prompt's last position.  The heads
take the products as the reference's ``preferred_element_type=f32`` dots do: the
model-dtype operands widened to f32 (exact products of bf16 values, f32 sums; TF32
stays off, PyTorch's default), f32 results.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import ModelConfig
from .internlm2 import InternLM2Model
from .llama import LlamaModel, transposed


class Qwen2RewardModel(LlamaModel):
    """Qwen2 decoder + score head: Linear-ReLU-Linear -> 1 (reference :21-61)."""

    is_reward_model = True

    def __init__(self, config: ModelConfig):
        config.attention_bias = True
        super().__init__(config)

    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        shapes.pop('lm_head', None)
        H = self.config.hidden_size
        shapes.update(score_w1=(H, H), score_b1=(H,), score_w2=(H, 1), score_b2=(1,))
        return shapes

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        plan.pop('lm_head.weight', None)
        plan.update({'score.0.weight': (('score_w1',), transposed),
                     'score.0.bias': (('score_b1',), None),
                     'score.2.weight': (('score_w2',), transposed),
                     'score.2.bias': (('score_b2',), None)})
        return plan

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """h = relu(x @ w1 + b1) in f32, rounded to the model dtype, then
        h @ w2 + b2 in f32: [..., 1]."""
        h = torch.matmul(x.float(), params['score_w1'].float()) + params['score_b1'].float()
        h = torch.relu(h).to(x.dtype)
        return torch.matmul(h.float(), params['score_w2'].float()) + params['score_b2'].float()


class InternLM2RewardModel(InternLM2Model):
    """InternLM2 decoder + one ``v_head`` projection (reference :64-87); its fused
    ``wqkv`` splits at load as the causal LM's does."""

    is_reward_model = True

    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        shapes.pop('lm_head', None)
        shapes['v_head'] = (self.config.hidden_size, 1)
        return shapes

    def make_assign_plan(self):
        plan = super().make_assign_plan()
        plan.pop('output.weight', None)
        plan.pop('lm_head.weight', None)
        plan['v_head.weight'] = (('v_head',), transposed)
        return plan

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.float(), params['v_head'].float())
