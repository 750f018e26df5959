"""Core transformer layer primitives as plain tensor functions.

Port of ``lmdeploy_tpu/nn/layers.py`` (RMSNorm, SiLU MLP, rotary tables with the
default / linear / dynamic-NTK / llama3 / longrope / yarn scalings, rotate-half rope),
the LayerNorm with bias of ``lmdeploy_tpu/models/phimoe.py:54`` and
``starcoder2.py:32``, and the pair-order rope layout of ``lmdeploy_tpu/models/glm4.py``
(``pairs_to_halves`` / ``halves_to_pairs``).  Gemma-3's local table is
``make_rope_table`` at the local theta, unscaled, at the global table's length.  These stay plain
PyTorch: they are elementwise or reductions next to the layer GEMMs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (mean, biased variance, then weight and bias), rounded once to
    x's dtype (reference ``PhiMoeModel._norm``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def silu_mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Fused gate/up projection + SiLU + down projection (llama-family MLP), with the
    reference's f32 products and f32 activation."""
    gate, up = torch.matmul(x.float(), gate_up.float()).chunk(2, dim=-1)
    act = (F.silu(gate) * up).to(x.dtype)
    return torch.matmul(act.float(), down.float()).to(x.dtype)


# -- rotary embeddings ------------------------------------------------------------------

def _rope_base_frequencies(head_dim: int, theta: float) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exponents)          # [D/2]


def _llama3_scaling(inv_freq: torch.Tensor, scaling: Dict[str, Any]) -> torch.Tensor:
    factor = scaling.get('factor', 8.0)
    low_freq_factor = scaling.get('low_freq_factor', 1.0)
    high_freq_factor = scaling.get('high_freq_factor', 4.0)
    old_len = scaling.get('original_max_position_embeddings', 8192)
    low_wavelen = old_len / low_freq_factor
    high_wavelen = old_len / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
    is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(is_mid, mid, scaled)


def make_rope_table(head_dim: int, max_len: int, theta: float = 10000.0,
                    rope_scaling: Optional[Dict[str, Any]] = None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin) tables [max_len, D/2] in f32, honoring HF rope_scaling.

    Built on the CPU in f32 (the same arithmetic order as the reference) and moved
    to ``device`` once."""
    inv_freq = _rope_base_frequencies(head_dim, theta)
    attn_factor = 1.0
    positions = torch.arange(max_len, dtype=torch.float32)
    if rope_scaling:
        rtype = rope_scaling.get('rope_type') or rope_scaling.get('type') or 'default'
        if rtype == 'linear':
            positions = positions / rope_scaling.get('factor', 1.0)
        elif rtype == 'llama3':
            inv_freq = _llama3_scaling(inv_freq, rope_scaling)
        elif rtype == 'dynamic':
            factor = rope_scaling.get('factor', 1.0)
            base = theta * (factor * max_len /
                            rope_scaling.get('original_max_position_embeddings', max_len)
                            - (factor - 1)) ** (head_dim / (head_dim - 2))
            inv_freq = _rope_base_frequencies(head_dim, base)
        elif rtype in ('longrope', 'su'):
            # Phi-3 LongRoPE as the reference builds it: ONE table for every position,
            # the long factors when the table outgrows the original context (HF
            # switches per sequence length instead), cos and sin times
            # sqrt(1 + ln(s) / ln(orig)), s = max_len / orig
            orig = rope_scaling.get('original_max_position_embeddings', max_len)
            factors = (rope_scaling.get('long_factor') if max_len > orig
                       else rope_scaling.get('short_factor'))
            if factors is not None:
                inv_freq = inv_freq / torch.tensor(factors, dtype=torch.float32)
            scale = max_len / max(orig, 1)
            if scale > 1.0:
                attn_factor = math.sqrt(1.0 + math.log(scale) / math.log(orig))
        elif rtype == 'yarn':
            factor = rope_scaling.get('factor', 1.0)
            orig = rope_scaling.get('original_max_position_embeddings', 4096)
            beta_fast = rope_scaling.get('beta_fast', 32.0)
            beta_slow = rope_scaling.get('beta_slow', 1.0)

            def find_dim(num_rot):
                return (head_dim * math.log(orig / (num_rot * 2 * math.pi))) / \
                    (2 * math.log(theta))
            low = max(math.floor(find_dim(beta_fast)), 0)
            high = min(math.ceil(find_dim(beta_slow)), head_dim - 1)
            rng = torch.arange(head_dim // 2, dtype=torch.float32)
            ramp = torch.clamp((rng - low) / max(high - low, 1e-3), 0, 1)
            mask = 1.0 - ramp
            inv_freq = inv_freq / factor * (1 - mask) + inv_freq * mask
            mscale = rope_scaling.get('mscale', 1.0)
            if mscale:
                attn_factor = 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0
        elif rtype != 'default':
            raise NotImplementedError(f'rope_scaling type {rtype!r} is not ported')
    angles = positions[:, None] * inv_freq[None, :]        # [max_len, D/2]
    cos, sin = torch.cos(angles) * attn_factor, torch.sin(angles) * attn_factor
    return cos.to(device), sin.to(device)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q/k. q: [B,T,Hq,D], k: [B,T,Hkv,D], cos/sin: [B,T,D/2] (HF rotate_half)."""
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]

    def rot(x):
        d2 = x.shape[-1] // 2
        x1, x2 = x[..., :d2].float(), x[..., d2:].float()
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    return rot(q), rot(k)


def pairs_to_halves(x: torch.Tensor) -> torch.Tensor:
    """[..., d] with rotary pairs interleaved (dims 2i, 2i+1) -> rotate-half order (dim
    i paired with i + d/2): GLM's rope layout, de-interleaved for ``apply_rope``."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def halves_to_pairs(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pairs_to_halves``."""
    *lead, d = x.shape
    return x.reshape(*lead, 2, d // 2).transpose(-1, -2).reshape(*lead, d)
