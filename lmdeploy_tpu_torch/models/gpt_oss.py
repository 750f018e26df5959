"""gpt-oss (20B / 120B) MoE family.

Port of ``lmdeploy_tpu/models/gpt_oss.py`` (``GptOssModel``).  Its distinctives:

  * attention sinks: a learned per-head logit joins each softmax denominator; per-layer
    ``sinks [L, Hq]`` weights, applied by ``ops/attention.py``;
  * alternating sliding / full attention from config ``layer_types``: a Python int
    per layer (``layer_windows``: the config's window, or 0 = full), in place of the
    reference's ``layer_window`` leaf, which the port's tree does not carry;
  * clamped SwiGLU: gate clamped to <= limit, up to +-limit,
    act = (up + 1) * gate * sigmoid(1.702 * gate);
  * router: logits plus bias, top-k, then a softmax over the k chosen logits only;
  * biases on the q/k/v/o projections and on every expert product;
  * MXFP4 checkpoints: expert weights as e2m1 codes with ue8m0 group scales (32 values
    a group), kept MXFP4-resident (``{'nib' u8 [L, E, K/2, N], 'scale' f32 [L, E,
    K/32, N]}``, 0.625 B a weight) and multiplied by ``ops/quant_bmm.mxfp4_bmm``
    through ``ops/moe.py``.  This needs 64 | H and 64 | Ie;
    ``LMDEPLOY_TPU_MXFP4_DEQUANT=1`` dequantizes at load to the model dtype instead.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..lite import formats
from ..ops.moe import eplb_remap, moe_ffn
from .llama import Leaf, LlamaModel

# seeded MXFP4 experts: uniform codes (e2m1 values of rms 2.93) with group scales
# 2^-8 or 2^-7, so weights have std ~0.018, near the dense init's 0.02; scales that
# differ across groups keep a wrong group-to-scale mapping visible
MXFP4_INIT_EXPONENTS = (-8, -7)


class GptOssModel(LlamaModel):

    EXPERT_QUANT_METHODS = ('mxfp4',)

    def __init__(self, config):
        super().__init__(config)
        hf = config.hf_config or {}
        self.swiglu_limit = float(hf.get('swiglu_limit', 7.0))
        types = hf.get('layer_types') or [
            'sliding_attention' if i % 2 == 0 else 'full_attention'
            for i in range(config.num_layers)]
        self.layer_windows = [(config.sliding_window or 128) if t == 'sliding_attention'
                              else 0 for t in types]
        qcfg = config.quantization_config or {}
        self.moe_mxfp4 = (qcfg.get('quant_method') == 'mxfp4'
                          and config.hidden_size % 64 == 0 and self._ie % 64 == 0
                          and os.environ.get('LMDEPLOY_TPU_MXFP4_DEQUANT') != '1')

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
        layers.update(bo=(L, H), sinks=(L, cfg.num_attention_heads), router=(L, H, E), router_bias=(L, E),
                      bg=(L, E, Ie), bu=(L, E, Ie), bd=(L, E, H))
        if self.moe_mxfp4:
            def qleaf(K, N):
                return {'nib': Leaf((L, E, K // 2, N), torch.uint8),
                        'scale': Leaf((L, E, K // 32, N), torch.float32)}
            layers.update(we_gate=qleaf(H, Ie), we_up=qleaf(H, Ie), we_down=qleaf(Ie, H))
        else:
            layers.update(we_gate=(L, E, H, Ie), we_up=(L, E, H, Ie), we_down=(L, E, Ie, H))
        return shapes

    def _init_leaf(self, name, leaf, gen, device):
        if name == 'nib':
            return torch.randint(0, 256, leaf.shape, generator=gen, device=device,
                                 dtype=torch.uint8)
        if name == 'scale':
            lo, hi = MXFP4_INIT_EXPONENTS
            exps = torch.randint(lo, hi + 1, leaf.shape, generator=gen, device=device)
            return torch.exp2(exps.float())
        return super()._init_leaf(name, leaf, gen, device)

    # -- MoE mlp ----------------------------------------------------------------------
    def route(self, w, xf: torch.Tensor):
        """Router logits (f32, plus bias), the top-k choices (ties to the lower
        expert index, as ``jax.lax.top_k``) and their softmax weights."""
        logits = torch.matmul(xf.float(), w['router'].float()) + w['router_bias'].float()
        top_vals, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        k = self.config.num_experts_per_tok
        return logits, top_idx[:, :k], torch.softmax(top_vals[:, :k], dim=-1)

    def _act(self, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        limit = self.swiglu_limit
        gate = gate.clamp(max=limit)
        up = up.clamp(-limit, limit)
        return (up + 1.0) * (gate * torch.sigmoid(gate * 1.702))

    def _mlp(self, w, x: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape
        xf = x.reshape(B * T, H)
        _, top_idx, top_w = self.route(w, xf)
        out = moe_ffn(xf, eplb_remap(w, top_idx), top_w, w['we_gate'], w['we_up'],
                      w['we_down'], x.dtype, biases=(w['bg'], w['bu'], w['bd']),
                      act=self._act)
        return out.reshape(B, T, H).to(x.dtype)

    # -- HF weight mapping ------------------------------------------------------------
    def make_assign_plan(self):
        cfg = self.config

        def transposed(t):
            return t.transpose(-1, -2)

        def gate_cols(t):             # [E, H, 2Ie] gate/up interleaved on the last dim
            return t[..., 0::2]

        def up_cols(t):
            return t[..., 1::2]
        plan = {'model.embed_tokens.weight': (('embed',), None),
                'model.norm.weight': (('final_norm',), None)}
        if not cfg.tie_word_embeddings:
            plan['lm_head.weight'] = (('lm_head',), transposed)
        per_layer = [
            ('input_layernorm.weight', 'attn_norm', None),
            ('post_attention_layernorm.weight', 'mlp_norm', None),
            ('self_attn.q_proj.weight', 'wq', transposed),
            ('self_attn.k_proj.weight', 'wk', transposed),
            ('self_attn.v_proj.weight', 'wv', transposed),
            ('self_attn.o_proj.weight', 'wo', transposed),
            ('self_attn.q_proj.bias', 'bq', None),
            ('self_attn.k_proj.bias', 'bk', None),
            ('self_attn.v_proj.bias', 'bv', None),
            ('self_attn.o_proj.bias', 'bo', None),
            ('self_attn.sinks', 'sinks', None),
            ('mlp.router.weight', 'router', transposed),
            ('mlp.router.bias', 'router_bias', None),
            ('mlp.experts.down_proj', 'we_down', None),          # bf16 release
            ('mlp.experts.down_proj_bias', 'bd', None),
        ]
        for layer in range(cfg.num_layers):
            p = f'model.layers.{layer}.'
            for hf, name, fn in per_layer:
                plan[p + hf] = (('layers', name, layer), fn)
            plan[p + 'mlp.experts.gate_up_proj'] = [
                (('layers', 'we_gate', layer), gate_cols),
                (('layers', 'we_up', layer), up_cols)]
            plan[p + 'mlp.experts.gate_up_proj_bias'] = [
                (('layers', 'bg', layer), gate_cols),
                (('layers', 'bu', layer), up_cols)]
        return plan

    def load_hook(self, name: str, tensor: torch.Tensor, params: Dict) -> bool:
        """MXFP4 expert tensors (``*_blocks`` + ``*_scales``) need both halves; the
        loader calls this for names the plan does not know.  Returns True when the
        tensor was consumed."""
        if not (name.endswith('_blocks') or name.endswith('_scales')):
            return False
        base, kind = name.rsplit('_', 1)
        pair = self.__dict__.setdefault('_mx_stash', {}).setdefault(base, {})
        pair[kind] = tensor.numpy()
        if 'blocks' not in pair or 'scales' not in pair:
            return True
        blocks, scales = pair['blocks'], pair['scales']
        del self._mx_stash[base]
        # base: model.layers.{l}.mlp.experts.{gate_up|down}_proj
        parts = base.split('.')
        layer, proj = int(parts[2]), parts[-1]
        lp = params['layers']

        def put(name, key, value):
            dst = lp[name] if key is None else lp[name][key]
            dst[layer].copy_(torch.from_numpy(np.ascontiguousarray(value)))
        if self.moe_mxfp4:
            # e2m1 codes and f32 scales in the kernel layout: codes [E, rows_out, K]
            # -> [E, K, rows_out], half-split along K
            codes = np.swapaxes(formats.mxfp4_codes(blocks), -1, -2)
            sc = np.swapaxes(formats.ue8m0_to_f32(scales), -1, -2)     # [E, K/32, rows]
            if proj == 'gate_up_proj':
                put('we_gate', 'nib', formats.pack_halfsplit(codes[..., 0::2]))
                put('we_up', 'nib', formats.pack_halfsplit(codes[..., 1::2]))
                put('we_gate', 'scale', sc[..., 0::2])
                put('we_up', 'scale', sc[..., 1::2])
            else:
                put('we_down', 'nib', formats.pack_halfsplit(codes))
                put('we_down', 'scale', sc)
            return True
        dense = np.swapaxes(formats.mxfp4_dequant(blocks, scales), -1, -2)
        if proj == 'gate_up_proj':        # [E, H, 2Ie], de-interleaved
            put('we_gate', None, dense[..., 0::2])
            put('we_up', None, dense[..., 1::2])
        else:                             # [E, Ie, H]
            put('we_down', None, dense)
        return True
