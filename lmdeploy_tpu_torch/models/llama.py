"""Llama-family causal LM: parameters as layer-stacked tensors, a Python loop over layers.

Port of ``lmdeploy_tpu/models/llama.py`` (``LlamaModel``) for the options the
``_llama`` / ``_qwen2`` / ``_qwen3`` registry builders switch on: attention bias,
qk-norm and tied embeddings, AWQ / GPTQ W4A16 checkpoints, and the 8-bit checkpoints
of ``nn/linear.py``: SmoothQuant W8A8 (``quant_method`` ``smooth_quant`` / ``w8a8``:
``{'w8' int8 [L, K, N], 'scale' f32 [L, N]}``), fp8 weight-only (``fp8`` /
``fbgemm_fp8`` with per-channel or per-tensor ``weight_scale``, the latter broadcast to
N: ``{'w8' float8_e4m3fn, 'scale'}``) and blocked fp8 (``fp8`` with
``weight_block_size`` [b0, b1]: ``{'w8', 'bscale' f32 [L, ceil(K/b1), ceil(N/b0)]}``,
the reference's grid shape).  Parameters keep the
reference's tree and names (``embed``, ``layers/{attn_norm, wq|wqkv, ...}`` stacked
``[L, ...]``, ``final_norm``, ``lm_head``) and its ``[in, out]`` weight layout, so a JAX
parameter tree carries over by name (``weight_convert.params_from_jax``).  A W4A16
linear is a dict leaf ``{'packed' i32[L, Kp/8, N], 'scales', 'zeros' f32[L, Kp/gs, N]}``
(``Kp`` = ``lite.formats.pad_k4(K)``), prepared to ``{'packed', 'sb', 'corr'}`` by
``prep_quant_leaves``.  The reference's ``lax.scan`` over layers becomes a Python loop,
in which one layer's ``[Kp/8, N]`` slice of a stacked leaf is a free view (the
reference's whole-stack-plus-layer-index kernel design only avoids an XLA slice
copy); the KV cache is written in place.

The reference layer body's hooks that subclasses use are kept: ``_mlp`` and
``_mlp_shapes`` (overridden by MoE models, which then keep gate and up unfused, and by
StarCoder2's ungated MLP), ``_norm`` (RMSNorm here; the LayerNorm models read the
``attn_norm_b`` / ``mlp_norm_b`` / ``final_norm_b`` biases), ``_head``, the ``bo``
output-projection bias, per-layer ``sinks`` and per-layer windows, and the scalings of
the dense variants (reference ``llama.py:73-82, 513-690``): ``embed_scale`` (the
embedding times the scale rounded to the hidden dtype), ``attn_scale`` (in place of
``1/sqrt(D)``), ``attn_logit_softcap`` (to ``paged_attention``),
``final_logit_softcap`` (a tanh on the f32 logits in ``_head``), ``residual_scale`` (on
both branch outputs), the sandwich norms ``post_attn_norm`` / ``post_mlp_norm``
(``sandwich_norms``: an RMSNorm of each branch output before its scale and residual
add), and the rope hooks ``_gather_rope`` / ``_apply_rope`` (GLM's interleaved partial
rotary, Gemma-3's table per layer).  A per-layer window is a Python int from
``layer_windows`` (None: every layer takes ``config.sliding_window``; 0: full
attention), never a tensor: the reference's ``layer_window`` leaf is not part of the
port's tree, and a choice that follows it (Gemma-3's rope table) follows the int.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..lite import formats
from ..nn.layers import apply_rope, rms_norm
from ..nn.linear import linear
from ..ops.attention import compute_slot_mapping, fill_kv_cache, paged_attention
from ..ops.kv_quant import f32_reciprocal
from ..ops.quant_matmul import prep_w4

# seeded W4A16 weights: nibbles uniform on 0..15 around zero point 7.5, and a scale
# that gives the dequantized weights the dense init's 0.02 std
W4_INIT_ZERO = 7.5
W4_INIT_SCALE = 0.02 / math.sqrt((16 ** 2 - 1) / 12)
# seeded 8-bit weights: e4m3 values of std FP8_INIT_SPAN (a quantizer's amax near
# e4m3's 448), int8 codes uniform on +-127 (std INT8_INIT_SPAN), and per-column (or
# per-block) scales around 0.02 / span, so weights have the dense init's std 0.02;
# scales that differ across columns and blocks keep a wrong scale mapping visible
FP8_INIT_SPAN = 112.0
INT8_INIT_SPAN = 127.0 / math.sqrt(3.0)
# the 8-bit checkpoint formats of the dense llama linears (nn/linear.py)
W8_METHODS = ('w8a8', 'fp8', 'fp8_blocked')


def init_fp8_leaf(name: str, shape, gen: torch.Generator, device,
                  span: float = FP8_INIT_SPAN) -> torch.Tensor:
    """A seeded 8-bit leaf: ``w8`` e4m3 values of std ``span``, drawn one row of the
    leading axis at a time (an f32 draw of a whole V2-Lite expert stack would be 19
    GB), or, for any other name, scales around 0.02 / ``span``."""
    if name == 'w8':
        out = torch.empty(shape, dtype=torch.float8_e4m3fn, device=device)
        for row in out:
            w = torch.randn(row.shape, generator=gen, device=device) * span
            row.copy_(w.clamp(-448.0, 448.0).to(torch.float8_e4m3fn))
        return out
    return (0.5 + torch.rand(shape, generator=gen, device=device)) * (0.02 / span)


def transposed(t):
    return t.t()


def rows(lo: int, hi: int):
    """The rows [lo, hi) of an HF ``[out, in]`` weight as an ``[in, out]`` leaf."""
    return lambda t: t[lo:hi].t()


def bias_rows(lo: int, hi: int):
    return lambda t: t[lo:hi]


def refuse_quantized(model: 'LlamaModel'):
    """The families whose checkpoints fuse or rename the projections load dense weights
    only, as the reference's assign plans do."""
    if model.quant_method is not None:
        raise NotImplementedError(f'{model.quant_method} checkpoints of '
                                  f'{model.config.hf_arch} are not ported (the assign plan '
                                  f'is dense only, as the reference\'s)')


class Leaf(NamedTuple):
    """A parameter leaf with its own dtype (quantized leaves); plain shape tuples
    take the model dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass
class AttnMeta:
    """Per-step attention metadata (tensors on the model's device)."""

    block_tables: torch.Tensor    # [B, W] int32
    history_lens: torch.Tensor    # [B] int32 -- cached tokens before this chunk
    q_lens: torch.Tensor          # [B] int32 -- valid tokens in this chunk
    # hybrid linear-attention models (models/qwen3_next.py): each row's batch slot in
    # the per-slot state (None: arange(B), the decode path's rows), and the rows whose
    # state a first chunk zeroes (None: none)
    slot_rows: Optional[torch.Tensor] = None    # [B] int
    reset_rows: Optional[torch.Tensor] = None   # [B] bool


class LlamaModel:
    """Weights layout + forward for the dense llama family."""

    # checkpoint formats that quantize only a subclass's expert stacks: the seven
    # linears stay dense (gpt-oss's MXFP4)
    EXPERT_QUANT_METHODS: Tuple[str, ...] = ()
    # the 8-bit checkpoint formats (W8_METHODS) the class serves; a MoE family takes
    # none, or blocked fp8 where it dequantizes it at load
    LINEAR_8BIT: Tuple[str, ...] = W8_METHODS
    # block-output RMSNorms before the residual add (GLM-4, Gemma-2 / 3)
    sandwich_norms: bool = False
    # an _mlp override that reads a fused 'w_gateup' leaf as the stock one does
    FUSE_GATE_UP: bool = False

    def __init__(self, config: ModelConfig):
        self.config = config
        # the mesh whose 'cp' ranks hold the KV cache's stripes (context parallelism;
        # set by ModelAgent under a mesh), else None
        self.cp_mesh = None
        self.q_out = config.num_attention_heads * config.head_dim
        self.kv_out = config.num_key_value_heads * config.head_dim
        self.quant_method = None
        self.group_size = 128
        self.layer_windows: Optional[List[int]] = None
        self.embed_scale = 1.0            # Gemma: sqrt(hidden); MiniCPM: scale_emb
        self.residual_scale: Optional[float] = None    # MiniCPM: scale_depth / sqrt(L)
        self.final_logit_softcap: Optional[float] = None   # Gemma-2
        self.attn_logit_softcap: Optional[float] = None    # Gemma-2
        self.attn_scale: Optional[float] = None    # Gemma-2 / 3: query_pre_attn_scalar^-0.5
        # EAGLE-3's feature taps: the layer OUTPUTS whose hidden states concatenate into
        # the draft's conditioning (set by engine/spec_agent.py; reference llama.py:84-88)
        self.aux_hidden_layers: Optional[Tuple[int, ...]] = None
        qcfg = config.quantization_config or {}
        method = qcfg.get('quant_method')
        if method in ('awq', 'gptq'):
            self.quant_method = 'w4a16'
            self.group_size = qcfg.get('group_size') or qcfg.get('q_group_size', 128)
        elif method in ('smooth_quant', 'w8a8'):
            self.quant_method = 'w8a8'
        elif method in ('fp8', 'fbgemm_fp8'):
            # e4m3 weights with per-column / per-tensor scales, or a block grid of
            # scales (DeepSeek-V3's and Qwen3-FP8's 128 x 128; reference
            # llama.py:96-112); DeepseekV2Model keeps its experts fp8 and dequantizes
            # the rest at load
            if qcfg.get('weight_block_size'):
                self.quant_method = 'fp8_blocked'
                self.fp8_block = tuple(qcfg['weight_block_size'])
            else:
                self.quant_method = 'fp8'
        elif method is not None and method not in self.EXPERT_QUANT_METHODS:
            raise NotImplementedError(f'{method!r} checkpoints are not ported yet')
        if self.quant_method in W8_METHODS and self.quant_method not in self.LINEAR_8BIT:
            raise NotImplementedError(f'{self.quant_method} checkpoints of '
                                      f'{type(self).__name__} are not ported (8-bit linear '
                                      f'leaves serve the dense llama family)')

    # -- parameters -------------------------------------------------------------------
    def _linear_shape(self, L: int, K: int, N: int):
        if self.quant_method == 'w8a8':
            return {'w8': Leaf((L, K, N), torch.int8), 'scale': Leaf((L, N), torch.float32)}
        if self.quant_method == 'fp8':
            return {'w8': Leaf((L, K, N), torch.float8_e4m3fn),
                    'scale': Leaf((L, N), torch.float32)}
        if self.quant_method == 'fp8_blocked':
            b0, b1 = self.fp8_block
            return {'w8': Leaf((L, K, N), torch.float8_e4m3fn),
                    'bscale': Leaf((L, -(-K // b1), -(-N // b0)), torch.float32)}
        if self.quant_method == 'w4a16':
            gs = self.group_size
            Kp = formats.pad_k4(K, gs)     # plane-packed layout: K in whole groups x4
            return {'packed': Leaf((L, Kp // 8, N), torch.int32),
                    'scales': Leaf((L, Kp // gs, N), torch.float32),
                    'zeros': Leaf((L, Kp // gs, N), torch.float32)}
        return (L, K, N)

    def _mlp_shapes(self, L: int, H: int, I: int) -> Dict:
        lin = self._linear_shape
        return {'w_gate': lin(L, H, I), 'w_up': lin(L, H, I), 'w_down': lin(L, I, H)}

    def param_shapes(self) -> Dict:
        cfg = self.config
        L, H, I, V = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                      cfg.vocab_size)
        lin = self._linear_shape
        layers = {
            'attn_norm': (L, H),
            'wq': lin(L, H, self.q_out),
            'wk': lin(L, H, self.kv_out),
            'wv': lin(L, H, self.kv_out),
            'wo': lin(L, self.q_out, H),
            'mlp_norm': (L, H),
            **self._mlp_shapes(L, H, I),
        }
        if cfg.attention_bias:
            layers.update(bq=(L, self.q_out), bk=(L, self.kv_out), bv=(L, self.kv_out))
        if cfg.qk_norm:
            layers.update(q_norm=(L, cfg.head_dim), k_norm=(L, cfg.head_dim))
        if self.sandwich_norms:
            layers.update(post_attn_norm=(L, H), post_mlp_norm=(L, H))
        shapes = {'embed': (V, H), 'layers': layers, 'final_norm': (H,)}
        if not cfg.tie_word_embeddings:
            shapes['lm_head'] = (H, V)
        return shapes

    def init_params(self, seed: int = 0, device='cpu', scale: float = 0.02,
                    dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights from one seeded ``torch.Generator`` on ``device``
        (norms are ones, norm biases zeros), in the model dtype unless ``dtype`` is
        given.  The same seed gives the same weights on the same device type.  W4A16
        leaves get random int32 words (uniform nibbles), zeros ``W4_INIT_ZERO`` and
        scales ``W4_INIT_SCALE``: zero-mean weights of std 0.02, the dense default,
        whose output columns differ (constant positive weights would make them
        alike); 8-bit leaves likewise (``init_fp8_leaf``)."""
        dtype = dtype or self.config.torch_dtype()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def walk(tree):
            out = {}
            for name, shape in tree.items():
                if isinstance(shape, dict):
                    out[name] = walk(shape)
                elif isinstance(shape, Leaf):
                    out[name] = self._init_leaf(name, shape, gen, device)
                elif 'norm' in name:
                    fill = torch.zeros if name.endswith('_b') else torch.ones
                    out[name] = fill(shape, dtype=dtype, device=device)
                else:
                    w = torch.randn(shape, generator=gen, device=device)
                    out[name] = (w * scale).to(dtype)
            return out
        return walk(self.param_shapes())

    def _init_leaf(self, name: str, leaf: Leaf, gen: torch.Generator,
                   device) -> torch.Tensor:
        """A seeded typed leaf (W4A16 words, scales and zeros; 8-bit weights and their
        scales)."""
        if name == 'packed':
            words = torch.randint(-2 ** 31, 2 ** 31, leaf.shape, generator=gen,
                                  device=device, dtype=torch.int64)
            return words.to(leaf.dtype)
        if name == 'w8' and leaf.dtype == torch.int8:
            return torch.randint(-127, 128, leaf.shape, generator=gen, device=device,
                                 dtype=torch.int8)
        if name in ('w8', 'scale', 'bscale', 'gscale'):
            span = INT8_INIT_SPAN if self.quant_method == 'w8a8' else FP8_INIT_SPAN
            return init_fp8_leaf(name, leaf.shape, gen, device, span)
        fill = W4_INIT_SCALE if name == 'scales' else W4_INIT_ZERO
        return torch.full(leaf.shape, fill, dtype=leaf.dtype, device=device)

    def make_assign_plan(self) -> Dict[str, Tuple[Tuple, Optional[Callable]]]:
        """{hf_name: (path, transform[, column])} (or a list of such entries, when one
        tensor fills several leaves): the loader writes ``transform(tensor)`` (or the
        tensor itself) at ``path``, where a layer index selects the stacked row and a
        column (``models.mixtral.ExpertSlice``) one expert of it (reference
        ``make_assign_plan``, dense, AWQ / GPTQ W4A16 and 8-bit paths)."""
        cfg = self.config
        plan = {'model.embed_tokens.weight': (('embed',), None),
                'model.norm.weight': (('final_norm',), None)}
        if not cfg.tie_word_embeddings:
            plan['lm_head.weight'] = (('lm_head',), transposed)
        per_layer = [
            ('input_layernorm.weight', ('attn_norm',), None),
            ('post_attention_layernorm.weight', ('mlp_norm',), None),
            ('self_attn.q_proj.bias', ('bq',), None),
            ('self_attn.k_proj.bias', ('bk',), None),
            ('self_attn.v_proj.bias', ('bv',), None),
            ('self_attn.q_norm.weight', ('q_norm',), None),
            ('self_attn.k_norm.weight', ('k_norm',), None),
        ]
        hf_linears = [('self_attn.q_proj', 'wq'), ('self_attn.k_proj', 'wk'),
                      ('self_attn.v_proj', 'wv'), ('self_attn.o_proj', 'wo'),
                      ('mlp.gate_proj', 'w_gate'), ('mlp.up_proj', 'w_up'),
                      ('mlp.down_proj', 'w_down')]
        if self.quant_method == 'w4a16':
            per_layer += self._w4a16_plan(hf_linears)
        elif self.quant_method in W8_METHODS:
            per_layer += self._w8_plan(hf_linears)
        else:
            per_layer += [(f'{hf}.weight', (name,), transposed) for hf, name in hf_linears]
        for layer in range(cfg.num_layers):
            for hf, path, fn in per_layer:
                plan[f'model.layers.{layer}.{hf}'] = (('layers',) + path + (layer,), fn)
        return plan

    def _w4a16_plan(self, hf_linears):
        """AWQ / GPTQ tensors -> the plane-packed leaves, K padded by ``pad_k4``
        (pad rows: q 0, scale 1, zero 0; reference llama.py:266-298)."""
        cfg = self.config
        gptq = (cfg.quantization_config or {}).get('quant_method') == 'gptq'
        unpack_w = formats.gptq_qweight_to_kernel if gptq else formats.awq_qweight_to_kernel
        unpack_z = formats.unpack_gptq_qzeros if gptq else formats.unpack_awq_qzeros
        gs = self.group_size
        k_in = {'wq': cfg.hidden_size, 'wk': cfg.hidden_size, 'wv': cfg.hidden_size,
                'wo': self.q_out, 'w_gate': cfg.hidden_size, 'w_up': cfg.hidden_size,
                'w_down': cfg.intermediate_size}

        def numpy_fn(fn):
            return lambda t: torch.from_numpy(np.ascontiguousarray(fn(t.numpy())))
        entries = []
        for hf, name in hf_linears:
            kp = formats.pad_k4(k_in[name], gs)
            entries += [
                (f'{hf}.qweight', (name, 'packed'),
                 numpy_fn(lambda x, kp=kp: unpack_w(x, pad_to=kp))),
                (f'{hf}.scales', (name, 'scales'),
                 numpy_fn(lambda x, g=kp // gs: formats.pad_groups(
                     x.astype(np.float32), g, 1.0))),
                (f'{hf}.qzeros', (name, 'zeros'),
                 numpy_fn(lambda x, g=kp // gs: formats.pad_groups(unpack_z(x), g, 0.0))),
            ]
        return entries

    def _w8_plan(self, hf_linears):
        """8-bit tensors -> ``w8`` [K, N] and its scales (reference llama.py:299-350):
        W8A8 ``.scale`` [N(, 1)]; fp8 ``.weight_scale``, per column or one per tensor
        broadcast to N; blocked fp8 ``.weight_scale_inv`` [Nb, Kb] transposed."""
        cfg = self.config
        n_out = {'wq': self.q_out, 'wk': self.kv_out, 'wv': self.kv_out,
                 'wo': cfg.hidden_size, 'w_gate': cfg.intermediate_size,
                 'w_up': cfg.intermediate_size, 'w_down': cfg.hidden_size}

        def scale_vec(n):
            def f(t):
                v = t.float().reshape(-1)
                return v.expand(n) if v.numel() == 1 else v
            return f
        entries = []
        for hf, name in hf_linears:
            entries.append((f'{hf}.weight', (name, 'w8'), lambda t: t.t()))
            if self.quant_method == 'w8a8':
                entries.append((f'{hf}.scale', (name, 'scale'), scale_vec(n_out[name])))
            elif self.quant_method == 'fp8':
                entries.append((f'{hf}.weight_scale', (name, 'scale'),
                                scale_vec(n_out[name])))
            else:
                entries.append((f'{hf}.weight_scale_inv', (name, 'bscale'),
                                lambda t: t.float().t()))
        return entries

    def fuse_projections(self, params: Dict) -> Dict:
        """wq/wk/wv -> wqkv and w_gate/w_up -> w_gateup along the output dim (one
        wide GEMM instead of three narrow ones), biases likewise.  Quantized dict
        leaves concatenate key by key: every quant layout packs along K and keeps
        N as the trailing axis.  Only the stock ``forward`` knows the fused names, so
        a class that overrides it keeps its leaves (reference llama.py:389-408); gate
        and up fuse only for the stock ``_mlp``.  Blocked-fp8 leaves stay unfused: their
        scale grids do not concatenate where N is not a whole number of blocks."""
        if type(self).forward is not LlamaModel.forward:
            return params
        lp = dict(params['layers'])

        def cat(names):
            leaves = [lp.pop(n) for n in names]
            if isinstance(leaves[0], dict):
                return {k: torch.cat([v[k] for v in leaves], dim=-1) for k in leaves[0]}
            return torch.cat(leaves, dim=-1)

        def fusable(name):
            return name in lp and not (isinstance(lp[name], dict) and 'bscale' in lp[name])
        if fusable('wq'):
            lp['wqkv'] = cat(['wq', 'wk', 'wv'])
            if 'bq' in lp:
                lp['bqkv'] = cat(['bq', 'bk', 'bv'])
        if fusable('w_gate') and (type(self)._mlp is LlamaModel._mlp or self.FUSE_GATE_UP):
            lp['w_gateup'] = cat(['w_gate', 'w_up'])
        return dict(params, layers=lp)

    def prep_quant_leaves(self, params: Dict, fast: bool = False,
                          mode: Optional[str] = None) -> Dict:
        """W4A16 linears -> the prepared form ``{'packed', 'sb', 'corr'}`` of the
        schedule ``mode`` ('gd', 'fast' or 'precise'; None: fast if ``fast`` else
        precise, as ``prep_w4`` reads it; reference llama.py:439-459).  Only a class
        running the stock ``forward`` opts in, and only 3-D ``[L, G, N]`` leaves
        convert: a MoE model's 4-D expert stacks ``[L, E, G, N]`` stay raw, since its
        ``_mlp`` widens them with their raw scales and zeros."""
        if type(self).forward is not LlamaModel.forward:
            return params
        lp = dict(params['layers'])
        for name, leaf in lp.items():
            if (isinstance(leaf, dict) and 'packed' in leaf and 'scales' in leaf
                    and leaf['packed'].dim() == 3):
                sb, corr = prep_w4(leaf['scales'], leaf['zeros'], not fast, mode=mode)
                lp[name] = {'packed': leaf['packed'], 'sb': sb, 'corr': corr}
        return dict(params, layers=lp)

    def layout_quant_leaves(self, params: Dict) -> Dict:
        """W8A8 int8 weights stored K-major: each ``w8`` keeps its ``[..., K, N]`` shape
        and values as the transposed view of a contiguous ``[..., N, K]`` tensor, the
        order in which cuBLASLt's int8 GEMM (``torch._int_mm``) takes its Hopper
        tensor-core kernels; row-major ``[K, N]`` codes took an sm80 compatibility
        kernel, 7-14x slower at Llama-3.1-8B's projections (PERF.md)."""
        if 'layers' not in params:
            return params
        lp = dict(params['layers'])
        for name, leaf in lp.items():
            if isinstance(leaf, dict) and 'w8' in leaf and leaf['w8'].dtype == torch.int8:
                w8 = leaf['w8'].transpose(-1, -2).contiguous().transpose(-1, -2)
                lp[name] = dict(leaf, w8=w8)
        return dict(params, layers=lp)

    def unfuse_projections(self, params: Dict) -> Dict:
        """Inverse of ``fuse_projections`` (per-name views of the fused leaves)."""
        lp = dict(params['layers'])
        qo, ko = self.q_out, self.kv_out

        def split(v, sizes):
            if isinstance(v, dict):
                parts = {k: a.split(sizes, dim=-1) for k, a in v.items()}
                return [{k: p[i] for k, p in parts.items()} for i in range(len(sizes))]
            return v.split(sizes, dim=-1)
        if 'wqkv' in lp:
            lp['wq'], lp['wk'], lp['wv'] = split(lp.pop('wqkv'), [qo, ko, ko])
            if 'bqkv' in lp:
                lp['bq'], lp['bk'], lp['bv'] = split(lp.pop('bqkv'), [qo, ko, ko])
        if 'w_gateup' in lp:
            inter = self.config.intermediate_size
            lp['w_gate'], lp['w_up'] = split(lp.pop('w_gateup'), [inter, inter])
        return dict(params, layers=lp)

    # -- pieces -----------------------------------------------------------------------
    def _qkv(self, w, x):
        if 'wqkv' in w:
            qkv = linear(x, w['wqkv'], w.get('bqkv'))
            return qkv.split([self.q_out, self.kv_out, self.kv_out], dim=-1)
        return (linear(x, w['wq'], w.get('bq')), linear(x, w['wk'], w.get('bk')),
                linear(x, w['wv'], w.get('bv')))

    def _gate_up(self, w, x):
        """The gate and up projections, from the fused leaf where there is one."""
        if 'w_gateup' in w:
            return linear(x, w['w_gateup']).chunk(2, dim=-1)
        return linear(x, w['w_gate']), linear(x, w['w_up'])

    def _mlp(self, w, x):
        # silu in f32 per element; the [*, I] intermediates stay in x.dtype
        gate, up = self._gate_up(w, x)
        act = F.silu(gate.float()).to(x.dtype) * up
        return linear(act, w['w_down'])

    def _norm(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              eps: float) -> torch.Tensor:
        """Pre-layer and final normalization (RMSNorm; LayerNorm models override)."""
        return rms_norm(x, weight, eps)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Hidden -> f32 logits (f32 accumulation AND f32 result, as the
        reference's preferred_element_type=f32 dot), then Gemma-2's final softcap
        ``tanh(logits / cap) * cap`` (the division as the jitted reference's product by
        fl(1/cap))."""
        lm_head = params.get('lm_head')
        if lm_head is None:
            lm_head = params['embed'].t()
        logits = torch.matmul(x.float(), lm_head.float())
        if self.final_logit_softcap:
            cap = self.final_logit_softcap
            logits = torch.tanh(logits * f32_reciprocal(cap)) * cap
        return logits

    def _gather_rope(self, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                     pos: torch.Tensor):
        """Positions [B, T] -> the (cos, sin) rows the layers rotate by (reference
        ``_gather_rope``; Gemma-3 adds its local table)."""
        return rope_cos[pos], rope_sin[pos]

    def _apply_rope(self, q: torch.Tensor, k: torch.Tensor, cos, sin, layer: int):
        """Rotate q and k of ``layer`` (reference ``_apply_rope``, which takes the
        layer's weights; here its index): rotate-half over the whole head."""
        return apply_rope(q, k, cos, sin)

    @staticmethod
    def _scaled(x: torch.Tensor, s: float) -> torch.Tensor:
        """``x * s`` with ``s`` rounded to x's dtype first (the reference's
        ``x * jnp.asarray(s, x.dtype)``); the product rounds once to x's dtype."""
        return x * float(torch.tensor(s, dtype=x.dtype))

    # -- forward ----------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                kv_cache: torch.Tensor, meta: AttnMeta,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                return_all_logits: bool = False,
                fresh_prefill: bool = False, return_hidden: bool = False,
                return_aux_hidden: bool = False,
                adapter_ids: Optional[torch.Tensor] = None):
        """One step over a [B, T] chunk (decode is T == 1); writes the chunk's K/V
        into ``kv_cache`` in place.  Returns f32 logits [B, V] at each row's last
        valid token, or [B, T, V] with ``return_all_logits``.  For speculative decoding
        (reference :683-709) it returns (logits, features) instead: with
        ``return_hidden`` the pre-final-norm hidden state (EAGLE), at the same positions
        as the logits; with ``return_aux_hidden`` and ``return_all_logits`` the outputs
        of the layers ``aux_hidden_layers`` (clipped to the model's), concatenated
        [B, T, n*H] (EAGLE-3).

        S-LoRA (reference :594-606): with slot stacks attached as ``params['lora']``
        (``ModelAgent.enable_slora``; {target: {'a' [L, S, in, rp], 'b' [L, S, rp,
        out]}}), each row's projection output adds ``(x @ a[id]) @ b[id]`` for its
        ``adapter_ids`` entry [B] (None: slot 0, no adapter), in f32, rounded to the
        output's dtype before the add.  The adapters reach wq / wk / wv / wo where those
        leaves are unfused, and the gated MLP where ``w_gate`` is a leaf, whose
        product then runs in f32 as the reference's does (silu(gate) * up, rounded
        once); other MLPs (experts, StarCoder2's) take none."""
        cfg = self.config
        B, T = input_ids.shape
        D = cfg.head_dim
        Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        scale = self.attn_scale or 1.0 / math.sqrt(D)
        block_size = kv_cache.shape[3]
        embed = params['embed']
        # the reference's gathers clamp out-of-range ids; torch would fault
        ids = input_ids.long().clamp(0, embed.shape[0] - 1)
        hidden = embed[ids].to(cfg.torch_dtype())                      # [B,T,H]
        if self.embed_scale != 1.0:
            hidden = self._scaled(hidden, self.embed_scale)
        pos = positions.long().clamp(0, rope_cos.shape[0] - 1)
        cos, sin = self._gather_rope(rope_cos, rope_sin, pos)           # [B,T,D/2]
        slot_mapping = compute_slot_mapping(meta.block_tables, meta.history_lens,
                                            meta.q_lens, T, block_size)
        lp = params['layers']
        windows = self.layer_windows or [cfg.sliding_window] * cfg.num_layers
        taps: List[torch.Tensor] = []
        lora = params.get('lora')
        if lora is not None and adapter_ids is None:
            adapter_ids = torch.zeros(B, dtype=torch.long, device=input_ids.device)
        if lora is not None:
            adapter_ids = adapter_ids.long()
        lw = None

        def lin(x_, w, name, bias=None):
            y = linear(x_, w[name], bias)
            if lw is not None and name in lw:
                a = lw[name]['a'][adapter_ids]                 # [B, in, rp]
                b = lw[name]['b'][adapter_ids]                 # [B, rp, out]
                t = torch.bmm(x_.float(), a)
                y = y + torch.bmm(t, b).to(y.dtype)
            return y

        def branch_out(out, norm):
            if norm is not None:
                out = rms_norm(out, norm, cfg.rms_norm_eps)
            if self.residual_scale is not None:
                out = self._scaled(out, self.residual_scale)
            return out
        for layer in range(cfg.num_layers):
            w = {name: {k: a[layer] for k, a in t.items()} if isinstance(t, dict)
                 else t[layer] for name, t in lp.items()}
            if lora is not None:
                lw = {name: {k: a[layer] for k, a in ab.items()} for name, ab in lora.items()}
            x = self._norm(hidden, w['attn_norm'], w.get('attn_norm_b'), cfg.rms_norm_eps)
            if lw is not None and 'wqkv' not in w:
                q, k, v = (lin(x, w, n, w.get(b))
                           for n, b in (('wq', 'bq'), ('wk', 'bk'), ('wv', 'bv')))
            else:
                q, k, v = self._qkv(w, x)
            q = q.reshape(B, T, Hq, D)
            k = k.reshape(B, T, Hkv, D)
            v = v.reshape(B, T, Hkv, D)
            if 'q_norm' in w:
                q = rms_norm(q, w['q_norm'], cfg.rms_norm_eps)
                k = rms_norm(k, w['k_norm'], cfg.rms_norm_eps)
            q, k = self._apply_rope(q, k, cos, sin, layer)
            fill_kv_cache(kv_cache, k.reshape(B * T, Hkv, D), v.reshape(B * T, Hkv, D),
                          slot_mapping, layer,
                          page_tables=meta.block_tables if fresh_prefill else None)
            attn = paged_attention(q, kv_cache, meta.block_tables, meta.history_lens,
                                   meta.q_lens, scale, layer, Hkv,
                                   logit_softcap=self.attn_logit_softcap,
                                   window_size=windows[layer] or None,
                                   chunk_kv=(k, v), fresh_prefill=fresh_prefill,
                                   sinks=w.get('sinks'), cp_mesh=self.cp_mesh)
            out = lin(attn.reshape(B, T, self.q_out), w, 'wo', w.get('bo'))
            hidden = hidden + branch_out(out, w.get('post_attn_norm'))
            x = self._norm(hidden, w['mlp_norm'], w.get('mlp_norm_b'), cfg.rms_norm_eps)
            if lw is not None and 'w_gate' in w:
                act = F.silu(lin(x, w, 'w_gate').float()) * lin(x, w, 'w_up').float()
                out = lin(act.to(x.dtype), w, 'w_down')
            else:
                out = self._mlp(w, x)
            hidden = hidden + branch_out(out, w.get('post_mlp_norm'))
            if return_aux_hidden:
                taps.append(hidden)
        prenorm = hidden
        hidden = self._norm(hidden, params['final_norm'], params.get('final_norm_b'),
                            cfg.rms_norm_eps)
        if return_all_logits:
            logits = self._head(params, hidden)
            if return_aux_hidden:
                idx = np.clip(np.asarray(self.aux_hidden_layers), 0, cfg.num_layers - 1)
                return logits, torch.cat([taps[i] for i in idx], dim=-1)
            return (logits, prenorm) if return_hidden else logits
        last = (meta.q_lens.long() - 1).clamp(min=0)
        rows = torch.arange(B, device=hidden.device)
        logits = self._head(params, hidden[rows, last])
        return (logits, prenorm[rows, last]) if return_hidden else logits

