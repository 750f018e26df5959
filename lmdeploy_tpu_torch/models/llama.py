"""Llama-family causal LM: parameters as layer-stacked tensors, a Python loop over layers.

Port of ``lmdeploy_tpu/models/llama.py`` (``LlamaModel``) for the options the
``_llama`` / ``_qwen2`` / ``_qwen3`` registry builders switch on: attention bias,
qk-norm and tied embeddings, and AWQ / GPTQ W4A16 checkpoints.  Parameters keep the
reference's tree and names (``embed``, ``layers/{attn_norm, wq|wqkv, ...}`` stacked
``[L, ...]``, ``final_norm``, ``lm_head``) and its ``[in, out]`` weight layout, so a JAX
parameter tree carries over by name (``weight_convert.params_from_jax``).  A W4A16
linear is a dict leaf ``{'packed' i32[L, Kp/8, N], 'scales', 'zeros' f32[L, Kp/gs, N]}``
(``Kp`` = ``lite.formats.pad_k4(K)``), prepared to ``{'packed', 'sb', 'corr'}`` by
``prep_quant_leaves``.  The reference's ``lax.scan`` over layers becomes a Python loop,
in which one layer's ``[Kp/8, N]`` slice of a stacked leaf is a free view (the
reference's whole-stack-plus-layer-index kernel design only avoids an XLA slice
copy); the KV cache is written in place.

The reference layer body's hooks that subclasses use are kept: ``_mlp`` (overridden
by MoE models, which then keep gate and up unfused), the ``bo`` output-projection
bias, per-layer ``sinks`` and per-layer windows.  A per-layer window is a Python int
from ``layer_windows`` (None: every layer takes ``config.sliding_window``), never a
tensor: the reference's ``layer_window`` leaf is not part of the port's tree.
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
from ..ops.quant_matmul import prep_w4

# seeded W4A16 weights: nibbles uniform on 0..15 around zero point 7.5, and a scale
# that gives the dequantized weights the dense init's 0.02 std
W4_INIT_ZERO = 7.5
W4_INIT_SCALE = 0.02 / math.sqrt((16 ** 2 - 1) / 12)


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


class LlamaModel:
    """Weights layout + forward for the dense llama family."""

    # checkpoint formats that quantize only a subclass's expert stacks: the seven
    # linears stay dense (gpt-oss's MXFP4)
    EXPERT_QUANT_METHODS: Tuple[str, ...] = ()

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
        qcfg = config.quantization_config or {}
        method = qcfg.get('quant_method')
        if method in ('awq', 'gptq'):
            self.quant_method = 'w4a16'
            self.group_size = qcfg.get('group_size') or qcfg.get('q_group_size', 128)
        elif method == 'fp8' and qcfg.get('weight_block_size'):
            # DeepSeek-V3's native format: e4m3 weights with a 128 x 128 block grid of
            # scales (reference llama.py:100-109); DeepseekV2Model keeps its experts
            # fp8 and dequantizes the rest at load, the dense llama leaves raise
            # (_linear_shape)
            self.quant_method = 'fp8_blocked'
            self.fp8_block = tuple(qcfg['weight_block_size'])
        elif method is not None and method not in self.EXPERT_QUANT_METHODS:
            raise NotImplementedError(f'{method!r} checkpoints are not ported yet')

    # -- parameters -------------------------------------------------------------------
    def _linear_shape(self, L: int, K: int, N: int):
        if self.quant_method == 'fp8_blocked':
            raise NotImplementedError('blocked-fp8 linear leaves of the llama family are '
                                      'not ported yet (ROADMAP.md section 1, item 4)')
        if self.quant_method == 'w4a16':
            gs = self.group_size
            Kp = formats.pad_k4(K, gs)     # plane-packed layout: K in whole groups x4
            return {'packed': Leaf((L, Kp // 8, N), torch.int32),
                    'scales': Leaf((L, Kp // gs, N), torch.float32),
                    'zeros': Leaf((L, Kp // gs, N), torch.float32)}
        return (L, K, N)

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
            'w_gate': lin(L, H, I),
            'w_up': lin(L, H, I),
            'w_down': lin(L, I, H),
        }
        if cfg.attention_bias:
            layers.update(bq=(L, self.q_out), bk=(L, self.kv_out), bv=(L, self.kv_out))
        if cfg.qk_norm:
            layers.update(q_norm=(L, cfg.head_dim), k_norm=(L, cfg.head_dim))
        shapes = {'embed': (V, H), 'layers': layers, 'final_norm': (H,)}
        if not cfg.tie_word_embeddings:
            shapes['lm_head'] = (H, V)
        return shapes

    def init_params(self, seed: int = 0, device='cpu', scale: float = 0.02,
                    dtype: Optional[torch.dtype] = None) -> Dict:
        """Random weights from one seeded ``torch.Generator`` on ``device``
        (norms are ones), in the model dtype unless ``dtype`` is given.  The same
        seed gives the same weights on the same device type.  W4A16 leaves get
        random int32 words (uniform nibbles), zeros ``W4_INIT_ZERO`` and scales
        ``W4_INIT_SCALE``: zero-mean weights of std 0.02, the dense default, whose
        output columns differ (constant positive weights would make them alike)."""
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
                    out[name] = torch.ones(shape, dtype=dtype, device=device)
                else:
                    w = torch.randn(shape, generator=gen, device=device)
                    out[name] = (w * scale).to(dtype)
            return out
        return walk(self.param_shapes())

    def _init_leaf(self, name: str, leaf: Leaf, gen: torch.Generator,
                   device) -> torch.Tensor:
        """A seeded typed leaf (W4A16 words, scales and zeros)."""
        if name == 'packed':
            words = torch.randint(-2 ** 31, 2 ** 31, leaf.shape, generator=gen,
                                  device=device, dtype=torch.int64)
            return words.to(leaf.dtype)
        fill = W4_INIT_SCALE if name == 'scales' else W4_INIT_ZERO
        return torch.full(leaf.shape, fill, dtype=leaf.dtype, device=device)

    def make_assign_plan(self) -> Dict[str, Tuple[Tuple, Optional[Callable]]]:
        """{hf_name: (path, transform[, column])} (or a list of such entries, when one
        tensor fills several leaves): the loader writes ``transform(tensor)`` (or the
        tensor itself) at ``path``, where a layer index selects the stacked row and a
        column (``models.mixtral.ExpertSlice``) one expert of it (reference
        ``make_assign_plan``, dense and AWQ / GPTQ W4A16 paths)."""
        cfg = self.config

        def transposed(x):
            return x.t()
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

    def fuse_projections(self, params: Dict) -> Dict:
        """wq/wk/wv -> wqkv and w_gate/w_up -> w_gateup along the output dim (one
        wide GEMM instead of three narrow ones), biases likewise.  Quantized dict
        leaves concatenate key by key: every quant layout packs along K and keeps
        N as the trailing axis.  Only the stock ``forward`` knows the fused names, so
        a class that overrides it keeps its leaves (reference llama.py:389-408); gate
        and up fuse only for the stock ``_mlp``."""
        if type(self).forward is not LlamaModel.forward:
            return params
        lp = dict(params['layers'])

        def cat(names):
            leaves = [lp.pop(n) for n in names]
            if isinstance(leaves[0], dict):
                return {k: torch.cat([v[k] for v in leaves], dim=-1) for k in leaves[0]}
            return torch.cat(leaves, dim=-1)
        if 'wq' in lp:
            lp['wqkv'] = cat(['wq', 'wk', 'wv'])
            if 'bq' in lp:
                lp['bqkv'] = cat(['bq', 'bk', 'bv'])
        if 'w_gate' in lp and type(self)._mlp is LlamaModel._mlp:
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

    def _mlp(self, w, x):
        # silu in f32 per element; the [*, I] intermediates stay in x.dtype
        if 'w_gateup' in w:
            gate, up = linear(x, w['w_gateup']).chunk(2, dim=-1)
        else:
            gate, up = linear(x, w['w_gate']), linear(x, w['w_up'])
        act = F.silu(gate.float()).to(x.dtype) * up
        return linear(act, w['w_down'])

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Hidden -> f32 logits (f32 accumulation AND f32 result, as the
        reference's preferred_element_type=f32 dot)."""
        lm_head = params.get('lm_head')
        if lm_head is None:
            lm_head = params['embed'].t()
        return torch.matmul(x.float(), lm_head.float())

    # -- forward ----------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                kv_cache: torch.Tensor, meta: AttnMeta,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                return_all_logits: bool = False,
                fresh_prefill: bool = False) -> torch.Tensor:
        """One step over a [B, T] chunk (decode is T == 1); writes the chunk's K/V
        into ``kv_cache`` in place.  Returns f32 logits [B, V] at each row's last
        valid token, or [B, T, V] with ``return_all_logits``."""
        cfg = self.config
        B, T = input_ids.shape
        D = cfg.head_dim
        Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        scale = 1.0 / math.sqrt(D)
        block_size = kv_cache.shape[3]
        embed = params['embed']
        # the reference's gathers clamp out-of-range ids; torch would fault
        ids = input_ids.long().clamp(0, embed.shape[0] - 1)
        hidden = embed[ids].to(cfg.torch_dtype())                      # [B,T,H]
        pos = positions.long().clamp(0, rope_cos.shape[0] - 1)
        cos, sin = rope_cos[pos], rope_sin[pos]                         # [B,T,D/2]
        slot_mapping = compute_slot_mapping(meta.block_tables, meta.history_lens,
                                            meta.q_lens, T, block_size)
        lp = params['layers']
        windows = self.layer_windows or [cfg.sliding_window] * cfg.num_layers
        for layer in range(cfg.num_layers):
            w = {name: {k: a[layer] for k, a in t.items()} if isinstance(t, dict)
                 else t[layer] for name, t in lp.items()}
            x = rms_norm(hidden, w['attn_norm'], cfg.rms_norm_eps)
            q, k, v = self._qkv(w, x)
            q = q.reshape(B, T, Hq, D)
            k = k.reshape(B, T, Hkv, D)
            v = v.reshape(B, T, Hkv, D)
            if 'q_norm' in w:
                q = rms_norm(q, w['q_norm'], cfg.rms_norm_eps)
                k = rms_norm(k, w['k_norm'], cfg.rms_norm_eps)
            q, k = apply_rope(q, k, cos, sin)
            fill_kv_cache(kv_cache, k.reshape(B * T, Hkv, D), v.reshape(B * T, Hkv, D),
                          slot_mapping, layer,
                          page_tables=meta.block_tables if fresh_prefill else None)
            attn = paged_attention(q, kv_cache, meta.block_tables, meta.history_lens,
                                   meta.q_lens, scale, layer, Hkv,
                                   window_size=windows[layer],
                                   chunk_kv=(k, v), fresh_prefill=fresh_prefill,
                                   sinks=w.get('sinks'), cp_mesh=self.cp_mesh)
            hidden = hidden + linear(attn.reshape(B, T, self.q_out), w['wo'], w.get('bo'))
            x = rms_norm(hidden, w['mlp_norm'], cfg.rms_norm_eps)
            hidden = hidden + self._mlp(w, x)
        hidden = rms_norm(hidden, params['final_norm'], cfg.rms_norm_eps)
        if return_all_logits:
            return self._head(params, hidden)
        last = (meta.q_lens.long() - 1).clamp(min=0)
        last_hidden = hidden[torch.arange(B, device=hidden.device), last]
        return self._head(params, last_hidden)

