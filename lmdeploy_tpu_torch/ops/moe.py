"""Sparse-MoE expert dispatch: sort-by-expert grouped GEMM and dense combine.

Port of ``lmdeploy_tpu/ops/moe.py`` (``moe_ffn`` and the single-device routes of
``_moe_ffn_one``).  The route depends on the step's token count N and on the stacks:

  * quantized stacks (MXFP4 ``{'nib', 'scale'}`` or blocked-fp8 ``{'w8', 'gscale'}``
    dict leaves), N >= 768: the grouped GEMM on the stacks widened to ``out_dtype``,
    each stack at once as the reference does (``_widened``) up to
    ``_WIDEN_WHOLE_BYTES``, a larger one an expert at a time just before its product
    (``_expert``, the same values: DeepSeek-V3's three stacks would take 22.5 GB of
    bf16 beside their f32 temporaries); x is not rounded on this route;
  * quantized stacks below 768: the dense combine over the resident stacks
    (``_moe_dense``), every product on ``ops/quant_bmm.mxfp4_bmm`` or ``fp8_bmm`` (the
    CUDA kernels on the card), which round x to bf16;
  * dense stacks, N >= 128: the grouped GEMM (``_moe_ragged``), else the dense combine
    (``_moe_dense``).

The reference's grouped GEMM is XLA's ``ragged_dot`` after a sort by expert, outside any
Pallas kernel; here it is a stable sort by expert and one ``torch.matmul`` per expert
over that expert's rows.  Dense-stack products take x in the stack's dtype with f32
sums (``_dot``: exact f32 products on the CPU, as the reference's
preferred_element_type=f32 dots; on the card a bf16 GEMM whose output is rounded to
bf16 once) and everything after them (biases, activation, combine weights) runs in
f32.  The dense-combine routes bound their [E, Nc, Ie]
activations to ~64 MB by halving the row chunk, as the reference does.

Left out until the multi-device slice: the two-half microbatch split and
``moe_ffn_ep_pipelined`` (expert parallelism); ``eplb_remap`` is the identity until
EPLB tables exist.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant_bmm import fp8_bmm, mxfp4_bmm, widen_fp8, widen_mxfp4

# token counts at which the grouped GEMM takes over (reference moe.py:29-36)
RAGGED_MIN_TOKENS = 128
QUANT_RAGGED_MIN_TOKENS = 768
_CHUNK_BYTES = 64 * 1024 * 1024
# a quantized stack's widened size up to which the grouped GEMM widens it at once (the
# largest before DeepSeek-V3, GLM-4.5-Air's 1.5 GB; V3's are 7.5 GB)
_WIDEN_WHOLE_BYTES = 4 << 30


def _silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def eplb_remap(w: dict, top_idx: torch.Tensor) -> torch.Tensor:
    """Logical expert choices -> EPLB physical slots: the identity without EPLB
    tables (``parallel/eplb.py`` is not ported)."""
    if 'eplb_l2p' in w:
        raise NotImplementedError('EPLB expert layouts are not ported yet')
    return top_idx


def moe_ffn(xf: torch.Tensor, top_idx: torch.Tensor, top_w: torch.Tensor,
            we_gate, we_up, we_down, out_dtype: torch.dtype, allow_ragged: bool = True,
            biases=None, act=_silu_mul) -> torch.Tensor:
    """Routed-expert FFN: ``act(x @ We_g, x @ We_u) @ We_d`` combined by ``top_w``.

    xf [N, H]; top_idx [N, k] expert choices; top_w [N, k] routing weights; stacks
    [E, H, Ie], [E, H, Ie], [E, Ie, H], or MXFP4 / blocked-fp8 dict leaves; ``biases``
    (bg [E, Ie], bu [E, Ie], bd [E, H]) or None.  Returns f32 [N, H]."""
    N = xf.shape[0]
    if isinstance(we_gate, dict):
        if allow_ragged and N >= QUANT_RAGGED_MIN_TOKENS:
            return _moe_ragged(xf, top_idx, top_w, _widened(we_gate, out_dtype),
                               _widened(we_up, out_dtype), _widened(we_down, out_dtype),
                               out_dtype, biases, act)
        return _moe_dense(xf, top_idx, top_w, we_gate, we_up, we_down, out_dtype,
                          biases, act)
    if allow_ragged and N >= RAGGED_MIN_TOKENS:
        return _moe_ragged(xf, top_idx, top_w, we_gate, we_up, we_down, out_dtype,
                           biases, act)
    return _moe_dense(xf, top_idx, top_w, we_gate, we_up, we_down, out_dtype, biases, act)


def _widened(leaf: dict, out_dtype: torch.dtype):
    """A resident quantized stack widened to a dense [E, K, N] where that takes at most
    ``_WIDEN_WHOLE_BYTES`` (the round trip amortizes over the chunk), else the leaf
    itself, which ``_expert`` widens an expert at a time."""
    codes_per_byte = 2 if 'nib' in leaf else 1
    if (_codes(leaf).numel() * codes_per_byte * torch.finfo(out_dtype).bits // 8
            > _WIDEN_WHOLE_BYTES):
        return leaf
    if 'w8' in leaf:
        return widen_fp8(leaf['w8'], leaf['gscale'], out_dtype)
    return widen_mxfp4(leaf['nib'], leaf['scale'], out_dtype)


def _expert(stack, e: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Expert ``e``'s [K, N] weights: a dense stack's slice, or a resident quantized
    stack's widened to ``out_dtype``, bit-equal to the weights the kernels decode
    (blocked fp8: but for the NaN code, which the reference's widening keeps as NaN)."""
    if not isinstance(stack, dict):
        return stack[e]
    if 'w8' in stack:
        return widen_fp8(stack['w8'][e], stack['gscale'][e], out_dtype)
    return widen_mxfp4(stack['nib'][e], stack['scale'][e], out_dtype)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a dense stack b, a taken in b's dtype, f32 result: on the CPU the
    exact products in f32 (the reference's preferred_element_type=f32 dot); on the
    card one GEMM in b's dtype (cuBLAS accumulates in f32 and rounds the output once)."""
    a = a.to(b.dtype)
    if a.is_cuda:
        return torch.matmul(a, b).float()
    return torch.matmul(a.float(), b.float())


def _moe_ragged(xf, top_idx, top_w, we_gate, we_up, we_down, out_dtype,
                biases=None, act=_silu_mul) -> torch.Tensor:
    N, H = xf.shape
    E = _codes(we_gate).shape[0]
    k = top_idx.shape[1]
    e_flat = top_idx.reshape(-1).long()                              # [N*k]
    order = torch.sort(e_flat, stable=True).indices                  # rows by expert
    tok = order // k                                                 # source token
    xs = xf[tok]                                                     # [N*k, H]
    e_sorted = e_flat[order]
    sizes = torch.bincount(e_flat, minlength=E).tolist()

    def grouped(a, stack, width):
        out = torch.empty((a.shape[0], width), dtype=torch.float32, device=a.device)
        start = 0
        for e, n in enumerate(sizes):
            if n:
                out[start:start + n] = _dot(a[start:start + n], _expert(stack, e, out_dtype))
            start += n
        return out
    width = _codes(we_gate).shape[-1]
    gate = grouped(xs, we_gate, width)
    up = grouped(xs, we_up, width)
    if biases is not None:
        gate = gate + biases[0][e_sorted].float()
        up = up + biases[1][e_sorted].float()
    a = act(gate, up)
    ys = grouped(a.to(out_dtype), we_down, H)                        # [N*k, H]
    if biases is not None:
        ys = ys + biases[2][e_sorted].float()
    wts = top_w.reshape(-1)[order].float()
    # rows back in (token, slot) order, then each token's k rows summed: a fixed order
    # (the reference's scatter-add; index_add_ on CUDA adds by atomics, in whatever
    # order they land, so greedy tokens would differ between identical runs)
    combined = torch.empty_like(ys)
    combined[order] = ys * wts[:, None]
    return combined.view(N, k, H).sum(1)


def dense_row_chunk(N: int, E: int, Ie: int, quant: bool) -> int:
    """The dense combine's rows a chunk: N halved while even and while the chunk's
    [E, Nc, Ie] activations (f32 for quantized stacks, bf16 for dense ones) pass
    ``_CHUNK_BYTES``; each chunk runs its own gate, up and down products."""
    Nc = N
    while Nc > 1 and Nc * E * Ie * (4 if quant else 2) > _CHUNK_BYTES and Nc % 2 == 0:
        Nc //= 2
    return Nc


def _codes(stack) -> torch.Tensor:
    """The tensor whose [E, ..., N] shape is the stack's: a dense stack, or its codes."""
    if not isinstance(stack, dict):
        return stack
    return stack['w8'] if 'w8' in stack else stack['nib']


def _quant_bmm(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """A quantized expert batched product: the CUDA kernel on a CUDA tensor, its plain
    version on the CPU (``fp8_bmm`` and ``mxfp4_bmm`` dispatch)."""
    if 'w8' in leaf:
        return fp8_bmm(x, leaf['w8'], leaf['gscale'])
    return mxfp4_bmm(x, leaf['nib'], leaf['scale'])


def _moe_dense(xf, top_idx, top_w, we_gate, we_up, we_down, out_dtype,
               biases=None, act=_silu_mul) -> torch.Tensor:
    """Dense combine (the reference's ``_moe_dense`` and ``_moe_dense_quant``): every
    expert's product runs on every row, on the resident codes for MXFP4 stacks (0.625
    B a weight from device memory), the combine weights apply before the down
    product, and the expert axis is summed at the end
    (sum_e cc[n, e] * (act(..)[e, n] @ Wd[e])); blocked-fp8 stacks likewise (1 B a
    weight).  Rows go in chunks that keep the
    [E, Nc, Ie] activations (f32 for quantized stacks, bf16 for dense ones in the
    reference's accounting) to ~64 MB."""
    N, H = xf.shape
    quant = isinstance(we_gate, dict)
    product = _quant_bmm if quant else _dot
    E, _, Ie = _codes(we_gate).shape
    # scatter-add, as the reference's .at[].add: a token that picks one expert twice
    # gets the sum of the two weights
    combine = torch.zeros((N, E), dtype=torch.float32, device=xf.device).scatter_add_(
        1, top_idx.long(), top_w.float())
    Nc = dense_row_chunk(N, E, Ie, quant)
    outs = []
    for s in range(0, N, Nc):
        xc, cc = xf[s:s + Nc], combine[s:s + Nc]
        gate = product(xc, we_gate)                                  # [E, Nc, Ie] f32
        up = product(xc, we_up)
        if biases is not None:
            gate = gate + biases[0].float()[:, None, :]
            up = up + biases[1].float()[:, None, :]
        a = act(gate, up) * cc.t()[:, :, None]                       # [E, Nc, Ie]
        y = product(a.to(out_dtype), we_down).sum(0)                 # [Nc, H] f32
        if biases is not None:
            # the down bias applies once per selected expert, weighted by combine
            y = y + cc @ biases[2].float()
        outs.append(y)
    return outs[0] if len(outs) == 1 else torch.cat(outs)
