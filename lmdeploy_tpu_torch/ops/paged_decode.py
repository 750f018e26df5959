"""T=1 attention over the paged KV cache (decode).

Replaces the TPU kernels of ``lmdeploy_tpu/ops/pallas/paged_decode.py``
(``paged_decode_attention`` and its bodies).  On a CUDA tensor each wrapper launches
its hand-written Hopper kernel (the ``.cu`` header says what bounds it and how it is
laid out); on a CPU tensor it runs its ``*_plain`` version, the same function in plain
PyTorch.  There is no fallback: a CUDA tensor a kernel does not take raises.

``paged_decode_attention`` dispatches on the cache:
  * pages in the model's dtype ``[L, NB, 2, BS, Hkv*D]`` (body ``_decode_kernel``) ->
    ``csrc/paged_decode.cu``;
  * fp8-e4m3 pages of the same layout (quant_policy 16; the reference sends them
    through ``_decode_kernel`` too) -> ``paged_decode_attention_fp8``, the e4m3
    instantiation of the same kernel.  Window, softcap and sinks as for the model's
    dtype.  P stays f32 for the P.V product: the TPU kernel's rounding of P to the page
    type (``pr.astype(v.dtype)``, e4m3 there) is not copied (the tensor-core path for
    2-byte pages at D > 128 does round P to the page type, as the TPU kernel does);
  * int8 ``QuantKV`` (``_decode_kernel_quant``) -> ``paged_decode_attention_int8``,
    ``csrc/paged_decode_int8.cu``: ``s = (q*scale)·k_i8 * ksc``, ``acc += (p*vsc) @ v_i8``;
  * int4 ``QuantKV4`` (``_decode_kernel_quant4``) -> ``paged_decode_attention_int4``,
    ``csrc/paged_decode_int4.cu``: ``s = (q*scale)·k_q * ksc + Σ(q*scale) * kmin``,
    ``acc += (p*vsc) @ v_q + Σ p*vmin``, with Σ(q*scale) over the head's own D dims;
  * TurboQuant ``QuantKVTurbo`` (``_decode_kernel_turbo``) ->
    ``paged_decode_attention_turbo``, ``csrc/paged_decode_turbo.cu``: q arrives
    rotated into the cache's domain, ``s = ((q*scale)·cent + qjl * (q*scale)·sgn) * mse``,
    ``acc += (p*vnorm) @ vcent``; the caller rotates the output back.
The quantized kernels have a logit softcap but no window and no sinks, as the
reference never sends those to them.  ``kv_lens`` counts the token just filled; 0 marks
an inactive row, whose output is 0.  Each wrapper counts its own launches.

The int8, int4 and TurboQuant kernels split each row's pages over blocks
(``page_splits``: ``SPLIT_TOKENS_INT8`` / ``_INT4`` / ``_TURBO`` tokens a split, a
function of the table's shape alone, and for int8 of the batch's size) and combine the
splits' (acc, m, l) in a second
launch; their wrappers count that launch in ``.combines``.  ``*_split_plain`` computes
the same two passes in plain PyTorch (``split_partials_plain``, then ``cp_combine``).

Context parallelism (``paged_decode_attention_cp``, body ``_decode_kernel_cp``): the
cache is a ``parallel.mesh.StripedKV``, each page's slots striped over the 'cp' ranks.
``paged_decode_cp_partial`` (``csrc/paged_decode_cp.cu``) gives one rank's
unnormalized flash partials ``(acc, m, l)`` over its stripe, local slot j of page p at
position ``p*stride + pos_off + j``; a row's positions in its window are the local
indices ``[n(ws), n(len))`` (``cp_local_slots``), which the kernel splits over blocks
(``cp_splits``) and combines per row (``split_rows_plain`` gives the splits it reads;
``paged_decode_cp_partial_split_plain`` the two passes in plain PyTorch);
``cp_combine`` joins the ranks' partials (the reference's pmax / psum, :813-821) with
the sinks once, after the combine.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .flash_prefill import HEAD_DIMS, KERNEL_DTYPES
from .kv_quant import (QuantKV, QuantKV4, QuantKVTurbo, turbo_codebooks, turbo_sigma,
                       unpack_2bit, unpack_nibbles)

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every kernel takes q (and gives its output) in bf16, f16 or f32 (its dtype argument,
# KERNEL_DTYPES); head dims: the plain-layout, int8 and int4 kernels HEAD_DIMS (MLA's
# latent 576 through their wide paths), the TurboQuant one the powers of two up to 256
# (its cache needs one), the context-parallel partial those up to 256 (the families
# that reach it: MLA never takes cp)
QUANT_HEAD_DIMS = HEAD_DIMS
TURBO_HEAD_DIMS = tuple(d for d in HEAD_DIMS if d <= 256 and d & (d - 1) == 0)
CP_HEAD_DIMS = tuple(d for d in HEAD_DIMS if d <= 256)
# the int8 / int4 / TurboQuant head dims whose narrow path runs on the tensor cores for a
# bf16 or f16 q (whole 64-dim units); f32 q and the other dims take the CUDA-core body
MMA_QUANT_HEAD_DIMS = tuple(d for d in HEAD_DIMS if d <= 256 and d % 64 == 0)
# the context-parallel partial's head dims on the tensor cores, for bf16 / f16 stripes
# (Llama-3.1-8B's and gpt-oss's); f32 stripes and the other dims take the CUDA cores
CP_MMA_HEAD_DIMS = (64, 128)
# paged_decode{,_fp8}(q, cache, tables, kv_lens, sinks, out, part, dtype, B, Hq, Hkv, D,
#                     NB, BS, W, layer, scale, softcap, window, splits, stream)
_ARGTYPES = [_P] * 7 + [_I] * 9 + [_F, _F, _I, _I, _P]
# the wide paths (and the context-parallel partial) split each row's pages over
# blocks of about this many tokens, then combine the splits; the tensor-core wide path
# over 2-byte pages (D > 128, the MLA decode) walks a sub-chunk faster, and its best
# split on the card is twice as long (chip_smoke.decode_phase sweeps it; PERF.md)
SPLIT_TOKENS = 512
SPLIT_TOKENS_MMA = 1024
# the int4 and TurboQuant narrow paths (D <= 256) split each row's pages over blocks of
# about this many tokens too: chip_smoke.decode_kv_phase sweeps 256-2048 at every case;
# these are the best or within 2% of it at the Llama-3.1-8B and bs64 cases (PERF.md)
SPLIT_TOKENS_INT4 = 1024
SPLIT_TOKENS_TURBO = 2048
# the int8 decode's split (every path but MLA's wide one), swept 256-2048 by
# chip_smoke.decode_int8_phase at its cases: 1024 at the 64- and 128-row llama2-7b
# shapes, 256 for batches of up to INT8_SMALL_BATCH rows (PERF.md)
SPLIT_TOKENS_INT8 = 1024
SPLIT_TOKENS_INT8_SMALL = 256
INT8_SMALL_BATCH = 16
# the context-parallel partial's split on the tensor cores, in local slots of a rank,
# swept 256-2048 by chip_smoke.decode_cp_phase (PERF.md); the CUDA-core body keeps
# SPLIT_TOKENS
SPLIT_TOKENS_CP = 512
# and so do the narrow paths over 2-byte and e4m3 pages (D <= 128): chip_smoke's
# decode_phase and decode_kv_phase sweep it at their cases.  512 is the best at the
# Llama-3.1-8B fp8-KV cell's 64-row shape (256 is 7% slower there), and half of it at
# the TinyLlama cell's 16-row one, where batches of up to NARROW_SMALL_BATCH rows take
# half; gpt-oss's full-attention layers (64 rows) are ~4% faster at 256 in two runs, a
# trade this one constant makes (PERF.md)
SPLIT_TOKENS_NARROW = 512
NARROW_SMALL_BATCH = 16
# paged_decode_int8(q, data, scale, tables, kv_lens, out, part, dtype, B, Hq, Hkv, D,
#                   NB, BS, W, layer, scale, softcap, splits, stream)
_ARGTYPES_INT8 = [_P] * 7 + [_I] * 9 + [_F, _F, _I, _P]
# paged_decode_int4(q, data, scale, minv, tables, kv_lens, out, part, dtype, B, Hq, Hkv,
#                   D, NB, BS, W, layer, scale, softcap, splits, stream)
_ARGTYPES_INT4 = [_P] * 8 + [_I] * 9 + [_F, _F, _I, _P]
# paged_decode_turbo(q, data, meta, tables, kv_lens, out, part, dtype, B, Hq, Hkv, D, NB,
#                    BS, W, layer, scale, softcap, sigma, splits, stream)
_ARGTYPES_TURBO = [_P] * 7 + [_I] * 9 + [_F, _F, _F, _I, _P]
# paged_decode_cp(q, stripe, tables, kv_lens, out, part, dtype, B, Hq, Hkv, D, NB, BSl, W,
#                 layer, pos_off, stride, scale, softcap, window, splits, stream)
_ARGTYPES_CP = [_P] * 6 + [_I] * 11 + [_F, _F, _I, _I, _P]


def _softmax_out(s: torch.Tensor, kv_lens: torch.Tensor, pv, B: int, Hq: int, D: int,
                 dtype, sk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain versions' shared tail: masked scores s [B, Hkv, G, S] -> softmax
    (one pass, f32), ``pv(p)`` -> unnormalized [B, Hkv, G, D], sinks in the
    denominator while the row max is real, l == 0 -> 1, inactive rows -> 0."""
    valid = torch.arange(s.shape[-1], device=s.device)[None, :] < kv_lens.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full((), MASK_VALUE, device=s.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(-1)
    if sk is not None:
        lsum = lsum + torch.where(m > 0.5 * MASK_VALUE, torch.exp(sk - m),
                                  torch.zeros_like(m))
    out = pv(p) / torch.where(lsum == 0, torch.ones_like(lsum), lsum)[..., None]
    out = torch.where((kv_lens > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(B, Hq, D).to(dtype)


def _softcap(s: torch.Tensor, logit_softcap: Optional[float]) -> torch.Tensor:
    if logit_softcap is not None and logit_softcap > 0:
        return torch.tanh(s / logit_softcap) * logit_softcap
    return s


def _token_major(x: torch.Tensor, B: int, S: int, Hkv: int) -> torch.Tensor:
    """Gathered per-token rows [B, W, BS, Hkv] -> [B, Hkv, 1, S] (broadcast over G)."""
    return x.reshape(B, S, Hkv).permute(0, 2, 1)[:, :, None]


def _check(kernel: str, q: torch.Tensor, pages: torch.Tensor, block_tables: torch.Tensor,
           kv_lens: torch.Tensor, layer: int, num_kv_heads: int, extras=(),
           head_dims=HEAD_DIMS):
    """The checks every decode wrapper makes before a launch; ``pages`` is the code
    tensor, ``extras`` the cache's other tensors.  Returns (B, Hq, D, NB, BS, W)."""
    B, Hq, D = q.shape
    L, NB, BS, W = pages.shape[0], pages.shape[1], pages.shape[-2], block_tables.shape[1]
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f'{kernel} kernel takes a bf16, f16 or f32 q, got {q.dtype}')
    if D not in head_dims:
        raise ValueError(f'{kernel} kernel is built for head_dim in {head_dims}, got {D}')
    if Hq % num_kv_heads or not 0 <= layer < L:
        raise ValueError(f'{kernel}: bad shapes q {tuple(q.shape)} cache '
                         f'{tuple(pages.shape)} kv heads {num_kv_heads} layer {layer}')
    for name, t, dt in (('block_tables', block_tables, torch.int32),
                        ('kv_lens', kv_lens, torch.int32)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f'{kernel}: {name} must be contiguous {dt} on {q.device}')
    if block_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError(f'{kernel}: block_tables / kv_lens batch mismatch')
    for t in (q, pages, *extras):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError(f'{kernel}: q and the cache must be contiguous on one device')
    return B, Hq, D, NB, BS, W


def _no_window_or_sinks(kind: str, window, sinks):
    if (window is not None and window > 0) or sinks is not None:
        raise ValueError(f'paged_decode: an {kind} cache takes no window and no sinks '
                         f'(the dense path serves them)')


# ---------------------------------------------------------------- bf16 and fp8 pages --
def plain_decode_terms(q: torch.Tensor, kv_cache: torch.Tensor, block_tables: torch.Tensor,
                       layer: int, scale: float, num_kv_heads: int,
                       logit_softcap: Optional[float]):
    """The decode over bf16, f16, f32 or fp8 pages: its scores s [B, Hkv, G, W*BS]
    (softcapped, not masked) and its P.V ``pv(p)`` -> unnormalized [B, Hkv, G, D], f32."""
    B, Hq, D = q.shape
    G = Hq // num_kv_heads
    _, NB, _, BS, _ = kv_cache.shape
    W = block_tables.shape[1]
    tables = block_tables.long().clamp(0, NB - 1)
    pages = kv_cache[layer][tables]                          # [B, W, 2, BS, HD]
    k = pages[:, :, 0].reshape(B, W * BS, num_kv_heads, D).float()
    v = pages[:, :, 1].reshape(B, W * BS, num_kv_heads, D).float()
    qg = q.float().reshape(B, num_kv_heads, G, D)
    s = _softcap(torch.einsum('bhgd,bshd->bhgs', qg, k) * scale, logit_softcap)
    return s, lambda p: torch.einsum('bhgs,bshd->bhgd', p, v)


def paged_decode_attention_plain(q: torch.Tensor, kv_cache: torch.Tensor,
                                 block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                 layer: int, scale: float, num_kv_heads: int,
                                 logit_softcap: Optional[float] = None,
                                 window: Optional[int] = None,
                                 sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Hq,D] over bf16, f16, f32 or fp8 pages -> [B,Hq,D], f32 softmax with the
    kernel's masking and sink rules."""
    B, Hq, D = q.shape
    G = Hq // num_kv_heads
    s, pv = plain_decode_terms(q, kv_cache, block_tables, layer, scale, num_kv_heads,
                               logit_softcap)
    if window is not None and window > 0:
        # keys before the window start take MASK_VALUE, as those past the length do
        start = (kv_lens.long()[:, None] - window).clamp(min=0)
        early = torch.arange(s.shape[-1], device=q.device)[None, :] < start
        s = torch.where(early[:, None, None, :], torch.full((), MASK_VALUE, device=q.device), s)
    sk = None if sinks is None else sinks.float().reshape(1, num_kv_heads, G)
    return _softmax_out(s, kv_lens, pv, B, Hq, D, q.dtype, sk)


def paged_decode_attention_split_plain(q: torch.Tensor, kv_cache: torch.Tensor,
                                       block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                       layer: int, scale: float, num_kv_heads: int,
                                       logit_softcap: Optional[float] = None,
                                       window: Optional[int] = None,
                                       sinks: Optional[torch.Tensor] = None,
                                       splits: Optional[int] = None) -> torch.Tensor:
    """The two passes of ``csrc/paged_decode.cu``'s split paths in plain PyTorch: each
    split's partials over its positions in the window (``split_partials_plain``;
    ``splits`` default the kernel's, ``plain_layout_splits``), then
    the fixed-order combine with the sinks (``cp_combine``).  The same function as
    ``paged_decode_attention_plain`` up to f32 rounding."""
    D, BS, W = q.shape[-1], kv_cache.shape[3], block_tables.shape[1]
    s, pv = plain_decode_terms(q, kv_cache, block_tables, layer, scale, num_kv_heads,
                               logit_softcap)
    if splits is None:
        splits = plain_layout_splits(D, kv_cache.dtype, q.shape[0], W, BS, window)
    return cp_combine(split_partials_plain(s, kv_lens, pv, BS, splits, window), sinks,
                      q.dtype)


def paged_decode_attention(q: torch.Tensor, kv_cache, block_tables: torch.Tensor,
                           kv_lens: torch.Tensor, layer: int, scale: float,
                           num_kv_heads: int, logit_softcap: Optional[float] = None,
                           window: Optional[int] = None,
                           sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Hq,D]; kv_cache [L,NB,2,BS,Hkv*D] in q's dtype or fp8 (or a quantized cache);
    block_tables [B,W] i32; kv_lens [B] i32; ``layer`` selects the cache layer;
    ``window`` None/<=0 = full attention; ``sinks`` [Hq] learned sink logits.
    Returns [B,Hq,D]."""
    quantized = {QuantKV: ('int8', paged_decode_attention_int8),
                 QuantKV4: ('int4', paged_decode_attention_int4),
                 QuantKVTurbo: ('TurboQuant', paged_decode_attention_turbo)}
    if type(kv_cache) in quantized:
        kind, fn = quantized[type(kv_cache)]
        _no_window_or_sinks(kind, window, sinks)
        return fn(q, kv_cache, block_tables, kv_lens, layer, scale, num_kv_heads,
                  logit_softcap)
    if kv_cache.dtype == torch.float8_e4m3fn:
        return paged_decode_attention_fp8(q, kv_cache, block_tables, kv_lens, layer,
                                          scale, num_kv_heads, logit_softcap, window, sinks)
    if not q.is_cuda:
        return paged_decode_attention_plain(q, kv_cache, block_tables, kv_lens, layer,
                                            scale, num_kv_heads, logit_softcap, window,
                                            sinks)
    if kv_cache.dtype != q.dtype:
        raise TypeError(f'paged_decode kernel takes a cache in q\'s dtype, got '
                        f'{q.dtype}/{kv_cache.dtype}')
    out, splits = _launch_plain_layout('paged_decode', 'paged_decode', q, kv_cache,
                                       block_tables, kv_lens, layer, scale, num_kv_heads,
                                       logit_softcap, window, sinks)
    paged_decode_attention.launches += 1
    paged_decode_attention.combines += splits > 1
    return out


# launches: one a call; combines: the calls whose split also launched the combine
paged_decode_attention.launches = 0
paged_decode_attention.combines = 0


def paged_decode_attention_fp8(q: torch.Tensor, kv_cache: torch.Tensor,
                               block_tables: torch.Tensor, kv_lens: torch.Tensor,
                               layer: int, scale: float, num_kv_heads: int,
                               logit_softcap: Optional[float] = None,
                               window: Optional[int] = None,
                               sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Hq,D] (bf16, f16 or f32) over fp8-e4m3 pages [L,NB,2,BS,Hkv*D]; the rest as
    ``paged_decode_attention``.  Its plain version is ``paged_decode_attention_plain``."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, kv_cache, block_tables, kv_lens, layer,
                                            scale, num_kv_heads, logit_softcap, window,
                                            sinks)
    if kv_cache.dtype != torch.float8_e4m3fn:
        raise TypeError(f'paged_decode_fp8 kernel takes an e4m3 cache, got {kv_cache.dtype}')
    out, splits = _launch_plain_layout('paged_decode_fp8', 'paged_decode_fp8', q, kv_cache,
                                       block_tables, kv_lens, layer, scale, num_kv_heads,
                                       logit_softcap, window, sinks)
    paged_decode_attention_fp8.launches += 1
    paged_decode_attention_fp8.combines += splits > 1
    return out


# launches: one a call; combines: the calls whose split also launched the combine
paged_decode_attention_fp8.launches = 0
paged_decode_attention_fp8.combines = 0


def _launch_plain_layout(kernel, symbol, q, kv_cache, block_tables, kv_lens, layer, scale,
                         num_kv_heads, logit_softcap, window, sinks) -> torch.Tensor:
    """Check and launch ``symbol`` of ``csrc/paged_decode.cu`` over plain-layout pages;
    returns (out, splits)."""
    B, Hq, D, NB, BS, W = _check(kernel, q, kv_cache, block_tables, kv_lens, layer,
                                 num_kv_heads)
    if kv_cache.dim() != 5 or kv_cache.shape[2] != 2 or kv_cache.shape[4] != num_kv_heads * D:
        raise ValueError(f'{kernel}: cache {tuple(kv_cache.shape)} is not '
                         f'[L, NB, 2, BS, {num_kv_heads * D}]')
    sinks_ptr = None
    if sinks is not None:
        sinks = sinks.to(device=q.device, dtype=torch.float32).contiguous()
        if sinks.shape != (Hq,):
            raise ValueError(f'{kernel}: sinks must be [{Hq}], got {tuple(sinks.shape)}')
        sinks_ptr = sinks.data_ptr()
    out = torch.empty_like(q)
    splits = plain_layout_splits(D, kv_cache.dtype, B, W, BS, window)
    part = _split_part(q, splits)
    fn = cuda_build.entry('paged_decode', symbol, _ARGTYPES)
    rc = fn(q.data_ptr(), kv_cache.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), sinks_ptr, out.data_ptr(),
            None if part is None else part.data_ptr(), KERNEL_DTYPES[q.dtype],
            B, Hq, num_kv_heads, D, NB, BS, W, layer, scale,
            logit_softcap if logit_softcap else 0.0,
            window if window and window > 0 else 0, splits, cuda_build.stream_handle(q))
    cuda_build.check(rc, kernel)
    return out, splits


def plain_layout_splits(D: int, dtype: torch.dtype, B: int, W: int, BS: int,
                        window: Optional[int] = None) -> int:
    """The split of each row's W pages that ``csrc/paged_decode.cu`` takes over pages of
    ``dtype`` for a batch of B rows: ``page_splits`` with ``narrow_split_tokens``, or
    one split where a window's pages (ceil(window / BS) + 1 at most) fit in one split's
    -- the other splits would hold nothing but still cost their blocks and the combine
    -- and, on the narrow paths, where the whole table holds 2 * SPLIT_TOKENS_NARROW
    positions at most: there one block a row beats the split and its combine (PERF.md)."""
    tokens = narrow_split_tokens(D, dtype, B)
    if window is not None and window > 0 and -(-window // BS) + 1 <= max(1, tokens // BS):
        return 1
    narrow = D <= 128 and torch.empty((), dtype=dtype).element_size() <= 2
    if narrow and W * BS <= 2 * SPLIT_TOKENS_NARROW:
        return 1
    return page_splits(W, BS, tokens)


def narrow_split_tokens(D: int, dtype: torch.dtype, B: int) -> int:
    """The tokens a split of ``csrc/paged_decode.cu`` over pages of ``dtype`` for a batch
    of B rows: the narrow paths' (2-byte and e4m3 pages up to D 128)
    ``SPLIT_TOKENS_NARROW`` (half of it up to ``NARROW_SMALL_BATCH`` rows), the
    tensor-core wide path's (2-byte pages above) ``SPLIT_TOKENS_MMA``, the wide one's
    ``SPLIT_TOKENS``."""
    size = torch.empty((), dtype=dtype).element_size()
    if D <= 128 and size <= 2:
        return SPLIT_TOKENS_NARROW // (2 if B <= NARROW_SMALL_BATCH else 1)
    return SPLIT_TOKENS_MMA if size == 2 else SPLIT_TOKENS


def page_splits(W: int, BS: int, tokens: int) -> int:
    """The split of a row's W pages of BS slots over blocks of about ``tokens``
    tokens: ceil(W / max(1, tokens // BS)) splits of ceil(W / splits) pages each.  A
    function of the table's shape alone (no read of kv_lens), so a call stays the same
    launch whatever the rows' lengths."""
    return -(-W // max(1, tokens // BS))


def _split_part(q: torch.Tensor, splits: int) -> Optional[torch.Tensor]:
    """A split launch's f32 [B, splits, Hq, D + 2] scratch (None for one split)."""
    B, Hq, D = q.shape
    return (torch.empty(B * splits * Hq * (D + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)


def split_partials_plain(s: torch.Tensor, kv_lens: torch.Tensor, pv, BS: int,
                         splits: int, window: Optional[int] = None,
                         start: Optional[torch.Tensor] = None):
    """The first pass of a decode whose row's pages are split over blocks: scores s
    [B, Hkv, G, W*BS] (softcapped, not masked), ``pv(p)`` -> unnormalized
    [B, Hkv, G, D].  Pages [sp * n, (sp + 1) * n), n = ceil(W / splits), make split sp;
    each split's f32 (acc [B,Hq,D], m [B,Hq], l [B,Hq]) over its slots below kv_len
    (and, with a ``window``, from kv_len - window on; with ``start`` [B], from there
    on), an empty split (0, MASK_VALUE, 0).  Returns them in split order, the form
    ``cp_combine`` joins."""
    B, Hkv, G, S = s.shape
    n = -(-(S // BS) // splits) * BS
    pos = torch.arange(S, device=s.device)
    lens = kv_lens.long()[:, None]
    valid = pos[None, :] < lens
    if window is not None and window > 0:
        valid &= pos[None, :] >= (lens - window).clamp(min=0)
    if start is not None:
        valid &= pos[None, :] >= start.long()[:, None]
    parts = []
    for sp in range(splits):
        keep = (valid & (pos >= sp * n) & (pos < (sp + 1) * n))[:, None, None, :]
        ss = torch.where(keep, s, torch.full((), MASK_VALUE, device=s.device))
        m = ss.amax(-1)
        p = torch.where(keep, torch.exp(ss - m[..., None]), torch.zeros((), device=s.device))
        parts.append((pv(p).reshape(B, Hkv * G, -1), m.reshape(B, -1),
                      p.sum(-1).reshape(B, -1)))
    return parts


def split_rows_plain(n_len: torch.Tensor, n_ws: torch.Tensor, BS: int, W: int,
                     splits: int):
    """The splits each row's combine reads (``csrc/decode_split.cuh:
    decode_split_combine_rank``): a row that counts the slots [n_ws, n_len) of its W
    pages of BS slots, split ``splits`` ways, holds one in splits [s_lo, s_hi), s_hi =
    ceil(pages / split_pages), pages = min(ceil(n_len / BS), W), s_lo = (n_ws / BS) /
    split_pages, and none where n_len <= n_ws.  Returns (s_lo, s_hi), [B] each."""
    n_len, n_ws = n_len.long(), n_ws.long()
    split_pages = -(-W // splits)
    pages = torch.where(n_len > n_ws, torch.clamp(-(-n_len // BS), max=W),
                        torch.zeros_like(n_len))
    s_hi = torch.clamp(-(-pages // split_pages), max=splits)
    return torch.minimum(s_hi, (n_ws // BS) // split_pages), s_hi


def combine_split_rows_plain(parts, s_lo: torch.Tensor, s_hi: torch.Tensor):
    """The combine of a context-parallel rank's splits: each row's splits [s_lo, s_hi)
    of ``parts`` [(acc [B,Hq,D], m [B,Hq], l [B,Hq]), ...] joined in order into its
    unnormalized (acc, m, l) -- m = max m_s, weights e^(m_s - m) -- and (0, MASK_VALUE,
    0) where it reads none."""
    idx = torch.arange(len(parts), device=s_lo.device)[:, None]
    keep = ((idx >= s_lo[None]) & (idx < s_hi[None]))[..., None]      # [S, B, 1]
    ms = torch.stack([m for _, m, _ in parts])
    m = torch.where(keep, ms, torch.full((), MASK_VALUE, device=ms.device)).amax(0)
    w = torch.where(keep, torch.exp(ms - m), torch.zeros((), device=ms.device))
    lsum = (w * torch.stack([lp for _, _, lp in parts])).sum(0)
    acc = (w[..., None] * torch.stack([a for a, _, _ in parts])).sum(0)
    return acc, m, lsum


# ----------------------------------------------------------------------------- int8 --
def int8_decode_terms(q: torch.Tensor, kv: QuantKV, block_tables: torch.Tensor,
                      layer: int, scale: float, num_kv_heads: int,
                      logit_softcap: Optional[float]):
    """The int8 decode's scores s [B, Hkv, G, W*BS] (softcapped, not masked) and its
    P.V ``pv(p)`` -> unnormalized [B, Hkv, G, D], f32, scales on the score side."""
    B, Hq, D = q.shape
    Hkv, G = num_kv_heads, Hq // num_kv_heads
    _, NB, _, BS, _ = kv.data.shape
    S = block_tables.shape[1] * BS
    tables = block_tables.long().clamp(0, NB - 1)
    pages = kv.data[layer][tables]                           # [B, W, 2, BS, HD] i8
    scales = kv.scale[layer][tables]                         # [B, W, 2, BS, Hkv]
    k = pages[:, :, 0].reshape(B, S, Hkv, D).float()
    v = pages[:, :, 1].reshape(B, S, Hkv, D).float()
    ksc = _token_major(scales[:, :, 0], B, S, Hkv)
    vsc = _token_major(scales[:, :, 1], B, S, Hkv)
    qg = q.float().reshape(B, Hkv, G, D) * scale
    s = _softcap(torch.einsum('bhgd,bshd->bhgs', qg, k) * ksc, logit_softcap)
    return s, lambda p: torch.einsum('bhgs,bshd->bhgd', p * vsc, v)


def paged_decode_attention_int8_plain(q: torch.Tensor, kv: QuantKV,
                                      block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                      layer: int, scale: float, num_kv_heads: int,
                                      logit_softcap: Optional[float] = None
                                      ) -> torch.Tensor:
    """q [B,Hq,D] over an int8 cache -> [B,Hq,D]; f32, scales on the score side."""
    B, Hq, D = q.shape
    s, pv = int8_decode_terms(q, kv, block_tables, layer, scale, num_kv_heads, logit_softcap)
    return _softmax_out(s, kv_lens, pv, B, Hq, D, q.dtype)


def int8_splits(W: int, BS: int, D: int, B: int) -> int:
    """The int8 kernel's split of a row's W pages for a batch of B rows: the narrow
    paths' ``SPLIT_TOKENS_INT8`` (``SPLIT_TOKENS_INT8_SMALL`` up to ``INT8_SMALL_BATCH``
    rows), the wide path's (D 576) ``SPLIT_TOKENS``."""
    if D > 256:
        return page_splits(W, BS, SPLIT_TOKENS)
    return page_splits(W, BS, SPLIT_TOKENS_INT8_SMALL if B <= INT8_SMALL_BATCH
                       else SPLIT_TOKENS_INT8)


def paged_decode_attention_int8_split_plain(q: torch.Tensor, kv: QuantKV,
                                            block_tables: torch.Tensor,
                                            kv_lens: torch.Tensor, layer: int,
                                            scale: float, num_kv_heads: int,
                                            logit_softcap: Optional[float] = None,
                                            splits: Optional[int] = None) -> torch.Tensor:
    """The int8 kernel's two passes in plain PyTorch: each split's partials
    (``split_partials_plain``; ``splits`` default the kernel's, ``int8_splits``), then
    the fixed-order combine (``cp_combine``).  The same function as
    ``paged_decode_attention_int8_plain`` up to f32 rounding."""
    B, _, D = q.shape
    BS, W = kv.data.shape[3], block_tables.shape[1]
    s, pv = int8_decode_terms(q, kv, block_tables, layer, scale, num_kv_heads, logit_softcap)
    splits = int8_splits(W, BS, D, B) if splits is None else splits
    return cp_combine(split_partials_plain(s, kv_lens, pv, BS, splits), None, q.dtype)


def paged_decode_attention_int8(q: torch.Tensor, kv: QuantKV, block_tables: torch.Tensor,
                                kv_lens: torch.Tensor, layer: int, scale: float,
                                num_kv_heads: int,
                                logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,Hq,D] (bf16, f16 or f32); ``kv.data`` int8 [L,NB,2,BS,Hkv*D], ``kv.scale`` f32
    [L,NB,2,BS,Hkv]; block_tables [B,W] i32; kv_lens [B] i32.  Returns [B,Hq,D]."""
    if not q.is_cuda:
        return paged_decode_attention_int8_plain(q, kv, block_tables, kv_lens, layer,
                                                 scale, num_kv_heads, logit_softcap)
    data, scales = kv.data, kv.scale
    if data.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f'paged_decode_int8 kernel takes int8 data and f32 scales, got '
                        f'{data.dtype}/{scales.dtype}')
    B, Hq, D, NB, BS, W = _check('paged_decode_int8', q, data, block_tables, kv_lens,
                                 layer, num_kv_heads, (scales,),
                                 head_dims=QUANT_HEAD_DIMS)
    L = data.shape[0]
    if (data.shape != (L, NB, 2, BS, num_kv_heads * D)
            or scales.shape != (L, NB, 2, BS, num_kv_heads)):
        raise ValueError(f'paged_decode_int8: bad shapes data {tuple(data.shape)} scale '
                         f'{tuple(scales.shape)} for {num_kv_heads} kv heads of {D}')
    out = torch.empty_like(q)
    splits = int8_splits(W, BS, D, B)
    part = _split_part(q, splits)
    fn = cuda_build.entry('paged_decode_int8', 'paged_decode_int8', _ARGTYPES_INT8)
    rc = fn(q.data_ptr(), data.data_ptr(), scales.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
            KERNEL_DTYPES[q.dtype], B, Hq, num_kv_heads, D, NB, BS, W, layer, scale,
            logit_softcap if logit_softcap else 0.0, splits, cuda_build.stream_handle(q))
    cuda_build.check(rc, 'paged_decode_int8')
    paged_decode_attention_int8.launches += 1
    paged_decode_attention_int8.combines += splits > 1
    return out


# launches: one a call; combines: the calls whose split also launched the combine
paged_decode_attention_int8.launches = 0
paged_decode_attention_int8.combines = 0


# ----------------------------------------------------------------------------- int4 --
def int4_decode_terms(q: torch.Tensor, kv: QuantKV4, block_tables: torch.Tensor,
                      layer: int, scale: float, num_kv_heads: int,
                      logit_softcap: Optional[float]):
    """The int4 decode's scores s [B, Hkv, G, W*BS] (softcapped, not masked) and its
    P.V ``pv(p)`` -> unnormalized [B, Hkv, G, D], f32."""
    B, Hq, D = q.shape
    Hkv, G = num_kv_heads, Hq // num_kv_heads
    NB, BS = kv.data.shape[1], kv.data.shape[3]
    S = block_tables.shape[1] * BS
    tables = block_tables.long().clamp(0, NB - 1)
    pages = unpack_nibbles(kv.data[layer][tables])           # [B, W, 2, BS, HD] 0..15
    k = pages[:, :, 0].reshape(B, S, Hkv, D).float()
    v = pages[:, :, 1].reshape(B, S, Hkv, D).float()
    sc = kv.scale[layer][tables]                             # [B, W, 2, BS, Hkv]
    mn = kv.minv[layer][tables]
    ksc, kmn = _token_major(sc[:, :, 0], B, S, Hkv), _token_major(mn[:, :, 0], B, S, Hkv)
    vsc, vmn = _token_major(sc[:, :, 1], B, S, Hkv), _token_major(mn[:, :, 1], B, S, Hkv)
    qg = q.float().reshape(B, Hkv, G, D) * scale
    s = torch.einsum('bhgd,bshd->bhgs', qg, k) * ksc + qg.sum(-1, keepdim=True) * kmn
    s = _softcap(s, logit_softcap)

    def pv(p):
        return (torch.einsum('bhgs,bshd->bhgd', p * vsc, v)
                + (p * vmn).sum(-1, keepdim=True))
    return s, pv


def paged_decode_attention_int4_plain(q: torch.Tensor, kv: QuantKV4,
                                      block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                      layer: int, scale: float, num_kv_heads: int,
                                      logit_softcap: Optional[float] = None
                                      ) -> torch.Tensor:
    """q [B,Hq,D] over an int4 cache -> [B,Hq,D]; f32, scale and min on the score
    side: ``s = (qs·k_q) * ksc + Σqs * kmin`` with qs = q * scale summed over the
    head's D dims, ``out = ((p*vsc) @ v_q + Σ p*vmin) / l``."""
    B, Hq, D = q.shape
    s, pv = int4_decode_terms(q, kv, block_tables, layer, scale, num_kv_heads, logit_softcap)
    return _softmax_out(s, kv_lens, pv, B, Hq, D, q.dtype)


def int4_splits(W: int, BS: int, D: int) -> int:
    """The int4 kernel's split of a row's W pages: the narrow paths'
    ``SPLIT_TOKENS_INT4``, the wide path's (D 576) ``SPLIT_TOKENS``."""
    return page_splits(W, BS, SPLIT_TOKENS if D > 256 else SPLIT_TOKENS_INT4)


def paged_decode_attention_int4_split_plain(q: torch.Tensor, kv: QuantKV4,
                                            block_tables: torch.Tensor,
                                            kv_lens: torch.Tensor, layer: int,
                                            scale: float, num_kv_heads: int,
                                            logit_softcap: Optional[float] = None,
                                            splits: Optional[int] = None) -> torch.Tensor:
    """The int4 kernel's two passes in plain PyTorch: each split's partials
    (``split_partials_plain``; ``splits`` default the kernel's, ``int4_splits``), then
    the fixed-order combine (``cp_combine``).  The same function as
    ``paged_decode_attention_int4_plain`` up to f32 rounding."""
    B, Hq, D = q.shape
    BS, W = kv.data.shape[3], block_tables.shape[1]
    s, pv = int4_decode_terms(q, kv, block_tables, layer, scale, num_kv_heads, logit_softcap)
    splits = int4_splits(W, BS, D) if splits is None else splits
    return cp_combine(split_partials_plain(s, kv_lens, pv, BS, splits), None, q.dtype)


def paged_decode_attention_int4(q: torch.Tensor, kv: QuantKV4, block_tables: torch.Tensor,
                                kv_lens: torch.Tensor, layer: int, scale: float,
                                num_kv_heads: int,
                                logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q [B,Hq,D] (bf16, f16 or f32); ``kv.data`` u8 [L,NB,2,BS,Hkv*D/2], ``kv.scale`` and ``kv.minv``
    f32 [L,NB,2,BS,Hkv]; block_tables [B,W] i32; kv_lens [B] i32.  Returns [B,Hq,D]."""
    if not q.is_cuda:
        return paged_decode_attention_int4_plain(q, kv, block_tables, kv_lens, layer,
                                                 scale, num_kv_heads, logit_softcap)
    data, scales, minv = kv.data, kv.scale, kv.minv
    if (data.dtype != torch.uint8 or scales.dtype != torch.float32
            or minv.dtype != torch.float32):
        raise TypeError(f'paged_decode_int4 kernel takes u8 data and f32 scale and min, '
                        f'got {data.dtype}/{scales.dtype}/{minv.dtype}')
    B, Hq, D, NB, BS, W = _check('paged_decode_int4', q, data, block_tables, kv_lens,
                                 layer, num_kv_heads, (scales, minv),
                                 head_dims=QUANT_HEAD_DIMS)
    L = data.shape[0]
    if (data.shape != (L, NB, 2, BS, num_kv_heads * D // 2)
            or scales.shape != (L, NB, 2, BS, num_kv_heads) or minv.shape != scales.shape):
        raise ValueError(f'paged_decode_int4: bad shapes data {tuple(data.shape)} scale '
                         f'{tuple(scales.shape)} min {tuple(minv.shape)} for '
                         f'{num_kv_heads} kv heads of {D}')
    out = torch.empty_like(q)
    splits = int4_splits(W, BS, D)
    part = _split_part(q, splits)
    fn = cuda_build.entry('paged_decode_int4', 'paged_decode_int4', _ARGTYPES_INT4)
    rc = fn(q.data_ptr(), data.data_ptr(), scales.data_ptr(), minv.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), KERNEL_DTYPES[q.dtype], B, Hq,
            num_kv_heads, D, NB, BS, W, layer, scale,
            logit_softcap if logit_softcap else 0.0, splits, cuda_build.stream_handle(q))
    cuda_build.check(rc, 'paged_decode_int4')
    paged_decode_attention_int4.launches += 1
    paged_decode_attention_int4.combines += splits > 1
    return out


# launches: one a call; combines: the calls whose split also launched the combine
paged_decode_attention_int4.launches = 0
paged_decode_attention_int4.combines = 0


# ----------------------------------------------------------------------- TurboQuant --
def turbo_decode_terms(q: torch.Tensor, kv: QuantKVTurbo, block_tables: torch.Tensor,
                       layer: int, scale: float, num_kv_heads: int,
                       logit_softcap: Optional[float]):
    """The TurboQuant decode's scores s [B, Hkv, G, W*BS] (softcapped, not masked) and
    its P.V ``pv(p)`` -> unnormalized [B, Hkv, G, D], f32, in the rotated domain."""
    B, Hq, D = q.shape
    Hkv, G = num_kv_heads, Hq // num_kv_heads
    NB, BS = kv.data.shape[1], kv.data.shape[2]
    HD = Hkv * D
    S = block_tables.shape[1] * BS
    tables = block_tables.long().clamp(0, NB - 1)
    rows = kv.data[layer][tables]                            # [B, W, BS, 3*HD/4]
    meta = kv.meta[layer][tables]                            # [B, W, BS, 3, Hkv]
    kc = unpack_nibbles(rows[..., :HD // 2]).reshape(B, S, Hkv, D)
    vc = unpack_2bit(rows[..., HD // 2:]).reshape(B, S, Hkv, D)
    cent3, cent2 = turbo_codebooks(D, q.device)
    cent = cent3[(kc & 0x7).long()]
    sgn = ((kc >> 3) & 0x1).float() * 2.0 - 1.0
    mse, qjl, vnorm = (_token_major(meta[..., i, :], B, S, Hkv) for i in range(3))
    qg = q.float().reshape(B, Hkv, G, D) * scale
    s = (torch.einsum('bhgd,bshd->bhgs', qg, cent)
         + qjl * torch.einsum('bhgd,bshd->bhgs', qg, sgn)) * mse
    s = _softcap(s, logit_softcap)
    return s, lambda p: torch.einsum('bhgs,bshd->bhgd', p * vnorm, cent2[vc.long()])


def paged_decode_attention_turbo_plain(q: torch.Tensor, kv: QuantKVTurbo,
                                       block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                       layer: int, scale: float, num_kv_heads: int,
                                       logit_softcap: Optional[float] = None
                                       ) -> torch.Tensor:
    """ROTATED q [B,Hq,D] over a TurboQuant cache -> rotated-domain [B,Hq,D]; f32,
    norms on the score side: ``s = (qs·cent + qjl * qs·sgn) * mse`` with qs = q *
    scale, ``out = ((p*vnorm) @ vcent) / l``."""
    B, Hq, D = q.shape
    s, pv = turbo_decode_terms(q, kv, block_tables, layer, scale, num_kv_heads, logit_softcap)
    return _softmax_out(s, kv_lens, pv, B, Hq, D, q.dtype)


def turbo_splits(W: int, BS: int) -> int:
    """The TurboQuant kernel's split of a row's W pages (``SPLIT_TOKENS_TURBO``)."""
    return page_splits(W, BS, SPLIT_TOKENS_TURBO)


def paged_decode_attention_turbo_split_plain(q: torch.Tensor, kv: QuantKVTurbo,
                                             block_tables: torch.Tensor,
                                             kv_lens: torch.Tensor, layer: int,
                                             scale: float, num_kv_heads: int,
                                             logit_softcap: Optional[float] = None,
                                             splits: Optional[int] = None) -> torch.Tensor:
    """The TurboQuant kernel's two passes in plain PyTorch (rotated domain): each
    split's partials (``split_partials_plain``; ``splits`` default the kernel's,
    ``turbo_splits``), then the fixed-order combine (``cp_combine``)."""
    BS, W = kv.data.shape[2], block_tables.shape[1]
    s, pv = turbo_decode_terms(q, kv, block_tables, layer, scale, num_kv_heads, logit_softcap)
    splits = turbo_splits(W, BS) if splits is None else splits
    return cp_combine(split_partials_plain(s, kv_lens, pv, BS, splits), None, q.dtype)


def paged_decode_attention_turbo(q: torch.Tensor, kv: QuantKVTurbo,
                                 block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                 layer: int, scale: float, num_kv_heads: int,
                                 logit_softcap: Optional[float] = None) -> torch.Tensor:
    """ROTATED q [B,Hq,D] (bf16, f16 or f32); ``kv.data`` u8 [L,NB,BS,3*Hkv*D/4], ``kv.meta`` f32
    [L,NB,BS,3,Hkv]; block_tables [B,W] i32; kv_lens [B] i32.  Returns the
    rotated-domain [B,Hq,D]."""
    if not q.is_cuda:
        return paged_decode_attention_turbo_plain(q, kv, block_tables, kv_lens, layer,
                                                  scale, num_kv_heads, logit_softcap)
    data, meta = kv.data, kv.meta
    if data.dtype != torch.uint8 or meta.dtype != torch.float32:
        raise TypeError(f'paged_decode_turbo kernel takes u8 data and f32 meta, got '
                        f'{data.dtype}/{meta.dtype}')
    B, Hq, D, NB, BS, W = _check('paged_decode_turbo', q, data, block_tables, kv_lens,
                                 layer, num_kv_heads, (meta,),
                                 head_dims=TURBO_HEAD_DIMS)
    L = data.shape[0]
    if (data.shape != (L, NB, BS, 3 * num_kv_heads * D // 4)
            or meta.shape != (L, NB, BS, 3, num_kv_heads)):
        raise ValueError(f'paged_decode_turbo: bad shapes data {tuple(data.shape)} meta '
                         f'{tuple(meta.shape)} for {num_kv_heads} kv heads of {D}')
    out = torch.empty_like(q)
    splits = turbo_splits(W, BS)
    part = _split_part(q, splits)
    fn = cuda_build.entry('paged_decode_turbo', 'paged_decode_turbo', _ARGTYPES_TURBO)
    rc = fn(q.data_ptr(), data.data_ptr(), meta.data_ptr(), block_tables.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
            KERNEL_DTYPES[q.dtype], B, Hq, num_kv_heads, D, NB, BS, W,
            layer, scale, logit_softcap if logit_softcap else 0.0,
            float(turbo_sigma(D)), splits, cuda_build.stream_handle(q))
    cuda_build.check(rc, 'paged_decode_turbo')
    paged_decode_attention_turbo.launches += 1
    paged_decode_attention_turbo.combines += splits > 1
    return out


# launches: one a call; combines: the calls whose split also launched the combine
paged_decode_attention_turbo.launches = 0
paged_decode_attention_turbo.combines = 0


# ------------------------------------------------------------- context parallelism --
def paged_decode_cp_partial_plain(q: torch.Tensor, stripe: torch.Tensor,
                                  block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                  layer: int, scale: float, num_kv_heads: int,
                                  pos_off: int, stride: int,
                                  logit_softcap: Optional[float] = None,
                                  window: Optional[int] = None):
    """One rank's flash partials over its stripe [L, NB, 2, BSl, Hkv*D], local slot j of
    page p at position ``p*stride + pos_off + j``: positions in ``[ws, kv_len)``
    count (ws = max(kv_len - window, 0) with a window), ``m`` = their max score
    (MASK_VALUE where there is none), ``l`` = the sum of e^(s - m), ``acc`` = the sum of
    e^(s - m) v, all f32.  Returns (acc [B,Hq,D], m [B,Hq], l [B,Hq])."""
    B, Hq, D = q.shape
    G = Hq // num_kv_heads
    _, NB, _, BSl, _ = stripe.shape
    W = block_tables.shape[1]
    tables = block_tables.long().clamp(0, NB - 1)
    pages = stripe[layer][tables]                            # [B, W, 2, BSl, HD]
    k = pages[:, :, 0].reshape(B, W * BSl, num_kv_heads, D).float()
    v = pages[:, :, 1].reshape(B, W * BSl, num_kv_heads, D).float()
    qg = q.float().reshape(B, num_kv_heads, G, D)
    s = _softcap(torch.einsum('bhgd,bshd->bhgs', qg, k) * scale, logit_softcap)
    pos = (torch.arange(W, device=q.device)[:, None] * stride + pos_off
           + torch.arange(BSl, device=q.device)[None, :]).reshape(-1)
    lens = kv_lens.long()[:, None]
    valid = pos[None, :] < lens
    if window is not None and window > 0:
        valid &= pos[None, :] >= (lens - window).clamp(min=0)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full((), MASK_VALUE, device=q.device))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros((), device=q.device))
    acc = torch.einsum('bhgs,bshd->bhgd', p, v)
    return acc.reshape(B, Hq, D), m.reshape(B, Hq), p.sum(-1).reshape(B, Hq)


def cp_local_slots(x: torch.Tensor, pos_off: int, stride: int, bsl: int) -> torch.Tensor:
    """n(x): the local slots of a context-parallel rank below positions x (an integer
    tensor).  Its slot j of page p is position p*stride + pos_off + j, so n(x) is 0 for
    x <= pos_off and else, with y = x - pos_off, (y // stride) * bsl + min(y % stride,
    bsl); a row's positions in [ws, len) are its local slots [n(ws), n(len))
    (``csrc/decode_split.cuh: Positions``)."""
    y = (x.long() - pos_off).clamp(min=0)
    return (y // stride) * bsl + (y % stride).clamp(max=bsl)


def cp_splits(W: int, bsl: int, D: int, dtype: torch.dtype) -> int:
    """The context-parallel partial's split of a row's W stripe pages of ``bsl`` slots:
    the tensor-core body's (bf16 / f16 stripes at ``CP_MMA_HEAD_DIMS``)
    ``SPLIT_TOKENS_CP`` local slots a split, the CUDA-core body's ``SPLIT_TOKENS``."""
    mma = D in CP_MMA_HEAD_DIMS and dtype in (torch.bfloat16, torch.float16)
    return page_splits(W, bsl, SPLIT_TOKENS_CP if mma else SPLIT_TOKENS)


def paged_decode_cp_partial_split_plain(q: torch.Tensor, stripe: torch.Tensor,
                                        block_tables: torch.Tensor, kv_lens: torch.Tensor,
                                        layer: int, scale: float, num_kv_heads: int,
                                        pos_off: int, stride: int,
                                        logit_softcap: Optional[float] = None,
                                        window: Optional[int] = None,
                                        splits: Optional[int] = None):
    """The kernel's two passes in plain PyTorch over the rank's local slots: row b counts
    the local slots [n(ws), n(len)) (``cp_local_slots``); each split's partials over its
    pages' slots (``split_partials_plain``; ``splits`` default the kernel's,
    ``cp_splits``), then each row's non-empty splits (``split_rows_plain``) joined in
    order into the rank's (acc, m, l) (``combine_split_rows_plain``).  The same function
    as ``paged_decode_cp_partial_plain`` up to f32 rounding."""
    D = q.shape[-1]
    bsl, W = stripe.shape[3], block_tables.shape[1]
    s, pv = plain_decode_terms(q, stripe, block_tables, layer, scale, num_kv_heads,
                               logit_softcap)
    lens = kv_lens.long()
    n_len = cp_local_slots(lens, pos_off, stride, bsl)
    n_ws = (cp_local_slots((lens - window).clamp(min=0), pos_off, stride, bsl)
            if window is not None and window > 0 else torch.zeros_like(lens))
    splits = cp_splits(W, bsl, D, q.dtype) if splits is None else splits
    parts = split_partials_plain(s, n_len, pv, bsl, splits, start=n_ws)
    return combine_split_rows_plain(parts, *split_rows_plain(n_len, n_ws, bsl, W, splits))


def paged_decode_cp_partial(q: torch.Tensor, stripe: torch.Tensor,
                            block_tables: torch.Tensor, kv_lens: torch.Tensor, layer: int,
                            scale: float, num_kv_heads: int, pos_off: int, stride: int,
                            logit_softcap: Optional[float] = None,
                            window: Optional[int] = None):
    """q [B,Hq,D] (bf16, f16 or f32) over one rank's stripe [L,NB,2,BSl,Hkv*D] in q's
    dtype; block_tables [B,W] i32; kv_lens [B] i32 (the whole row's length).  Returns
    the rank's unnormalized partials (acc f32 [B,Hq,D], m f32 [B,Hq], l f32 [B,Hq]),
    as ``paged_decode_cp_partial_plain``; on the card the kernel writes them one after
    the other into one buffer."""
    if not q.is_cuda:
        return paged_decode_cp_partial_plain(q, stripe, block_tables, kv_lens, layer, scale,
                                             num_kv_heads, pos_off, stride, logit_softcap,
                                             window)
    if stripe.dtype != q.dtype:
        raise TypeError(f'paged_decode_cp kernel takes a stripe in q\'s dtype, got '
                        f'{q.dtype}/{stripe.dtype}')
    B, Hq, D, NB, BSl, W = _check('paged_decode_cp', q, stripe, block_tables, kv_lens,
                                  layer, num_kv_heads, head_dims=CP_HEAD_DIMS)
    if stripe.dim() != 5 or stripe.shape[2] != 2 or stripe.shape[4] != num_kv_heads * D:
        raise ValueError(f'paged_decode_cp: stripe {tuple(stripe.shape)} is not '
                         f'[L, NB, 2, BSl, {num_kv_heads * D}]')
    if not 0 <= pos_off <= stride - BSl:
        raise ValueError(f'paged_decode_cp: a stripe of {BSl} slots at offset {pos_off} '
                         f'does not fit a page of {stride}')
    out = torch.empty(B * Hq * (D + 2), dtype=torch.float32, device=q.device)
    splits = cp_splits(W, BSl, D, q.dtype)
    part = _split_part(q, splits)
    fn = cuda_build.entry('paged_decode_cp', 'paged_decode_cp', _ARGTYPES_CP)
    rc = fn(q.data_ptr(), stripe.data_ptr(), block_tables.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            KERNEL_DTYPES[q.dtype], B, Hq, num_kv_heads, D, NB, BSl, W, layer, pos_off,
            stride, scale, logit_softcap if logit_softcap else 0.0,
            window if window and window > 0 else 0, splits, cuda_build.stream_handle(q))
    cuda_build.check(rc, 'paged_decode_cp')
    paged_decode_cp_partial.launches += 1
    paged_decode_cp_partial.combines += splits > 1
    heads = B * Hq
    return (out[:heads * D].view(B, Hq, D), out[heads * D:heads * (D + 1)].view(B, Hq),
            out[heads * (D + 1):].view(B, Hq))


# launches: one a call; combines: the calls whose split also launched the combine
paged_decode_cp_partial.launches = 0
paged_decode_cp_partial.combines = 0


def cp_combine(parts, sinks: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """The ranks' partials [(acc [B,Hq,D], m [B,Hq], l [B,Hq]), ...], in rank order and
    on one device -> the attention output [B,Hq,D] in ``out_dtype`` (reference
    :813-821; also the plain combine of the int4 / TurboQuant splits):
    ``m_g = max m``, ``a = exp(m - m_g)``, ``l_g = sum l*a``,
    ``acc_g = sum acc*a`` (summed in rank order: no atomics), sinks [Hq] add
    ``exp(sink - m_g)`` to ``l_g`` where ``m_g > 0.5*MASK_VALUE``, and
    ``out = acc_g / (l_g == 0 ? 1 : l_g)``.  A collective over a process group (an
    all-reduce of max, then of the weighted sums) can take this function's place."""
    m_g = torch.stack([m for _, m, _ in parts]).amax(0)
    l_g = acc_g = None
    for acc, m, lsum in parts:
        a = torch.exp(m - m_g)
        l_g = lsum * a if l_g is None else l_g + lsum * a
        acc_g = acc * a[..., None] if acc_g is None else acc_g + acc * a[..., None]
    if sinks is not None:
        l_g = l_g + torch.where(m_g > 0.5 * MASK_VALUE,
                                torch.exp(sinks.float().to(m_g.device) - m_g),
                                torch.zeros_like(m_g))
    return (acc_g / torch.where(l_g == 0, torch.ones_like(l_g), l_g)[..., None]).to(out_dtype)


def paged_decode_attention_cp(q: torch.Tensor, kv_cache, block_tables: torch.Tensor,
                              kv_lens: torch.Tensor, layer: int, scale: float,
                              num_kv_heads: int, mesh,
                              logit_softcap: Optional[float] = None,
                              window: Optional[int] = None,
                              sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Context-parallel decode over a ``StripedKV`` cache whose stripes lie on the
    mesh's 'cp' devices: q [B,Hq,D] on the mesh's first device; each rank's partials
    run on its own device (the kernel on a card, the plain version on the CPU), then
    ``cp_combine`` joins them on q's device.  ``sinks`` [Hq] join once, after the
    combine.  Returns [B,Hq,D] in q's dtype."""
    if kv_cache.cp != mesh.shape['cp'] or kv_cache.devices != mesh.cp_devices:
        raise ValueError(f'paged_decode_attention_cp: the cache\'s {kv_cache.cp} stripes '
                         f'on {kv_cache.devices} are not the mesh\'s cp ranks {mesh}')
    BS = kv_cache.shape[3]
    bsl = BS // kv_cache.cp
    parts = []
    for r, stripe in enumerate(kv_cache.stripes):
        dev = stripe.device
        acc, m, lsum = paged_decode_cp_partial(
            q.to(dev), stripe, block_tables.to(dev), kv_lens.to(dev), layer, scale,
            num_kv_heads, r * bsl, BS, logit_softcap, window)
        parts.append((acc.to(q.device), m.to(q.device), lsum.to(q.device)))
    return cp_combine(parts, sinks, q.dtype)
