"""Paged attention over a block-table KV cache: cache layout, fill, gather, dispatch.

Port of ``lmdeploy_tpu/ops/attention.py``.

The cache is ONE tensor ``[L, num_blocks, 2, block_size, Hkv*D]``: each page holds a K
plane and a V plane of head-major token rows, as in the reference but without its
128-lane padding (``kv_row_width``); ``weight_convert.cache_from_reference`` /
``cache_to_reference`` convert between the two without loss.  Block 0 is the reserved
padding block: padded rows and padded tokens write there and read from there, so no
index ever leaves the cache.  Writes are in place (``index_copy_``); there is no
buffer donation to lean on, so nothing here returns a new cache.

The quantized caches (``ops/kv_quant.py`` has their layouts) are filled by
quantizing each (token, head) row and scattering every tensor of the cache at the
token's row index, one ``index_copy_`` each:
  * int8 ``QuantKV`` (quant_policy 4) and int4 ``QuantKV4`` (8): code planes plus
    token-major scale (and min) rows; the gather dequantizes in f32;
  * fp8 (16): the plain cache in ``float8_e4m3fn``, written through its byte view
    (the CPU has no ``index_copy_`` for fp8) with the reference's cast
    (``kv_quant.to_fp8``: NaN past the e4m3 range, as JAX gives);
  * TurboQuant ``QuantKVTurbo`` (42): K and V rows Hadamard-rotated per head, then
    coded; the cache lives in the rotated domain, so every path that reads it rotates
    q in and the output back (the reference's :501-533).

Under context parallelism the cache is a ``parallel.mesh.StripedKV`` (each page's
slots striped over the 'cp' ranks): the fill sends token position ``pos`` to page
``pos // BS``, rank ``(pos % BS) // BSl`` and local slot ``pos % BSl`` (BSl = BS/cp),
and the gather joins the ranks' slots back into the unsharded rows (the reference's
GSPMD gather).

``paged_attention`` picks the path from the tensor's device (the rules of the
reference's ``paged_attention`` :475-629):
  * ``cp_mesh`` given, T == 1                -> ``paged_decode_attention_cp`` (each
    rank's partials over its stripe, then the combine; on the CPU too)
  * CUDA, T == 1 (decode)                    -> an ``ops/paged_decode.py`` kernel (on
    an int8, int4 or TurboQuant cache only without window and sinks: ``decode_route``;
    every block size)
  * CUDA, fresh prefill, no softcap/window   -> ``ops/flash_prefill.py`` kernel, over
    the chunk's exact K/V also with a quantized cache
  * everything else (chunked continuation, prefix hits, CPU) -> gather + dense torch,
    as the reference does in XLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.mesh import StripedKV
from .flash_prefill import flash_prefill_attention
from .kv_quant import (QuantKV, QuantKV4, QuantKVTurbo, dequantize_turbo_k,
                       dequantize_turbo_v, hadamard_rotate, hadamard_rotate_inv,
                       pack_2bit, pack_nibbles, quantize_rows, quantize_rows_int4,
                       quantize_rows_turbo_k, quantize_rows_turbo_v, to_fp8,
                       unpack_2bit, unpack_nibbles)
from .paged_decode import paged_decode_attention, paged_decode_attention_cp

# the dense path's score tensor per query tile, f32 bytes
SCORE_TILE_BYTES = 512 * 1024 * 1024
QUANT_CACHES = (QuantKV, QuantKV4, QuantKVTurbo)


def decode_route(kv_cache, window_size: Optional[int] = None,
                 sinks: Optional[torch.Tensor] = None) -> str:
    """The path a decode step over ``kv_cache`` takes on the card, from the cache's type
    alone: 'kernel' (an ``ops/paged_decode.py`` kernel, at any block size), or
    'gathered' (``gather_layer_kv`` + ``attention_dense_gathered``) for an int8, int4 or
    TurboQuant cache with a window or sinks, whose kernels take neither (the
    reference's rule, :584-609)."""
    windowed = window_size is not None and window_size > 0
    if isinstance(kv_cache, QUANT_CACHES) and (windowed or sinks is not None):
        return 'gathered'
    return 'kernel'


def compute_slot_mapping(block_tables: torch.Tensor, history_lens: torch.Tensor,
                         q_lens: torch.Tensor, T: int, block_size: int) -> torch.Tensor:
    """Flat cache slots for each (row, chunk-position) token; padding -> block 0.

    Returns [B*T] int64 (reference ``compute_slot_mapping``: the block index is
    clipped to the table width, padded tokens map to offsets of block 0)."""
    B, W = block_tables.shape
    idx = torch.arange(T, device=block_tables.device)[None, :]
    pos = history_lens.long()[:, None] + idx                      # [B, T]
    blk_off = pos % block_size
    blk_idx = (pos // block_size).clamp(0, W - 1)
    phys = torch.gather(block_tables.long(), 1, blk_idx)
    slots = phys * block_size + blk_off
    valid = idx < q_lens.long()[:, None]
    return torch.where(valid, slots, blk_off).reshape(B * T)


def _as_stored(kv_cache: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the cache's writable view, ``x`` in the cache's type): an fp8 cache is written
    through its byte view with the reference's cast."""
    if kv_cache.dtype == torch.float8_e4m3fn:
        return kv_cache.view(torch.uint8), to_fp8(x)
    return kv_cache, x.to(kv_cache.dtype)


def fill_kv_cache(kv_cache, k_new: torch.Tensor, v_new: torch.Tensor,
                  slot_mapping: torch.Tensor, layer: int,
                  page_tables: Optional[torch.Tensor] = None) -> None:
    """Write new K/V rows into layer ``layer`` of the cache, in place.

    k_new/v_new: [N, Hkv, D]; slot_mapping: [N] flat slots (block * BS + offset).
    ``page_tables`` [B, W] is passed only for fresh prefill (history 0, contiguous
    positions): whole [2, BS, HD] pages of a plain (or fp8) cache are then written at
    once, as the reference's page-granular path does.  Rows shorter than T write
    garbage into their last partial page beyond q_len (masked by length, overwritten
    later) and into block 0.  A quantized cache always takes the row scatter
    (reference :110-127).
    """
    if isinstance(kv_cache, StripedKV):
        _fill_striped(kv_cache, k_new, v_new, slot_mapping, layer, page_tables)
        return
    L, nb, _, bs, hd = kv_cache.shape
    N = k_new.shape[0]
    if page_tables is not None and not isinstance(kv_cache, QUANT_CACHES):
        B = page_tables.shape[0]
        T = N // B
        if T % bs == 0 and page_tables.shape[1] >= T // bs:
            n_pages = T // bs
            rows_k = k_new.reshape(B, n_pages, bs, hd)
            rows_v = v_new.reshape(B, n_pages, bs, hd)
            upd = torch.stack([rows_k, rows_v], dim=2).reshape(B * n_pages, 2, bs, hd)
            idx = page_tables[:, :n_pages].reshape(-1).long().clamp(0, nb - 1)
            dst, upd = _as_stored(kv_cache, upd)
            dst[layer].index_copy_(0, idx, upd)
            return
    # row scatter; the reference drops out-of-range slots (mode='drop'): here
    # they are sent to the padding block, whose contents are don't-care
    slots = slot_mapping.long()
    block = slots // bs
    off = slots % bs
    block = torch.where((block >= 0) & (block < nb), block, torch.zeros_like(block))
    if isinstance(kv_cache, QuantKVTurbo):
        _fill_turbo(kv_cache, k_new, v_new, (layer * nb + block) * bs + off)
        return
    k_idx = ((layer * nb + block) * 2) * bs + off
    rows = torch.cat([k_idx, k_idx + bs])
    if isinstance(kv_cache, (QuantKV, QuantKV4)):
        # per-(token, head) codes; the [L, NB, 2, BS, Hkv] scale (and min) pages share
        # the data's leading dims, so one [Hkv] row of each lands at the same row index
        if isinstance(kv_cache, QuantKV):
            (kq, *kpar), (vq, *vpar) = quantize_rows(k_new), quantize_rows(v_new)
        else:
            (kq, *kpar), (vq, *vpar) = quantize_rows_int4(k_new), quantize_rows_int4(v_new)
            kq, vq = pack_nibbles(kq), pack_nibbles(vq)
        data, *params = kv_cache.tensors()
        width = data.shape[-1]
        data.view(-1, width).index_copy_(
            0, rows, torch.cat([kq.reshape(N, width), vq.reshape(N, width)]))
        for dst, kp, vp in zip(params, kpar, vpar):
            dst.view(-1, dst.shape[-1]).index_copy_(0, rows, torch.cat([kp, vp]))
        return
    dst, upd = _as_stored(kv_cache, torch.cat([k_new.reshape(N, hd), v_new.reshape(N, hd)]))
    dst.view(L * nb * 2 * bs, hd).index_copy_(0, rows, upd)


def _fill_striped(kv: StripedKV, k_new: torch.Tensor, v_new: torch.Tensor,
                  slot_mapping: torch.Tensor, layer: int,
                  page_tables: Optional[torch.Tensor]) -> None:
    """``fill_kv_cache`` into a cache striped over 'cp': the same rows as the unsharded
    fill, each token in its rank's stripe at its local slot.  A fresh prefill of whole
    pages writes each rank's slice of the pages at once; the row scatter sends a token
    to every stripe, at its block in its own rank's and at block 0 (the padding block,
    don't-care) in the others', so no step depends on the data's shape."""
    L, nb, _, bs, hd = kv.shape
    cp = kv.cp
    bsl = bs // cp
    N = k_new.shape[0]
    if page_tables is not None:
        B = page_tables.shape[0]
        T = N // B
        if T % bs == 0 and page_tables.shape[1] >= T // bs:
            n_pages = T // bs
            upd = torch.stack([k_new.reshape(B, n_pages, cp, bsl, hd),
                               v_new.reshape(B, n_pages, cp, bsl, hd)], dim=2)
            idx = page_tables[:, :n_pages].reshape(-1).long().clamp(0, nb - 1)
            for r, stripe in enumerate(kv.stripes):
                part = upd[:, :, :, r].reshape(B * n_pages, 2, bsl, hd)
                stripe[layer].index_copy_(0, idx.to(stripe.device),
                                          part.to(stripe.device, stripe.dtype))
            return
    slots = slot_mapping.long()
    block = slots // bs
    off = slots % bs
    block = torch.where((block >= 0) & (block < nb), block, torch.zeros_like(block))
    rank, local = off // bsl, off % bsl
    upd = torch.cat([k_new.reshape(N, hd), v_new.reshape(N, hd)])
    for r, stripe in enumerate(kv.stripes):
        k_idx = ((layer * nb + torch.where(rank == r, block, torch.zeros_like(block)))
                 * 2) * bsl + local
        rows = torch.cat([k_idx, k_idx + bsl]).to(stripe.device)
        stripe.view(-1, hd).index_copy_(0, rows, upd.to(stripe.device, stripe.dtype))


def _fill_turbo(kv: QuantKVTurbo, k_new: torch.Tensor, v_new: torch.Tensor,
                rows: torch.Tensor):
    """TurboQuant k4v2 rows at token row indices ``rows`` of the ``[L*NB*BS, ...]``
    views: K and V rotated per head, then coded (the reference's ``_fill_turbo``)."""
    N = k_new.shape[0]
    kc, mse, qjl = quantize_rows_turbo_k(hadamard_rotate(k_new))     # [N, Hkv, D]
    vc, vnorm = quantize_rows_turbo_v(hadamard_rotate(v_new))
    codes = torch.cat([pack_nibbles(kc).reshape(N, -1), pack_2bit(vc).reshape(N, -1)], 1)
    kv.data.view(-1, kv.data.shape[-1]).index_copy_(0, rows, codes)
    kv.meta.view(-1, *kv.meta.shape[-2:]).index_copy_(0, rows,
                                                      torch.stack([mse, qjl, vnorm], 1))


def gather_layer_kv(kv_cache, layer: int, block_tables: torch.Tensor,
                    num_kv_heads: int, head_dim: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's pages for the chunk's rows as (k, v) [Hkv, B, W*BS, D]; a quantized
    cache comes back dequantized in f32 (a TurboQuant one in the rotated domain), a
    plain or fp8 one in its own type."""
    B, W = block_tables.shape
    Hkv, D = num_kv_heads, head_dim
    NB = kv_cache.shape[1]
    tables = block_tables.long().clamp(0, NB - 1)
    if isinstance(kv_cache, StripedKV):
        # the ranks' slots of each page joined in rank order: [B, W, 2, BS, row]
        dev = block_tables.device
        g = torch.cat([s[layer][tables.to(s.device)].to(dev) for s in kv_cache.stripes],
                      dim=3)
    else:
        data = kv_cache.data if isinstance(kv_cache, QUANT_CACHES) else kv_cache
        g = data[layer][tables]                 # [B, W, 2, BS, row] or turbo [B, W, BS, row]
    if isinstance(kv_cache, QuantKVTurbo):
        bs, hd = g.shape[2], Hkv * D
        meta = kv_cache.meta[layer][tables]                       # [B, W, BS, 3, Hkv]
        kc = unpack_nibbles(g[..., :hd // 2]).reshape(B, W, bs, Hkv, D)
        vc = unpack_2bit(g[..., hd // 2:]).reshape(B, W, bs, Hkv, D)
        g = torch.stack([dequantize_turbo_k(kc, meta[..., 0, :], meta[..., 1, :]),
                         dequantize_turbo_v(vc, meta[..., 2, :])], dim=2)
    elif isinstance(kv_cache, QuantKV):
        sc = kv_cache.scale[layer][tables]                        # [B, W, 2, BS, Hkv]
        g = g.float().reshape(*g.shape[:4], Hkv, D) * sc[..., None]
    elif isinstance(kv_cache, QuantKV4):
        sc = kv_cache.scale[layer][tables]
        mn = kv_cache.minv[layer][tables]
        g = (unpack_nibbles(g).float().reshape(*g.shape[:4], Hkv, D) * sc[..., None]
             + mn[..., None])
    bs = g.shape[3]

    def to_heads(x):
        x = x.reshape(B, W, bs, Hkv, D)
        return x.permute(3, 0, 1, 2, 4).reshape(Hkv, B, W * bs, D)
    return to_heads(g[:, :, 0]), to_heads(g[:, :, 1])


def attention_dense_gathered(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             history_lens: torch.Tensor, scale: float,
                             logit_softcap: Optional[float] = None,
                             window_size: Optional[int] = None,
                             sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over already-gathered KV [Hkv, B, S, D]; q [B, T, Hq, D].

    Causal by absolute position (history + t), an optional sliding window
    (keys with pos_k > pos_q - window), logit softcap tanh(s/c)*c after the
    scale, and learned sink logits that join the softmax denominator only.

    Queries are taken in tiles that keep the f32 score tensor under
    ``SCORE_TILE_BYTES`` (each query row's softmax is its own, so tiling changes no
    result): a long prefill chunk with sinks or a window takes this path on the card
    (gpt-oss), where one [B, Hq, T, S] tensor would not fit."""
    B, T, Hq, D = q.shape
    Hkv, _, S, _ = k.shape
    tile = max(1, SCORE_TILE_BYTES // (B * Hq * S * 4))
    if T > tile:
        return torch.cat([attention_dense_gathered(q[:, t:t + tile], k, v,
                                                   history_lens + t, scale,
                                                   logit_softcap, window_size, sinks)
                          for t in range(0, T, tile)], dim=1)
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum('bthgd,hbsd->bhgts', qg, k.float()) * scale   # [B,Hkv,G,T,S]
    if logit_softcap is not None and logit_softcap > 0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    pos_q = history_lens.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = pos_k[:, None, :] <= pos_q[:, :, None]                     # [B,T,S]
    if window_size is not None and window_size > 0:
        mask &= pos_k[:, None, :] > (pos_q[:, :, None] - window_size)
    scores = scores.masked_fill(~mask[:, None, None], float('-inf'))
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, G)[None, :, :, None]
        m = torch.maximum(scores.amax(-1), sk)                        # [B,Hkv,G,T]
        e = torch.exp(scores - m[..., None])
        probs = e / (e.sum(-1) + torch.exp(sk - m))[..., None]
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum('bhgts,hbsd->bthgd', probs, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def paged_attention(q: torch.Tensor, kv_cache, block_tables: torch.Tensor,
                    history_lens: torch.Tensor, q_lens: torch.Tensor, scale: float,
                    layer: int, num_kv_heads: int,
                    logit_softcap: Optional[float] = None,
                    window_size: Optional[int] = None,
                    chunk_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    fresh_prefill: bool = False,
                    sinks: Optional[torch.Tensor] = None,
                    cp_mesh=None) -> torch.Tensor:
    """Chunk queries q [B, T, Hq, D] against the (already filled) paged cache.

    ``chunk_kv`` = the chunk's own (k, v) [B, T, Hkv, D], used by fresh prefill.
    ``cp_mesh``: the mesh whose 'cp' ranks hold the stripes of a ``StripedKV`` cache
    (reference :562-598): a decode step runs each rank's partials and combines them; a
    fresh prefill chunk still takes flash_prefill on its own K/V (it reads no cache, so
    it gives what the reference's gather path gives), any other chunk the gathered
    path over the stripes."""
    T, D = q.shape[1], q.shape[3]
    if cp_mesh is not None:
        if not isinstance(kv_cache, StripedKV):
            raise NotImplementedError('context-parallel attention reads a plain cache '
                                      'striped over the ranks (engine/cache_engine.py)')
        if T == 1:
            return paged_decode_attention_cp(
                q[:, 0].contiguous(), kv_cache, block_tables, (history_lens + 1).int(),
                layer, scale, num_kv_heads, cp_mesh, logit_softcap=logit_softcap,
                window=window_size, sinks=sinks)[:, None]
    decode = q.is_cuda and T == 1 and decode_route(kv_cache, window_size, sinks) == 'kernel'
    if (not decode and q.is_cuda and fresh_prefill and chunk_kv is not None
            and logit_softcap is None and window_size is None and sinks is None):
        return flash_prefill_attention(q, chunk_kv[0], chunk_kv[1], scale)
    turbo = isinstance(kv_cache, QuantKVTurbo)
    if turbo:
        q_in = q
        q = hadamard_rotate(q).to(q.dtype)       # into the cache's rotated domain
    if decode:
        out = paged_decode_attention(
            q[:, 0].contiguous(), kv_cache, block_tables,
            (history_lens + 1).int(),        # kv length includes the token just filled
            layer, scale, num_kv_heads, logit_softcap=logit_softcap,
            window=window_size, sinks=sinks)[:, None]
    else:
        k, v = gather_layer_kv(kv_cache, layer, block_tables, num_kv_heads, D)
        out = attention_dense_gathered(q, k, v, history_lens, scale,
                                       logit_softcap, window_size, sinks)
    return hadamard_rotate_inv(out).to(q_in.dtype) if turbo else out
