"""Paged attention over a block-table KV cache: cache layout, fill, gather, dispatch.

Port of the plain-cache parts of ``lmdeploy_tpu/ops/attention.py``.

The cache is ONE tensor ``[L, num_blocks, 2, block_size, Hkv*D]``: each page holds a K
plane and a V plane of head-major token rows, as in the reference but without its
128-lane padding (``kv_row_width``); ``weight_convert.cache_from_reference`` /
``cache_to_reference`` convert between the two without loss.  Block 0 is the reserved
padding block: padded rows and padded tokens write there and read from there, so no
index ever leaves the cache.  Writes are in place (``index_copy_``); there is no
buffer donation to lean on, so nothing here returns a new cache.

``paged_attention`` picks the path from the tensor's device:
  * CUDA, T == 1 (decode)                    -> ``ops/paged_decode.py`` kernel
  * CUDA, fresh prefill, no softcap/window   -> ``ops/flash_prefill.py`` kernel
  * everything else (chunked continuation, prefix hits, CPU) -> gather + dense torch,
    as the reference does in XLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_prefill import flash_prefill_attention
from .paged_decode import paged_decode_attention


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


def fill_kv_cache(kv_cache: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  slot_mapping: torch.Tensor, layer: int,
                  page_tables: Optional[torch.Tensor] = None) -> None:
    """Write new K/V rows into layer ``layer`` of the cache, in place.

    k_new/v_new: [N, Hkv, D]; slot_mapping: [N] flat slots (block * BS + offset).
    ``page_tables`` [B, W] is passed only for fresh prefill (history 0, contiguous
    positions): whole [2, BS, HD] pages are then written at once, as the reference's
    page-granular path does.  Rows shorter than T write garbage into their last
    partial page beyond q_len (masked by length, overwritten later) and into block 0.
    """
    L, nb, _, bs, hd = kv_cache.shape
    N = k_new.shape[0]
    if page_tables is not None:
        B = page_tables.shape[0]
        T = N // B
        if T % bs == 0 and page_tables.shape[1] >= T // bs:
            n_pages = T // bs
            rows_k = k_new.reshape(B, n_pages, bs, hd)
            rows_v = v_new.reshape(B, n_pages, bs, hd)
            upd = torch.stack([rows_k, rows_v], dim=2).reshape(B * n_pages, 2, bs, hd)
            idx = page_tables[:, :n_pages].reshape(-1).long().clamp(0, nb - 1)
            kv_cache[layer].index_copy_(0, idx, upd.to(kv_cache.dtype))
            return
    # row scatter; the reference drops out-of-range slots (mode='drop'): here
    # they are sent to the padding block, whose contents are don't-care
    slots = slot_mapping.long()
    block = slots // bs
    off = slots % bs
    block = torch.where((block >= 0) & (block < nb), block, torch.zeros_like(block))
    k_idx = ((layer * nb + block) * 2) * bs + off
    flat = kv_cache.view(L * nb * 2 * bs, hd)
    flat.index_copy_(0, torch.cat([k_idx, k_idx + bs]),
                     torch.cat([k_new.reshape(N, hd), v_new.reshape(N, hd)]
                               ).to(kv_cache.dtype))


def gather_layer_kv(kv_cache: torch.Tensor, layer: int, block_tables: torch.Tensor,
                    num_kv_heads: int, head_dim: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's pages for the chunk's rows as (k, v) [Hkv, B, W*BS, D]."""
    B, W = block_tables.shape
    pages = kv_cache[layer]
    NB, _, bs, _ = pages.shape
    g = pages[block_tables.long().clamp(0, NB - 1)]               # [B, W, 2, BS, HD]

    def to_heads(x):
        x = x.reshape(B, W, bs, num_kv_heads, head_dim)
        return x.permute(3, 0, 1, 2, 4).reshape(num_kv_heads, B, W * bs, head_dim)
    return to_heads(g[:, :, 0]), to_heads(g[:, :, 1])


def attention_dense_gathered(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             history_lens: torch.Tensor, scale: float,
                             logit_softcap: Optional[float] = None,
                             window_size: Optional[int] = None,
                             sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over already-gathered KV [Hkv, B, S, D]; q [B, T, Hq, D].

    Causal by absolute position (history + t), an optional sliding window
    (keys with pos_k > pos_q - window), logit softcap tanh(s/c)*c after the
    scale, and learned sink logits that join the softmax denominator only."""
    B, T, Hq, D = q.shape
    Hkv, _, S, _ = k.shape
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


def paged_attention(q: torch.Tensor, kv_cache: torch.Tensor, block_tables: torch.Tensor,
                    history_lens: torch.Tensor, q_lens: torch.Tensor, scale: float,
                    layer: int, num_kv_heads: int,
                    logit_softcap: Optional[float] = None,
                    window_size: Optional[int] = None,
                    chunk_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    fresh_prefill: bool = False,
                    sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunk queries q [B, T, Hq, D] against the (already filled) paged cache.

    ``chunk_kv`` = the chunk's own (k, v) [B, T, Hkv, D], used by fresh prefill."""
    T, D = q.shape[1], q.shape[3]
    if q.is_cuda and T == 1:
        out = paged_decode_attention(
            q[:, 0].contiguous(), kv_cache, block_tables,
            (history_lens + 1).int(),        # kv length includes the token just filled
            layer, scale, num_kv_heads, logit_softcap=logit_softcap,
            window=window_size, sinks=sinks)
        return out[:, None]
    if (q.is_cuda and fresh_prefill and chunk_kv is not None and logit_softcap is None
            and window_size is None and sinks is None):
        return flash_prefill_attention(q, chunk_kv[0], chunk_kv[1], scale)
    k, v = gather_layer_kv(kv_cache, layer, block_tables, num_kv_heads, D)
    return attention_dense_gathered(q, k, v, history_lens, scale,
                                    logit_softcap, window_size, sinks)
