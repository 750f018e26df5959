// T = 1 attention over a paged KV cache in the model's dtype or fp8-e4m3, for Hopper
// (sm_90a).
//
// Replaces the plain branch of the TPU kernel lmdeploy_tpu/ops/pallas/paged_decode.py
// (paged_decode_attention, body _decode_kernel), which serves pages in the model's
// dtype and, with quant_policy 16, fp8-e4m3 pages.  Same function, same edge cases:
//   * kv_lens[b] counts the token just filled; 0 marks an inactive row, whose
//     output is 0 (never NaN);
//   * a sliding window keeps positions pos >= max(len - window, 0) when window > 0;
//   * the logit softcap is tanh(s / c) * c, applied after the scale;
//   * sink logits add exp(sink - m) to the softmax denominator only while the
//     row max m is above 0.5 * MASK_VALUE;
//   * MASK_VALUE = -0.7 * FLT_MAX for masked scores, not -inf.
//
// Cache layout: [L, NB, 2, BS, Hkv * D] -- each page holds a K plane and a V plane of
// head-major token rows (the reference layout without its 128-lane padding).  Block 0
// is the padding block; tables [B, W] i32 map a row's page index to its block.  The
// query / output type (bf16, f16, f32) and the page element type (the same, or e4m3)
// are template parameters.  D is any of {64, 80, 96, 128, 192, 256, 576} (MLA's latent
// 576: one kv head whose V rows are the latent followed by 64 zeros; the kernels
// compute all 576 output columns).
//
// What bounds it on an H100: bytes of K/V read.  At bs 64 with ~384 tokens a row,
// TinyLlama's bf16 K+V is 1 KiB per token per layer, 25 MB per layer: ~7.5 us at
// 3.35 TB/s, against ~0.1 MFLOP of arithmetic per row and head.  MLA's cache is 2,304
// bytes a token and layer (2 planes x 576 x bf16), whatever the head count; its 16
// (V2-Lite) or 128 (V3) query heads over that one latent head make ~16-128 FLOP a
// byte, so on CUDA cores the arithmetic, not the bytes, would set its time.
//
// Design.  The query heads of a GQA group share every K/V byte a block loads.
//   * Narrow, tensor cores (bf16 / f16 q, D = 64 or 128, pages of 2-byte or e4m3
//     elements, any block size): narrow_decode.cuh's body, which the int8 decode and the
//     context-parallel partials share.  A block of 4 warps takes up to 8 query heads of
//     a kv head and one split of the row's pages, streamed through per-warp 3-stage
//     cp.async rings of 64-token sub-chunks with no block barrier in the loop; S = Q K^T
//     and O^T += V^T P^T on mma.sync m16n8k16, each K element read once for the group,
//     P as hi + lo in V's operand type.  2-byte pages go to the tensor cores as they
//     are; e4m3 elements are decoded into 16-bit operands exactly, NaN code included
//     (V to bf16).
//   * Narrow, CUDA cores (f32 q over e4m3 pages, D = 80 / 96): one block of 128
//     threads per (kv head, batch row, split) walks the split's pages.  Per page: the head's [BS, D] slice of the K plane and of the
//     V plane goes to shared memory with 16-byte coalesced loads; scores with one
//     thread per token, its K row held in registers as raw words, against the f32 query
//     rows; online softmax per query head in f32 (warp reductions over the page); P.V
//     with one thread per (head, column) and the accumulator in shared memory.  Every
//     element widens to f32, P stays f32.
//   * Both narrow bodies split each row's pages over blocks (the wrapper's split, a
//     function of W, BS, B and the window alone: no read of the lengths; one split
//     where a window's pages fit in one): a block whose split holds no position in the
//     window writes nothing, the others their unnormalized (acc, m, l), and a second
//     kernel (decode_split_combine_rows) joins a row's non-empty splits in a fixed
//     order, then applies the sinks and the l == 0 guard.  One split writes the output
//     itself.
//   * Tensor-core wide (D = 192, 256, 576 over 2-byte pages, the MLA decode): a block
//     of 4 warps takes up to 16 query heads of a kv head -- one m16 tile, exactly
//     DeepSeek-V2-Lite's 16 heads over its latent head; a larger group (V3's 128) is
//     split over head blocks, the fastest-varying grid index, so the blocks that read
//     one page run side by side and share it through L2.  Q sits in shared memory in
//     its own type once.  The row's pages stream through a 2-stage ring of sub-chunks
//     (TC = 32 tokens at D = 576, a 37 KB slice of each plane; 64 below) with 16-byte
//     cp.async copies: sub-chunk i + 1's copies are in flight while sub-chunk i is
//     computed.  S = Q K^T on mma.sync m16n8k16 over all of D, each warp taking a
//     quarter of the sub-chunk's keys; the row max and row sum are combined across the
//     warps in a fixed order; P goes to P.V as hi + lo in the page type (two products,
//     as the narrow body's), more precise than the Pallas kernel's one rounding
//     (pr.astype(v.dtype)): rounded once, Gemma-2-9B's decode (softcap 50) read 2.1-2.6x
//     the tolerance against the f32-P plain version at score spreads of std 8-40 (2.4x
//     at 23, the spread its parity row's prefill scores have), hi + lo 0.64-0.70x, for
//     1-2% more time (chip_steps.py p_once; H100 80GB HBM3, 700 W); at MLA's 576 one
//     rounding read 1.27x over a DeepSeek-V3 MTP head's cache (rows of 257-352 tokens,
//     128 heads: softmax weights larger than at V3's 1,100-token rows); for O += P V
//     each warp owns a quarter of D's columns with its f32 accumulator in registers (V
//     fragments from ldmatrix.trans).
//   * Wide (f32 pages at any D, e4m3 pages at D > 128; D a runtime value): a block of
//     512 threads takes a group of up to 16 query heads and walks its pages in
//     sub-chunks of TC tokens (128 up to D = 128, 64 up to 256, 32 at 576).  Each
//     thread scores one token for NT / TC of the heads, walking the token's K row once,
//     16 bytes at a time, with one f32 accumulator per head; P stays f32.
//   * Both wide kernels split the row's pages over blocks too, SPLIT pages each (a
//     4,096-token row would otherwise walk serially while the short rows' blocks idle):
//     each block writes its unnormalized (acc, m, l) and a second kernel combines the
//     splits in a fixed order (m = max m_s, l = sum l_s e^(m_s - m), acc likewise),
//     then applies the sinks and the l == 0 guard.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "attn_types.cuh"
#include "decode_split.cuh"
#include "narrow_decode.cuh"
#include "quant_decode.cuh"

namespace {

using attn::finish;
using attn::fp8_t;
using attn::MASK_VALUE;

constexpr int NT = 128;           // narrow kernel threads
constexpr int NTW = 512;          // wide kernel threads
constexpr int GB = 16;            // query heads per wide block at most

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------ CUDA-core narrow kernel
// elements 2j, 2j+1 of a row held as 32-bit words, widened to f32 (a bf16 is the
// high half of its f32)
__device__ __forceinline__ float2 pair_f2(const uint32_t* w, int j, __nv_bfloat16) {
  return make_float2(__uint_as_float(w[j] << 16), __uint_as_float(w[j] & 0xFFFF0000u));
}

__device__ __forceinline__ float2 pair_f2(const uint32_t* w, int j, __half) {
  const uint32_t x = w[j];
  return __half22float2(*reinterpret_cast<const __half2*>(&x));
}

__device__ __forceinline__ float2 pair_f2(const uint32_t* w, int j, fp8_t) {
  const __nv_fp8x2_storage_t x2 = static_cast<__nv_fp8x2_storage_t>(w[j >> 1] >> ((j & 1) * 16));
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(x2, __NV_E4M3)));
}

__host__ __device__ inline int narrow_words(int G, int D, int BS) {
  // qs [G][D] + os [G][D] + ps [G][BS] + m, l, alpha [G], rounded to 16 bytes
  return (2 * G * D + G * BS + 3 * G + 3) & ~3;
}

template <typename TK, int D>
size_t narrow_smem(int G, int BS) {
  return (size_t)narrow_words(G, D, BS) * sizeof(float)
       + (size_t)BS * (D + attn::epc<TK>()) * sizeof(TK)   // K slice, padded rows
       + (size_t)BS * D * sizeof(TK);                      // V slice
}

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(NT)
paged_decode_narrow_simt(const TQ* __restrict__ q,            // [B, Hq, D]
                         const TK* __restrict__ cache,        // [L, NB, 2, BS, Hkv*D]
                         const int* __restrict__ tables,      // [B, W]
                         const int* __restrict__ kv_lens,     // [B]
                         const float* __restrict__ sinks,     // [Hq] or null
                         TQ* __restrict__ out,                // [B, Hq, D]
                         float* __restrict__ part,            // [B, S, Hq, D + 2] or null
                         int Hq, int Hkv, int NB, int BS, int W, int layer,
                         float scale, float softcap, int window, int split_pages) {
  constexpr int EPC = attn::epc<TK>();   // elements per 16-byte chunk
  constexpr int KSTR = D + EPC;   // 16-byte padded K rows: conflict-free row reads
  constexpr int CH = D / EPC;     // 16-byte chunks per head row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int G = Hq / Hkv;
  const int HD = Hkv * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the split's pages in the window: [p_lo, p_hi)
  const int len = kv_lens[b];
  const int ws = window > 0 ? max(len - window, 0) : 0;
  const int p_lo = max(ws / BS, sp * split_pages);
  const int p_hi = min(min((len + BS - 1) / BS, W), (sp + 1) * split_pages);
  if (S > 1 && (len <= 0 || p_lo >= p_hi)) return;   // an empty split writes nothing

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [G][D]
  float* os = qs + G * D;           // [G][D]
  float* ps = os + G * D;           // [G][BS]
  float* ms = ps + G * BS;          // [G]
  float* ls = ms + G;               // [G]
  float* as = ls + G;               // [G]
  TK* ks = reinterpret_cast<TK*>(smem + narrow_words(G, D, BS));
  TK* vs = ks + BS * KSTR;

  const TQ* qrow = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    qs[i] = attn::to_f(qrow[i]);
    os[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    ms[g] = MASK_VALUE;
    ls[g] = 0.f;
  }
  __syncthreads();

  if (len > 0) {
    const long long plane = (long long)BS * HD;
    for (int p = p_lo; p < p_hi; ++p) {
      const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
      const TK* kpage = cache + ((long long)layer * NB + blk) * 2 * plane + (long long)h * D;
      const TK* vpage = kpage + plane;
      for (int i = tid; i < BS * CH; i += NT) {
        const int t = i / CH;
        const int c = i - t * CH;
        const uint4 kx = *reinterpret_cast<const uint4*>(kpage + (long long)t * HD + c * EPC);
        const uint4 vx = *reinterpret_cast<const uint4*>(vpage + (long long)t * HD + c * EPC);
        *reinterpret_cast<uint4*>(ks + t * KSTR + c * EPC) = kx;
        *reinterpret_cast<uint4*>(vs + t * D + c * EPC) = vx;
      }
      __syncthreads();

      for (int t = tid; t < BS; t += NT) {
        const int pos = p * BS + t;
        const bool valid = pos < len && pos >= ws;
        uint32_t kr[CH * 4];          // the token's K row as raw 32-bit words
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * KSTR + c * EPC);
          kr[c * 4 + 0] = raw.x;
          kr[c * 4 + 1] = raw.y;
          kr[c * 4 + 2] = raw.z;
          kr[c * 4 + 3] = raw.w;
        }
        for (int g = 0; g < G; ++g) {
          const float* qg = qs + g * D;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + d);
            const float2 ka = pair_f2(kr, d / 2, TK());
            const float2 kb = pair_f2(kr, d / 2 + 1, TK());
            acc = fmaf(qv.x, ka.x, fmaf(qv.y, ka.y, fmaf(qv.z, kb.x, fmaf(qv.w, kb.y, acc))));
          }
          float s = acc * scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          ps[g * BS + t] = valid ? s : MASK_VALUE;
        }
      }
      __syncthreads();

      for (int g = warp; g < G; g += NT / 32) {
        float* prow = ps + g * BS;
        float mx = MASK_VALUE;
        for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, prow[t]);
        mx = warp_max(mx);
        const float m_old = ms[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < BS; t += 32) {
          const float e = expf(prow[t] - m_new);
          prow[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          as[g] = alpha;
          ls[g] = ls[g] * alpha + sum;
          ms[g] = m_new;
        }
      }
      __syncthreads();

      for (int i = tid; i < G * D; i += NT) {
        const int g = i / D;
        const int d = i - g * D;
        const float* prow = ps + g * BS;
        float acc = os[i] * as[g];
        for (int t = 0; t < BS; ++t) acc = fmaf(prow[t], attn::to_f(vs[t * D + d]), acc);
        os[i] = acc;
      }
      __syncthreads();
    }
  }

  if (S == 1) {
    TQ* orow = out + ((long long)b * Hq + (long long)h * G) * D;
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      orow[i] = attn::from_f<TQ>(finish(os[i], ms[g], ls[g], sinks, h * G + g));
    }
    return;
  }
  // this split's unnormalized (acc, m, l) for the combine
  for (int i = tid; i < G * (D + 2); i += NT) {
    const int g = i / (D + 2);
    const int d = i - g * (D + 2);
    const float v = d < D ? os[g * D + d] : (d == D ? ms[g] : ls[g]);
    part[(((long long)b * S + sp) * Hq + h * G + g) * (D + 2) + d] = v;
  }
}

// ------------------------------------------------------ tensor-core narrow kernel
// narrow_decode.cuh's body over 2-byte pages in q's type or e4m3 pages
template <typename T, typename TK>
using NarrowPages =
    typename std::conditional<sizeof(TK) == 2, ndec::Pages16<T>, ndec::PagesE4m3>::type;

template <typename T, typename TK, int D, bool ONE_PAGE>
__global__ void __launch_bounds__(qdec::NT, qdec::min_blocks<D>())
paged_decode_narrow(const ndec::Args a) {
  ndec::narrow_body<T, NarrowPages<T, TK>, D, ONE_PAGE, false>(a);
}

// ------------------------------------------------------------------------ wide kernel
__host__ __device__ inline int wide_words(int gb, int D, int TC) {
  // qs [gb][D] + os [gb][D] + ps [gb][TC] + m, l, alpha [gb], rounded to 16 bytes
  return (2 * gb * D + gb * TC + 3 * gb + 3) & ~3;
}

template <typename TK, int TC>
size_t wide_smem(int gb, int D) {
  return (size_t)wide_words(gb, D, TC) * sizeof(float)
       + (size_t)TC * (D + attn::epc<TK>()) * sizeof(TK)   // K slice, padded rows
       + (size_t)TC * D * sizeof(TK);                      // V slice
}

template <typename TQ, typename TK, int TC>
__global__ void __launch_bounds__(NTW)
paged_decode_wide(const TQ* __restrict__ q,                 // [B, Hq, D]
                  const TK* __restrict__ cache,             // [L, NB, 2, BS, Hkv*D]
                  const int* __restrict__ tables,           // [B, W]
                  const int* __restrict__ kv_lens,          // [B]
                  const float* __restrict__ sinks,          // [Hq] or null
                  TQ* __restrict__ out,                     // [B, Hq, D]
                  float* __restrict__ part,                 // [B, S, Hq, D + 2] or null
                  int Hq, int Hkv, int D, int NB, int BS, int W, int layer,
                  float scale, float softcap, int window, int split_pages) {
  constexpr int EPC = attn::epc<TK>();   // elements per 16-byte chunk
  constexpr int HP = NTW / TC;           // head parts: threads per token
  constexpr int ACC = (GB + HP - 1) / HP;
  const int KSTR = D + EPC;       // 16-byte padded K rows: conflict-free row reads
  const int CH = D / EPC;         // 16-byte chunks per head row
  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const int h = blockIdx.x / hsplits;
  const int g0 = (blockIdx.x - h * hsplits) * GB;
  const int gb = min(GB, G - g0);
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int HD = Hkv * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [gb][D]
  float* os = qs + gb * D;          // [gb][D]
  float* ps = os + gb * D;          // [gb][TC]
  float* ms = ps + gb * TC;         // [gb]
  float* ls = ms + gb;              // [gb]
  float* as = ls + gb;              // [gb]
  TK* ks = reinterpret_cast<TK*>(smem + wide_words(gb, D, TC));
  TK* vs = ks + TC * KSTR;

  const long long head0 = (long long)b * Hq + (long long)h * G + g0;
  const TQ* qrow = q + head0 * D;
  for (int i = tid; i < gb * D; i += NTW) {
    qs[i] = attn::to_f(qrow[i]);
    os[i] = 0.f;
  }
  for (int g = tid; g < gb; g += NTW) {
    ms[g] = MASK_VALUE;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int len = kv_lens[b];
  if (len > 0) {
    const int ws = window > 0 ? max(len - window, 0) : 0;
    const int p_lo = max(ws / BS, sp * split_pages);
    const int p_hi = min(min((len + BS - 1) / BS, W), (sp + 1) * split_pages);
    const long long plane = (long long)BS * HD;
    const int tt = tid % TC;          // this thread's token in the sub-chunk
    const int hp = tid / TC;          // and its heads hp, hp + HP, ...
    for (int p = p_lo; p < p_hi; ++p) {
      const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
      const TK* kpage = cache + ((long long)layer * NB + blk) * 2 * plane + (long long)h * D;
      const TK* vpage = kpage + plane;
      for (int t0 = 0; t0 < BS; t0 += TC) {
        const int c0 = p * BS + t0;                 // the sub-chunk's first position
        if (c0 >= len) break;
        if (c0 + TC <= ws) continue;
        const int nt = min(TC, BS - t0);
        for (int i = tid; i < nt * CH; i += NTW) {
          const int t = i / CH;
          const int c = i - t * CH;
          const long long off = (long long)(t0 + t) * HD + c * EPC;
          *reinterpret_cast<uint4*>(ks + t * KSTR + c * EPC) =
              *reinterpret_cast<const uint4*>(kpage + off);
          *reinterpret_cast<uint4*>(vs + t * D + c * EPC) =
              *reinterpret_cast<const uint4*>(vpage + off);
        }
        __syncthreads();

        {
          const int pos = c0 + tt;
          const bool valid = tt < nt && pos < len && pos >= ws;
          float acc[ACC];
#pragma unroll
          for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
          if (tt < nt) {
            const TK* kr = ks + tt * KSTR;
            for (int c = 0; c < CH; ++c) {
              float kf[EPC];
              attn::widen16<TK>(*reinterpret_cast<const uint4*>(kr + c * EPC), kf);
#pragma unroll
              for (int j = 0; j < ACC; ++j) {
                const int g = hp + HP * j;
                if (g < gb) {
                  const float* qg = qs + g * D + c * EPC;
                  float a = acc[j];
#pragma unroll
                  for (int e = 0; e < EPC; e += 4) {
                    const float4 qv = *reinterpret_cast<const float4*>(qg + e);
                    a = fmaf(qv.x, kf[e], fmaf(qv.y, kf[e + 1],
                             fmaf(qv.z, kf[e + 2], fmaf(qv.w, kf[e + 3], a))));
                  }
                  acc[j] = a;
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < ACC; ++j) {
            const int g = hp + HP * j;
            if (g < gb) {
              float s = acc[j] * scale;
              if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
              ps[g * TC + tt] = valid ? s : MASK_VALUE;
            }
          }
        }
        __syncthreads();

        for (int g = warp; g < gb; g += NTW / 32) {
          float* prow = ps + g * TC;
          float mx = MASK_VALUE;
          for (int t = lane; t < TC; t += 32) mx = fmaxf(mx, prow[t]);
          mx = warp_max(mx);
          const float m_old = ms[g];
          const float m_new = fmaxf(m_old, mx);
          float sum = 0.f;
          for (int t = lane; t < TC; t += 32) {
            const float e = t < nt ? expf(prow[t] - m_new) : 0.f;
            prow[t] = e;
            sum += e;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            const float alpha = expf(m_old - m_new);
            as[g] = alpha;
            ls[g] = ls[g] * alpha + sum;
            ms[g] = m_new;
          }
        }
        __syncthreads();

        for (int i = tid; i < gb * D; i += NTW) {
          const int g = i / D;
          const int d = i - g * D;
          const float* prow = ps + g * TC;
          float acc = os[i] * as[g];
          for (int t = 0; t < nt; ++t) acc = fmaf(prow[t], attn::to_f(vs[t * D + d]), acc);
          os[i] = acc;
        }
        __syncthreads();
      }
    }
  }

  if (S == 1) {
    TQ* orow = out + head0 * D;
    for (int i = tid; i < gb * D; i += NTW) {
      const int g = i / D;
      orow[i] = attn::from_f<TQ>(finish(os[i], ms[g], ls[g], sinks, h * G + g0 + g));
    }
    return;
  }
  // this split's unnormalized (acc, m, l) for the combine
  for (int i = tid; i < gb * (D + 2); i += NTW) {
    const int g = i / (D + 2);
    const int d = i - g * (D + 2);
    const float v = d < D ? os[g * D + d] : (d == D ? ms[g] : ls[g]);
    part[(((long long)b * S + sp) * Hq + h * G + g0 + g) * (D + 2) + d] = v;
  }
}

// ------------------------------------------------------- tensor-core wide kernel
constexpr int NTM = 128;          // 4 warps
constexpr int MST = 2;            // sub-chunk ring stages

// P as hi + lo at every D (chip_steps.py's p_once step plants the one rounding here)
template <int D>
__host__ __device__ constexpr bool mma_p_hi_lo() { return true; }

template <int D, int TC>
__host__ __device__ constexpr int mma_smem() {
  // Q [GB][D + 8], the ring [MST][K, V][TC][D + 8], P (and its lo parts) [GB][TC + 8]
  // (2-byte elements), then the per-warp row maxima and sums [2][4][GB] f32
  return (GB * (D + 8) + MST * 2 * TC * (D + 8) + (mma_p_hi_lo<D>() ? 2 : 1) * GB * (TC + 8))
             * 2 + 2 * 4 * GB * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 16 : 0) : "memory");   // 0: zero-fill
}

template <typename T, int D, int TC>
__global__ void __launch_bounds__(NTM)
paged_decode_mma(const T* __restrict__ q,                 // [B, Hq, D]
                 const T* __restrict__ cache,             // [L, NB, 2, BS, Hkv*D]
                 const int* __restrict__ tables,          // [B, W]
                 const int* __restrict__ kv_lens,         // [B]
                 const float* __restrict__ sinks,         // [Hq] or null
                 T* __restrict__ out,                     // [B, Hq, D]
                 float* __restrict__ part,                // [B, S, Hq, D + 2] or null
                 int Hq, int Hkv, int NB, int BS, int W, int layer,
                 float scale, float softcap, int window, int split_pages) {
  constexpr int ST = D + 8;            // padded Q / K / V row (elements): conflict-free
  constexpr int PST = TC + 8;          // padded P row
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int KC = D / 16;           // k16 steps over D for S = Q K^T
  constexpr int NTW = TC / 32;         // n8 key tiles per warp for S
  constexpr int DW = D / 4;            // output columns per warp
  constexpr int DT = DW / 8;           // n8 tiles over them
  constexpr bool HILO = mma_p_hi_lo<D>();
  static_assert(DT % 2 == 0 && TC % 32 == 0, "two n8 tiles per ldmatrix.x4");
  extern __shared__ __align__(16) uint8_t mma_raw[];
  T* Qs = reinterpret_cast<T*>(mma_raw);         // [GB][ST]
  T* ring = Qs + GB * ST;                         // [MST][2][TC][ST]
  T* Ps = ring + MST * 2 * TC * ST;               // [GB][PST]
  T* Pl = Ps + GB * PST;                          // [GB][PST] with HILO
  float* rmax = reinterpret_cast<float*>(Pl + (HILO ? GB * PST : 0));   // [4][GB]
  float* rsum = rmax + 4 * GB;                              // [4][GB]

  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const int h = blockIdx.x / hsplits;
  const int g0 = (blockIdx.x - h * hsplits) * GB;
  const int gb = min(GB, G - g0);
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int HD = Hkv * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const long long head0 = (long long)b * Hq + (long long)h * G + g0;
  for (int i = tid; i < GB * CH; i += NTM) {      // rows past gb are zeros
    const int r = i / CH;
    const int c = i - r * CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < gb) x = *reinterpret_cast<const uint4*>(q + (head0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * ST + c * 8) = x;
  }

  // the block's sub-chunks, numbered over its pages (cpp to a page): a contiguous run
  // from the first that reaches the window start to the last that starts before len
  const int len = kv_lens[b];
  const int ws = window > 0 ? max(len - window, 0) : 0;
  const int cpp = (BS + TC - 1) / TC;
  int i_lo = 0, i_hi = 0;
  if (len > 0) {
    const int p_lo = max(ws / BS, sp * split_pages);
    const int p_hi = min(min((len + BS - 1) / BS, W), (sp + 1) * split_pages);
    if (p_lo < p_hi) {
      i_lo = p_lo * cpp;
      i_hi = p_hi * cpp;
      while (i_lo < i_hi && (i_lo / cpp) * BS + (i_lo % cpp) * TC + TC <= ws) ++i_lo;
      while (i_hi > i_lo && ((i_hi - 1) / cpp) * BS + ((i_hi - 1) % cpp) * TC >= len) --i_hi;
    }
  }
  const long long plane = (long long)BS * HD;
  auto load = [&](int i, int stage) {
    const int p = i / cpp;
    const int t0 = (i - p * cpp) * TC;
    const int nt = min(TC, BS - t0);
    const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
    const T* kp = cache + ((long long)layer * NB + blk) * 2 * plane + (long long)h * D
                  + (long long)t0 * HD;
    const T* vp = kp + plane;
    T* ks = ring + stage * 2 * TC * ST;
    T* vs = ks + TC * ST;
    for (int x = tid; x < TC * CH; x += NTM) {
      const int t = x / CH;
      const int c = x - t * CH;
      const bool in = t < nt;          // rows past the page's end read as zeros
      const long long off = in ? (long long)t * HD + c * 8 : 0;
      cp_async16(ks + t * ST + c * 8, kp + off, in);
      cp_async16(vs + t * ST + c * 8, vp + off, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  if (i_lo < i_hi) load(i_lo, 0);
  for (int i = i_lo; i < i_hi; ++i) {
    const int stage = (i - i_lo) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // sub-chunk i has landed for every thread, and every thread is done with i - 1,
    // whose stage takes i + 1 now
    __syncthreads();
    if (i + 1 < i_hi) load(i + 1, stage ^ 1);
    const T* ks = ring + stage * 2 * TC * ST;
    const T* vs = ks + TC * ST;
    const int p = i / cpp;
    const int t0 = (i - p * cpp) * TC;
    const int nt = min(TC, BS - t0);
    const int c0 = p * BS + t0;        // the sub-chunk's first position

    // S = Q K^T over this warp's keys [warp * 8 NTW, +8 NTW), the full D
    float s[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      qa[0] = attn::ld32(Qs + gid * ST + kc * 16 + 2 * tig);
      qa[1] = attn::ld32(Qs + (gid + 8) * ST + kc * 16 + 2 * tig);
      qa[2] = attn::ld32(Qs + gid * ST + kc * 16 + 8 + 2 * tig);
      qa[3] = attn::ld32(Qs + (gid + 8) * ST + kc * 16 + 8 + 2 * tig);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const T* kr = ks + ((warp * NTW + n) * 8 + gid) * ST + kc * 16 + 2 * tig;
        attn::Mma<T>::run(s[n], qa, attn::ld32(kr), attn::ld32(kr + 8));
      }
    }
    // scale, softcap, window / length / page-end mask; the row max over the warps
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = (warp * NTW + n) * 8 + 2 * tig + (e & 1);
        const int pos = c0 + t;
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = (t < nt && pos < len && pos >= ws) ? x : MASK_VALUE;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = attn::quad_max(mx0);
    mx1 = attn::quad_max(mx1);
    if (tig == 0) {
      rmax[warp * GB + gid] = mx0;
      rmax[warp * GB + gid + 8] = mx1;
    }
    __syncthreads();
    float mn0 = m0, mn1 = m1;
#pragma unroll
    for (int w = 0; w < 4; ++w) {          // every warp combines in the same order
      mn0 = fmaxf(mn0, rmax[w * GB + gid]);
      mn1 = fmaxf(mn1, rmax[w * GB + gid + 8]);
    }
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
      // P in the page type for the P.V product (hi, and with HILO what it leaves)
      const int c = (warp * NTW + n) * 8 + 2 * tig;
      if constexpr (HILO) {
        uint32_t h, l;
        ndec::split_hi_lo<T>(s[n][0], s[n][1], h, l);
        *reinterpret_cast<uint32_t*>(Ps + gid * PST + c) = h;
        *reinterpret_cast<uint32_t*>(Pl + gid * PST + c) = l;
        ndec::split_hi_lo<T>(s[n][2], s[n][3], h, l);
        *reinterpret_cast<uint32_t*>(Ps + (gid + 8) * PST + c) = h;
        *reinterpret_cast<uint32_t*>(Pl + (gid + 8) * PST + c) = l;
      } else {
        *reinterpret_cast<uint32_t*>(Ps + gid * PST + c) = attn::Mma<T>::pack(s[n][0], s[n][1]);
        *reinterpret_cast<uint32_t*>(Ps + (gid + 8) * PST + c) =
            attn::Mma<T>::pack(s[n][2], s[n][3]);
      }
    }
    sum0 = attn::quad_sum(sum0);
    sum1 = attn::quad_sum(sum1);
    if (tig == 0) {
      rsum[warp * GB + gid] = sum0;
      rsum[warp * GB + gid + 8] = sum1;
    }
    __syncthreads();
    float t0s = 0.f, t1s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      t0s += rsum[w * GB + gid];
      t1s += rsum[w * GB + gid + 8];
    }
    l0 = l0 * a0 + t0s;
    l1 = l1 * a1 + t1s;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // O[:, this warp's columns] += P V over all the sub-chunk's keys
#pragma unroll
    for (int kc = 0; kc < TC / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = attn::ld32(Ps + gid * PST + kc * 16 + 2 * tig);
      pa[1] = attn::ld32(Ps + (gid + 8) * PST + kc * 16 + 2 * tig);
      pa[2] = attn::ld32(Ps + gid * PST + kc * 16 + 8 + 2 * tig);
      pa[3] = attn::ld32(Ps + (gid + 8) * PST + kc * 16 + 8 + 2 * tig);
      uint32_t pl[4];
      if constexpr (HILO) {
        pl[0] = attn::ld32(Pl + gid * PST + kc * 16 + 2 * tig);
        pl[1] = attn::ld32(Pl + (gid + 8) * PST + kc * 16 + 2 * tig);
        pl[2] = attn::ld32(Pl + gid * PST + kc * 16 + 8 + 2 * tig);
        pl[3] = attn::ld32(Pl + (gid + 8) * PST + kc * 16 + 8 + 2 * tig);
      }
      const T* vr = vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST
                    + (lane >> 4) * 8 + warp * DW;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb4[4];
        attn::ldsm_x4_trans(vb4, vr + dt * 8);
        attn::Mma<T>::run(o[dt], pa, vb4[0], vb4[1]);
        attn::Mma<T>::run(o[dt + 1], pa, vb4[2], vb4[3]);
        if constexpr (HILO) {
          attn::Mma<T>::run(o[dt], pl, vb4[0], vb4[1]);
          attn::Mma<T>::run(o[dt + 1], pl, vb4[2], vb4[3]);
        }
      }
    }
  }

  // each thread holds heads gid and gid + 8, columns warp * DW + dt * 8 + 2 tig (+1)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int g = gid + 8 * half;
    if (g >= gb) continue;
    const float m = half ? m1 : m0;
    const float l = half ? l1 : l0;
    const int hq = h * G + g0 + g;
    if (S == 1) {
      T* dst = out + (head0 + g) * D + warp * DW + 2 * tig;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) = attn::Mma<T>::pack(
            finish(o[dt][2 * half], m, l, sinks, hq), finish(o[dt][2 * half + 1], m, l, sinks, hq));
    } else {
      // this split's unnormalized (acc, m, l) for the combine
      float* dst = part + (((long long)b * S + sp) * Hq + hq) * (D + 2);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        dst[warp * DW + dt * 8 + 2 * tig] = o[dt][2 * half];
        dst[warp * DW + dt * 8 + 2 * tig + 1] = o[dt][2 * half + 1];
      }
      if (warp == 0 && tig == 0) {
        dst[D] = m;
        dst[D + 1] = l;
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess) configured = bytes;
  return e;
}

// the second pass of a narrow launch of more than one split
template <typename TQ>
cudaError_t combine_rows(float* part, const int* kv_lens, const float* sinks, void* out, int B,
                         int Hq, int D, int splits, int BS, int W, int split_pages,
                         int window, cudaStream_t stream) {
  attn::decode_split_combine_rows<TQ><<<dim3(Hq, B), 128, 2 * splits * sizeof(float),
                                        stream>>>(part, kv_lens, static_cast<TQ*>(out), Hq,
                                                  D, splits, BS, W, split_pages, sinks,
                                                  window);
  return cudaGetLastError();
}

template <typename TQ, typename TK, int D>
cudaError_t launch_narrow(const void* q, const void* cache, const int* tables,
                          const int* kv_lens, const float* sinks, void* out, float* part,
                          int B, int Hq, int Hkv, int NB, int BS, int W, int layer,
                          float scale, float softcap, int window, int splits,
                          cudaStream_t stream) {
  const size_t bytes = narrow_smem<TK, D>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  cudaError_t e = set_smem(paged_decode_narrow_simt<TQ, TK, D>, bytes, configured);
  if (e != cudaSuccess) return e;
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_narrow_simt<TQ, TK, D><<<dim3(Hkv, B, splits), NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(cache), tables, kv_lens, sinks,
      static_cast<TQ*>(out), part, Hq, Hkv, NB, BS, W, layer, scale, softcap, window,
      split_pages);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine_rows<TQ>(part, kv_lens, sinks, out, B, Hq, D, splits, BS, W, split_pages,
                          window, stream);
}

template <typename T, typename TK, int D, bool ONE_PAGE>
cudaError_t launch_narrow_mma(const void* q, const void* cache, const int* tables,
                              const int* kv_lens, const float* sinks, void* out, float* part,
                              int B, int Hq, int Hkv, int NB, int BS, int W, int layer,
                              float scale, float softcap, int window, int splits,
                              cudaStream_t stream) {
  constexpr int bytes = ndec::smem_bytes<NarrowPages<T, TK>, D>();
  static cudaError_t configured = cudaFuncSetAttribute(
      paged_decode_narrow<T, TK, D, ONE_PAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (configured != cudaSuccess) return configured;
  const int hsplits = (Hq / Hkv + qdec::GQ - 1) / qdec::GQ;
  const int split_pages = (W + splits - 1) / splits;
  const ndec::Args args{q,     cache,  nullptr, tables, kv_lens, sinks,   out,    part,
                        Hq,    Hkv,    NB,      BS,     W,       layer,   scale,  softcap,
                        window, split_pages, {}};
  paged_decode_narrow<T, TK, D, ONE_PAGE><<<dim3(Hkv * hsplits, B, splits), qdec::NT, bytes,
                                            stream>>>(args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine_rows<T>(part, kv_lens, sinks, out, B, Hq, D, splits, BS, W, split_pages,
                         window, stream);
}

template <typename TQ, typename TK, int TC>
cudaError_t launch_wide(const void* q, const void* cache, const int* tables,
                        const int* kv_lens, const float* sinks, void* out, float* part,
                        int B, int Hq, int Hkv, int D, int NB, int BS, int W, int layer,
                        float scale, float softcap, int window, int splits,
                        cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const size_t bytes = wide_smem<TK, TC>(G < GB ? G : GB, D);
  static size_t configured = 48 * 1024;
  cudaError_t e = set_smem(paged_decode_wide<TQ, TK, TC>, bytes, configured);
  if (e != cudaSuccess) return e;
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_wide<TQ, TK, TC><<<dim3(Hkv * hsplits, B, splits), NTW, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(cache), tables, kv_lens, sinks,
      static_cast<TQ*>(out), part, Hq, Hkv, D, NB, BS, W, layer, scale, softcap, window,
      split_pages);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  attn::decode_split_combine<TQ><<<dim3(Hq, B), 128, 0, stream>>>(
      part, sinks, static_cast<TQ*>(out), Hq, D, splits);
  return cudaGetLastError();
}

template <typename T, int D, int TC>
cudaError_t launch_mma(const void* q, const void* cache, const int* tables,
                       const int* kv_lens, const float* sinks, void* out, float* part,
                       int B, int Hq, int Hkv, int NB, int BS, int W, int layer, float scale,
                       float softcap, int window, int splits, cudaStream_t stream) {
  constexpr int bytes = mma_smem<D, TC>();
  static cudaError_t configured = cudaFuncSetAttribute(
      paged_decode_mma<T, D, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (configured != cudaSuccess) return configured;
  const int hsplits = (Hq / Hkv + GB - 1) / GB;
  const int split_pages = (W + splits - 1) / splits;
  // head blocks fastest: the blocks of one (row, split) read the same pages together
  paged_decode_mma<T, D, TC><<<dim3(Hkv * hsplits, B, splits), NTM, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), tables, kv_lens, sinks,
      static_cast<T*>(out), part, Hq, Hkv, NB, BS, W, layer, scale, softcap, window,
      split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  attn::decode_split_combine<T><<<dim3(Hq, B), 128, 0, stream>>>(
      part, sinks, static_cast<T*>(out), Hq, D, splits);
  return cudaGetLastError();
}

// the tensor-core narrow launch at D 64 / 128: the ONE_PAGE build (a block size that is
// a multiple of qdec::WT: one page lookup a warp) or the one that looks up each row's
template <typename TQ, typename TK>
auto narrow_mma_launch(int D, int BS) {
  const bool one = BS % qdec::WT == 0;
  if (D == 64)
    return one ? launch_narrow_mma<TQ, TK, 64, true> : launch_narrow_mma<TQ, TK, 64, false>;
  return one ? launch_narrow_mma<TQ, TK, 128, true> : launch_narrow_mma<TQ, TK, 128, false>;
}

// 2-byte and e4m3 pages up to D = 128: the tensor-core narrow kernel for a bf16 / f16 q
// at D 64 / 128, else the CUDA-core one; above
// D = 128: 2-byte pages the tensor-core wide kernel, e4m3 pages the wide one; f32 pages:
// the wide one
template <typename TQ, typename TK>
int dispatch(const void* q, const void* cache, const void* tables, const void* kv_lens,
             const void* sinks, void* out, void* part, int B, int Hq, int Hkv, int D,
             int NB, int BS, int W, int layer, float scale, float softcap, int window,
             int splits, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || W <= 0 || splits <= 0
      || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  const float* sk = static_cast<const float*>(sinks);
  float* pt = static_cast<float*>(part);
  if constexpr (sizeof(TK) <= 2) {
    if constexpr (!std::is_same<TQ, float>::value) {
      if (D == 64 || D == 128)
        return (int)narrow_mma_launch<TQ, TK>(D, BS)(
            q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, NB, BS, W, layer, scale, softcap,
            window, splits, s);
    }
    switch (D) {
#define NARROW_CASE(DIM)                                                                  \
      case DIM:                                                                           \
        return (int)launch_narrow<TQ, TK, DIM>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv,  \
                                               NB, BS, W, layer, scale, softcap, window,  \
                                               splits, s);
      NARROW_CASE(64)
      NARROW_CASE(80)
      NARROW_CASE(96)
      NARROW_CASE(128)
#undef NARROW_CASE
      default:
        break;
    }
  }
  if constexpr (sizeof(TK) == 2) {
    switch (D) {
#define MMA_CASE(DIM, TC)                                                                 \
      case DIM:                                                                           \
        return (int)launch_mma<TK, DIM, TC>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, NB, \
                                            BS, W, layer, scale, softcap, window, splits, \
                                            s);
      MMA_CASE(192, 64)
      MMA_CASE(256, 64)
      MMA_CASE(576, 32)
#undef MMA_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 64: case 80: case 96: case 128:
        return (int)launch_wide<TQ, TK, 128>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, D,
                                             NB, BS, W, layer, scale, softcap, window,
                                             splits, s);
      case 192: case 256:
        return (int)launch_wide<TQ, TK, 64>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, D,
                                            NB, BS, W, layer, scale, softcap, window,
                                            splits, s);
      case 576:
        return (int)launch_wide<TQ, TK, 32>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, D,
                                            NB, BS, W, layer, scale, softcap, window,
                                            splits, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// q [B,Hq,D] contiguous of dtype 0 bf16, 1 f16 or 2 f32; cache [L,NB,2,BS,Hkv*D]
// contiguous, in q's dtype (paged_decode) or e4m3 (paged_decode_fp8); tables [B,W] i32;
// kv_lens [B] i32; sinks [Hq] f32 or null; out [B,Hq,D] in q's dtype.  softcap <= 0
// and window <= 0 disable those options.  splits: the split of each row's W pages over
// blocks (1 for none), with part f32 [B, splits, Hq, D + 2] scratch when it is above 1;
// a split launch is followed by its combine.  Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int paged_decode(const void* q, const void* cache, const void* tables,
                            const void* kv_lens, const void* sinks, void* out, void* part,
                            int dtype, int B, int Hq, int Hkv, int D, int NB, int BS, int W,
                            int layer, float scale, float softcap, int window, int splits,
                            void* stream) {
  switch (dtype) {
    case 0:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(q, cache, tables, kv_lens, sinks, out,
                                                    part, B, Hq, Hkv, D, NB, BS, W, layer,
                                                    scale, softcap, window, splits, stream);
    case 1:
      return dispatch<__half, __half>(q, cache, tables, kv_lens, sinks, out, part, B, Hq,
                                      Hkv, D, NB, BS, W, layer, scale, softcap, window,
                                      splits, stream);
    case 2:
      return dispatch<float, float>(q, cache, tables, kv_lens, sinks, out, part, B, Hq, Hkv,
                                    D, NB, BS, W, layer, scale, softcap, window, splits,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int paged_decode_fp8(const void* q, const void* cache, const void* tables,
                                const void* kv_lens, const void* sinks, void* out,
                                void* part, int dtype, int B, int Hq, int Hkv, int D,
                                int NB, int BS, int W, int layer, float scale,
                                float softcap, int window, int splits, void* stream) {
  switch (dtype) {
    case 0:
      return dispatch<__nv_bfloat16, fp8_t>(q, cache, tables, kv_lens, sinks, out, part, B,
                                            Hq, Hkv, D, NB, BS, W, layer, scale, softcap,
                                            window, splits, stream);
    case 1:
      return dispatch<__half, fp8_t>(q, cache, tables, kv_lens, sinks, out, part, B, Hq,
                                     Hkv, D, NB, BS, W, layer, scale, softcap, window,
                                     splits, stream);
    case 2:
      return dispatch<float, fp8_t>(q, cache, tables, kv_lens, sinks, out, part, B, Hq, Hkv,
                                    D, NB, BS, W, layer, scale, softcap, window, splits,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
