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
// are template parameters: every element widens to f32 on load (e4m3 through f16,
// exactly), and the output rounds once.  P stays f32 for the P.V product: the TPU
// kernel's rounding of P to the page type (pr.astype(v.dtype), e4m3 there) is not
// copied.  D is any of {64, 80, 96, 128, 192, 256, 576} (MLA's latent 576: one kv head
// whose V rows are the latent followed by 64 zeros; the kernel computes all 576
// output columns).
//
// What bounds it on an H100: bytes of K/V read.  At bs 64 with ~384 tokens a row,
// TinyLlama's bf16 K+V is 1 KiB per token per layer, 25 MB per layer: ~7.5 us at
// 3.35 TB/s, against ~0.1 MFLOP of arithmetic per row and head.  MLA's cache is 2,304
// bytes a token and layer (2 planes x 576 x bf16), whatever the head count.
//
// Design (simple and right first; TMA, a pipelined page walk and tensor-core scores
// are later work).  The query heads of a GQA group share every K/V byte a block loads.
//   * Narrow (D <= 128, pages of 2-byte or e4m3 elements; D a template parameter):
//     one block of 128 threads per (kv head, batch row) walks the row's pages from the
//     window start to its length.  Per page: the head's [BS, D] slice of the K plane and
//     of the V plane goes to shared memory with 16-byte coalesced loads; scores with
//     one thread per token, its K row held in registers as raw words, against the f32
//     query rows; online softmax per query head in f32 (warp reductions over the
//     page); P.V with one thread per (head, column) and the accumulator in shared
//     memory.
//   * Wide (D > 128, and f32 pages at any D; D a runtime value): a [G, D] f32
//     accumulator of a large group at D = 576 does not fit beside two page slices, so
//     a block of 512 threads takes a group of up to 16 query heads (a larger group,
//     DeepSeek-V3's 128 over one latent head, is split over blocks that each re-read
//     the pages from L2), and walks its pages in sub-chunks of TC tokens (128 tokens up
//     to D = 128, 64 up to 256, 32 at 576: a 37 KB plane slice at 576 in bf16).  Each
//     thread scores one token for NT / TC of the heads, walking the token's K row
//     once, 16 bytes at a time, with one f32 accumulator per head.  The row's pages
//     are also split over blocks, SPLIT pages each (a 4,096-token row would otherwise
//     walk serially while the short rows' blocks idle): each block writes its
//     unnormalized (acc, m, l) and a second kernel combines the splits in a fixed
//     order (m = max m_s, l = sum l_s e^(m_s - m), acc likewise), then applies the
//     sinks and the l == 0 guard.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_types.cuh"
#include "decode_split.cuh"

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

// ---------------------------------------------------------------------- narrow kernel
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
paged_decode_narrow(const TQ* __restrict__ q,                 // [B, Hq, D]
                    const TK* __restrict__ cache,             // [L, NB, 2, BS, Hkv*D]
                    const int* __restrict__ tables,           // [B, W]
                    const int* __restrict__ kv_lens,          // [B]
                    const float* __restrict__ sinks,          // [Hq] or null
                    TQ* __restrict__ out,                     // [B, Hq, D]
                    int Hq, int Hkv, int NB, int BS, int W, int layer,
                    float scale, float softcap, int window) {
  constexpr int EPC = attn::epc<TK>();   // elements per 16-byte chunk
  constexpr int KSTR = D + EPC;   // 16-byte padded K rows: conflict-free row reads
  constexpr int CH = D / EPC;     // 16-byte chunks per head row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int HD = Hkv * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

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

  const int len = kv_lens[b];
  if (len > 0) {
    const int ws = window > 0 ? max(len - window, 0) : 0;
    const int p_hi = min((len + BS - 1) / BS, W);
    const long long plane = (long long)BS * HD;
    for (int p = ws / BS; p < p_hi; ++p) {
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

  TQ* orow = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    orow[i] = attn::from_f<TQ>(finish(os[i], ms[g], ls[g], sinks, h * G + g));
  }
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess) configured = bytes;
  return e;
}

template <typename TQ, typename TK, int D>
cudaError_t launch_narrow(const void* q, const void* cache, const int* tables,
                          const int* kv_lens, const float* sinks, void* out, int B, int Hq,
                          int Hkv, int NB, int BS, int W, int layer, float scale,
                          float softcap, int window, cudaStream_t stream) {
  const size_t bytes = narrow_smem<TK, D>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  cudaError_t e = set_smem(paged_decode_narrow<TQ, TK, D>, bytes, configured);
  if (e != cudaSuccess) return e;
  paged_decode_narrow<TQ, TK, D><<<dim3(Hkv, B), NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(cache), tables, kv_lens, sinks,
      static_cast<TQ*>(out), Hq, Hkv, NB, BS, W, layer, scale, softcap, window);
  return cudaGetLastError();
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

// the wide kernel serves every D and element type; the narrow one D <= 128 over
// 2-byte or e4m3 pages
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
    switch (D) {
#define NARROW_CASE(DIM)                                                                  \
      case DIM:                                                                           \
        return (int)launch_narrow<TQ, TK, DIM>(q, cache, tb, kl, sk, out, B, Hq, Hkv, NB, \
                                               BS, W, layer, scale, softcap, window, s);
      NARROW_CASE(64)
      NARROW_CASE(80)
      NARROW_CASE(96)
      NARROW_CASE(128)
#undef NARROW_CASE
      default:
        break;
    }
  }
  switch (D) {
    case 64: case 80: case 96: case 128:
      return (int)launch_wide<TQ, TK, 128>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, D, NB,
                                           BS, W, layer, scale, softcap, window, splits, s);
    case 192: case 256:
      return (int)launch_wide<TQ, TK, 64>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, D, NB,
                                          BS, W, layer, scale, softcap, window, splits, s);
    case 576:
      return (int)launch_wide<TQ, TK, 32>(q, cache, tb, kl, sk, out, pt, B, Hq, Hkv, D, NB,
                                          BS, W, layer, scale, softcap, window, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Hq,D] contiguous of dtype 0 bf16, 1 f16 or 2 f32; cache [L,NB,2,BS,Hkv*D]
// contiguous, in q's dtype (paged_decode) or e4m3 (paged_decode_fp8); tables [B,W] i32;
// kv_lens [B] i32; sinks [Hq] f32 or null; out [B,Hq,D] in q's dtype.  softcap <= 0
// and window <= 0 disable those options.  splits: the wide kernel's split of each
// row's W pages over blocks (1 for none; the narrow kernel ignores it), with part f32
// [B, splits, Hq, D + 2] scratch when it is above 1.  Returns the CUDA error code of
// the launch (0 = launched).
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
