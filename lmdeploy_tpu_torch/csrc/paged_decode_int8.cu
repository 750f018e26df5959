// T = 1 attention over a paged int8 KV cache, for Hopper (sm_90a).
//
// Replaces the int8 branch of the TPU kernel lmdeploy_tpu/ops/pallas/paged_decode.py
// (paged_decode_attention, body _decode_kernel_quant, softmax step _softmax_update).
// Same function, in the same order:
//   s = (q * scale) . k_i8 * ksc;  optional softcap tanh(s / c) * c;  mask by kv_len
//   (MASK_VALUE = -0.7 * FLT_MAX, not -inf);  online softmax in f32 with l summing the
//   unscaled p;  acc += (p * vsc) @ v_i8;  out = acc / l  (l == 0 -> 1).
// kv_lens[b] counts the token just filled; 0 marks an inactive row, whose output is
// 0.  No window and no sinks: the reference never sends those to this kernel.
//
// Cache layout: data int8 [L, NB, 2, BS, Hkv * D] -- a K plane and a V plane of
// head-major token rows per page (the reference layout without its 128-lane
// padding); scale f32 [L, NB, 2, BS, Hkv], token-major, read straight from there
// (the reference's per-layer transpose to head-major is a Mosaic workaround).  Block
// 0 is the padding block; tables [B, W] i32 map a row's page index to its block.
//
// What bounds it on an H100: bytes of K/V read.  Per token and layer:
// Hkv * (2 * D int8 + 2 * 4 scale bytes) -- 8,448 bytes at llama2-7b (Hkv 32,
// D 128), half the bf16 cache's bytes.
//
// Design.  Every path splits each row's pages over blocks (grid (kv heads x head
// blocks, B, splits); the split is the wrapper's, a function of W, BS and D alone): each
// block with pages writes its unnormalized (acc, m, l), and a second kernel of
// decode_split.cuh combines a row's splits in a fixed order (no atomics).  One split
// writes the output itself.
//   * Tensor-core narrow (bf16 / f16 q, D = 64, 128, 192, 256, any block size):
//     narrow_decode.cuh's body with int8 elements and scales.  A block of 4 warps takes
//     up to 8 query heads of a kv head; its pages stream through a 3-stage ring of
//     64-token sub-chunks (the [64, D] int8 slices of the K and V planes, padded to D +
//     16 bytes a row, and the 64 K and 64 V scales, cp.async 16 and 4 bytes), each warp
//     copying and waiting for its own 16 rows (no block barrier in the loop).  S = Q K^T
//     on mma.sync m16n8k16: each K code is decoded once for the whole group, straight
//     into the B fragment, exactly (bf16 and f16 hold every int8 value; the magic
//     numbers of narrow_decode.cuh: i8x2), against q in its own type, so each product
//     is exact in f32; s = (q . k) * (scale * ksc).  O^T += V^T P'^T on mma.sync with
//     the V codes decoded to bf16 the same way and P' = p * vsc as bf16 hi + lo (16 of
//     its 24 bits); l sums the unscaled p.  So the function is the f32 loop's up to
//     rounding.
//   * CUDA-core narrow (f32 q at any D, and D = 80 / 96, which are no whole 64-dim
//     units): one block per (kv head, batch row, split) walks its pages.  The G query
//     heads of the GQA group share every page the block loads.  Per page: the head's
//     [BS, D] int8 slices of the K and V planes go to shared memory with 16-byte loads,
//     and the page's BS K and V scales of this head beside them; scores with one thread
//     per token, its K row held in registers; online softmax per query head (warp
//     reductions); P.V with one thread per (head, column), accumulator in shared memory.
//   * Wide (MLA's latent D = 576, one kv head under 16 or 128 query heads): whole
//     [BS, 576] page slices and a register K row do not fit, so, as paged_decode.cu's
//     wide path, a block of 512 threads takes up to 16 query heads (a larger group is
//     split over blocks that each re-read the pages from L2) and walks each page in
//     sub-chunks of 32 tokens: the [32, D] int8 K and V slices and their scales in
//     shared memory, one thread per (token, head) for the scores, reading the token's
//     K row 16 bytes at a time.  The arithmetic is the CUDA-core narrow path's, term for
//     term.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "attn_types.cuh"
#include "decode_split.cuh"
#include "narrow_decode.cuh"
#include "quant_decode.cuh"

namespace {

using attn::MASK_VALUE;

constexpr int NT = 128;

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

// signed byte e (0..3) of a packed word, as float
__device__ __forceinline__ float byte_f(uint32_t w, int e) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * e)) >> 24);
}

__host__ __device__ inline int float_words(int G, int D, int BS) {
  // qs [G][D] + os [G][D] + ps [G][BS] + m, l, alpha [G] + ksc, vsc [BS], rounded to 16 B
  return (2 * G * D + G * BS + 3 * G + 2 * BS + 3) & ~3;
}

template <int D>
size_t smem_bytes(int G, int BS) {
  return (size_t)float_words(G, D, BS) * sizeof(float)
       + (size_t)BS * (D + 16)          // K slice, 16-byte padded rows
       + (size_t)BS * D;                // V slice
}

template <typename TQ, int D>
__global__ void __launch_bounds__(NT)
paged_decode_int8_kernel(const TQ* __restrict__ q,   // [B, Hq, D]
                         const int8_t* __restrict__ data,       // [L, NB, 2, BS, Hkv*D]
                         const float* __restrict__ scales,      // [L, NB, 2, BS, Hkv]
                         const int* __restrict__ tables,        // [B, W]
                         const int* __restrict__ kv_lens,       // [B]
                         TQ* __restrict__ out,       // [B, Hq, D]
                         float* __restrict__ part,   // [B, S, Hq, D + 2] or null
                         int Hq, int Hkv, int NB, int BS, int W, int layer,
                         float scale, float softcap, int split_pages) {
  constexpr int KSTR = D + 16;    // padded K rows: conflict-free 16-byte row reads
  constexpr int CH = D / 16;      // 16-byte chunks per head row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int G = Hq / Hkv;
  const int HD = Hkv * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [G][D]  q * scale
  float* os = qs + G * D;           // [G][D]
  float* ps = os + G * D;           // [G][BS]
  float* ms = ps + G * BS;          // [G]
  float* ls = ms + G;               // [G]
  float* as = ls + G;               // [G]
  float* ksc = as + G;              // [BS]
  float* vsc = ksc + BS;            // [BS]
  int8_t* ks = reinterpret_cast<int8_t*>(smem + float_words(G, D, BS));
  int8_t* vs = ks + BS * KSTR;

  const TQ* qrow = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    qs[i] = attn::to_f(qrow[i]) * scale;
    os[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    ms[g] = MASK_VALUE;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int len = kv_lens[b];
  const int p_lo = sp * split_pages;
  const int p_hi = min(min((len + BS - 1) / BS, W), p_lo + split_pages);
  const long long plane = (long long)BS * HD;
  const long long splane = (long long)BS * Hkv;
  for (int p = p_lo; p < p_hi; ++p) {
    const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
    const long long page = (long long)layer * NB + blk;
    const int8_t* kpage = data + page * 2 * plane + (long long)h * D;
    const int8_t* vpage = kpage + plane;
    const float* kscale = scales + page * 2 * splane + h;
    for (int i = tid; i < BS * CH; i += NT) {
      const int t = i / CH;
      const int c = i - t * CH;
      *reinterpret_cast<uint4*>(ks + t * KSTR + c * 16) =
          *reinterpret_cast<const uint4*>(kpage + (long long)t * HD + c * 16);
      *reinterpret_cast<uint4*>(vs + t * D + c * 16) =
          *reinterpret_cast<const uint4*>(vpage + (long long)t * HD + c * 16);
    }
    for (int t = tid; t < BS; t += NT) {
      ksc[t] = kscale[(long long)t * Hkv];
      vsc[t] = kscale[splane + (long long)t * Hkv];
    }
    __syncthreads();

    for (int t = tid; t < BS; t += NT) {
      const bool valid = p * BS + t < len;
      uint32_t kr[D / 4];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * KSTR + c * 16);
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
          const uint32_t w = kr[d / 4];
          acc = fmaf(qv.x, byte_f(w, 0), acc);
          acc = fmaf(qv.y, byte_f(w, 1), acc);
          acc = fmaf(qv.z, byte_f(w, 2), acc);
          acc = fmaf(qv.w, byte_f(w, 3), acc);
        }
        float s = acc * ksc[t];
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
        sum += e;                     // l sums the unscaled p
        prow[t] = e * vsc[t];         // P.V takes p * vsc
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
      for (int t = 0; t < BS; ++t) acc = fmaf(prow[t], static_cast<float>(vs[t * D + d]), acc);
      os[i] = acc;
    }
    __syncthreads();
  }

  if (S == 1) {
    TQ* orow = out + ((long long)b * Hq + (long long)h * G) * D;
    for (int i = tid; i < G * D; i += NT) {
      const float l = ls[i / D];
      orow[i] = attn::from_f<TQ>(len > 0 ? os[i] / (l == 0.f ? 1.f : l) : 0.f);
    }
    return;
  }
  // this split's unnormalized (acc, m, l); an empty split's (0, MASK_VALUE, 0)
  for (int i = tid; i < G * (D + 2); i += NT) {
    const int g = i / (D + 2);
    const int d = i - g * (D + 2);
    const float v = d < D ? os[g * D + d] : (d == D ? ms[g] : ls[g]);
    part[(((long long)b * S + sp) * Hq + h * G + g) * (D + 2) + d] = v;
  }
}

// ------------------------------------------------------- tensor-core narrow kernel
template <typename T, int D, bool ONE_PAGE>
__global__ void __launch_bounds__(qdec::NT, qdec::min_blocks<D>())
paged_decode_int8_mma(const ndec::Args a) {
  ndec::narrow_body<T, ndec::PagesInt8, D, ONE_PAGE, false>(a);
}

// ------------------------------------------------------------------------ wide kernel
constexpr int NTW = 512;          // wide kernel threads
constexpr int TCW = 32;           // tokens a sub-chunk
constexpr int HPW = NTW / TCW;    // head parts: the threads that share a token
constexpr int GB = 16;            // query heads a wide block at most
constexpr int ACCW = (GB + HPW - 1) / HPW;

__host__ __device__ inline int wide_words(int gb, int D) {
  // qs [gb][D] + os [gb][D] + ps [gb][TCW] + m, l, alpha [gb] + ksc, vsc [TCW],
  // rounded to 16 bytes
  return (2 * gb * D + gb * TCW + 3 * gb + 2 * TCW + 3) & ~3;
}

inline size_t wide_smem(int gb, int D) {
  return (size_t)wide_words(gb, D) * sizeof(float)
       + (size_t)TCW * (D + 16)         // K slice, 16-byte padded rows
       + (size_t)TCW * D;               // V slice
}

template <typename TQ>
__global__ void __launch_bounds__(NTW)
paged_decode_int8_wide(const TQ* __restrict__ q,                // [B, Hq, D]
                       const int8_t* __restrict__ data,         // [L, NB, 2, BS, Hkv*D]
                       const float* __restrict__ scales,        // [L, NB, 2, BS, Hkv]
                       const int* __restrict__ tables,          // [B, W]
                       const int* __restrict__ kv_lens,         // [B]
                       TQ* __restrict__ out,                    // [B, Hq, D]
                       float* __restrict__ part,                // [B, S, Hq, D + 2] or null
                       int Hq, int Hkv, int D, int NB, int BS, int W, int layer,
                       float scale, float softcap, int split_pages) {
  const int KSTR = D + 16;        // padded K rows: conflict-free 16-byte row reads
  const int CH = D / 16;          // 16-byte chunks per head row
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
  float* qs = smem;                 // [gb][D]  q * scale
  float* os = qs + gb * D;          // [gb][D]
  float* ps = os + gb * D;          // [gb][TCW]
  float* ms = ps + gb * TCW;        // [gb]
  float* ls = ms + gb;              // [gb]
  float* as = ls + gb;              // [gb]
  float* ksc = as + gb;             // [TCW]
  float* vsc = ksc + TCW;           // [TCW]
  int8_t* ks = reinterpret_cast<int8_t*>(smem + wide_words(gb, D));
  int8_t* vs = ks + TCW * KSTR;

  const long long head0 = (long long)b * Hq + (long long)h * G + g0;
  const TQ* qrow = q + head0 * D;
  for (int i = tid; i < gb * D; i += NTW) {
    qs[i] = attn::to_f(qrow[i]) * scale;
    os[i] = 0.f;
  }
  for (int g = tid; g < gb; g += NTW) {
    ms[g] = MASK_VALUE;
    ls[g] = 0.f;
  }
  __syncthreads();

  const int len = kv_lens[b];
  const int p_lo = sp * split_pages;
  const int p_hi = min(min((len + BS - 1) / BS, W), (sp + 1) * split_pages);
  const long long plane = (long long)BS * HD;
  const long long splane = (long long)BS * Hkv;
  const int tt = tid % TCW;         // this thread's token in the sub-chunk
  const int hp = tid / TCW;         // and its heads hp, hp + HPW, ...
  for (int p = p_lo; p < p_hi; ++p) {
    const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
    const long long page = (long long)layer * NB + blk;
    const int8_t* kpage = data + page * 2 * plane + (long long)h * D;
    const int8_t* vpage = kpage + plane;
    const float* kscale = scales + page * 2 * splane + h;
    for (int t0 = 0; t0 < BS; t0 += TCW) {
      const int c0 = p * BS + t0;                 // the sub-chunk's first position
      if (c0 >= len) break;
      const int nt = min(TCW, BS - t0);
      for (int i = tid; i < nt * CH; i += NTW) {
        const int t = i / CH;
        const int c = i - t * CH;
        const long long off = (long long)(t0 + t) * HD + c * 16;
        *reinterpret_cast<uint4*>(ks + t * KSTR + c * 16) =
            *reinterpret_cast<const uint4*>(kpage + off);
        *reinterpret_cast<uint4*>(vs + t * D + c * 16) =
            *reinterpret_cast<const uint4*>(vpage + off);
      }
      for (int t = tid; t < nt; t += NTW) {
        ksc[t] = kscale[(long long)(t0 + t) * Hkv];
        vsc[t] = kscale[splane + (long long)(t0 + t) * Hkv];
      }
      __syncthreads();

      {
        const bool valid = tt < nt && c0 + tt < len;
        float acc[ACCW];
#pragma unroll
        for (int j = 0; j < ACCW; ++j) acc[j] = 0.f;
        if (tt < nt) {
          const int8_t* kr = ks + tt * KSTR;
          for (int c = 0; c < CH; ++c) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 16);
            const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int j = 0; j < ACCW; ++j) {
              const int g = hp + HPW * j;
              if (g < gb) {
                const float* qg = qs + g * D + c * 16;
                float a = acc[j];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * e);
                  a = fmaf(qv.x, byte_f(w[e], 0), a);
                  a = fmaf(qv.y, byte_f(w[e], 1), a);
                  a = fmaf(qv.z, byte_f(w[e], 2), a);
                  a = fmaf(qv.w, byte_f(w[e], 3), a);
                }
                acc[j] = a;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < ACCW; ++j) {
          const int g = hp + HPW * j;
          if (g < gb) {
            float s = tt < nt ? acc[j] * ksc[tt] : 0.f;
            if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
            ps[g * TCW + tt] = valid ? s : MASK_VALUE;
          }
        }
      }
      __syncthreads();

      for (int g = warp; g < gb; g += NTW / 32) {
        float* prow = ps + g * TCW;
        float mx = MASK_VALUE;
        for (int t = lane; t < TCW; t += 32) mx = fmaxf(mx, prow[t]);
        mx = warp_max(mx);
        const float m_old = ms[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < TCW; t += 32) {
          const float e = t < nt ? expf(prow[t] - m_new) : 0.f;
          sum += e;                               // l sums the unscaled p
          prow[t] = t < nt ? e * vsc[t] : 0.f;    // P.V takes p * vsc
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
        const float* prow = ps + g * TCW;
        float a = os[i] * as[g];
        for (int t = 0; t < nt; ++t) a = fmaf(prow[t], static_cast<float>(vs[t * D + d]), a);
        os[i] = a;
      }
      __syncthreads();
    }
  }

  if (S == 1) {
    TQ* orow = out + head0 * D;
    for (int i = tid; i < gb * D; i += NTW) {
      const float l = ls[i / D];
      orow[i] = attn::from_f<TQ>(len > 0 ? os[i] / (l == 0.f ? 1.f : l) : 0.f);
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

template <typename TQ>
cudaError_t launch_wide(const void* q, const void* data, const void* scales,
                        const int* tables, const int* kv_lens, void* out, float* part,
                        int B, int Hq, int Hkv, int D, int NB, int BS, int W, int layer,
                        float scale, float softcap, int splits, cudaStream_t stream) {
  if (splits <= 0 || (splits > 1 && part == nullptr)) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const size_t bytes = wide_smem(G < GB ? G : GB, D);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_int8_wide<TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_int8_wide<TQ><<<dim3(Hkv * hsplits, B, splits), NTW, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(data),
      static_cast<const float*>(scales), tables, kv_lens, static_cast<TQ*>(out), part, Hq,
      Hkv, D, NB, BS, W, layer, scale, softcap, split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  attn::decode_split_combine<TQ><<<dim3(Hq, B), 128, 0, stream>>>(
      part, nullptr, static_cast<TQ*>(out), Hq, D, splits);
  return cudaGetLastError();
}

// the second pass of a narrow launch of more than one split
template <typename TQ>
cudaError_t combine(float* part, const int* kv_lens, void* out, int B, int Hq, int D,
                    int splits, int BS, int W, int split_pages, cudaStream_t stream) {
  attn::decode_split_combine_rows<TQ><<<dim3(Hq, B), 128, 2 * splits * sizeof(float),
                                        stream>>>(part, kv_lens, static_cast<TQ*>(out), Hq,
                                                  D, splits, BS, W, split_pages);
  return cudaGetLastError();
}

template <typename TQ, int D>
cudaError_t launch(const void* q, const void* data, const void* scales, const int* tables,
                   const int* kv_lens, void* out, float* part, int B, int Hq, int Hkv,
                   int NB, int BS, int W, int layer, float scale, float softcap, int splits,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_int8_kernel<TQ, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_int8_kernel<TQ, D><<<dim3(Hkv, B, splits), NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(data),
      static_cast<const float*>(scales), tables, kv_lens, static_cast<TQ*>(out), part, Hq,
      Hkv, NB, BS, W, layer, scale, softcap, split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine<TQ>(part, kv_lens, out, B, Hq, D, splits, BS, W, split_pages, stream);
}

template <typename T, int D, bool ONE_PAGE>
cudaError_t launch_mma(const void* q, const void* data, const void* scales,
                       const int* tables, const int* kv_lens, void* out, float* part, int B,
                       int Hq, int Hkv, int NB, int BS, int W, int layer, float scale,
                       float softcap, int splits, cudaStream_t stream) {
  constexpr int bytes = ndec::smem_bytes<ndec::PagesInt8, D>();
  static cudaError_t configured = cudaFuncSetAttribute(
      paged_decode_int8_mma<T, D, ONE_PAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (configured != cudaSuccess) return configured;
  const int hsplits = (Hq / Hkv + qdec::GQ - 1) / qdec::GQ;
  const int split_pages = (W + splits - 1) / splits;
  const ndec::Args args{q,      data,        static_cast<const float*>(scales), tables,
                        kv_lens, nullptr,    out,   part,  Hq,    Hkv,     NB,   BS,
                        W,      layer,       scale, softcap, 0,   split_pages, {}};
  paged_decode_int8_mma<T, D, ONE_PAGE><<<dim3(Hkv * hsplits, B, splits), qdec::NT, bytes,
                                          stream>>>(args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine<T>(part, kv_lens, out, B, Hq, D, splits, BS, W, split_pages, stream);
}

template <typename TQ>
int by_dim(const void* q, const void* data, const void* scales, const int* tb,
           const int* kl, void* out, float* part, int B, int Hq, int Hkv, int D, int NB,
           int BS, int W, int layer, float scale, float softcap, int splits,
           cudaStream_t s) {
  if (splits <= 0 || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
#define INT8_CASE(DIM)                                                                 \
  case DIM:                                                                            \
    return (int)launch<TQ, DIM>(q, data, scales, tb, kl, out, part, B, Hq, Hkv, NB,    \
                                BS, W, layer, scale, softcap, splits, s);
#define MMA_CASE(DIM)                                                                  \
  case DIM:                                                                            \
    return (int)(BS % qdec::WT == 0 ? launch_mma<TQ, DIM, true>                        \
                                    : launch_mma<TQ, DIM, false>)(                     \
        q, data, scales, tb, kl, out, part, B, Hq, Hkv, NB, BS, W, layer, scale,        \
        softcap, splits, s);
  switch (D) {
    INT8_CASE(80)
    INT8_CASE(96)
    case 576:
      return (int)launch_wide<TQ>(q, data, scales, tb, kl, out, part, B, Hq, Hkv, D, NB,
                                  BS, W, layer, scale, softcap, splits, s);
    default:
      break;
  }
  // bf16 / f16 q at whole 64-dim units: the tensor-core body; f32 q the CUDA cores'
  if constexpr (std::is_same<TQ, float>::value) {
    switch (D) {
      INT8_CASE(64)
      INT8_CASE(128)
      INT8_CASE(192)
      INT8_CASE(256)
      default:
        break;
    }
  } else {
    switch (D) {
      MMA_CASE(64)
      MMA_CASE(128)
      MMA_CASE(192)
      MMA_CASE(256)
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef INT8_CASE
#undef MMA_CASE
}

}  // namespace

// q [B,Hq,D] of dtype 0 bf16, 1 f16 or 2 f32; data [L,NB,2,BS,Hkv*D] int8; scales
// [L,NB,2,BS,Hkv] f32; tables [B,W] i32; kv_lens [B] i32; out [B,Hq,D] in q's dtype;
// all contiguous.  D in {64, 80, 96, 128, 192, 256} (the narrow kernels) or 576 (the
// wide one).  softcap <= 0 disables it.  splits: the split of each row's W pages over
// blocks (1 for none), with part f32 [B, splits, Hq, D + 2] scratch when it is above 1;
// a split launch is followed by the combine.  Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int paged_decode_int8(const void* q, const void* data, const void* scales,
                                 const void* tables, const void* kv_lens, void* out,
                                 void* part, int dtype, int B, int Hq, int Hkv, int D,
                                 int NB, int BS, int W, int layer, float scale,
                                 float softcap, int splits, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  float* pt = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return by_dim<__nv_bfloat16>(q, data, scales, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS,
                                   W, layer, scale, softcap, splits, s);
    case 1:
      return by_dim<__half>(q, data, scales, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS, W,
                            layer, scale, softcap, splits, s);
    case 2:
      return by_dim<float>(q, data, scales, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS, W,
                           layer, scale, softcap, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
