// T = 1 attention over a paged bf16 or fp8-e4m3 KV cache, for Hopper (sm_90a).
//
// Replaces the plain branch of the TPU kernel lmdeploy_tpu/ops/pallas/paged_decode.py
// (paged_decode_attention, body _decode_kernel), which serves bf16 pages and, with
// quant_policy 16, fp8-e4m3 pages.  Same function, same edge cases:
//   * kv_lens[b] counts the token just filled; 0 marks an inactive row, whose
//     output is 0 (never NaN);
//   * a sliding window keeps positions pos >= max(len - window, 0) when window > 0;
//   * the logit softcap is tanh(s / c) * c, applied after the scale;
//   * sink logits add exp(sink - m) to the softmax denominator only while the
//     row max m is above 0.5 * MASK_VALUE;
//   * MASK_VALUE = -0.7 * FLT_MAX for masked scores, not -inf.
//
// Cache layout: [L, NB, 2, BS, Hkv * D] bf16 or e4m3 -- each page holds a K plane and
// a V plane of head-major token rows (the reference layout without its 128-lane
// padding).  Block 0 is the padding block; tables [B, W] i32 map a row's page
// index to its block.  The element type is a template parameter: e4m3 widens to f32
// on load (through fp16, exactly), and everything else is the bf16 kernel's.  P stays
// f32 for the P.V product with either type: the TPU kernel's rounding of P to the
// page type (pr.astype(v.dtype), e4m3 there) is not copied.
//
// What bounds it on an H100: bytes of K/V read.  At bs 64 with ~384 tokens a row,
// TinyLlama's bf16 K+V is 1 KiB per token per layer, 25 MB per layer: ~7.5 us at
// 3.35 TB/s, against ~0.1 MFLOP of arithmetic per row and head.  An e4m3 page is half
// the bytes: 2,048 per token at Llama-3.1-8B (Hkv 8, D 128).
//
// Design (simple and right first; a split over pages, TMA and a pipelined page
// walk are later work):
//   * One block per (kv head, batch row) walks the row's pages from the window
//     start to its length.
//   * The G query heads of the GQA group share every K/V page the block loads, so
//     each byte of the row's K/V for this head is read from device memory once.
//   * Per page: the head's [BS, D] slice of the K plane and of the V plane goes to
//     shared memory with 16-byte coalesced loads; scores with one thread per token
//     against the f32 query rows; online softmax per query head in f32 (warp
//     reductions over the page); P.V with one thread per (head, column) and the
//     accumulator in shared memory, so any G and D in {64, 128} fit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

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

// the page element types: bf16 and e4m3 (its raw byte)
using fp8_t = __nv_fp8_storage_t;

// elements 2j, 2j+1 of a row held as 32-bit words, widened to f32 (a bf16 is the
// high half of its f32)
__device__ __forceinline__ float2 pair_f2(const uint32_t* w, int j, __nv_bfloat16) {
  return make_float2(__uint_as_float(w[j] << 16), __uint_as_float(w[j] & 0xFFFF0000u));
}

__device__ __forceinline__ float2 pair_f2(const uint32_t* w, int j, fp8_t) {
  const __nv_fp8x2_storage_t x2 = static_cast<__nv_fp8x2_storage_t>(w[j >> 1] >> ((j & 1) * 16));
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(x2, __NV_E4M3)));
}

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float to_f(fp8_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

__host__ __device__ inline int float_words(int G, int D, int BS) {
  // qs [G][D] + os [G][D] + ps [G][BS] + m, l, alpha [G], rounded to 16 bytes
  return (2 * G * D + G * BS + 3 * G + 3) & ~3;
}

template <typename T, int D>
size_t smem_bytes(int G, int BS) {
  return (size_t)float_words(G, D, BS) * sizeof(float)
       + (size_t)BS * (D + 16 / sizeof(T)) * sizeof(T)     // K slice, padded rows
       + (size_t)BS * D * sizeof(T);                       // V slice
}

// the finished output of one query head from its (acc, m, l), sinks applied
__device__ __forceinline__ float finish(float acc, float m, float l,
                                        const float* sinks, int h) {
  if (sinks != nullptr && m > 0.5f * MASK_VALUE) l += expf(sinks[h] - m);
  return acc / (l == 0.f ? 1.f : l);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hq, D]
                    const T* __restrict__ cache,              // [L, NB, 2, BS, Hkv*D]
                    const int* __restrict__ tables,           // [B, W]
                    const int* __restrict__ kv_lens,          // [B]
                    const float* __restrict__ sinks,          // [Hq] or null
                    __nv_bfloat16* __restrict__ out,          // [B, Hq, D]
                    int Hq, int Hkv, int NB, int BS, int W, int layer,
                    float scale, float softcap, int window) {
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
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
  T* ks = reinterpret_cast<T*>(smem + float_words(G, D, BS));
  T* vs = ks + BS * KSTR;

  const __nv_bfloat16* qrow = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    qs[i] = __bfloat162float(qrow[i]);
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
      const T* kpage = cache + ((long long)layer * NB + blk) * 2 * plane + (long long)h * D;
      const T* vpage = kpage + plane;
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
            const float2 ka = pair_f2(kr, d / 2, T());
            const float2 kb = pair_f2(kr, d / 2 + 1, T());
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
        for (int t = 0; t < BS; ++t) acc = fmaf(prow[t], to_f(vs[t * D + d]), acc);
        os[i] = acc;
      }
      __syncthreads();
    }
  }

  __nv_bfloat16* orow = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    orow[i] = __float2bfloat16(finish(os[i], ms[g], ls[g], sinks, h * G + g));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* cache, const int* tables, const int* kv_lens,
                   const float* sinks, void* out, int B, int Hq, int Hkv, int NB, int BS,
                   int W, int layer, float scale, float softcap, int window,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, D>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  paged_decode_kernel<T, D><<<dim3(Hkv, B), NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(cache),
      tables, kv_lens, sinks, static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, NB, BS, W, layer, scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* cache, const void* tables, const void* kv_lens,
             const void* sinks, void* out, int B, int Hq, int Hkv, int D, int NB, int BS,
             int W, int layer, float scale, float softcap, int window, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  const float* sk = static_cast<const float*>(sinks);
  switch (D) {
    case 64:
      return (int)launch<T, 64>(q, cache, tb, kl, sk, out, B, Hq, Hkv, NB, BS, W, layer,
                                scale, softcap, window, s);
    case 128:
      return (int)launch<T, 128>(q, cache, tb, kl, sk, out, B, Hq, Hkv, NB, BS, W, layer,
                                 scale, softcap, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Hq,D] bf16 contiguous; cache [L,NB,2,BS,Hkv*D] bf16 (paged_decode_bf16) or e4m3
// (paged_decode_fp8) contiguous; tables [B,W] i32; kv_lens [B] i32; sinks [Hq] f32 or
// null; out [B,Hq,D] bf16.  softcap <= 0 and window <= 0 disable those options.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int paged_decode_bf16(const void* q, const void* cache, const void* tables,
                                 const void* kv_lens, const void* sinks, void* out,
                                 int B, int Hq, int Hkv, int D, int NB, int BS, int W,
                                 int layer, float scale, float softcap, int window,
                                 void* stream) {
  return dispatch<__nv_bfloat16>(q, cache, tables, kv_lens, sinks, out, B, Hq, Hkv, D, NB,
                                 BS, W, layer, scale, softcap, window, stream);
}

extern "C" int paged_decode_fp8(const void* q, const void* cache, const void* tables,
                                const void* kv_lens, const void* sinks, void* out,
                                int B, int Hq, int Hkv, int D, int NB, int BS, int W,
                                int layer, float scale, float softcap, int window,
                                void* stream) {
  return dispatch<fp8_t>(q, cache, tables, kv_lens, sinks, out, B, Hq, Hkv, D, NB, BS, W,
                         layer, scale, softcap, window, stream);
}
