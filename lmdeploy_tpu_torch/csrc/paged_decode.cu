// T = 1 attention over a paged bf16 KV cache, for Hopper (sm_90a).
//
// Replaces the plain branch of the TPU kernel lmdeploy_tpu/ops/pallas/paged_decode.py
// (paged_decode_attention, body _decode_kernel).  Same function, same edge cases:
//   * kv_lens[b] counts the token just filled; 0 marks an inactive row, whose
//     output is 0 (never NaN);
//   * a sliding window keeps positions pos >= max(len - window, 0) when window > 0;
//   * the logit softcap is tanh(s / c) * c, applied after the scale;
//   * sink logits add exp(sink - m) to the softmax denominator only while the
//     row max m is above 0.5 * MASK_VALUE;
//   * MASK_VALUE = -0.7 * FLT_MAX for masked scores, not -inf.
//
// Cache layout: [L, NB, 2, BS, Hkv * D] bf16 -- each page holds a K plane and a V
// plane of head-major token rows (the reference layout without its 128-lane
// padding).  Block 0 is the padding block; tables [B, W] i32 map a row's page
// index to its block.
//
// What bounds it on an H100: bytes of K/V read.  At bs 64 with ~384 tokens a row,
// TinyLlama's K+V is 1 KiB per token per layer, 25 MB per layer: ~7.5 us at
// 3.35 TB/s, against ~0.1 MFLOP of arithmetic per row and head.
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

__host__ __device__ inline int float_words(int G, int D, int BS) {
  // qs [G][D] + os [G][D] + ps [G][BS] + m, l, alpha [G], rounded to 16 bytes
  return (2 * G * D + G * BS + 3 * G + 3) & ~3;
}

template <int D>
size_t smem_bytes(int G, int BS) {
  return (size_t)float_words(G, D, BS) * sizeof(float)
       + (size_t)BS * (D + 8) * sizeof(__nv_bfloat16)      // K slice, padded rows
       + (size_t)BS * D * sizeof(__nv_bfloat16);           // V slice
}

// the finished output of one query head from its (acc, m, l), sinks applied
__device__ __forceinline__ float finish(float acc, float m, float l,
                                        const float* sinks, int h) {
  if (sinks != nullptr && m > 0.5f * MASK_VALUE) l += expf(sinks[h] - m);
  return acc / (l == 0.f ? 1.f : l);
}

template <int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hq, D]
                    const __nv_bfloat16* __restrict__ cache,  // [L, NB, 2, BS, Hkv*D]
                    const int* __restrict__ tables,           // [B, W]
                    const int* __restrict__ kv_lens,          // [B]
                    const float* __restrict__ sinks,          // [Hq] or null
                    __nv_bfloat16* __restrict__ out,          // [B, Hq, D]
                    int Hq, int Hkv, int NB, int BS, int W, int layer,
                    float scale, float softcap, int window) {
  constexpr int KSTR = D + 8;     // 16-byte padded K rows: conflict-free row reads
  constexpr int CH = D / 8;       // 16-byte chunks per head row
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
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + float_words(G, D, BS));
  __nv_bfloat16* vs = ks + BS * KSTR;

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
      const __nv_bfloat16* kpage = cache + ((long long)layer * NB + blk) * 2 * plane + (long long)h * D;
      const __nv_bfloat16* vpage = kpage + plane;
      for (int i = tid; i < BS * CH; i += NT) {
        const int t = i / CH;
        const int c = i - t * CH;
        const uint4 kx = *reinterpret_cast<const uint4*>(kpage + (long long)t * HD + c * 8);
        const uint4 vx = *reinterpret_cast<const uint4*>(vpage + (long long)t * HD + c * 8);
        *reinterpret_cast<uint4*>(ks + t * KSTR + c * 8) = kx;
        *reinterpret_cast<uint4*>(vs + t * D + c * 8) = vx;
      }
      __syncthreads();

      for (int t = tid; t < BS; t += NT) {
        const int pos = p * BS + t;
        const bool valid = pos < len && pos >= ws;
        __nv_bfloat162 kr[D / 2];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * KSTR + c * 8);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) kr[c * 4 + e] = k2[e];
        }
        for (int g = 0; g < G; ++g) {
          const float* qg = qs + g * D;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + d);
            const float2 ka = __bfloat1622float2(kr[d / 2]);
            const float2 kb = __bfloat1622float2(kr[d / 2 + 1]);
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
        for (int t = 0; t < BS; ++t) acc = fmaf(prow[t], __bfloat162float(vs[t * D + d]), acc);
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

template <int D>
cudaError_t launch(const void* q, const void* cache, const int* tables, const int* kv_lens,
                   const float* sinks, void* out, int B, int Hq, int Hkv, int NB, int BS,
                   int W, int layer, float scale, float softcap, int window,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  paged_decode_kernel<D><<<dim3(Hkv, B), NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache),
      tables, kv_lens, sinks, static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, NB, BS, W, layer, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// q [B,Hq,D] bf16 contiguous; cache [L,NB,2,BS,Hkv*D] bf16 contiguous; tables [B,W] i32;
// kv_lens [B] i32; sinks [Hq] f32 or null; out [B,Hq,D] bf16.  softcap <= 0 and
// window <= 0 disable those options.  Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int paged_decode_bf16(const void* q, const void* cache, const void* tables,
                                 const void* kv_lens, const void* sinks, void* out,
                                 int B, int Hq, int Hkv, int D, int NB, int BS, int W,
                                 int layer, float scale, float softcap, int window,
                                 void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  const float* sk = static_cast<const float*>(sinks);
  switch (D) {
    case 64:
      return (int)launch<64>(q, cache, tb, kl, sk, out, B, Hq, Hkv, NB, BS, W, layer,
                             scale, softcap, window, s);
    case 128:
      return (int)launch<128>(q, cache, tb, kl, sk, out, B, Hq, Hkv, NB, BS, W, layer,
                              scale, softcap, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
