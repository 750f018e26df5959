// T = 1 attention over a paged TurboQuant k4v2 KV cache, for Hopper (sm_90a).
//
// Replaces the TurboQuant branch of the TPU kernel lmdeploy_tpu/ops/pallas/
// paged_decode.py (paged_decode_attention, body _decode_kernel_turbo, softmax step
// _softmax_update).  Same function, in the same order:
//   q arrives rotated into the cache's Hadamard domain (the caller rotates it, and
//   rotates the output back, outside the kernel);  qs = q * scale;
//   s = (qs . cent + qjl * (qs . sgn)) * mse, where a K code's low 3 bits index the
//   Lloyd-Max codebook cent = C3 * sigma and bit 3 is the sign sgn = +-1 of the QJL
//   residual;  optional softcap tanh(s / c) * c;  mask by kv_len (MASK_VALUE =
//   -0.7 * FLT_MAX, not -inf);  online softmax in f32 with l summing the unscaled p;
//   acc += (p * vnorm) @ vcent, vcent = C2[v code] * sigma;  out = acc / l (l == 0 -> 1).
// sigma = 1 / sqrt(D) rounded to f32 comes from the wrapper; cent and vcent are the
// f32 products C * sigma, as the reference forms them.  kv_lens[b] counts the token
// just filled; 0 marks an inactive row, whose output is 0.  No window and no sinks:
// the reference never sends those to this kernel.
//
// Cache layout (the port's, ops/kv_quant.py): data u8 [L, NB, BS, 3 * Hkv * D / 4], one
// row per token: K codes in bytes [0, Hkv * D / 2), head h's D / 2 bytes at h * D / 2,
// byte j holding dim 2j in its low nibble and dim 2j+1 in its high one; V codes in
// bytes [Hkv * D / 2, 3 * Hkv * D / 4), head h's D / 4 bytes at Hkv * D / 2 + h * D / 4,
// byte j holding dim 4j + e at bits 2e..2e+1; meta f32 [L, NB, BS, 3, Hkv] = (K mse
// norm, K qjl norm, V norm).  (The reference packs its codes over the whole
// head-major row in two planes, V at K's width; weight_convert maps the two.)  Any
// Hkv: the reference's (Hkv * D) % 256 rule is a TPU lane constraint.
//
// What bounds it on an H100: bytes of K/V read.  Per token and layer:
// Hkv * (D / 2 + D / 4 code bytes + 3 * 4 meta bytes) -- 864 bytes at Llama-3.1-8B
// (Hkv 8, D 128), 21% of the bf16 cache's 4,096.
//
// Design (paged_decode_int8.cu's, with code pages; a split over pages, TMA and
// tensor-core scores are later work):
//   * One block per (kv head, batch row) walks the row's pages up to its length.
//   * The G query heads of the GQA group share every page the block loads.
//   * Per page: the head's [BS, D / 2] K bytes and [BS, D / 4] V bytes go to shared
//     memory with 16-byte loads, the page's BS mse, qjl and V norms of this head
//     beside them; scores with one thread per token (two dot products, codes looked
//     up in a shared 8-entry table); online softmax per query head (warp
//     reductions); P.V with one thread per (chunk of heads, column), accumulator in
//     shared memory.  The query heads go in chunks of 4 (q, P and the accumulator as
//     float4s; chunks of 1 when a group has one head), so each K and V code is decoded
//     once for 4 heads: at a byte or less a weight, decoding per head costs more than
//     the page's bytes (PERF.md, PR 4).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_types.cuh"

namespace {

constexpr int NT = 128;
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;
// Lloyd-Max codebooks at sigma = 1 (lmdeploy_tpu/ops/kv_quant.py LLOYD_C3, LLOYD_C2)
__constant__ float C3[8] = {-2.1519456f, -1.3439093f, -0.7560052f, -0.2450942f,
                            0.2450942f, 0.7560052f, 1.3439093f, 2.1519456f};
__constant__ float C2[4] = {-1.5104176f, -0.4527808f, 0.4527808f, 1.5104176f};

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

// Query heads are taken in chunks of CW (4, or 1 for one head a group; the last chunk
// zero-padded): one code decode serves CW heads, and q, P and the accumulator are
// CW-vectors in shared memory.
template <int CW>
struct Vec {
  float v[CW];
};

template <int CW>
__device__ __forceinline__ Vec<CW> load_vec(const float* p) {
  Vec<CW> r;
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) r.v[j] = p[j];
  }
  return r;
}

template <int CW>
__device__ __forceinline__ void store_vec(float* p, const Vec<CW>& r) {
  if constexpr (CW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) p[j] = r.v[j];
  }
}

template <int CW>
__device__ __forceinline__ void fma_vec(Vec<CW>& acc, const Vec<CW>& a, float b) {
#pragma unroll
  for (int j = 0; j < CW; ++j) acc.v[j] = fmaf(a.v[j], b, acc.v[j]);
}

__host__ __device__ inline int chunks(int G, int CW) { return (G + CW - 1) / CW; }

__host__ __device__ inline int float_words(int G, int D, int BS, int CW) {
  // q [C][D][CW] + o [C][D][CW] + p [C][BS][CW] + m, l, alpha [C*CW] + mse, qjl, vnorm
  // [BS] + cent [8] + vcent [4], rounded to 16 bytes
  const int CC = chunks(G, CW) * CW;
  return (2 * CC * D + CC * BS + 3 * CC + 3 * BS + 12 + 3) & ~3;
}

template <int D, int CW>
size_t smem_bytes(int G, int BS) {
  return (size_t)float_words(G, D, BS, CW) * sizeof(float)
       + (size_t)BS * (D / 2 + 16)      // K slice, 16-byte padded rows
       + (size_t)BS * (D / 4);          // V slice
}

template <typename TQ, int D, int CW>
__global__ void __launch_bounds__(NT)
paged_decode_turbo_kernel(const TQ* __restrict__ q,  // [B, Hq, D] rotated
                          const uint8_t* __restrict__ data,     // [L, NB, BS, 3*Hkv*D/4]
                          const float* __restrict__ meta,       // [L, NB, BS, 3, Hkv]
                          const int* __restrict__ tables,       // [B, W]
                          const int* __restrict__ kv_lens,      // [B]
                          TQ* __restrict__ out,      // [B, Hq, D]
                          int Hq, int Hkv, int NB, int BS, int W, int layer,
                          float scale, float softcap, float sigma) {
  constexpr int KB = D / 2;       // K code bytes per head row
  constexpr int VB = D / 4;       // V code bytes per head row
  constexpr int KSTR = KB + 16;   // padded K rows: conflict-free 16-byte row reads
  constexpr int KCH = KB / 16;    // 16-byte chunks per head row
  constexpr int VCH = VB / 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int C = chunks(G, CW);
  const int RB = 3 * Hkv * D / 4;    // bytes per token row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [C][D][CW]  q * scale
  float* os = qs + C * D * CW;      // [C][D][CW]
  float* ps = os + C * D * CW;      // [C][BS][CW] scores, then p * vnorm
  float* ms = ps + C * BS * CW;     // [C*CW]
  float* ls = ms + C * CW;          // [C*CW]
  float* as = ls + C * CW;          // [C*CW]
  float* mse = as + C * CW;         // [BS]
  float* qjl = mse + BS;            // [BS]
  float* vnm = qjl + BS;            // [BS]
  float* cent = vnm + BS;           // [8]
  float* vcent = cent + 8;          // [4]
  uint8_t* ks = reinterpret_cast<uint8_t*>(smem + float_words(G, D, BS, CW));
  uint8_t* vs = ks + BS * KSTR;

  const TQ* qrow = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < C * D * CW; i += NT) {
    const int c = i / (D * CW);
    const int d = (i / CW) % D;
    const int g = CW * c + i % CW;
    qs[i] = g < G ? attn::to_f(qrow[g * D + d]) * scale : 0.f;
    os[i] = 0.f;
  }
  for (int g = tid; g < C * CW; g += NT) {
    ms[g] = MASK_VALUE;
    ls[g] = 0.f;
    as[g] = 0.f;
  }
  if (tid < 8) cent[tid] = C3[tid] * sigma;
  if (tid < 4) vcent[tid] = C2[tid] * sigma;
  __syncthreads();

  const int len = kv_lens[b];
  const int p_hi = min((len + BS - 1) / BS, W);
  const long long page_bytes = (long long)BS * RB;
  for (int p = 0; p < p_hi; ++p) {
    const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
    const long long page = (long long)layer * NB + blk;
    const uint8_t* krow = data + page * page_bytes + (long long)h * KB;
    const uint8_t* vrow = data + page * page_bytes + (long long)Hkv * KB + (long long)h * VB;
    const float* mrow = meta + page * BS * 3 * Hkv + h;
    for (int i = tid; i < BS * KCH; i += NT) {
      const int t = i / KCH;
      const int c = i - t * KCH;
      *reinterpret_cast<uint4*>(ks + t * KSTR + c * 16) =
          *reinterpret_cast<const uint4*>(krow + (long long)t * RB + c * 16);
    }
    for (int i = tid; i < BS * VCH; i += NT) {
      const int t = i / VCH;
      const int c = i - t * VCH;
      *reinterpret_cast<uint4*>(vs + t * VB + c * 16) =
          *reinterpret_cast<const uint4*>(vrow + (long long)t * RB + c * 16);
    }
    for (int t = tid; t < BS; t += NT) {
      const float* m = mrow + (long long)t * 3 * Hkv;
      mse[t] = m[0];
      qjl[t] = m[Hkv];
      vnm[t] = m[2 * Hkv];
    }
    __syncthreads();

    // scores: one thread per token, each code decoded once for a chunk of CW heads
    for (int t = tid; t < BS; t += NT) {
      const bool valid = p * BS + t < len;
      uint32_t kr[D / 8];
#pragma unroll
      for (int c = 0; c < KCH; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * KSTR + c * 16);
        kr[c * 4 + 0] = raw.x;
        kr[c * 4 + 1] = raw.y;
        kr[c * 4 + 2] = raw.z;
        kr[c * 4 + 3] = raw.w;
      }
      for (int c = 0; c < C; ++c) {
        const float* qc = qs + c * D * CW;
        Vec<CW> s1 = {}, s2 = {};
#pragma unroll
        for (int w = 0; w < D / 8; ++w) {
          const uint32_t k = kr[w];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint32_t code = (k >> (4 * i)) & 0xFu;
            const Vec<CW> qv = load_vec<CW>(qc + (8 * w + i) * CW);
            fma_vec(s1, qv, cent[code & 7u]);
            fma_vec(s2, qv, (code & 8u) ? 1.f : -1.f);
          }
        }
        Vec<CW> o;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          float s = (s1.v[j] + qjl[t] * s2.v[j]) * mse[t];
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          o.v[j] = CW * c + j >= G ? 0.f : (valid ? s : MASK_VALUE);
        }
        store_vec(ps + (c * BS + t) * CW, o);
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      float* prow = ps + (g / CW) * BS * CW + g % CW;
      float mx = MASK_VALUE;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, prow[CW * t]);
      mx = warp_max(mx);
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float e = expf(prow[CW * t] - m_new);
        sum += e;                     // l sums the unscaled p
        prow[CW * t] = e * vnm[t];    // P.V takes p * vnorm
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

    // P.V: one thread per (head chunk, column), each V code decoded once for CW heads
    for (int i = tid; i < C * D; i += NT) {
      const int c = i / D;
      const int d = i - c * D;
      const Vec<CW> al = load_vec<CW>(as + CW * c);
      Vec<CW> acc = load_vec<CW>(os + i * CW);
#pragma unroll
      for (int j = 0; j < CW; ++j) acc.v[j] *= al.v[j];
      const uint8_t* vcol = vs + (d >> 2);
      const int shift = (d & 3) * 2;
      const float* pc = ps + c * BS * CW;
      for (int t = 0; t < BS; ++t)
        fma_vec(acc, load_vec<CW>(pc + t * CW), vcent[(vcol[t * VB] >> shift) & 3]);
      store_vec(os + i * CW, acc);
    }
    __syncthreads();
  }

  TQ* orow = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    const float l = ls[g];
    const float o = os[((g / CW) * D + d) * CW + g % CW];
    orow[i] = attn::from_f<TQ>(len > 0 ? o / (l == 0.f ? 1.f : l) : 0.f);
  }
}

template <typename TQ, int D, int CW>
cudaError_t launch(const void* q, const void* data, const void* meta, const int* tables,
                   const int* kv_lens, void* out, int B, int Hq, int Hkv, int NB, int BS,
                   int W, int layer, float scale, float softcap, float sigma,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<D, CW>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_turbo_kernel<TQ, D, CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  paged_decode_turbo_kernel<TQ, D, CW><<<dim3(Hkv, B), NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const uint8_t*>(data),
      static_cast<const float*>(meta), tables, kv_lens, static_cast<TQ*>(out),
      Hq, Hkv, NB, BS, W, layer, scale, softcap, sigma);
  return cudaGetLastError();
}

template <typename TQ, int D>
cudaError_t launch_g(const void* q, const void* data, const void* meta, const int* tables,
                     const int* kv_lens, void* out, int B, int Hq, int Hkv, int NB, int BS,
                     int W, int layer, float scale, float softcap, float sigma,
                     cudaStream_t stream) {
  if (Hq == Hkv)       // one query head a group: no chunk padding
    return launch<TQ, D, 1>(q, data, meta, tables, kv_lens, out, B, Hq, Hkv, NB, BS, W, layer,
                        scale, softcap, sigma, stream);
  return launch<TQ, D, 4>(q, data, meta, tables, kv_lens, out, B, Hq, Hkv, NB, BS, W, layer,
                      scale, softcap, sigma, stream);
}

template <typename TQ>
int by_dim(const void* q, const void* data, const void* meta, const int* tb,
           const int* kl, void* out, int B, int Hq, int Hkv, int D, int NB, int BS, int W,
           int layer, float scale, float softcap, float sigma, cudaStream_t s) {
  switch (D) {
    case 64:
      return (int)launch_g<TQ, 64>(q, data, meta, tb, kl, out, B, Hq, Hkv, NB, BS, W,
                                   layer, scale, softcap, sigma, s);
    case 128:
      return (int)launch_g<TQ, 128>(q, data, meta, tb, kl, out, B, Hq, Hkv, NB, BS, W,
                                    layer, scale, softcap, sigma, s);
    case 256:
      return (int)launch_g<TQ, 256>(q, data, meta, tb, kl, out, B, Hq, Hkv, NB, BS, W,
                                    layer, scale, softcap, sigma, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Hq,D] (rotated) of dtype 0 bf16, 1 f16 or 2 f32; data [L,NB,BS,3*Hkv*D/4] u8;
// meta [L,NB,BS,3,Hkv] f32; tables [B,W] i32; kv_lens [B] i32; out [B,Hq,D] in q's
// dtype (rotated domain); all contiguous.  D in {64, 128, 256} (the cache needs a
// power of two).  softcap <= 0 disables it; sigma = f32(1 / sqrt(D)).  Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int paged_decode_turbo(const void* q, const void* data, const void* meta,
                                  const void* tables, const void* kv_lens, void* out,
                                  int dtype, int B, int Hq, int Hkv, int D, int NB, int BS,
                                  int W, int layer, float scale, float softcap, float sigma,
                                  void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  switch (dtype) {
    case 0:
      return by_dim<__nv_bfloat16>(q, data, meta, tb, kl, out, B, Hq, Hkv, D, NB, BS, W,
                                   layer, scale, softcap, sigma, s);
    case 1:
      return by_dim<__half>(q, data, meta, tb, kl, out, B, Hq, Hkv, D, NB, BS, W, layer,
                            scale, softcap, sigma, s);
    case 2:
      return by_dim<float>(q, data, meta, tb, kl, out, B, Hq, Hkv, D, NB, BS, W, layer,
                           scale, softcap, sigma, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
