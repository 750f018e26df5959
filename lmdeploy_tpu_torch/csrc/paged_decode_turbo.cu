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
// Design.  Each row's pages are split over blocks (grid (kv heads x head blocks, B,
// splits); the split is the wrapper's, a function of W and BS alone): each block with
// pages writes its unnormalized (acc, m, l) in the rotated domain, and a second kernel
// of decode_split.cuh combines a row's splits in a fixed order (no atomics).  One
// split writes the output itself.
//   * Tensor-core (bf16 / f16 q; quant_decode.cuh): a block of 4 warps takes up to 8
//     query heads of a kv head.  Its pages stream through a 3-stage ring of 64-token
//     sub-chunks (the head's [64, D / 2] K bytes, [64, D / 4] V bytes and the 64 mse,
//     qjl and V norms) with cp.async: two sub-chunks are in flight while one is
//     computed.  Each warp copies and owns 16 rows of every sub-chunk, waits only for
//     its own copies (no block barrier in the loop) and keeps its own online softmax.
//     Each code is decoded once for the whole group, straight into an mma.sync
//     m16n8k16 operand.  Scores: q in its own type against the codebook C3 (sigma
//     factored out) as T hi + lo, selected by byte permutes from register tables, and
//     against the QJL signs +-1 (exact): s = (scale * sigma * (q . C3) + scale * qjl *
//     (q . sgn)) * mse in f32.  P.V: C2 is antisymmetric, so C2[c] = A1 * s1 + A0 * s0
//     with s1, s0 = +-1 the code's two bits (A1 = (C2[3] + C2[2]) / 2, A0 = (C2[3] -
//     C2[2]) / 2); O^T += S1^T (A1 sigma P')^T + S0^T (A0 sigma P')^T with P' = p *
//     vnorm as bf16 hi + lo.  So the function is the f32 loop's up to rounding.  A
//     block whose split holds no page writes nothing: the combine reads a row's
//     non-empty splits only.
//   * CUDA-core (f32 q): one block per (kv head, batch row, split).
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

#include <type_traits>

#include "attn_mma.cuh"
#include "attn_types.cuh"
#include "decode_split.cuh"
#include "quant_decode.cuh"

namespace {

using attn::MASK_VALUE;

constexpr int NT = 128;
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
                          float* __restrict__ part,  // [B, S, Hq, D + 2] or null
                          int Hq, int Hkv, int NB, int BS, int W, int layer,
                          float scale, float softcap, float sigma, int split_pages) {
  constexpr int KB = D / 2;       // K code bytes per head row
  constexpr int VB = D / 4;       // V code bytes per head row
  constexpr int KSTR = KB + 16;   // padded K rows: conflict-free 16-byte row reads
  constexpr int KCH = KB / 16;    // 16-byte chunks per head row
  constexpr int VCH = VB / 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
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
  const int p_lo = sp * split_pages;
  const int p_hi = min(min((len + BS - 1) / BS, W), p_lo + split_pages);
  const long long page_bytes = (long long)BS * RB;
  for (int p = p_lo; p < p_hi; ++p) {
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

  if (S == 1) {
    TQ* orow = out + ((long long)b * Hq + (long long)h * G) * D;
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      const int d = i - g * D;
      const float l = ls[g];
      const float o = os[((g / CW) * D + d) * CW + g % CW];
      orow[i] = attn::from_f<TQ>(len > 0 ? o / (l == 0.f ? 1.f : l) : 0.f);
    }
    return;
  }
  // this split's unnormalized (acc, m, l); an empty split's (0, MASK_VALUE, 0)
  for (int i = tid; i < G * (D + 2); i += NT) {
    const int g = i / (D + 2);
    const int d = i - g * (D + 2);
    const float v = d < D ? os[((g / CW) * D + d) * CW + g % CW] : (d == D ? ms[g] : ls[g]);
    part[(((long long)b * S + sp) * Hq + h * G + g) * (D + 2) + d] = v;
  }
}

// ------------------------------------------------------- tensor-core kernel
// one ring stage: the K rows [TC][D / 2 + 16] and V rows [TC][VS] bytes (padded:
// conflict-free fragment loads), then mse, qjl, vnorm [3][TC] f32
template <int D>
struct Stage {
  static constexpr int KS = D / 2 + 16;
  static constexpr int VS = D / 4 + (D == 64 ? 0 : 16);
  static constexpr int V = qdec::TC * KS;
  static constexpr int M = V + qdec::TC * VS;
  static constexpr int BYTES = M + 3 * qdec::TC * 4;
};

// the ring, whose smem the tail takes after it
template <int D>
__host__ __device__ constexpr int mma_smem() {
  return qdec::NST * Stage<D>::BYTES > qdec::tail_bytes<D>() ? qdec::NST * Stage<D>::BYTES
                                                              : qdec::tail_bytes<D>();
}

template <typename T>
__device__ __forceinline__ uint32_t bits16(float x);
template <>
__device__ __forceinline__ uint32_t bits16<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ uint32_t bits16<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

template <typename T>
__device__ __forceinline__ float from_bits16(uint32_t b) {
  if constexpr (std::is_same<T, __half>::value) return __half2float(__ushort_as_half(b));
  else return __uint_as_float(b << 16);
}

// an 8-entry table of T values as the low bytes (lo[0]: entries 0-3, lo[1]: 4-7) and
// the high bytes of its entries, for byte-permute selection by a 3-bit index
struct Table8 {
  uint32_t lo[2] = {0u, 0u}, hi[2] = {0u, 0u};
  __device__ void set(int k, uint32_t v) {
    lo[k >> 2] |= (v & 0xFFu) << (8 * (k & 3));
    hi[k >> 2] |= (v >> 8) << (8 * (k & 3));
  }
  // sel's four 3-bit fields (a, b, c, d) -> T pairs (entry a, entry c), (b, d)
  __device__ __forceinline__ void pairs(uint32_t sel, uint32_t& p0, uint32_t& p1) const {
    const uint32_t rl = qdec::prmt(lo[0], lo[1], sel), rh = qdec::prmt(hi[0], hi[1], sel);
    p0 = qdec::prmt(rl, rh, 0x6240);
    p1 = qdec::prmt(rl, rh, 0x7351);
  }
};

template <typename T, int D, bool ONE_PAGE>
__global__ void __launch_bounds__(qdec::NT, qdec::min_blocks<D>())
paged_decode_turbo_mma(const T* __restrict__ q,                 // [B, Hq, D] rotated
                       const uint8_t* __restrict__ data,         // [L, NB, BS, 3*Hkv*D/4]
                       const float* __restrict__ meta,           // [L, NB, BS, 3, Hkv]
                       const int* __restrict__ tables,           // [B, W]
                       const int* __restrict__ kv_lens,          // [B]
                       T* __restrict__ out,                      // [B, Hq, D]
                       float* __restrict__ part,                 // [B, S, Hq, D + 2] or null
                       int Hq, int Hkv, int NB, int BS, int W, int layer,
                       float scale, float softcap, float sigma, int split_pages) {
  using namespace qdec;
  using St = Stage<D>;
  constexpr int KB = D / 2;           // K code bytes a head row
  constexpr int VB = D / 4;           // V code bytes a head row
  constexpr int KS = St::KS;
  constexpr int VS = St::VS;
  constexpr int KCH = KB / 16;
  constexpr int VCH = VB / 16;
  extern __shared__ __align__(16) uint8_t mma_raw[];

  const int G = Hq / Hkv;
  const int hsplits = (G + GQ - 1) / GQ;
  const int h = blockIdx.x / hsplits;
  const int g0 = (blockIdx.x - h * hsplits) * GQ;
  const int gb = min(GQ, G - g0);
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int hq0 = h * G + g0;
  const long long head0 = (long long)b * Hq + hq0;
  const int len = kv_lens[b];
  const Span span(len, 0, BS, W, sp, split_pages);
  if (span.empty()) {
    empty_split(out, head0, gb, D, S);
    return;
  }

  uint32_t qa[D / 16][2];
  q_fragments<T, D>(gid < gb ? q + (head0 + gid) * D : nullptr, tig, qa);
  // C3 (sigma factored out) as T hi + lo
  Table8 chi, clo;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t hb = bits16<T>(C3[k]);
    chi.set(k, hb);
    clo.set(k, bits16<T>(C3[k] - from_bits16<T>(hb)));
  }
  const float scs = scale * sigma;
  // C2 = a1 * s1 + a0 * s0 (s1, s0 = +-1 from the code's high and low bit), sigma in
  const float a1 = 0.5f * (C2[3] + C2[2]) * sigma, a0 = 0.5f * (C2[3] - C2[2]) * sigma;

  const int RB = 3 * Hkv * VB;        // bytes a token row
  auto load = [&](int j, int st) {
    // the warp's own rows; rows past the split's positions read as zeros
    const int r0 = span.row0(j, warp);
    const int hi = span.hi(r0);
    const WarpRows<ONE_PAGE> rows(tables + (long long)b * W, r0, BS, NB, layer, hi > 0);
    auto token_row = [&](int t) {        // row t's index in [L * NB * BS]
      const Slot s = rows(t);
      return s.page * BS + s.row;
    };
    uint8_t* stage = mma_raw + st * St::BYTES;
    for (int x = lane; x < WT * (KCH + VCH); x += 32) {   // the warp's own rows
      const bool kpart = x < WT * KCH;
      const int y = kpart ? x : x - WT * KCH;
      const int ch = kpart ? KCH : VCH;
      const int t = y / ch;
      const int c = y % ch;
      const bool in = t < hi;
      const long long off = in ? token_row(t) * RB + c * 16 : 0;
      if (kpart) cp_async16(stage + (warp * WT + t) * KS + c * 16, data + off + h * KB, in);
      else cp_async16(stage + St::V + (warp * WT + t) * VS + c * 16,
                      data + off + Hkv * KB + h * VB, in);
    }
    float* ms = reinterpret_cast<float*>(stage + St::M);
    for (int x = lane; x < 3 * WT; x += 32) {
      const int a = x / WT;              // mse, qjl, vnorm
      const int t = x % WT;
      const bool in = t < hi;
      const long long off = in ? (token_row(t) * 3 + a) * Hkv + h : 0;
      cp_async4(ms + a * TC + warp * WT + t, meta + off, in);
    }
    cp_commit();
  };

  float m = MASK_VALUE, l = 0.f;      // head gid; l: this lane's share
  float o[D / 64][4][4];
#pragma unroll
  for (int u = 0; u < D / 64; ++u)
#pragma unroll
    for (int n = 0; n < 4; ++n) o[u][n][0] = o[u][n][1] = o[u][n][2] = o[u][n][3] = 0.f;

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (span.j_lo + st < span.j_hi) load(span.j_lo + st, st);
    else cp_commit();
  }
  for (int i = span.j_lo; i < span.j_hi; ++i) {
    cp_wait<NST - 2>();
    // the warp's rows of sub-chunk i have landed for all its lanes, and the warp is
    // done with its rows of i - 1, whose stage takes i + NST - 1 now: each warp copies
    // and reads only its own rows, so no block barrier
    __syncwarp();
    const int nx = i + NST - 1;
    if (nx < span.j_hi) load(nx, (nx - span.j_lo) % NST);
    else cp_commit();
    // the warp's rows below hi are positions of the split; a warp with none computes on
    // masked zero rows, which add nothing once its m is real (the tail weighs a warp
    // whose m never was by 0)
    const int hi = span.hi(span.row0(i, warp));
    const uint8_t* stage = mma_raw + ((i - span.j_lo) % NST) * St::BYTES;
    const float* ms = reinterpret_cast<const float*>(stage + St::M);
    const int wt = warp * WT;         // the warp's first row of the sub-chunk

    // q . C3 (hi + lo into one accumulator) and q . sgn over the warp's two 8-token
    // tiles, each K code decoded once
    float sc[2][4], ss[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      ss[j][0] = ss[j][1] = ss[j][2] = ss[j][3] = 0.f;
      const uint8_t* kr = stage + (wt + 8 * j + gid) * KS + 4 * tig;
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + 16 * jj);
        // the codebook index fields of nibbles (0, 1, 4, 5) and (2, 3, 6, 7)
        const uint32_t sa = prmt(w, 0u, 0x0020) & 0x7777u;
        const uint32_t sb = prmt(w, 0u, 0x0031) & 0x7777u;
        const uint32_t a0[4] = {qa[2 * jj][0], 0u, qa[2 * jj][1], 0u};
        const uint32_t a1[4] = {qa[2 * jj + 1][0], 0u, qa[2 * jj + 1][1], 0u};
        uint32_t b0, b1;
        chi.pairs(sa, b0, b1);
        attn::Mma<T>::run(sc[j], a0, b0, b1);
        clo.pairs(sa, b0, b1);
        attn::Mma<T>::run(sc[j], a0, b0, b1);
        attn::Mma<T>::run(ss[j], a0, sign2<T>(w << 12), sign2<T>(w << 8));
        chi.pairs(sb, b0, b1);
        attn::Mma<T>::run(sc[j], a1, b0, b1);
        clo.pairs(sb, b0, b1);
        attn::Mma<T>::run(sc[j], a1, b0, b1);
        attn::Mma<T>::run(ss[j], a1, sign2<T>(w << 4), sign2<T>(w));
      }
    }
    // s = (scale sigma (q . C3) + scale qjl (q . sgn)) * mse; softcap; mask by len
    float mx = MASK_VALUE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = wt + 8 * j + 2 * tig;
      const float2 mse = *reinterpret_cast<const float2*>(ms + t);
      const float2 qjl = *reinterpret_cast<const float2*>(ms + TC + t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = (scs * sc[j][e] + scale * (e ? qjl.y : qjl.x) * ss[j][e]) * (e ? mse.y : mse.x);
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = t - wt + e < hi ? x : MASK_VALUE;
        sc[j][e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = attn::quad_max(mx);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
    // P' = p * vnorm times a1 and a0, hi and lo: P.V's B fragments
    uint32_t p1h[2], p1l[2], p0h[2], p0l[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = wt + 8 * j + 2 * tig;
      const float2 vn = *reinterpret_cast<const float2*>(ms + 2 * TC + t);
      const float p0 = expf(sc[j][0] - m_new), p1 = expf(sc[j][1] - m_new);
      l += p0 + p1;                                    // l sums the unscaled p
      const float v0 = p0 * vn.x, v1 = p1 * vn.y;
      split_bf16(a1 * v0, a1 * v1, p1h[j], p1l[j]);
      split_bf16(a0 * v0, a0 * v1, p0h[j], p0l[j]);
    }
    // O^T's columns are heads 2 tig and 2 tig + 1: their alphas from lanes 8 tig (+4)
    const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * tig);
    const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);
#pragma unroll
    for (int u = 0; u < D / 64; ++u)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[u][n][0] *= al0;
        o[u][n][1] *= al1;
        o[u][n][2] *= al0;
        o[u][n][3] *= al1;
      }

    // O^T += V^T P'^T: the warp's tokens 2 tig, 2 tig + 1 (+8), halfwords gid + 8 u (8
    // codes each: code k's bits 2k, 2k + 1 give s0, s1 of dim 8 (gid + 8u) + k)
    const uint8_t* vr = stage + St::V + (wt + 2 * tig) * VS + 2 * gid;
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      const uint32_t x1 = *reinterpret_cast<const uint16_t*>(vr + 16 * u);
      const uint32_t x2 = *reinterpret_cast<const uint16_t*>(vr + VS + 16 * u);
      const uint32_t x3 = *reinterpret_cast<const uint16_t*>(vr + 8 * VS + 16 * u);
      const uint32_t x4 = *reinterpret_cast<const uint16_t*>(vr + 9 * VS + 16 * u);
      const uint32_t z12 = x1 | (x2 << 16), z34 = x3 | (x4 << 16);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // rows gid and gid + 8: codes n and n + 4; bit 2k (s0) or 2k + 1 (s1) to bit 15
        const uint32_t s1[4] = {sign2<__nv_bfloat16>(z12 << (14 - 2 * n)),
                                sign2<__nv_bfloat16>(z12 << (6 - 2 * n)),
                                sign2<__nv_bfloat16>(z34 << (14 - 2 * n)),
                                sign2<__nv_bfloat16>(z34 << (6 - 2 * n))};
        const uint32_t s0[4] = {sign2<__nv_bfloat16>(z12 << (15 - 2 * n)),
                                sign2<__nv_bfloat16>(z12 << (7 - 2 * n)),
                                sign2<__nv_bfloat16>(z34 << (15 - 2 * n)),
                                sign2<__nv_bfloat16>(z34 << (7 - 2 * n))};
        float* c = o[u][n];
        attn::Mma<__nv_bfloat16>::run(c, s1, p1h[0], p1h[1]);
        attn::Mma<__nv_bfloat16>::run(c, s1, p1l[0], p1l[1]);
        attn::Mma<__nv_bfloat16>::run(c, s0, p0h[0], p0h[1]);
        attn::Mma<__nv_bfloat16>::run(c, s0, p0l[0], p0l[1]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                    // the ring's smem takes the tail's
  block_tail<T, D>(o, m, l, 0.f, reinterpret_cast<float*>(mma_raw), out, part, head0, hq0, gb,
                   b, S, sp, Hq);
}

// the second pass of a launch of more than one split
template <typename TQ>
cudaError_t combine(float* part, const int* kv_lens, void* out, int B, int Hq, int D,
                    int splits, int BS, int W, int split_pages, cudaStream_t stream) {
  attn::decode_split_combine_rows<TQ><<<dim3(Hq, B), 128, 2 * splits * sizeof(float),
                                        stream>>>(part, kv_lens, static_cast<TQ*>(out), Hq,
                                                  D, splits, BS, W, split_pages);
  return cudaGetLastError();
}

template <typename TQ, int D, int CW>
cudaError_t launch(const void* q, const void* data, const void* meta, const int* tables,
                   const int* kv_lens, void* out, float* part, int B, int Hq, int Hkv, int NB,
                   int BS, int W, int layer, float scale, float softcap, float sigma,
                   int splits, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D, CW>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_turbo_kernel<TQ, D, CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_turbo_kernel<TQ, D, CW><<<dim3(Hkv, B, splits), NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const uint8_t*>(data),
      static_cast<const float*>(meta), tables, kv_lens, static_cast<TQ*>(out), part,
      Hq, Hkv, NB, BS, W, layer, scale, softcap, sigma, split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine<TQ>(part, kv_lens, out, B, Hq, D, splits, BS, W, split_pages, stream);
}

template <typename T, int D, bool ONE_PAGE>
cudaError_t launch_mma(const void* q, const void* data, const void* meta, const int* tables,
                       const int* kv_lens, void* out, float* part, int B, int Hq, int Hkv,
                       int NB, int BS, int W, int layer, float scale, float softcap,
                       float sigma, int splits, cudaStream_t stream) {
  constexpr int bytes = mma_smem<D>();
  static cudaError_t configured = cudaFuncSetAttribute(
      paged_decode_turbo_mma<T, D, ONE_PAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (configured != cudaSuccess) return configured;
  const int hsplits = (Hq / Hkv + qdec::GQ - 1) / qdec::GQ;
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_turbo_mma<T, D, ONE_PAGE><<<dim3(Hkv * hsplits, B, splits), qdec::NT, bytes,
                                           stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(data),
      static_cast<const float*>(meta), tables, kv_lens, static_cast<T*>(out), part, Hq, Hkv,
      NB, BS, W, layer, scale, softcap, sigma, split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine<T>(part, kv_lens, out, B, Hq, D, splits, BS, W, split_pages, stream);
}

template <typename TQ, int D>
cudaError_t launch_g(const void* q, const void* data, const void* meta, const int* tables,
                     const int* kv_lens, void* out, float* part, int B, int Hq, int Hkv,
                     int NB, int BS, int W, int layer, float scale, float softcap,
                     float sigma, int splits, cudaStream_t stream) {
  if constexpr (!std::is_same<TQ, float>::value) {   // bf16 / f16 q: the tensor cores
    return (BS % qdec::WT == 0 ? launch_mma<TQ, D, true> : launch_mma<TQ, D, false>)(
        q, data, meta, tables, kv_lens, out, part, B, Hq, Hkv, NB, BS, W, layer, scale,
        softcap, sigma, splits, stream);
  } else if (Hq == Hkv) {   // one query head a group: no chunk padding
    return launch<TQ, D, 1>(q, data, meta, tables, kv_lens, out, part, B, Hq, Hkv, NB, BS, W,
                            layer, scale, softcap, sigma, splits, stream);
  } else {
    return launch<TQ, D, 4>(q, data, meta, tables, kv_lens, out, part, B, Hq, Hkv, NB, BS, W,
                            layer, scale, softcap, sigma, splits, stream);
  }
}

template <typename TQ>
int by_dim(const void* q, const void* data, const void* meta, const int* tb,
           const int* kl, void* out, float* part, int B, int Hq, int Hkv, int D, int NB,
           int BS, int W, int layer, float scale, float softcap, float sigma, int splits,
           cudaStream_t s) {
  if (splits <= 0 || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return (int)launch_g<TQ, 64>(q, data, meta, tb, kl, out, part, B, Hq, Hkv, NB, BS, W,
                                   layer, scale, softcap, sigma, splits, s);
    case 128:
      return (int)launch_g<TQ, 128>(q, data, meta, tb, kl, out, part, B, Hq, Hkv, NB, BS, W,
                                    layer, scale, softcap, sigma, splits, s);
    case 256:
      return (int)launch_g<TQ, 256>(q, data, meta, tb, kl, out, part, B, Hq, Hkv, NB, BS, W,
                                    layer, scale, softcap, sigma, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Hq,D] (rotated) of dtype 0 bf16, 1 f16 or 2 f32; data [L,NB,BS,3*Hkv*D/4] u8;
// meta [L,NB,BS,3,Hkv] f32; tables [B,W] i32; kv_lens [B] i32; out [B,Hq,D] in q's
// dtype (rotated domain); all contiguous.  D in {64, 128, 256} (the cache needs a
// power of two).  softcap <= 0 disables it; sigma = f32(1 / sqrt(D)).  splits: the
// split of each row's W pages over blocks (1 for none), with part f32 [B, splits, Hq,
// D + 2] scratch when it is above 1; a split launch is followed by the combine.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int paged_decode_turbo(const void* q, const void* data, const void* meta,
                                  const void* tables, const void* kv_lens, void* out,
                                  void* part, int dtype, int B, int Hq, int Hkv, int D,
                                  int NB, int BS, int W, int layer, float scale,
                                  float softcap, float sigma, int splits, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  float* pt = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return by_dim<__nv_bfloat16>(q, data, meta, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS, W,
                                   layer, scale, softcap, sigma, splits, s);
    case 1:
      return by_dim<__half>(q, data, meta, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS, W, layer,
                            scale, softcap, sigma, splits, s);
    case 2:
      return by_dim<float>(q, data, meta, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS, W, layer,
                           scale, softcap, sigma, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
