// T = 1 attention over a paged int4 KV cache, for Hopper (sm_90a).
//
// Replaces the int4 branch of the TPU kernel lmdeploy_tpu/ops/pallas/paged_decode.py
// (paged_decode_attention, body _decode_kernel_quant4, softmax step _softmax_update).
// Same function, in the same order:
//   qs = q * scale;  s = (qs . k_q) * ksc + (sum_d qs) * kmin, the sum over the head's
//   own D dims (what the reference's zero-padded block-diagonal q gives);  optional
//   softcap tanh(s / c) * c;  mask by kv_len (MASK_VALUE = -0.7 * FLT_MAX, not -inf);
//   online softmax in f32 with l summing the unscaled p;
//   acc += (p * vsc) @ v_q + rowsum(p * vmin);  out = acc / l  (l == 0 -> 1).
// k_q, v_q are the 4-bit codes 0..15, unpacked with integer ops.  kv_lens[b] counts
// the token just filled; 0 marks an inactive row, whose output is 0.  No window and
// no sinks: the reference never sends those to this kernel.
//
// Cache layout (the port's, ops/kv_quant.py): data u8 [L, NB, 2, BS, Hkv * D / 2] -- a
// K plane and a V plane per page, byte j of a token's head-major row holding dim 2j
// in its low nibble and dim 2j+1 in its high one, so a head's D / 2 bytes are
// contiguous and every token owns its bytes; scale and minv f32 [L, NB, 2, BS, Hkv],
// token-major.  (The reference packs token pairs into one byte row and keeps
// de-interleaved head-major scales, shapes Mosaic forced; weight_convert maps the two.)
// Block 0 is the padding block; tables [B, W] i32 map a row's page index to its block.
//
// What bounds it on an H100: bytes of K/V read.  Per token and layer:
// Hkv * (2 * D / 2 code bytes + 4 * 4 scale and min bytes) -- 1,152 bytes at
// Llama-3.1-8B (Hkv 8, D 128), 28% of the bf16 cache's 4,096.
//
// Design.  Every path splits each row's pages over blocks (grid (kv heads x head
// blocks, B, splits); the split is the wrapper's, a function of W and BS alone): each
// block with pages writes its unnormalized (acc, m, l), and a second kernel of
// decode_split.cuh combines a row's splits in a fixed order (no atomics).  One split
// writes the output itself.
//   * Tensor-core narrow (bf16 / f16 q, D = 64, 128, 192, 256; quant_decode.cuh): a
//     block of 4 warps takes up to 8 query heads of a kv head.  Its pages stream
//     through a 3-stage ring of 64-token sub-chunks (the [64, D / 2] byte slices of
//     the K and V planes and the 64 K / V scales and mins) with cp.async: two
//     sub-chunks are in flight while one is computed.  Each warp copies and owns 16
//     rows of every sub-chunk, waits only for its own copies (no block barrier in the
//     loop) and keeps its own online softmax.  S = Q K^T on mma.sync m16n8k16: each K
//     code is decoded once for the whole group, straight into the B fragment (2^k |
//     code as a 16-bit float, minus 2^k: exact), against q in its own type (codes
//     0..15 and q are exact in bf16 / f16, the product exact in f32); s = (q . k_q) *
//     (scale * ksc) + sum(q) * scale * kmin in f32.  O^T += V^T P'^T on mma.sync with
//     the V codes decoded the same way, P' = p * vsc as bf16 hi + lo (two products, 16
//     of its 24 bits), and rowsum(p * vmin) on the CUDA cores.  So the function is the
//     f32 loop's up to rounding.  A block whose split holds no page writes nothing:
//     the combine reads a row's non-empty splits only.
//   * CUDA-core narrow (f32 q at any D, and D = 80 / 96, which are no whole 64-dim
//     units): one block per (kv head, batch row, split) walks its pages.  The G query
//     heads of the GQA group share every page the block loads.  Per page: the head's
//     [BS, D / 2] byte slices of the K and V planes go to shared memory with 16-byte
//     loads, the page's BS K and V scales and mins of this head beside them; scores
//     with one thread per token (a 32-bit word holds 8 codes, code i at bits 4i..4i+3
//     is dim 8w + i); online softmax per query head (warp reductions), which also sums
//     p * vmin; P.V with one thread per (head, column), accumulator in shared memory.
//   * Wide (MLA's latent D = 576, one kv head under 16 or 128 query heads): as
//     paged_decode_int8.cu's wide path -- 512 threads and up to 16 query heads a
//     block, 32-token sub-chunks of the [*, D / 2] byte slices and their scales and
//     mins in shared memory, one thread per (token, head) for the scores.  The
//     arithmetic is the CUDA-core narrow path's, term for term.
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

// code i (0..7) of a packed word, as float
__device__ __forceinline__ float nib_f(uint32_t w, int i) {
  return static_cast<float>((w >> (4 * i)) & 0xFu);
}

// CB bytes global -> shared (CB 16 or 8, both sides aligned to CB)
template <int CB>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src) {
  if constexpr (CB == 16)
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  else
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

__host__ __device__ inline int float_words(int G, int D, int BS) {
  // qs [G][D] + os [G][D] + ps [G][BS] + m, l, alpha, qsum, pmin [G]
  // + ksc, kmn, vsc, vmn [BS], rounded to 16 bytes
  return (2 * G * D + G * BS + 5 * G + 4 * BS + 3) & ~3;
}

template <int D>
size_t smem_bytes(int G, int BS) {
  return (size_t)float_words(G, D, BS) * sizeof(float)
       + (size_t)BS * (D / 2 + 16)      // K slice, 16-byte padded rows
       + (size_t)BS * (D / 2);          // V slice
}

template <typename TQ, int D>
__global__ void __launch_bounds__(NT)
paged_decode_int4_kernel(const TQ* __restrict__ q,   // [B, Hq, D]
                         const uint8_t* __restrict__ data,      // [L, NB, 2, BS, Hkv*D/2]
                         const float* __restrict__ scales,      // [L, NB, 2, BS, Hkv]
                         const float* __restrict__ minv,        // [L, NB, 2, BS, Hkv]
                         const int* __restrict__ tables,        // [B, W]
                         const int* __restrict__ kv_lens,       // [B]
                         TQ* __restrict__ out,       // [B, Hq, D]
                         float* __restrict__ part,   // [B, S, Hq, D + 2] or null
                         int Hq, int Hkv, int NB, int BS, int W, int layer,
                         float scale, float softcap, int split_pages) {
  constexpr int DB = D / 2;       // code bytes per head row
  constexpr int KSTR = DB + 16;   // padded K rows: conflict-free 16-byte row reads
  // 16-byte chunks per head row, or 8-byte ones where a head row is not a multiple of
  // 16 bytes (D = 80: 40 bytes, and each head's row starts 8-byte aligned)
  constexpr int CB = DB % 16 == 0 ? 16 : 8;
  constexpr int CH = DB / CB;
  static_assert(DB % CB == 0, "head rows of whole 8-byte chunks");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int G = Hq / Hkv;
  const int RB = Hkv * DB;        // bytes per token row of a plane
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
  float* qsum = as + G;             // [G]  sum_d qs
  float* pmin = qsum + G;           // [G]  this page's sum_t p * vmin
  float* ksc = pmin + G;            // [BS]
  float* kmn = ksc + BS;            // [BS]
  float* vsc = kmn + BS;            // [BS]
  float* vmn = vsc + BS;            // [BS]
  uint8_t* ks = reinterpret_cast<uint8_t*>(smem + float_words(G, D, BS));
  uint8_t* vs = ks + BS * KSTR;

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
  for (int g = warp; g < G; g += NT / 32) {
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += qs[g * D + d];
    sum = warp_sum(sum);
    if (lane == 0) qsum[g] = sum;
  }
  __syncthreads();

  const int len = kv_lens[b];
  const int p_lo = sp * split_pages;
  const int p_hi = min(min((len + BS - 1) / BS, W), p_lo + split_pages);
  const long long plane = (long long)BS * RB;
  const long long splane = (long long)BS * Hkv;
  for (int p = p_lo; p < p_hi; ++p) {
    const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
    const long long page = (long long)layer * NB + blk;
    const uint8_t* kpage = data + page * 2 * plane + (long long)h * DB;
    const uint8_t* vpage = kpage + plane;
    const long long soff = page * 2 * splane + h;
    for (int i = tid; i < BS * CH; i += NT) {
      const int t = i / CH;
      const int c = i - t * CH;
      copy_chunk<CB>(ks + t * KSTR + c * CB, kpage + (long long)t * RB + c * CB);
      copy_chunk<CB>(vs + t * DB + c * CB, vpage + (long long)t * RB + c * CB);
    }
    for (int t = tid; t < BS; t += NT) {
      ksc[t] = scales[soff + (long long)t * Hkv];
      kmn[t] = minv[soff + (long long)t * Hkv];
      vsc[t] = scales[soff + splane + (long long)t * Hkv];
      vmn[t] = minv[soff + splane + (long long)t * Hkv];
    }
    __syncthreads();

    for (int t = tid; t < BS; t += NT) {
      const bool valid = p * BS + t < len;
      uint32_t kr[D / 8];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint8_t* src = ks + t * KSTR + c * CB;
        if constexpr (CB == 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          kr[c * 4 + 0] = raw.x;
          kr[c * 4 + 1] = raw.y;
          kr[c * 4 + 2] = raw.z;
          kr[c * 4 + 3] = raw.w;
        } else {
          const uint2 raw = *reinterpret_cast<const uint2*>(src);
          kr[c * 2 + 0] = raw.x;
          kr[c * 2 + 1] = raw.y;
        }
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * D;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < D / 8; ++w) {
          const float4 qa = *reinterpret_cast<const float4*>(qg + 8 * w);
          const float4 qb = *reinterpret_cast<const float4*>(qg + 8 * w + 4);
          const uint32_t k = kr[w];
          acc = fmaf(qa.x, nib_f(k, 0), acc);
          acc = fmaf(qa.y, nib_f(k, 1), acc);
          acc = fmaf(qa.z, nib_f(k, 2), acc);
          acc = fmaf(qa.w, nib_f(k, 3), acc);
          acc = fmaf(qb.x, nib_f(k, 4), acc);
          acc = fmaf(qb.y, nib_f(k, 5), acc);
          acc = fmaf(qb.z, nib_f(k, 6), acc);
          acc = fmaf(qb.w, nib_f(k, 7), acc);
        }
        float s = acc * ksc[t] + qsum[g] * kmn[t];
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
      float sum = 0.f, smin = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float e = expf(prow[t] - m_new);
        sum += e;                     // l sums the unscaled p
        smin = fmaf(e, vmn[t], smin); // rowsum(p * vmin)
        prow[t] = e * vsc[t];         // P.V takes p * vsc
      }
      sum = warp_sum(sum);
      smin = warp_sum(smin);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
        pmin[g] = smin;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      const int d = i - g * D;
      const float* prow = ps + g * BS;
      const uint8_t* vcol = vs + (d >> 1);
      const int shift = (d & 1) * 4;
      float acc = 0.f;
      for (int t = 0; t < BS; ++t)
        acc = fmaf(prow[t], static_cast<float>((vcol[t * DB] >> shift) & 0xF), acc);
      os[i] = os[i] * as[g] + (acc + pmin[g]);
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
// one ring stage: the K and V rows [TC][D / 2 + 16] bytes, then ksc, kmn, vsc, vmn
// [4][TC] f32
template <int D>
struct Stage {
  static constexpr int RS = D / 2 + 16;   // padded row: conflict-free fragment loads
  static constexpr int V = qdec::TC * RS;
  static constexpr int M = 2 * qdec::TC * RS;
  static constexpr int BYTES = M + 4 * qdec::TC * 4;
};

// the ring, whose smem the tail takes after it
template <int D>
__host__ __device__ constexpr int mma_smem() {
  return qdec::NST * Stage<D>::BYTES > qdec::tail_bytes<D>() ? qdec::NST * Stage<D>::BYTES
                                                              : qdec::tail_bytes<D>();
}

template <typename T, int D, bool ONE_PAGE>
__global__ void __launch_bounds__(qdec::NT, qdec::min_blocks<D>())
paged_decode_int4_mma(const T* __restrict__ q,                 // [B, Hq, D]
                      const uint8_t* __restrict__ data,         // [L, NB, 2, BS, Hkv*D/2]
                      const float* __restrict__ scales,         // [L, NB, 2, BS, Hkv]
                      const float* __restrict__ minv,           // [L, NB, 2, BS, Hkv]
                      const int* __restrict__ tables,           // [B, W]
                      const int* __restrict__ kv_lens,          // [B]
                      T* __restrict__ out,                      // [B, Hq, D]
                      float* __restrict__ part,                 // [B, S, Hq, D + 2] or null
                      int Hq, int Hkv, int NB, int BS, int W, int layer,
                      float scale, float softcap, int split_pages) {
  using namespace qdec;
  using St = Stage<D>;
  constexpr int DB = D / 2;           // code bytes a head row
  constexpr int RS = St::RS;
  constexpr int CH = DB / 16;         // 16-byte chunks a row
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
  const float qsum =
      scale * q_fragments<T, D>(gid < gb ? q + (head0 + gid) * D : nullptr, tig, qa);

  const int RB = Hkv * DB;            // bytes a token row of a plane
  const long long plane = (long long)BS * RB;
  const long long splane = (long long)BS * Hkv;
  auto load = [&](int j, int st) {
    // the warp's own rows; rows past the split's positions read as zeros
    const int r0 = span.row0(j, warp);
    const int hi = span.hi(r0);
    const WarpRows<ONE_PAGE> rows(tables + (long long)b * W, r0, BS, NB, layer, hi > 0);
    uint8_t* stage = mma_raw + st * St::BYTES;
    for (int x = lane; x < WT * CH; x += 32) {
      const int t = x / CH;
      const int c = x % CH;
      const bool in = t < hi;
      long long off = 0;
      if (in) {
        const Slot s = rows(t);
        off = s.page * 2 * plane + (long long)h * DB + (long long)s.row * RB + c * 16;
      }
      cp_async16(stage + (warp * WT + t) * RS + c * 16, data + off, in);
      cp_async16(stage + St::V + (warp * WT + t) * RS + c * 16, data + off + (in ? plane : 0),
                 in);
    }
    float* ms = reinterpret_cast<float*>(stage + St::M);
    for (int x = lane; x < 4 * WT; x += 32) {
      const int a = x / WT;              // ksc, kmn (K plane), vsc, vmn (V plane)
      const int t = x % WT;
      const bool in = t < hi;
      long long off = 0;
      if (in) {
        const Slot s = rows(t);
        off = s.page * 2 * splane + (a >> 1) * splane + h + (long long)s.row * Hkv;
      }
      cp_async4(ms + a * TC + warp * WT + t, (a & 1 ? minv : scales) + off, in);
    }
    cp_commit();
  };

  float m = MASK_VALUE, l = 0.f, pmin = 0.f;    // head gid; l, pmin: this lane's share
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

    // S = Q K^T over the warp's two 8-token tiles, each K code decoded once
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint8_t* kr = stage + (wt + 8 * j + gid) * RS + 4 * tig;
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + 16 * jj);
        const uint32_t a0[4] = {qa[2 * jj][0], 0u, qa[2 * jj][1], 0u};
        const uint32_t a1[4] = {qa[2 * jj + 1][0], 0u, qa[2 * jj + 1][1], 0u};
        attn::Mma<T>::run(s[j], a0, nib2<T>(w, 0), nib2<T>(w, 1));
        attn::Mma<T>::run(s[j], a1, nib2<T>(w, 2), nib2<T>(w, 3));
      }
    }
    // s = (q . k_q) * scale * ksc + sum(q * scale) * kmin; softcap; mask by len
    float mx = MASK_VALUE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = wt + 8 * j + 2 * tig;
      const float2 ksc = *reinterpret_cast<const float2*>(ms + t);
      const float2 kmn = *reinterpret_cast<const float2*>(ms + TC + t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][e] * (scale * (e ? ksc.y : ksc.x)) + qsum * (e ? kmn.y : kmn.x);
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = t - wt + e < hi ? x : MASK_VALUE;
        s[j][e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = attn::quad_max(mx);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
    pmin *= alpha;
    uint32_t ph[2], pl[2];            // P' = p * vsc, hi and lo: P.V's B fragments
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = wt + 8 * j + 2 * tig;
      const float2 vsc = *reinterpret_cast<const float2*>(ms + 2 * TC + t);
      const float2 vmn = *reinterpret_cast<const float2*>(ms + 3 * TC + t);
      const float p0 = expf(s[j][0] - m_new), p1 = expf(s[j][1] - m_new);
      l += p0 + p1;                                    // l sums the unscaled p
      pmin = fmaf(p0, vmn.x, fmaf(p1, vmn.y, pmin));   // rowsum(p * vmin)
      split_bf16(p0 * vsc.x, p1 * vsc.y, ph[j], pl[j]);
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

    // O^T += V^T P'^T: the warp's tokens 2 tig, 2 tig + 1 (+8), words gid + 8 u
    const uint8_t* vr = stage + St::V + (wt + 2 * tig) * RS + 4 * gid;
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      const uint32_t x1 = *reinterpret_cast<const uint32_t*>(vr + 32 * u);
      const uint32_t x2 = *reinterpret_cast<const uint32_t*>(vr + RS + 32 * u);
      const uint32_t x3 = *reinterpret_cast<const uint32_t*>(vr + 8 * RS + 32 * u);
      const uint32_t x4 = *reinterpret_cast<const uint32_t*>(vr + 9 * RS + 32 * u);
      // two tokens' bytes side by side: nibble n of each half is one dim of both
      const uint32_t z12 = prmt(x1, x2, 0x5410), y12 = prmt(x1, x2, 0x7632);
      const uint32_t z34 = prmt(x3, x4, 0x5410), y34 = prmt(x3, x4, 0x7632);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t a[4] = {nib2<__nv_bfloat16>(z12, n), nib2<__nv_bfloat16>(y12, n),
                               nib2<__nv_bfloat16>(z34, n), nib2<__nv_bfloat16>(y34, n)};
        attn::Mma<__nv_bfloat16>::run(o[u][n], a, ph[0], ph[1]);
        attn::Mma<__nv_bfloat16>::run(o[u][n], a, pl[0], pl[1]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                    // the ring's smem takes the tail's
  block_tail<T, D>(o, m, l, pmin, reinterpret_cast<float*>(mma_raw), out, part, head0, hq0,
                   gb, b, S, sp, Hq);
}

// ------------------------------------------------------------------------ wide kernel
constexpr int NTW = 512;          // wide kernel threads
constexpr int TCW = 32;           // tokens a sub-chunk
constexpr int HPW = NTW / TCW;    // head parts: the threads that share a token
constexpr int GB = 16;            // query heads a wide block at most
constexpr int ACCW = (GB + HPW - 1) / HPW;

__host__ __device__ inline int wide_words(int gb, int D) {
  // qs [gb][D] + os [gb][D] + ps [gb][TCW] + m, l, alpha, qsum, pmin [gb]
  // + ksc, kmn, vsc, vmn [TCW], rounded to 16 bytes
  return (2 * gb * D + gb * TCW + 5 * gb + 4 * TCW + 3) & ~3;
}

inline size_t wide_smem(int gb, int D) {
  return (size_t)wide_words(gb, D) * sizeof(float)
       + (size_t)TCW * (D / 2 + 16)     // K slice, 16-byte padded rows
       + (size_t)TCW * (D / 2);         // V slice
}

template <typename TQ>
__global__ void __launch_bounds__(NTW)
paged_decode_int4_wide(const TQ* __restrict__ q,                // [B, Hq, D]
                       const uint8_t* __restrict__ data,        // [L, NB, 2, BS, Hkv*D/2]
                       const float* __restrict__ scales,        // [L, NB, 2, BS, Hkv]
                       const float* __restrict__ minv,          // [L, NB, 2, BS, Hkv]
                       const int* __restrict__ tables,          // [B, W]
                       const int* __restrict__ kv_lens,         // [B]
                       TQ* __restrict__ out,                    // [B, Hq, D]
                       float* __restrict__ part,                // [B, S, Hq, D + 2] or null
                       int Hq, int Hkv, int D, int NB, int BS, int W, int layer,
                       float scale, float softcap, int split_pages) {
  const int DB = D / 2;           // code bytes per head row
  const int KSTR = DB + 16;       // padded K rows: conflict-free 16-byte row reads
  const int CH = DB / 16;         // 16-byte chunks (32 codes) per head row
  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const int h = blockIdx.x / hsplits;
  const int g0 = (blockIdx.x - h * hsplits) * GB;
  const int gb = min(GB, G - g0);
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int RB = Hkv * DB;        // bytes per token row of a plane
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
  float* qsum = as + gb;            // [gb]  sum_d qs
  float* pmin = qsum + gb;          // [gb]  this sub-chunk's sum_t p * vmin
  float* ksc = pmin + gb;           // [TCW]
  float* kmn = ksc + TCW;           // [TCW]
  float* vsc = kmn + TCW;           // [TCW]
  float* vmn = vsc + TCW;           // [TCW]
  uint8_t* ks = reinterpret_cast<uint8_t*>(smem + wide_words(gb, D));
  uint8_t* vs = ks + TCW * KSTR;

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
  for (int g = warp; g < gb; g += NTW / 32) {
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += qs[g * D + d];
    sum = warp_sum(sum);
    if (lane == 0) qsum[g] = sum;
  }
  __syncthreads();

  const int len = kv_lens[b];
  const int p_lo = sp * split_pages;
  const int p_hi = min(min((len + BS - 1) / BS, W), (sp + 1) * split_pages);
  const long long plane = (long long)BS * RB;
  const long long splane = (long long)BS * Hkv;
  const int tt = tid % TCW;         // this thread's token in the sub-chunk
  const int hp = tid / TCW;         // and its heads hp, hp + HPW, ...
  for (int p = p_lo; p < p_hi; ++p) {
    const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
    const long long page = (long long)layer * NB + blk;
    const uint8_t* kpage = data + page * 2 * plane + (long long)h * DB;
    const uint8_t* vpage = kpage + plane;
    const long long soff = page * 2 * splane + h;
    for (int t0 = 0; t0 < BS; t0 += TCW) {
      const int c0 = p * BS + t0;                 // the sub-chunk's first position
      if (c0 >= len) break;
      const int nt = min(TCW, BS - t0);
      for (int i = tid; i < nt * CH; i += NTW) {
        const int t = i / CH;
        const int c = i - t * CH;
        const long long off = (long long)(t0 + t) * RB + c * 16;
        *reinterpret_cast<uint4*>(ks + t * KSTR + c * 16) =
            *reinterpret_cast<const uint4*>(kpage + off);
        *reinterpret_cast<uint4*>(vs + t * DB + c * 16) =
            *reinterpret_cast<const uint4*>(vpage + off);
      }
      for (int t = tid; t < nt; t += NTW) {
        const long long o = soff + (long long)(t0 + t) * Hkv;
        ksc[t] = scales[o];
        kmn[t] = minv[o];
        vsc[t] = scales[o + splane];
        vmn[t] = minv[o + splane];
      }
      __syncthreads();

      {
        const bool valid = tt < nt && c0 + tt < len;
        float acc[ACCW];
#pragma unroll
        for (int j = 0; j < ACCW; ++j) acc[j] = 0.f;
        if (tt < nt) {
          const uint8_t* kr = ks + tt * KSTR;
          for (int c = 0; c < CH; ++c) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 16);
            const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int j = 0; j < ACCW; ++j) {
              const int g = hp + HPW * j;
              if (g < gb) {
                const float* qg = qs + g * D + c * 32;
                float a = acc[j];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float4 qa = *reinterpret_cast<const float4*>(qg + 8 * e);
                  const float4 qb = *reinterpret_cast<const float4*>(qg + 8 * e + 4);
                  const uint32_t k = w[e];
                  a = fmaf(qa.x, nib_f(k, 0), a);
                  a = fmaf(qa.y, nib_f(k, 1), a);
                  a = fmaf(qa.z, nib_f(k, 2), a);
                  a = fmaf(qa.w, nib_f(k, 3), a);
                  a = fmaf(qb.x, nib_f(k, 4), a);
                  a = fmaf(qb.y, nib_f(k, 5), a);
                  a = fmaf(qb.z, nib_f(k, 6), a);
                  a = fmaf(qb.w, nib_f(k, 7), a);
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
            float s = tt < nt ? acc[j] * ksc[tt] + qsum[g] * kmn[tt] : 0.f;
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
        float sum = 0.f, smin = 0.f;
        for (int t = lane; t < TCW; t += 32) {
          const float e = t < nt ? expf(prow[t] - m_new) : 0.f;
          sum += e;                                   // l sums the unscaled p
          smin = t < nt ? fmaf(e, vmn[t], smin) : smin;   // rowsum(p * vmin)
          prow[t] = t < nt ? e * vsc[t] : 0.f;        // P.V takes p * vsc
        }
        sum = warp_sum(sum);
        smin = warp_sum(smin);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          as[g] = alpha;
          ls[g] = ls[g] * alpha + sum;
          ms[g] = m_new;
          pmin[g] = smin;
        }
      }
      __syncthreads();

      for (int i = tid; i < gb * D; i += NTW) {
        const int g = i / D;
        const int d = i - g * D;
        const float* prow = ps + g * TCW;
        const uint8_t* vcol = vs + (d >> 1);
        const int shift = (d & 1) * 4;
        float a = 0.f;
        for (int t = 0; t < nt; ++t)
          a = fmaf(prow[t], static_cast<float>((vcol[t * DB] >> shift) & 0xF), a);
        os[i] = os[i] * as[g] + (a + pmin[g]);
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
                        const void* minv, const int* tables, const int* kv_lens, void* out,
                        float* part, int B, int Hq, int Hkv, int D, int NB, int BS, int W,
                        int layer, float scale, float softcap, int splits,
                        cudaStream_t stream) {
  if (splits <= 0 || (splits > 1 && part == nullptr)) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const size_t bytes = wide_smem(G < GB ? G : GB, D);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_int4_wide<TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_int4_wide<TQ><<<dim3(Hkv * hsplits, B, splits), NTW, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const uint8_t*>(data),
      static_cast<const float*>(scales), static_cast<const float*>(minv), tables, kv_lens,
      static_cast<TQ*>(out), part, Hq, Hkv, D, NB, BS, W, layer, scale, softcap,
      split_pages);
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
cudaError_t launch(const void* q, const void* data, const void* scales, const void* minv,
                   const int* tables, const int* kv_lens, void* out, float* part, int B,
                   int Hq, int Hkv, int NB, int BS, int W, int layer, float scale,
                   float softcap, int splits, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(Hq / Hkv, BS);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_int4_kernel<TQ, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_int4_kernel<TQ, D><<<dim3(Hkv, B, splits), NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const uint8_t*>(data),
      static_cast<const float*>(scales), static_cast<const float*>(minv), tables, kv_lens,
      static_cast<TQ*>(out), part, Hq, Hkv, NB, BS, W, layer, scale, softcap, split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine<TQ>(part, kv_lens, out, B, Hq, D, splits, BS, W, split_pages, stream);
}

template <typename T, int D, bool ONE_PAGE>
cudaError_t launch_mma(const void* q, const void* data, const void* scales, const void* minv,
                       const int* tables, const int* kv_lens, void* out, float* part, int B,
                       int Hq, int Hkv, int NB, int BS, int W, int layer, float scale,
                       float softcap, int splits, cudaStream_t stream) {
  constexpr int bytes = mma_smem<D>();
  static cudaError_t configured = cudaFuncSetAttribute(
      paged_decode_int4_mma<T, D, ONE_PAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (configured != cudaSuccess) return configured;
  const int hsplits = (Hq / Hkv + qdec::GQ - 1) / qdec::GQ;
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_int4_mma<T, D, ONE_PAGE><<<dim3(Hkv * hsplits, B, splits), qdec::NT, bytes,
                                          stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(data),
      static_cast<const float*>(scales), static_cast<const float*>(minv), tables, kv_lens,
      static_cast<T*>(out), part, Hq, Hkv, NB, BS, W, layer, scale, softcap, split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine<T>(part, kv_lens, out, B, Hq, D, splits, BS, W, split_pages, stream);
}

template <typename TQ>
int by_dim(const void* q, const void* data, const void* scales, const void* minv,
           const int* tb, const int* kl, void* out, float* part, int B, int Hq, int Hkv,
           int D, int NB, int BS, int W, int layer, float scale, float softcap, int splits,
           cudaStream_t s) {
  if (splits <= 0 || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
#define NARROW_CASE(DIM)                                                               \
  case DIM:                                                                            \
    return (int)launch<TQ, DIM>(q, data, scales, minv, tb, kl, out, part, B, Hq, Hkv,  \
                                NB, BS, W, layer, scale, softcap, splits, s);
#define MMA_CASE(DIM)                                                                  \
  case DIM:                                                                            \
    return (int)(BS % qdec::WT == 0 ? launch_mma<TQ, DIM, true>                        \
                                    : launch_mma<TQ, DIM, false>)(                     \
        q, data, scales, minv, tb, kl, out, part, B, Hq, Hkv, NB, BS, W, layer, scale,  \
        softcap, splits, s);
  switch (D) {
    NARROW_CASE(80)
    NARROW_CASE(96)
    case 576:
      return (int)launch_wide<TQ>(q, data, scales, minv, tb, kl, out, part, B, Hq, Hkv, D,
                                  NB, BS, W, layer, scale, softcap, splits, s);
    default:
      break;
  }
  // bf16 / f16 q at whole 64-dim units: the tensor-core body; f32 q the CUDA cores'
  if constexpr (std::is_same<TQ, float>::value) {
    switch (D) {
      NARROW_CASE(64)
      NARROW_CASE(128)
      NARROW_CASE(192)
      NARROW_CASE(256)
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
#undef NARROW_CASE
#undef MMA_CASE
}

}  // namespace

// q [B,Hq,D] of dtype 0 bf16, 1 f16 or 2 f32; data [L,NB,2,BS,Hkv*D/2] u8; scales,
// minv [L,NB,2,BS,Hkv] f32; tables [B,W] i32; kv_lens [B] i32; out [B,Hq,D] in q's
// dtype; all contiguous.  D in {64, 80, 96, 128, 192, 256} (the narrow kernels) or 576
// (the wide one).  softcap <= 0 disables it.  splits: the split of each row's W pages
// over blocks (1 for none), with part f32 [B, splits, Hq, D + 2] scratch when it is
// above 1; a split launch is followed by the combine.  Returns the CUDA error code of
// the launches (0 = launched).
extern "C" int paged_decode_int4(const void* q, const void* data, const void* scales,
                                 const void* minv, const void* tables, const void* kv_lens,
                                 void* out, void* part, int dtype, int B, int Hq, int Hkv,
                                 int D, int NB, int BS, int W, int layer, float scale,
                                 float softcap, int splits, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  float* pt = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return by_dim<__nv_bfloat16>(q, data, scales, minv, tb, kl, out, pt, B, Hq, Hkv, D,
                                   NB, BS, W, layer, scale, softcap, splits, s);
    case 1:
      return by_dim<__half>(q, data, scales, minv, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS,
                            W, layer, scale, softcap, splits, s);
    case 2:
      return by_dim<float>(q, data, scales, minv, tb, kl, out, pt, B, Hq, Hkv, D, NB, BS,
                           W, layer, scale, softcap, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
