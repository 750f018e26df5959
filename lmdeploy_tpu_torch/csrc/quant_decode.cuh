// Pieces shared by the tensor-core narrow paths of the paged decodes
// (paged_decode_int4.cu, paged_decode_turbo.cu, and paged_decode.cu over 2-byte and
// e4m3 pages): the cp.async copies of the page ring, the register decode of 4-bit
// codes into mma.sync operands, the hi + lo split of f32 P' into two bf16 operands, the
// Q fragments, and the block's tail that joins its four warps' (O, m, l) and writes the
// output or the split's partials.
//
// Layout of one block (4 warps, up to GQ = 8 query heads of one kv head, one split of
// a row's pages).  The split's positions stream through a cp.async ring of TC-token
// sub-chunks (Span; any block size: WarpRows finds each row's page); each warp owns
// WT = 16 rows of every sub-chunk (two 8-token score tiles, one P.V step), copies those
// rows itself and keeps its own online softmax, so the warps wait only for their own
// copies (no block barrier in the loop); the block's tail joins the warps (block_tail).
//   * Scores S[head][token] = Q K^T on mma.sync m16n8k16: A = Q (rows = heads, the
//     rows past the group zero), B = K^T of an 8-token tile.  Lane (gid, tig) decodes
//     token gid's words tig + 4 jj, each word's nibbles (n, n + 4) into one register,
//     so the k index of a step is a permutation of the head dims; the Q fragments are
//     built in the same order (q_fragments).
//   * O^T[dim][head] += V^T P'^T on mma.sync: A = V^T (rows = dims), B = P'^T, which
//     is S's accumulator layout as it stands (head gid, tokens 2 tig, 2 tig + 1 and
//     + 8): no shuffle.  Lane (gid, tig) decodes tokens 2 tig, 2 tig + 1, + 8, + 9,
//     their unit gid + 8 u (a 32-bit word of 8 nibbles, or 16 bits of 8 two-bit
//     codes), pairing two tokens at one dim with a byte permute.  Tile (u, n) row gid
//     is dim 8 (gid + 8 u) + n, row gid + 8 that dim + 4 (out_dim).
//   * P' (p times the token's V scale or norm) is f32; it goes to the tensor cores as
//     bf16 hi + lo (hi = bf16(P'), lo = bf16(P' - hi)), two products into one f32
//     accumulator: 16 of P''s 24 bits, where one bf16 P would keep 8.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "attn_types.cuh"
#include "decode_split.cuh"

namespace qdec {

constexpr int NT = 128;           // 4 warps
constexpr int TC = 64;            // tokens a sub-chunk
constexpr int WT = TC / 4;        // rows of a sub-chunk a warp copies and reads: 16
constexpr int NST = 3;            // ring stages
constexpr int GQ = 8;             // query heads a block at most (one n8 tile of P.V)
// blocks an SM at least (__launch_bounds__): 4 up to D 128 (128 registers); 3 above, where
// the ring's shared memory allows 3 anyway and 128 registers would spill
template <int D>
__host__ __device__ constexpr int min_blocks() { return D <= 128 ? 4 : 3; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 16 : 0) : "memory");   // 0: zero-fill
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}
constexpr int AND_OR = 0xEA;      // (a & b) | c
constexpr int AND_XOR = 0x6A;     // (a & b) ^ c

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  return __byte_perm(a, b, sel);
}

// the 16-bit element type's constants: 2^k whose ulp is 1 (so 2^k | n is 2^k + n for
// n < 16), -2^k, and -1
template <typename T>
struct Bits;
template <>
struct Bits<__nv_bfloat16> {
  static constexpr uint32_t MAGIC = 0x43004300u, NEG_MAGIC = 0xC300C300u, ONE = 0x3F803F80u,
                            NEG_ONE = 0xBF80BF80u;
};
template <>
struct Bits<__half> {
  static constexpr uint32_t MAGIC = 0x64006400u, NEG_MAGIC = 0xE400E400u, ONE = 0x3C003C00u,
                            NEG_ONE = 0xBC00BC00u;
};

// a * b + c on two 16-bit lanes
template <typename T>
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c);
template <>
__device__ __forceinline__ uint32_t fma2<__nv_bfloat16>(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
template <>
__device__ __forceinline__ uint32_t fma2<__half>(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the 4-bit fields at bits 4n and 4n + 16 of w as two T values 0..15, exact: the low
// one in the low half
template <typename T>
__device__ __forceinline__ uint32_t nib2(uint32_t w, int n) {
  const uint32_t x = lop3<AND_OR>(w >> (4 * n), 0x000F000Fu, Bits<T>::MAGIC);
  return fma2<T>(x, Bits<T>::ONE, Bits<T>::NEG_MAGIC);
}

// bits 15 and 31 of x as two T values: +1 where the bit is set, else -1
template <typename T>
__device__ __forceinline__ uint32_t sign2(uint32_t x) {
  return lop3<AND_XOR>(x, 0x80008000u, Bits<T>::NEG_ONE);
}

// f32 (lo, hi) -> bf16x2 hi parts and the bf16x2 of what they leave
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& h, uint32_t& l) {
  h = attn::Mma<__nv_bfloat16>::pack(lo, hi);
  l = attn::Mma<__nv_bfloat16>::pack(lo - __uint_as_float(h << 16),
                                     hi - __uint_as_float(h & 0xFFFF0000u));
}

// the Q fragments of the D / 16 k steps (a[0], a[2]: rows gid; rows gid + 8 are zero):
// step 2 jj + hh pairs dims (8w + 2hh, 8w + 2hh + 4) and (8w + 2hh + 1, 8w + 2hh + 5),
// w = tig + 4 jj, as nib2 pairs a K word's nibbles.  qrow: this lane's head, or null
// past the group.  Returns sum_d q (f32) over the head's D dims, quad-reduced.
template <typename T, int D>
__device__ __forceinline__ float q_fragments(const T* qrow, int tig, uint32_t (&qa)[D / 16][2]) {
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < D / 32; ++jj) {
    const int w = tig + 4 * jj;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (qrow != nullptr) u = *reinterpret_cast<const uint4*>(qrow + 8 * w);
    qa[2 * jj][0] = prmt(u.x, u.z, 0x5410);
    qa[2 * jj][1] = prmt(u.x, u.z, 0x7632);
    qa[2 * jj + 1][0] = prmt(u.y, u.w, 0x5410);
    qa[2 * jj + 1][1] = prmt(u.y, u.w, 0x7632);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += attn::to_f(e[i]);
  }
  return attn::quad_sum(sum);
}

// output dim of P.V tile (u, n), row gid (half 0) or gid + 8 (half 1)
__device__ __forceinline__ int out_dim(int gid, int u, int n, int half) {
  return 8 * (gid + 8 * u) + n + 4 * half;
}

// A block's split of a row's slots and its sub-chunks.  The row counts its slots [ws,
// len) (attn::Positions: positions on plain pages, a rank's local slots on a stripe; ws
// the window's start, 0 without one).  Split sp holds the slots of its pages below len,
// [p0, p1), of which those from ws on count.  Sub-chunk j holds slots p0 + j TC .. + TC,
// so it may span pages (a block size under TC) or cover part of one; [j_lo, j_hi) are
// those that hold a counted slot (none for an empty split).  Warp w reads the WT rows of
// each sub-chunk from slot row0(j, w) on; its rows [lo, hi) count.
struct Span {
  int p0, p1, ws, j_lo = 0, j_hi = 0;
  __device__ Span(int len, int ws_, int BS, int W, int sp, int split_pages) : ws(ws_) {
    p0 = sp * split_pages * BS;
    p1 = min(min(sp * split_pages + split_pages, W) * BS, len);
    if (len > 0 && p1 > max(p0, ws)) {
      j_lo = max(ws - p0, 0) / TC;
      j_hi = (p1 - p0 + TC - 1) / TC;
    }
  }
  __device__ bool empty() const { return j_lo >= j_hi; }
  __device__ int row0(int j, int warp) const { return p0 + j * TC + warp * WT; }
  __device__ int lo(int r0) const { return max(ws - r0, 0); }
  __device__ int hi(int r0) const { return min(p1 - r0, WT); }
};

// Position r of a row whose block-table row is table: its page (layer * NB + the
// table's block, clamped into the cache) and its row on that page.
struct Slot {
  long long page;
  int row;
};
__device__ __forceinline__ Slot slot(const int* table, int r, int BS, int NB, int layer) {
  const int pg = r / BS;
  return {(long long)layer * NB + min(max(table[pg], 0), NB - 1), r - pg * BS};
}

// The slots of a warp's WT rows of a sub-chunk, from position r0 on.  ONE_PAGE (the
// build for block sizes that are a multiple of WT): they lie on one page, looked up once
// for the warp (any: a row of them is copied); otherwise on several, each row's looked
// up as it is copied.  The kernels take ONE_PAGE as a template parameter, so the
// common build carries no per-row lookup.
template <bool ONE_PAGE>
struct WarpRows {
  const int* table;
  int r0, BS, NB, layer;
  Slot first{0, 0};
  __device__ WarpRows(const int* table_, int r0_, int BS_, int NB_, int layer_, bool any)
      : table(table_), r0(r0_), BS(BS_), NB(NB_), layer(layer_) {
    if (ONE_PAGE && any) first = slot(table, r0, BS, NB, layer);
  }
  __device__ __forceinline__ Slot operator()(int t) const {
    if constexpr (ONE_PAGE) return Slot{first.page, first.row + t};
    else return slot(table, r0 + t, BS, NB, layer);
  }
};

// smem of the tail: [4 warps][GQ heads][D + 1] f32 O, then [3][4][GQ] m, l, extra
template <int D>
__host__ __device__ constexpr int tail_bytes() {
  return (4 * GQ * (D + 1) + 3 * 4 * GQ) * 4;
}

// The block's tail, in the ring's smem once it is drained: each warp's O^T tiles (lane:
// heads 2 tig, 2 tig + 1 at out_dim), its m and l and extra (int4's sum of p * vmin,
// added to every dim; 0 otherwise) for head gid, this lane's shares of l and extra,
// joined over the warps in a fixed order; then out = O / l (l == 0 -> 1; sinks [Hq],
// if any, join l while m is real) for one split, else the split's unnormalized
// (acc, m, l) into part [B, S, Hq, D + 2]; with raw (a context-parallel rank's partials)
// one split writes its unnormalized (acc, m, l) to part planar (acc [B, Hq, D], then m
// and l [B, Hq]: the rank's output).  head0 = b * Hq + hq0, hq0 the block's first query
// head.
template <typename T, int D>
__device__ __forceinline__ void block_tail(const float (&o)[D / 64][4][4], float m, float l,
                                           float extra, float* tail, T* out, float* part,
                                           long long head0, int hq0, int gb, int b, int S,
                                           int sp, int Hq, const float* sinks = nullptr,
                                           bool raw = false) {
  constexpr int OS = D + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float* ob = tail;                               // [4][GQ][OS]
  float* wm = ob + 4 * GQ * OS;                   // [4][GQ]
  float* wl = wm + 4 * GQ;
  float* we = wl + 4 * GQ;
  l = attn::quad_sum(l);
  extra = attn::quad_sum(extra);
  if (tig == 0) {
    wm[warp * GQ + gid] = m;
    wl[warp * GQ + gid] = l;
    we[warp * GQ + gid] = extra;
  }
  float* o0 = ob + (warp * GQ + 2 * tig) * OS;
  float* o1 = o0 + OS;
#pragma unroll
  for (int u = 0; u < D / 64; ++u) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int d0 = out_dim(gid, u, n, 0), d1 = out_dim(gid, u, n, 1);
      o0[d0] = o[u][n][0];
      o1[d0] = o[u][n][1];
      o0[d1] = o[u][n][2];
      o1[d1] = o[u][n][3];
    }
  }
  __syncthreads();
  for (int x = tid; x < gb * D; x += NT) {
    const int g = x / D;
    const int d = x - g * D;
    float mx = wm[g];
#pragma unroll
    for (int w = 1; w < 4; ++w) mx = fmaxf(mx, wm[w * GQ + g]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float e = expf(wm[w * GQ + g] - mx);
      lsum += wl[w * GQ + g] * e;
      acc += (ob[(w * GQ + g) * OS + d] + we[w * GQ + g]) * e;
    }
    if (S == 1 && !raw) {
      out[(head0 + g) * D + d] =
          attn::from_f<T>(attn::finish(acc, mx, lsum, sinks, hq0 + g));
    } else if (S == 1) {
      const long long bh = (long long)gridDim.y * Hq;
      part[(head0 + g) * D + d] = acc;
      if (d == 0) {
        part[bh * D + head0 + g] = mx;
        part[bh * (D + 1) + head0 + g] = lsum;
      }
    } else {
      float* dst = part + (((long long)b * S + sp) * Hq + hq0 + g) * (D + 2);
      dst[d] = acc;
      if (d == 0) {
        dst[D] = mx;
        dst[D + 1] = lsum;
      }
    }
  }
}

// A block with no pages: with one split its row is inactive and its output rows are
// 0 (raw: the partials (0, MASK_VALUE, 0) into part, the rank's planar output); else
// nothing is written (the combine reads a row's non-empty splits only).
template <typename T>
__device__ __forceinline__ void empty_split(T* out, long long head0, int gb, int D, int S,
                                            float* part = nullptr, int Hq = 0) {
  if (S > 1) return;
  if (part == nullptr) {
    for (int x = threadIdx.x; x < gb * D; x += NT) out[head0 * D + x] = attn::from_f<T>(0.f);
    return;
  }
  const long long bh = (long long)gridDim.y * Hq;
  for (int x = threadIdx.x; x < gb * D; x += NT) part[head0 * D + x] = 0.f;
  for (int g = threadIdx.x; g < gb; g += NT) {
    part[bh * D + head0 + g] = attn::MASK_VALUE;
    part[bh * (D + 1) + head0 + g] = 0.f;
  }
}

}  // namespace qdec
