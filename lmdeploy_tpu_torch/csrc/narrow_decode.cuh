// The narrow tensor-core decode body (D = 64 .. 256 in whole 64-dim units, a bf16 / f16
// q, any block size), shared by three kernels, each of which instantiates it with its
// policies:
//   * paged_decode.cu: pages of 2-byte elements in q's type, or e4m3 (D 64 / 128);
//   * paged_decode_int8.cu: int8 pages with a f32 K and V scale a token and kv head;
//   * paged_decode_cp.cu: one context-parallel rank's stripe of 2-byte pages (D 64 /
//     128), whose output is the rank's unnormalized (acc, m, l).
// The parts that differ are the policies: how a K or V element becomes a 16-bit mma.sync
// operand (Pages16 as it is, PagesE4m3 and PagesInt8 decoded exactly), whether each
// token carries f32 K and V scales (copied into the stage beside its rows), how a row's
// slots map onto positions and what the tail writes: plain pages and the finished
// output, or (RAW) a context-parallel rank's stripe, whose local slots rise with their
// positions (attn::Positions), and its unnormalized (acc, m, l).
//
// Design (quant_decode.cuh's layout).  A block of 4 warps takes up to 8 query heads of a
// kv head and one split of the row's slots.  The split's slots stream through a 3-stage
// cp.async ring of 64-token sub-chunks (the head's [64, D] slices of the K and V planes,
// and with scales the 64 K and 64 V scales); each warp copies and owns 16 consecutive
// slots of every sub-chunk (under 16 slots a page they lie on several, each row's page
// looked up as it is copied), waits only for its own copies (no block barrier in the
// loop) and keeps its own online softmax; the block's tail joins the warps.
//   * S = Q K^T on mma.sync m16n8k16 with the group's heads as the rows of the A tile,
//     each K element read (and decoded) once for the group, against q in its own type:
//     every K operand is exact (2-byte elements as they are; e4m3 through cvt e4m3x2 ->
//     f16x2, exact, and for a bf16 q on through f32, exact too; int8 codes by the magic
//     numbers below, exact in bf16 and f16), so every product of S is exact in f32.
//     With scales, s = (q . k) * (scale * ksc), the reference's (q * scale) . k * ksc up
//     to rounding.
//   * O^T += V^T P'^T on mma.sync with P'^T straight from S's accumulators, P' = p (or p
//     * vsc with scales; l sums the unscaled p) in f32, split into hi + lo in V's operand
//     type (16 of its 24 bits in bf16, 22 in f16: two products), where rounding it once,
//     as the Pallas kernel does (pr.astype(v.dtype)), moved short rows' outputs by up to
//     1.5x the allowance of one bf16 ulp.  2-byte V goes in as it is; e4m3 and int8 V are
//     decoded to bf16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "attn_types.cuh"
#include "decode_split.cuh"
#include "quant_decode.cuh"

namespace ndec {

using attn::fp8_t;
using attn::MASK_VALUE;

// the two e4m3 codes in bits 0..15 of x (the lower one first) as two T, exactly, NaN
// code included: e4m3 -> f16 is exact, and so is f16 -> f32 -> bf16 (every e4m3 value
// is a normal f16 of 3 mantissa bits)
template <typename T>
__device__ __forceinline__ uint32_t e4m3x2(uint32_t x);
template <>
__device__ __forceinline__ uint32_t e4m3x2<__half>(uint32_t x) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(x & 0xFFFFu), __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}
template <>
__device__ __forceinline__ uint32_t e4m3x2<__nv_bfloat16>(uint32_t x) {
  const uint32_t h = e4m3x2<__half>(x);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return attn::Mma<__nv_bfloat16>::pack(f.x, f.y);
}

// int8 codes 2 hh and 2 hh + 1 (bytes) of w as two T, exactly (|code| <= 128 is exact in
// both types).  f16: 0x6400 | (code ^ 0x80) is 1024 + code + 128, minus 1152.  bf16 has 7
// mantissa bits: 0x4300 | byte is 128 + byte for a byte under 128 (a code >= 0), and for
// the others (bit 7 lands in the exponent's low bit) 256 + 2 (byte - 128); the code is
// then x - 128, or x / 2 - 256, the factor and addend picked by that bit.  (Through f32
// -- I2F, then a pack -- took 5-11% longer a call on an H100: chip_steps.py's
// cvt_decode.)
template <typename T>
__device__ __forceinline__ uint32_t i8x2(uint32_t w, int hh);
template <>
__device__ __forceinline__ uint32_t i8x2<__half>(uint32_t w, int hh) {
  const uint32_t x = qdec::prmt(w ^ 0x80808080u, 0x64646464u, hh ? 0x4342u : 0x4140u);
  return qdec::fma2<__half>(x, qdec::Bits<__half>::ONE, 0xE480E480u);
}
template <>
__device__ __forceinline__ uint32_t i8x2<__nv_bfloat16>(uint32_t w, int hh) {
  const uint32_t x = qdec::prmt(w, 0x43434343u, hh ? 0x4342u : 0x4140u);
  return qdec::fma2<__nv_bfloat16>(x, qdec::lop3<qdec::AND_XOR>(x, 0x00800080u, 0x3F803F80u),
                                   qdec::lop3<qdec::AND_OR>(x, 0x00800080u, 0xC300C300u));
}

// Element policies: the page element TK, V's operand type TV for P.V, whether each token
// carries f32 K and V scales, and (1-byte elements) dec<T>(w, hh): elements 2 hh and
// 2 hh + 1 of the 32-bit word w as two T.
template <typename T>
struct Pages16 {                      // 2-byte pages in q's type: as they are
  using TK = T;
  using TV = T;
  static constexpr bool SCALES = false;
};
struct PagesE4m3 {
  using TK = fp8_t;
  using TV = __nv_bfloat16;
  static constexpr bool SCALES = false;
  template <typename T>
  static __device__ __forceinline__ uint32_t dec(uint32_t w, int hh) {
    return e4m3x2<T>(w >> (16 * hh));
  }
};
struct PagesInt8 {
  using TK = int8_t;
  using TV = __nv_bfloat16;
  static constexpr bool SCALES = true;
  template <typename T>
  static __device__ __forceinline__ uint32_t dec(uint32_t w, int hh) {
    return i8x2<T>(w, hh);
  }
};

// one ring stage: the K and V rows of a sub-chunk, [TC][D * sizeof(TK) + 16] bytes each,
// then with scales the sub-chunk's K and V scales [2][TC] f32
template <typename E, int D>
struct Stage {
  static constexpr int RB = D * (int)sizeof(typename E::TK);   // bytes of a head's row
  static constexpr int RS = RB + 16;               // padded row: conflict-free fragments
  static constexpr int V = qdec::TC * RS;
  static constexpr int M = 2 * qdec::TC * RS;
  static constexpr int BYTES = M + (E::SCALES ? 2 * qdec::TC * 4 : 0);
};

// the ring, whose smem the tail takes after it
template <typename E, int D>
__host__ __device__ constexpr int smem_bytes() {
  return qdec::NST * Stage<E, D>::BYTES > qdec::tail_bytes<D>()
             ? qdec::NST * Stage<E, D>::BYTES : qdec::tail_bytes<D>();
}

// A launch's arguments.  kv_lens[b] counts the token just filled; 0 marks an inactive
// row.  window <= 0 and softcap <= 0 disable those; sinks (plain pages only) join the
// finished output's denominator.  split_pages: pages a split (grid.z splits).
struct Args {
  const void* q;                      // [B, Hq, D] T
  const void* cache;                  // [L, NB, 2, BS, Hkv * D] TK
  const float* scales;                // [L, NB, 2, BS, Hkv] f32 (SCALES) or null
  const int* tables;                  // [B, W]
  const int* kv_lens;                 // [B]
  const float* sinks;                 // [Hq] or null
  void* out;                          // [B, Hq, D] T; RAW: f32 planar (acc, m, l)
  float* part;                        // [B, S, Hq, D + 2] or null
  int Hq, Hkv, NB, BS, W, layer;
  float scale, softcap;
  int window, split_pages;
  attn::Positions pos;
};

// S's B fragment of k step kc for the token row kr: dims 16 kc + 4 tig, + 1 (b0) and
// + 2, + 3 (b1) -- the k order of a step is a permutation of its 16 dims, the Q
// fragments' too
template <typename T, typename E>
__device__ __forceinline__ void k_fragment(const uint8_t* kr, int kc, int tig, uint32_t& b0,
                                           uint32_t& b1) {
  if constexpr (sizeof(typename E::TK) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(kr + (16 * kc + 4 * tig) * 2);
    b0 = w.x;
    b1 = w.y;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + 16 * kc + 4 * tig);
    b0 = E::template dec<T>(w, 0);
    b1 = E::template dec<T>(w, 1);
  }
}

// f32 (lo, hi) -> T x2 hi parts and the T x2 of what they leave: 16 (bf16) or 22 (f16)
// of P's 24 bits in two products
template <typename T>
__device__ __forceinline__ void split_hi_lo(float lo, float hi, uint32_t& h, uint32_t& l);
template <>
__device__ __forceinline__ void split_hi_lo<__nv_bfloat16>(float lo, float hi, uint32_t& h,
                                                           uint32_t& l) {
  qdec::split_bf16(lo, hi, h, l);
}
template <>
__device__ __forceinline__ void split_hi_lo<__half>(float lo, float hi, uint32_t& h,
                                                    uint32_t& l) {
  h = attn::Mma<__half>::pack(lo, hi);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  l = attn::Mma<__half>::pack(lo - f.x, hi - f.y);
}

// The body: grid (Hkv * head blocks, B, splits), qdec::NT threads, smem_bytes<E, D>().
template <typename T, typename E, int D, bool ONE_PAGE, bool RAW>
__device__ __forceinline__ void
narrow_body(const Args& a) {
  using TK = typename E::TK;
  using TV = typename E::TV;
  using St = Stage<E, D>;
  constexpr int RS = St::RS;
  constexpr int CH = St::RB / 16;     // 16-byte chunks a row
  constexpr int TC = qdec::TC, WT = qdec::WT, NST = qdec::NST, GQ = qdec::GQ;
  extern __shared__ __align__(16) uint8_t ndec_smem[];
  const T* q = static_cast<const T*>(a.q);
  const int* tables = a.tables;
  const int Hq = a.Hq, Hkv = a.Hkv, NB = a.NB, BS = a.BS, W = a.W, layer = a.layer;

  const int G = Hq / Hkv;
  const int hsplits = (G + GQ - 1) / GQ;
  const int h = blockIdx.x / hsplits;
  const int g0 = (blockIdx.x - h * hsplits) * GQ;
  const int gb = min(GQ, G - g0);
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int hq0 = h * G + g0;
  const long long head0 = (long long)b * Hq + hq0;
  T* out = RAW ? nullptr : static_cast<T*>(a.out);
  // RAW with one split: the partials are the rank's output (planar acc, m, l)
  float* part = RAW && S == 1 ? static_cast<float*>(a.out) : a.part;
  // the split's slots in the window, in sub-chunks of TC slots
  int len = a.kv_lens[b], ws;
  if constexpr (RAW) a.pos.window(len, a.window, len, ws);   // the rank's local slots
  else ws = a.window > 0 ? max(len - a.window, 0) : 0;
  const qdec::Span span(len, ws, BS, W, sp, a.split_pages);
  if (span.empty()) {
    qdec::empty_split(out, head0, gb, D, S, RAW ? part : nullptr, Hq);
    return;
  }

  // Q's A fragments (rows gid; rows gid + 8 are zero), in the K fragments' k order
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint2 u = make_uint2(0u, 0u);
    if (gid < gb)
      u = *reinterpret_cast<const uint2*>(q + (head0 + gid) * D + 16 * kc + 4 * tig);
    qa[kc][0] = u.x;
    qa[kc][1] = u.y;
  }

  const long long RR = (long long)Hkv * St::RB;   // bytes a token row of a plane
  const long long plane = (long long)BS * RR;
  const long long splane = (long long)BS * Hkv;   // scales a plane
  const uint8_t* bytes = static_cast<const uint8_t*>(a.cache);
  const int wt = warp * WT;           // the warp's first row of a sub-chunk
  auto load = [&](int j, int st) {
    // the warp's 16 rows; rows outside [lo, hi) read as zeros
    const int r0 = span.row0(j, warp);
    const int lo = span.lo(r0), hi = span.hi(r0);
    const qdec::WarpRows<ONE_PAGE> rows(tables + (long long)b * W, r0, BS, NB, layer,
                                        lo < hi);
    uint8_t* stage = ndec_smem + st * St::BYTES;
    for (int x = lane; x < WT * CH; x += 32) {
      const int t = x / CH;
      const int c = x % CH;
      const bool in = t >= lo && t < hi;
      long long off = 0;
      if (in) {
        const qdec::Slot s = rows(t);
        off = s.page * 2 * plane + (long long)h * St::RB + (long long)s.row * RR + c * 16;
      }
      qdec::cp_async16(stage + (wt + t) * RS + c * 16, bytes + off, in);
      qdec::cp_async16(stage + St::V + (wt + t) * RS + c * 16, bytes + off + (in ? plane : 0),
                       in);
    }
    if constexpr (E::SCALES) {
      // the rows' K scales (lanes 0-15) and V scales (16-31), token-major planes
      const int t = lane % WT, v = lane / WT;
      const bool in = t >= lo && t < hi;
      long long off = 0;
      if (in) {
        const qdec::Slot s = rows(t);
        off = s.page * 2 * splane + v * splane + (long long)s.row * Hkv + h;
      }
      qdec::cp_async4(reinterpret_cast<float*>(stage + St::M) + v * TC + wt + t,
                      a.scales + off, in);
    }
    qdec::cp_commit();
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
    else qdec::cp_commit();
  }
  for (int j = span.j_lo; j < span.j_hi; ++j) {
    qdec::cp_wait<NST - 2>();
    // the warp's rows of sub-chunk j have landed for all its lanes, and the warp is
    // done with its rows of j - 1, whose stage takes j + NST - 1 now: each warp copies
    // and reads only its own rows, so no block barrier
    __syncwarp();
    const int nx = j + NST - 1;
    if (nx < span.j_hi) load(nx, (nx - span.j_lo) % NST);
    else qdec::cp_commit();
    // the warp's rows [lo, hi) are slots of the split in the window
    const int r0 = span.row0(j, warp);
    const int lo = span.lo(r0), hi = span.hi(r0);
    if (lo >= hi) continue;
    const uint8_t* stage = ndec_smem + ((j - span.j_lo) % NST) * St::BYTES;
    const float* sc = reinterpret_cast<const float*>(stage + St::M);   // with scales

    // S = Q K^T over the warp's two 8-token tiles, each K element read once
    float s[2][4];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      s[jt][0] = s[jt][1] = s[jt][2] = s[jt][3] = 0.f;
      const uint8_t* kr = stage + (wt + 8 * jt + gid) * RS;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b0, b1;
        k_fragment<T, E>(kr, kc, tig, b0, b1);
        const uint32_t qf[4] = {qa[kc][0], 0u, qa[kc][1], 0u};
        attn::Mma<T>::run(s[jt], qf, b0, b1);
      }
    }
    // scale (and K scale), softcap, mask; the online softmax of head gid
    float mx = MASK_VALUE;
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      float2 ksc = make_float2(1.f, 1.f);
      if constexpr (E::SCALES) ksc = *reinterpret_cast<const float2*>(sc + wt + 8 * jt + 2 * tig);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * jt + 2 * tig + e;
        float x = E::SCALES ? s[jt][e] * (a.scale * (e ? ksc.y : ksc.x)) : s[jt][e] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        x = t >= lo && t < hi ? x : MASK_VALUE;
        s[jt][e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = attn::quad_max(mx);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
    // P'^T's B fragments, hi and lo in V's operand type (P' = p, or p * vsc)
    uint32_t ph[2], pl[2];
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      float e0 = expf(s[jt][0] - m_new), e1 = expf(s[jt][1] - m_new);
      l += e0 + e1;                   // l sums the unscaled p
      if constexpr (E::SCALES) {
        const float2 vsc = *reinterpret_cast<const float2*>(sc + TC + wt + 8 * jt + 2 * tig);
        e0 *= vsc.x;
        e1 *= vsc.y;
      }
      split_hi_lo<TV>(e0, e1, ph[jt], pl[jt]);
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

    // O^T += V^T P'^T: the warp's tokens 2 tig, 2 tig + 1 (+8), dims 8 (gid + 8 u) ..;
    // tile (u, n) row gid is dim 8 (gid + 8 u) + n, row gid + 8 that dim + 4
    const uint8_t* vr = stage + St::V + (wt + 2 * tig) * RS;
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      if constexpr (sizeof(TK) == 2) {
        const int off = 16 * (gid + 8 * u);
        const uint4 x1 = *reinterpret_cast<const uint4*>(vr + off);
        const uint4 x2 = *reinterpret_cast<const uint4*>(vr + RS + off);
        const uint4 x3 = *reinterpret_cast<const uint4*>(vr + 8 * RS + off);
        const uint4 x4 = *reinterpret_cast<const uint4*>(vr + 9 * RS + off);
        const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w}, w2[4] = {x2.x, x2.y, x2.z, x2.w};
        const uint32_t w3[4] = {x3.x, x3.y, x3.z, x3.w}, w4[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          // two tokens' elements of one dim side by side
          const uint32_t sel = n & 1 ? 0x7632 : 0x5410;
          const int i = n >> 1;
          const uint32_t va[4] = {qdec::prmt(w1[i], w2[i], sel),
                                  qdec::prmt(w1[2 + i], w2[2 + i], sel),
                                  qdec::prmt(w3[i], w4[i], sel),
                                  qdec::prmt(w3[2 + i], w4[2 + i], sel)};
          attn::Mma<T>::run(o[u][n], va, ph[0], ph[1]);
          attn::Mma<T>::run(o[u][n], va, pl[0], pl[1]);
        }
      } else {
        const int off = 8 * (gid + 8 * u);
        const uint2 x1 = *reinterpret_cast<const uint2*>(vr + off);
        const uint2 x2 = *reinterpret_cast<const uint2*>(vr + RS + off);
        const uint2 x3 = *reinterpret_cast<const uint2*>(vr + 8 * RS + off);
        const uint2 x4 = *reinterpret_cast<const uint2*>(vr + 9 * RS + off);
        static_assert(std::is_same<TV, __nv_bfloat16>::value, "1-byte V decodes to bf16");
        // two tokens' bytes of one dim side by side: dims n = 0, 1 of each half from
        // 0x5140, n = 2, 3 from 0x7362
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const uint32_t sel = nn ? 0x7362 : 0x5140;
          const uint32_t z[4] = {qdec::prmt(x1.x, x2.x, sel), qdec::prmt(x1.y, x2.y, sel),
                                 qdec::prmt(x3.x, x4.x, sel), qdec::prmt(x3.y, x4.y, sel)};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int n = 2 * nn + hh;
            const uint32_t va[4] = {E::template dec<__nv_bfloat16>(z[0], hh),
                                    E::template dec<__nv_bfloat16>(z[1], hh),
                                    E::template dec<__nv_bfloat16>(z[2], hh),
                                    E::template dec<__nv_bfloat16>(z[3], hh)};
            attn::Mma<__nv_bfloat16>::run(o[u][n], va, ph[0], ph[1]);
            attn::Mma<__nv_bfloat16>::run(o[u][n], va, pl[0], pl[1]);
          }
        }
      }
    }
  }
  qdec::cp_wait<0>();
  __syncthreads();                    // the ring's smem takes the tail's
  qdec::block_tail<T, D>(o, m, l, 0.f, reinterpret_cast<float*>(ndec_smem), out, part,
                         head0, hq0, gb, b, S, sp, Hq, RAW ? nullptr : a.sinks, RAW);
}

}  // namespace ndec
