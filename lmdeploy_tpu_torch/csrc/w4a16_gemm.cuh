// The W4A16 GEMM body over plane-packed int4 weights for Hopper (sm_90a), shared by the
// four schedules (w4a16_gemm.cu: gd; w4a16_gemm_szc.cu: fast and precise;
// w4a16_gemm_unprepared.cu: unprepared).  Each source wraps gemm_body in a __global__ of
// its own name, so traces and launch counts tell the schedules apart, and launches it
// through dispatch.
//
// Layout: packed i32 [K/8, N]; plane j (0..3) covers x columns [j*K/4, (j+1)*K/4),
// word r holds plane row 2r at bits [4j, 4j+4) and row 2r+1 at bits [16+4j, 20+4j).
// So ((w >> 4j) & 0x000F000F) | 0x43004300 is a bf16x2 pair (128+q for rows 2r and
// 2r+1) with no convert.  Per quant group g the kernels read a scale table S and a
// correction table C ([K/gs, N], read as [4 planes][K/(4 gs)][N]) and xg f32
// [M, K/gs], the per-group sums of the same bf16 x the kernel reads (made by torch ops
// before the launch, as the reference does).  The schedules:
//   GD          S = f32 s, C = f32 (z+128)*s: out = sum_g s_g (x_g @ (128+q)_g) - xg C
//   UNPREPARED  S = f32 s, C = f32 z (raw): the same, with C = (z + 128) * s formed in
//               registers in f32, two roundings, as the reference's (zeros + 128) * s
//   FAST        S = bf16 s, C = f32 (z+128)*s: out = x @ bf16((128+q)*s) - xg C, each
//               weight's product rounded once (bf16x2 FMA with -0)
//   PRECISE     S = bf16 s, C = bf16 (z-7)*s: (128+q) - 135 = q - 7 first (exact in
//               bf16), then times s as in FAST; xg arrives rounded to bf16
// Numerics (ROADMAP.md section 3, traps 1-3): the correction sum_g xg * C (~17-30x the
// signal in GD, UNPREPARED and FAST) is f32 FMA on the CUDA cores, never TF32; the
// output stays f32 until it is subtracted.  A K split's partials are summed in split
// order: no order-free sums.
//
// What bounds it on an H100: at the decode buckets (M <= 64) the weight bytes, at 128
// rows about evenly bytes and operations.  Mixtral-8x7B's wqkv (4096 x 6144, gs 128)
// is 12.6 MB of words and 0.8-1.6 MB of tables, ~4.2 us at 3.35 TB/s, against 3.3 us
// of operations at M = 64 (989 TFLOP/s; H100 SXM data sheet, not measured).
//
// Design: the product is computed transposed, out^T = W^T x^T, so that the decoded
// weights are wgmma's A operand in registers and x is its B operand in shared memory.
//   * The magic-number decode gives k-adjacent bf16 pairs of one output column: exactly
//     the pairs of an A fragment of W^T.  A warp's 16 wgmma rows are 16 output columns;
//     its lane reads the words of rows tig and tig + 4 of a k16 step for two columns
//     (col0: fragment registers a0 / a2, col1: a1 / a3) and decodes them straight into
//     a0..a3: the decoded weights never return to shared memory, and each packed word
//     feeds the 4 planes' k steps.  The fragments are pinned in registers
//     (hopper::fence_frags) before their wgmmas issue; left to itself ptxas sank each
//     decode down to its wgmma and reused one register set, which made every wgmma
//     wait for the one before.
//   * The wgmma N is the token tile (16, 64 or 128 rows by M), so for M <= 128 every
//     weight byte is read and decoded once.  M 129-256 (prefill chunks) runs two token
//     tiles as separate blocks (grid y), each reading the weights.
//   * A block of 320 threads owns 128 output columns: two consumer warpgroups of 64
//     columns (one m64 tile each) and two producer warps.  One producer thread streams
//     each quant group's words (4 TMA boxes of 32 columns x gs/2 word rows, 128-byte
//     swizzle) and the S and C rows of its 4 planes (one 3-D box each) into a ring of
//     2-4 stages; the other streams, for each (group, plane), the x tile ([tokens][64
//     columns] boxes, 128-byte swizzle, rows past M read as zeros) and a [tokens][4]
//     window of xg into a ring of 4-8 stages; full / empty mbarriers.  Under the
//     swizzle a warp's fragment reads are conflict-free once the columns of a lane
//     group gid are chosen as {0-3, 16-19} + 8 (warp % 2), and + 4 for the fragment's
//     rows gid + 8.  Up to 64 tokens a group's words are held in registers across its
//     4 planes.
//   * GD and UNPREPARED scale each group's dot outputs, so per (group, plane) a
//     consumer issues the gs/16 wgmma k steps into a zeroed f32 partial (at 128 tokens
//     in two halves), waits, and folds it in: acc += s * part - xg * C, f32 FMA.  One
//     arrival a consumer warp releases a stage.
//   * FAST and PRECISE scale each weight before the product, so one accumulator runs
//     over every group and plane with no wait or fold between them: the consumer
//     decodes units of KU k steps into two fragment sets in turn, issues a unit's
//     wgmmas, adds the plane's xg * C into a correction of its own (f32 FMA, while the
//     tensor cores work) and waits only for the unit before (wgmma_wait<1>), whose
//     fragment registers the next unit refills; a plane's x stage is released once the
//     wait shows its last wgmmas done.  Every consumer thread arrives for itself: a
//     lane's branch inside the wgmma chain makes ptxas serialise it.  The correction is
//     subtracted at the end, as the TPU kernel's acc - corr; every 4096 rows of K the
//     chain is folded into it (corr -= acc, one wait), since wgmma's f32 sum of the
//     ~30x biased fast products over a longer chain drifts (K = 11264 in one chain read
//     1.03x the allowance on an H100).  At 128 tokens the accumulator alone takes 64
//     of the 168 registers ptxas allows a thread of a 320-thread block, and a
//     correction beside it spilled: there each plane's xg * C is subtracted from the
//     accumulator once its wgmmas have landed (a wait a plane, none between its
//     units), which keeps the running sum near the signal.
//   * Narrow weights (wo, w_down: 32 column tiles on 132 SMs) split K over blocks
//     (w4a16_splits in ops/quant_matmul.py picks the count): each split writes its f32
//     partial to a workspace, and the last block of a tile to arrive (a per-tile
//     counter) sums the splits in split order, resets the counter and writes bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace w4a16 {

using namespace hopper;

enum Mode { GD = 0, UNPREPARED = 1, FAST = 2, PRECISE = 3 };

constexpr int BN = 128;                       // output columns a block
constexpr int CONSUMERS = 256;                // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 64;       // + two producer warps
constexpr uint32_t NIBBLES = 0x000F000Fu;
constexpr uint32_t MAGIC = 0x43004300u;       // bf16 pair (128, 128): exponent 2^7, ulp 1
constexpr uint32_t BF16X2_ONE = 0x3F803F80u;  // (1, 1)
constexpr uint32_t BF16X2_M135 = 0xC307C307u; // (-135, -135)
constexpr uint32_t BF16X2_M0 = 0x80008000u;   // (-0, -0): a*b + -0 is a*b, rounded once

// the kernel's arguments: five tensor maps (__grid_constant__, so TMA reads them in
// place) and the rest
struct Params {
  CUtensorMap xmap;   // x [M, K] bf16
  CUtensorMap wmap;   // packed [K/8, N] i32
  CUtensorMap smap;   // S [4][Gq][N]
  CUtensorMap cmap;   // C [4][Gq][N]
  CUtensorMap gmap;   // xg [M, G] f32
  __nv_bfloat16* out; // [M, N]
  float* ws;          // [S, N, Mp]
  int* counters;      // [m tiles * n tiles]
  int M, N, K, S;
};

template <int MODE, int GS, int NTOK>
struct Cfg {
  // one accumulator over every group and plane (the scale is on each weight)
  static constexpr bool CHAIN = MODE == FAST || MODE == PRECISE;
  static constexpr int SB = CHAIN ? 2 : 4;              // bytes of an S entry
  static constexpr int CB = MODE == PRECISE ? 2 : 4;    // bytes of a C entry
  // the words' stage: a group's words (4 boxes of 32 columns x gs/2 rows), then the S
  // and C rows of its 4 planes ([4][BN] each), 1 KB aligned for the next stage's swizzle
  static constexpr int W_BYTES = GS / 2 * BN * 4;
  static constexpr int S_OFF = W_BYTES;
  static constexpr int C_OFF = S_OFF + 4 * BN * SB;
  static constexpr int W_TX = C_OFF + 4 * BN * CB;
  static constexpr int W_STAGE = (W_TX + 1023) / 1024 * 1024;
  // the x stage of one (group, plane): XW / 64 boxes of [NTOK][64 columns], then a
  // [NTOK][4] window of xg
  static constexpr int XW = GS < 64 ? 64 : GS;
  static constexpr int X_BYTES = NTOK * XW * 2;
  static constexpr int XG_OFF = X_BYTES;
  static constexpr int X_TX = XG_OFF + NTOK * 16;
  static constexpr int X_STAGE = (X_TX + 1023) / 1024 * 1024;
  static constexpr int W_BUDGET = (NTOK == 16 ? 144 : NTOK == 64 ? 108 : 72) * 1024;
  static constexpr int NW_FIT = W_BUDGET / W_STAGE;
  static constexpr int NW = NW_FIT > 8 ? 8 : NW_FIT;   // groups of words in flight
  static constexpr int NX_FIT = (225 * 1024 - NW * W_STAGE) / X_STAGE;
  static constexpr int NX = NX_FIT > 8 ? 8 : NX_FIT;   // (group, plane) x stages in flight
  static constexpr int SMEM = NW * W_STAGE + NX * X_STAGE + 1024;
  static constexpr int R = NTOK / 2;                   // accumulator floats a thread
  static constexpr int KS = GS / 16;                   // wgmma k steps a group
  static constexpr bool HOLD = NTOK <= 64;             // a group's words held in registers
  // k steps issued at once: a plane (gd, unprepared; at 128 tokens half of one), or a
  // unit of the chain, two of which are in registers at a time
  static constexpr int KH = NTOK == 128 && KS > 1 ? KS / 2 : KS;
  static constexpr int KU = NTOK == 16 ? KS : KS < 2 ? KS : 2;
  // the chain's correction in registers of its own (else, at 128 tokens, where the
  // accumulator alone takes 64 of 168 registers, subtracted from it a plane at a time)
  static constexpr bool CORR = CHAIN && NTOK <= 64;
  // the chain's token columns (n8 tiles) of the correction a unit adds
  static constexpr int JN = NTOK / 8 / (KS / KU);
  // groups between the chain's folds of its accumulator into the correction registers:
  // 4096 rows of K, 256 k steps (wgmma's f32 sum over a longer chain of the ~30x
  // biased fast products drifted past the allowance at K = 11264)
  static constexpr int FOLD = 4096 / (4 * GS);
  // arrivals that release a stage: one a consumer warp, or one a consumer thread
  static constexpr int ARRIVALS = CHAIN ? CONSUMERS : CONSUMERS / 32;
  static_assert(NW >= 2 && NX >= 2, "ring too small");
  static_assert(KS % KU == 0 && KS % KH == 0 && NTOK / 8 % (KS / KU) == 0, "k steps");
};

// one A register of plane j from a packed word: the bf16 pair 128 + q (gd, unprepared);
// less 135 (precise, exact); times the column's bf16 scale pair s, rounded once (fast,
// precise)
template <int MODE>
__device__ __forceinline__ uint32_t weight_pair(uint32_t w, int j, uint32_t s) {
  uint32_t v = ((w >> (4 * j)) & NIBBLES) | MAGIC;
  if constexpr (MODE == PRECISE)
    asm("fma.rn.bf16x2 %0, %0, %1, %2;\n" : "+r"(v) : "r"(BF16X2_ONE), "r"(BF16X2_M135));
  if constexpr (MODE == FAST || MODE == PRECISE)
    asm("fma.rn.bf16x2 %0, %0, %1, %2;\n" : "+r"(v) : "r"(s), "r"(BF16X2_M0));
  return v;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// a 2-byte entry (a bf16 scale or correction), zero-extended
__device__ __forceinline__ uint32_t ld_shared_b16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// an f32 S or C entry, or a bf16 one widened
template <int BYTES>
__device__ __forceinline__ float ld_table(uint32_t addr) {
  if constexpr (BYTES == 4) return ld_shared_f32(addr);
  else return __uint_as_float(ld_shared_b16(addr) << 16);
}

// the 256 consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int MODE, int GS, int NTOK>
__device__ __forceinline__ void
gemm_body(const Params& p) {
  using C = Cfg<MODE, GS, NTOK>;
  constexpr int NW = C::NW, NX = C::NX, R = C::R, KS = C::KS, KH = C::KH, KU = C::KU;
  constexpr bool HOLD = C::HOLD, CHAIN = C::CHAIN;
  __shared__ __align__(8) uint64_t full_w[NW], empty_w[NW], full_x[NX], empty_x[NX];
  __shared__ int last_block;
  extern __shared__ __align__(128) uint8_t raw[];
  // the word stages, then the x stages; 128-byte swizzle wants 1 KB alignment
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t xbase = base + NW * C::W_STAGE;
  const int M = p.M, N = p.N, K = p.K, S = p.S;
  const int Kq = K / 4;
  const int Gq = K / (4 * GS);
  const int n_tile = blockIdx.x, m_tile = blockIdx.y, split = blockIdx.z;
  const int n0 = n_tile * BN, m0 = m_tile * NTOK;
  const int g_lo = (int)((long long)Gq * split / S);
  const int g_hi = (int)((long long)Gq * (split + 1) / S);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NW; ++s) {
      mbar_init(smem_u32(&full_w[s]), 1);
      mbar_init(smem_u32(&empty_w[s]), C::ARRIVALS);
    }
#pragma unroll
    for (int s = 0; s < NX; ++s) {
      mbar_init(smem_u32(&full_x[s]), 1);
      mbar_init(smem_u32(&empty_x[s]), C::ARRIVALS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producers: one thread keeps the words' ring full (words, S and C of a group),
    // another the x ring (x and xg of a (group, plane)), each running as far ahead as
    // its ring allows
    if (threadIdx.x == CONSUMERS) {
      prefetch_map(&p.wmap);
      prefetch_map(&p.smap);
      prefetch_map(&p.cmap);
      for (int g = g_lo, wi = 0; g < g_hi; ++g, ++wi) {
        const int sw = wi % NW;
        mbar_wait(smem_u32(&empty_w[sw]), ((wi / NW) & 1) ^ 1);
        const uint32_t bw = smem_u32(&full_w[sw]);
        mbar_expect_tx(bw, C::W_TX);
        const uint32_t wd = base + sw * C::W_STAGE;
#pragma unroll
        for (int b = 0; b < BN / 32; ++b)
          tma_load(wd + b * (GS / 2) * 128, &p.wmap, n0 + 32 * b, g * (GS / 2), bw);
        tma_load(wd + C::S_OFF, &p.smap, n0, g, 0, bw);
        tma_load(wd + C::C_OFF, &p.cmap, n0, g, 0, bw);
      }
    } else if (threadIdx.x == CONSUMERS + 32) {
      prefetch_map(&p.xmap);
      prefetch_map(&p.gmap);
      int xi = 0;
      for (int g = g_lo; g < g_hi; ++g) {
#pragma unroll 1
        for (int j = 0; j < 4; ++j, ++xi) {
          const int sx = xi % NX;
          mbar_wait(smem_u32(&empty_x[sx]), ((xi / NX) & 1) ^ 1);
          const uint32_t bx = smem_u32(&full_x[sx]);
          mbar_expect_tx(bx, C::X_TX);
          const uint32_t xd = xbase + sx * C::X_STAGE;
#pragma unroll
          for (int a = 0; a < C::XW / 64; ++a)
            tma_load(xd + a * NTOK * 128, &p.xmap, j * Kq + g * GS + 64 * a, m0, bx);
          tma_load(xd + C::XG_OFF, &p.gmap, (j * Gq + g) & ~3, m0, bx);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg (0, 1) owns the block's columns 64 wg .. 64 wg + 63
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // the warp's 16 rows are 16 columns of word box `box` (32 columns): row gid is
  // column cc of the box, row gid + 8 column cc + 4
  const int box = 2 * wg + (warp >> 1);
  const int cc = 8 * (warp & 1) + (gid & 3) + 16 * (gid >> 2);
  const int col0 = n0 + 32 * box + cc;
  const int col1 = col0 + 4;
  // byte offsets in the box of the lane's words of a k step: [column half][row tig / tig + 4]
  uint32_t woff[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      woff[h][q] = box * (GS / 2) * 128 + sw128_offset(tig + 4 * q, (cc >> 2) + h)
                   + (gid & 3) * 4;
  auto x_desc = [&](uint32_t xs, int k) {
    return sw128_desc(xs + (k / 4) * NTOK * 128 + (k % 4) * 32);
  };
  // a consumer's release of a ring stage (C::ARRIVALS)
  auto release = [&](uint64_t* bar) {
    if constexpr (CHAIN) mbar_arrive(smem_u32(bar));
    else mbar_release_warp(bar, lane);
  };

  constexpr bool CORR = C::CORR;
  float acc[R], part[CHAIN ? 1 : R], corr[CORR ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (CHAIN ? 1 : R); ++i) part[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (CORR ? R : 1); ++i) corr[i] = 0.f;
  // the A fragments: the chain's two sets (unit u in set u % 2), or gd's one
  constexpr int KF = CHAIN ? KU : KH;
  uint32_t af[CHAIN ? 2 : 1][KF][4];

  int xi = 0;
  for (int g = g_lo, wi = 0; g < g_hi; ++g, ++wi) {
    const int sw = wi % NW;
    mbar_wait(smem_u32(&full_w[sw]), (wi / NW) & 1);
    const uint32_t wst = base + sw * C::W_STAGE;
    // up to 64 tokens the group's words stay in registers across its 4 planes: each
    // word is read from shared memory once, not once a plane
    uint32_t w[HOLD ? KS : 1][4];
    if constexpr (HOLD) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[kk][i] = ld_shared(wst + kk * 8 * 128 + woff[i & 1][i >> 1]);
    }
    auto word = [&](int k, int i) -> uint32_t {
      if constexpr (HOLD) return w[k][i];
      else return ld_shared(wst + k * 8 * 128 + woff[i & 1][i >> 1]);
    };
#pragma unroll
    for (int j = 0; j < 4; ++j, ++xi) {
      const int sx = xi % NX;
      const uint32_t xs = xbase + sx * C::X_STAGE;
      // the plane's S and C of the thread's two columns, and its xg window
      const uint32_t srow = wst + C::S_OFF + (j * BN + 32 * box + cc) * C::SB;
      const uint32_t crow = wst + C::C_OFF + (j * BN + 32 * box + cc) * C::CB;
      const uint32_t xgs = xs + C::XG_OFF + ((j * Gq + g) & 3) * 4;
      if constexpr (CHAIN) {
        // each weight times its column's bf16 scale: col0's pair in a0 / a2, col1's in
        // a1 / a3
        const uint32_t sp[2] = {ld_shared_b16(srow) * 0x10001u,
                                ld_shared_b16(srow + 4 * C::SB) * 0x10001u};
        float c0, c1;
#pragma unroll
        for (int k0 = 0; k0 < KS; k0 += KU) {
          uint32_t (&a)[KF][4] = af[((j * KS + k0) / KU) & 1];
#pragma unroll
          for (int kk = 0; kk < KU; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[kk][i] = weight_pair<MODE>(word(k0 + kk, i), j, sp[i & 1]);
          fence_frags(a);
          if (k0 == 0) mbar_wait(smem_u32(&full_x[sx]), (xi / NX) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KU; ++kk)
            wgmma_rs<true, 0>(acc, a[kk], x_desc(xs, k0 + kk), 1);
          wgmma_commit();
          if constexpr (CORR) {
            // corr += xg * C for the plane, f32 FMA while the tensor cores work, its
            // token columns spread over the plane's units
            if (k0 == 0) {
              c0 = ld_table<C::CB>(crow);
              c1 = ld_table<C::CB>(crow + 4 * C::CB);
            }
#pragma unroll
            for (int jn = k0 / KU * C::JN; jn < (k0 / KU + 1) * C::JN; ++jn)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float xv = ld_shared_f32(xgs + (8 * jn + 2 * tig + e) * 16);
                corr[4 * jn + e] = fmaf(xv, c0, corr[4 * jn + e]);
                corr[4 * jn + 2 + e] = fmaf(xv, c1, corr[4 * jn + 2 + e]);
              }
            // the unit before has completed: its fragment registers may be refilled, and
            // at a plane's first unit the previous plane's x stage is free
            wgmma_wait<1>();
            if (k0 == 0 && xi > 0) release(&empty_x[(xi - 1) % NX]);
          } else if (k0 + KU < KS) {
            wgmma_wait<1>();
          }
        }
        if constexpr (!CORR) {
          // acc -= xg * C in f32 once the plane's wgmmas have landed
          c0 = ld_table<C::CB>(crow);
          c1 = ld_table<C::CB>(crow + 4 * C::CB);
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int jn = 0; jn < NTOK / 8; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xv = ld_shared_f32(xgs + (8 * jn + 2 * tig + e) * 16);
              acc[4 * jn + e] = fmaf(-xv, c0, acc[4 * jn + e]);
              acc[4 * jn + 2 + e] = fmaf(-xv, c1, acc[4 * jn + 2 + e]);
            }
          release(&empty_x[sx]);
        }
      } else {
        // plane j's A fragments of KH k steps, decoded from the words and pinned in
        // registers, then their wgmmas into the zeroed partial; at 128 tokens a plane
        // goes in two such halves, so that its fragments, the partial and the running
        // sum fit the registers
        uint32_t (&a)[KF][4] = af[0];
        auto decode_part = [&](int k0) {
#pragma unroll
          for (int kk = 0; kk < KH; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[kk][i] = weight_pair<MODE>(word(k0 + kk, i), j, 0);
          fence_frags(a);
        };
        auto issue_part = [&](int k0) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KH; ++kk)   // the plane's first k step overwrites the partial
            wgmma_rs<true, 0>(part, a[kk], x_desc(xs, k0 + kk), k0 + kk > 0);
          wgmma_commit();
        };
        decode_part(0);
        mbar_wait(smem_u32(&full_x[sx]), (xi / NX) & 1);
        fence_regs(part);
        issue_part(0);
#pragma unroll
        for (int k0 = KH; k0 < KS; k0 += KH) {
          wgmma_wait<0>();                // the fragment registers are read no more
          decode_part(k0);
          issue_part(k0);
        }
        // acc += s * part - xg * C in f32 once the partial has landed
        wgmma_wait<0>();
        fence_regs(part);
        const float s0 = ld_shared_f32(srow), s1 = ld_shared_f32(srow + 4 * C::SB);
        float c0 = ld_shared_f32(crow), c1 = ld_shared_f32(crow + 4 * C::CB);
        if constexpr (MODE == UNPREPARED) {
          // the reference's (z + 128) * s, each f32 operation rounded as there
          c0 = __fmul_rn(__fadd_rn(c0, 128.f), s0);
          c1 = __fmul_rn(__fadd_rn(c1, 128.f), s1);
        }
#pragma unroll
        for (int jn = 0; jn < NTOK / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xv = ld_shared_f32(xgs + (8 * jn + 2 * tig + e) * 16);
            acc[4 * jn + e] = fmaf(-xv, c0, fmaf(part[4 * jn + e], s0, acc[4 * jn + e]));
            acc[4 * jn + 2 + e] =
                fmaf(-xv, c1, fmaf(part[4 * jn + 2 + e], s1, acc[4 * jn + 2 + e]));
          }
        release(&empty_x[sx]);
      }
    }
    // the group's words, S and C have been read into registers
    release(&empty_w[sw]);
    if constexpr (CORR) {
      if (wi % C::FOLD == C::FOLD - 1 && g + 1 < g_hi) {
        // fold: corr - acc keeps the difference, the chain restarts from zero
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          corr[i] -= acc[i];
          acc[i] = 0.f;
        }
      }
    }
  }
  if constexpr (CORR) {
    // the last chain, less the correction (and the earlier chains folded into it)
    wgmma_wait<0>();
    fence_regs(acc);
    if (xi > 0) release(&empty_x[(xi - 1) % NX]);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] -= corr[i];
  }

  if (S > 1) {
    // split-K: publish this split's partial ([N][Mp], tokens contiguous); the tile's
    // last block sums them all in split order
    const long long Mp = (long long)gridDim.y * NTOK;
    float* mine = p.ws + (long long)split * N * Mp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h ? col1 : col0;
      if (col >= N) continue;
#pragma unroll
      for (int jn = 0; jn < NTOK / 8; ++jn)
        *reinterpret_cast<float2*>(mine + col * Mp + m0 + 8 * jn + 2 * tig) =
            make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
    __threadfence();
    consumers_sync();
    if (threadIdx.x == 0) {
      const int tile = m_tile * gridDim.x + n_tile;
      const int arrived = atomicAdd(p.counters + tile, 1);
      last_block = arrived == S - 1;
      if (last_block) p.counters[tile] = 0;   // every split has arrived: ready to reuse
    }
    consumers_sync();
    if (!last_block) return;
    __threadfence();
    // the splits in split order, each split's loads all in flight together
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* part_s = p.ws + (long long)s * N * Mp + m0 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h ? col1 : col0;
        if (col >= N) continue;
#pragma unroll
        for (int jn = 0; jn < NTOK / 8; ++jn) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(part_s + col * Mp + 8 * jn));
          acc[4 * jn + 2 * h] += v.x;
          acc[4 * jn + 2 * h + 1] += v.y;
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = h ? col1 : col0;
    if (col >= N) continue;
#pragma unroll
    for (int jn = 0; jn < NTOK / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * jn + 2 * tig + e;
        if (row < M) p.out[(long long)row * N + col] = __float2bfloat16_rn(acc[4 * jn + 2 * h + e]);
      }
  }
}

// ------------------------------------------------------------------------ host side
// the launch of one (group size, token tile) build: encodes the tensor maps and calls
// KERNEL::run<GS, NTOK>, the source's own __global__ launch
template <class KERNEL, int GS, int NTOK>
cudaError_t launch(const void* x, const void* packed, const void* tab_s, const void* tab_c,
                   const void* xg, void* out, void* ws, void* counters, int M, int N, int K,
                   int S, cudaStream_t stream) {
  using C = Cfg<KERNEL::MODE, GS, NTOK>;
  const int G = K / GS;
  const CUtensorMapDataType s_type =
      C::SB == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapDataType c_type =
      C::CB == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  Params p;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xst[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {64, NTOK};
  const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K / 8};
  const cuuint64_t wst[1] = {(cuuint64_t)N * 4};
  const cuuint32_t wb[2] = {32, GS / 2};
  // S and C [4 planes][G/4][N]: one box is a group's row of each plane
  const cuuint64_t td[3] = {(cuuint64_t)N, (cuuint64_t)G / 4, 4};
  const cuuint64_t sst[2] = {(cuuint64_t)N * C::SB, (cuuint64_t)G / 4 * N * C::SB};
  const cuuint64_t cst[2] = {(cuuint64_t)N * C::CB, (cuuint64_t)G / 4 * N * C::CB};
  const cuuint32_t tb[3] = {BN, 1, 4};
  const cuuint64_t gd[2] = {(cuuint64_t)G, (cuuint64_t)M};
  const cuuint64_t gst[1] = {(cuuint64_t)G * 4};
  const cuuint32_t gb[2] = {4, NTOK};
  if (!tile_map(&p.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xst, xb,
                CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&p.wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, packed, wd, wst, wb,
                   CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&p.smap, s_type, 3, tab_s, td, sst, tb, CU_TENSOR_MAP_SWIZZLE_NONE)
      || !tile_map(&p.cmap, c_type, 3, tab_c, td, cst, tb, CU_TENSOR_MAP_SWIZZLE_NONE)
      || !tile_map(&p.gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xg, gd, gst, gb,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.N = N;
  p.K = K;
  p.S = S;
  const dim3 grid((N + BN - 1) / BN, (M + NTOK - 1) / NTOK, S);
  return KERNEL::template run<GS, NTOK>(p, grid, C::SMEM, stream);
}

// the token tile: 16 rows up to M 16, 64 up to 64, else 128 (ops/quant_matmul.token_tile)
template <class KERNEL, int GS>
cudaError_t launch_m(const void* x, const void* packed, const void* tab_s, const void* tab_c,
                     const void* xg, void* out, void* ws, void* counters, int M, int N, int K,
                     int S, cudaStream_t st) {
  if (M <= 16)
    return launch<KERNEL, GS, 16>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N, K, S, st);
  if (M <= 64)
    return launch<KERNEL, GS, 64>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N, K, S, st);
  return launch<KERNEL, GS, 128>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N, K, S, st);
}

// The C entries' common body: x [M,K] bf16; packed [K/8,N] i32; tab_s, tab_c [K/gs,N] (the
// schedule's S and C tables); xg [M,K/gs] f32; out [M,N] bf16; ws [splits, N,
// ceil(M/T)*T] f32 (unused when splits == 1); counters [ceil(N/128) * ceil(M/T)] i32,
// zero on entry and on return (T = the token tile: 16, 64 or 128 rows for M <= 16, <=
// 64, else); launches that may run at once need their own counters (the wrapper keeps
// one buffer per stream).  All contiguous, 16-byte aligned.  K % (4*gs) == 0, N % 8 ==
// 0, 1 <= splits <= K/(4*gs), group_size 32, 64 or 128.  Returns the CUDA error code of
// the launch (0 = launched).
template <class KERNEL>
int dispatch(const void* x, const void* packed, const void* tab_s, const void* tab_c,
             const void* xg, void* out, void* ws, void* counters, int M, int N, int K,
             int group_size, int splits, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (N % 8 || group_size <= 0 || K % (4 * group_size) || splits < 1
      || splits > K / (4 * group_size) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group_size) {
    case 32:
      return (int)launch_m<KERNEL, 32>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N,
                                       K, splits, s);
    case 64:
      return (int)launch_m<KERNEL, 64>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N,
                                       K, splits, s);
    case 128:
      return (int)launch_m<KERNEL, 128>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N,
                                        K, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace w4a16
