// W4A16 GEMM over plane-packed int4 weights, group-dot schedule, for Hopper (sm_90a).
//
// Replaces the group-dot body of the TPU kernel lmdeploy_tpu/ops/pallas/quant_matmul.py
// (w4a16_matmul_stacked, body _w4a16_kernel_stacked_gd).  Same function:
//   out[m, n] = sum_j sum_g (x_{j,g} @ (128 + q)_{j,g})[m, n] * s[j*Gq + g, n]
//             - sum_g xg[m, g] * corr[g, n]
// all in f32, written once as bf16 at the end.
//
// Layout: packed i32 [K/8, N]; plane j (0..3) covers x columns [j*K/4, (j+1)*K/4),
// word r holds plane row 2r at bits [4j, 4j+4) and row 2r+1 at bits [16+4j, 20+4j).
// So ((w >> 4j) & 0x000F000F) | 0x43004300 is a bf16x2 pair (128+q for rows 2r and
// 2r+1) with no convert.  sb / corr f32 [K/gs, N]; xg f32 [M, K/gs] holds the per-group
// sums of the same bf16 x this kernel reads (made by torch ops before the launch, as
// the reference does).
//
// Numerics (ROADMAP.md section 3, traps 1-3): every group's partial product is an f32
// wgmma accumulator, scaled by s in f32; the correction sum_g xg * corr (~17-30x the
// signal) is f32 FMA on the CUDA cores, never TF32; the output stays f32 until corr is
// subtracted.  Groups are folded in a fixed order (group-major, then plane), and a K
// split's partials are summed in split order: no order-free sums.
//
// What bounds it on an H100: at M = 128 (the e2e decode bucket) operations.  llama2-7b,
// gs 128, per layer (H100 SXM data sheet, 3.35 TB/s and 989 TFLOP/s; not measured):
//   wqkv     4096 x 12288   28.3 MB -> 8.5 us   (operations 13.0 us at M = 128)
//   wo       4096 x  4096    9.4 MB -> 2.8 us   (4.3 us)
//   w_gateup 4096 x 22016   50.7 MB -> 15.1 us  (23.3 us)
//   w_down  11264 x  4096   26.0 MB -> 7.8 us   (11.9 us; K padded from 11008)
// about 53 us a layer at M = 128; at M = 64 and below the weight bytes bound it.
//
// Design: the product is computed transposed, out^T = W^T x^T, so that the decoded
// weights are wgmma's A operand in registers and x is its B operand in shared memory.
//   * The magic-number decode gives k-adjacent bf16 pairs of one output column: exactly
//     the pairs of an A fragment of W^T.  A warp's 16 wgmma rows are 16 output columns;
//     its lane reads the words of rows tig and tig + 4 of a k16 step for two columns
//     and decodes them straight into a0..a3: the decoded weights never return to shared
//     memory, and each packed word feeds the 4 planes' k steps.  The fragments are
//     pinned in registers (hopper::fence_frags) before their wgmmas issue; left to
//     itself ptxas sank each decode down to its wgmma and reused one register set,
//     which made every wgmma wait for the one before.
//   * The wgmma N is the token tile (16, 64 or 128 rows by M), so for M <= 128 every
//     weight byte is read and decoded once.  M 129-256 (prefill chunks) runs two token
//     tiles as separate blocks (grid y), each reading the weights: the running sum and
//     the group's partial of 256 tokens would not both fit the registers.
//   * A block of 320 threads owns 128 output columns: two consumer warpgroups of 64
//     columns (one m64 tile each) and two producer warps.  One producer thread streams
//     each quant group's words (4 TMA boxes of 32 columns x gs/2 word rows, 128-byte
//     swizzle) and the S and C rows of its 4 planes (one 3-D box each) into a ring of
//     2-4 stages; the other streams, for each (group, plane), the x tile ([tokens][64
//     columns] boxes, 128-byte swizzle, rows past M read as zeros) and a [tokens][4]
//     window of xg into a ring of 4-8 stages; full / empty mbarriers, one release a
//     consumer warp.  Under the swizzle a warp's fragment reads are conflict-free once
//     the columns of a lane group gid are chosen as {0-3, 16-19} + 8 (warp % 2), and
//     + 4 for the fragment's rows gid + 8.
//   * Per (group, plane) a consumer issues the gs/16 wgmma k steps into a zeroed f32
//     partial (at 128 tokens in two halves, so that the fragments, the partial and the
//     running sum fit 168 registers), waits, and folds it in: acc += s * part - xg * C,
//     f32 FMA.  Up to 64 tokens a group's words are held in registers across its 4
//     planes.
//   * Narrow weights (wo, w_down: 32 column tiles on 132 SMs) split K over blocks
//     (w4a16_gd_splits in ops/quant_matmul.py picks the count): each split writes its
//     f32 partial to a workspace, and the last block of a tile to arrive (a per-tile
//     counter) sums the splits in split order, resets the counter and writes bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BN = 128;                       // output columns a block
constexpr int CONSUMERS = 256;                // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 64;       // + two producer warps
constexpr uint32_t NIBBLES = 0x000F000Fu;
constexpr uint32_t MAGIC = 0x43004300u;       // bf16 pair (128, 128): exponent 2^7, ulp 1

template <int GS, int NTOK>
struct Cfg {
  // the words' stage: a group's words (4 boxes of 32 columns x gs/2 rows), then the S
  // and C rows of its 4 planes ([4][BN] f32 each)
  static constexpr int W_BYTES = GS / 2 * BN * 4;
  static constexpr int S_OFF = W_BYTES;
  static constexpr int C_OFF = S_OFF + 4 * BN * 4;
  static constexpr int W_STAGE = C_OFF + 4 * BN * 4;
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
  static constexpr int KH = NTOK == 128 && KS > 1 ? KS / 2 : KS;   // k steps issued at once
  static_assert(NW >= 2 && NX >= 2, "ring too small");
};

__device__ __forceinline__ uint32_t decode(uint32_t w, int j) {
  return ((w >> (4 * j)) & NIBBLES) | MAGIC;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// the 256 consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int GS, int NTOK>
__global__ void __launch_bounds__(THREADS, 1)
w4a16_gd_kernel(const __grid_constant__ CUtensorMap xmap,   // x [M, K] bf16
                const __grid_constant__ CUtensorMap wmap,   // packed [K/8, N] i32
                const __grid_constant__ CUtensorMap smap,   // sb [4][Gq][N] f32
                const __grid_constant__ CUtensorMap cmap,   // corr [4][Gq][N] f32
                const __grid_constant__ CUtensorMap gmap,   // xg [M, G] f32
                __nv_bfloat16* __restrict__ out,            // [M, N]
                float* __restrict__ ws,                     // [S, N, Mp]
                int* __restrict__ counters,                 // [m tiles * n tiles]
                int M, int N, int K, int S) {
  using C = Cfg<GS, NTOK>;
  constexpr int NW = C::NW, NX = C::NX, R = C::R, KS = C::KS, KH = C::KH;
  constexpr bool HOLD = C::HOLD;
  __shared__ __align__(8) uint64_t full_w[NW], empty_w[NW], full_x[NX], empty_x[NX];
  __shared__ int last_block;
  extern __shared__ __align__(128) uint8_t raw[];
  // the word stages, then the x stages; 128-byte swizzle wants 1 KB alignment
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t xbase = base + NW * C::W_STAGE;
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
      mbar_init(smem_u32(&empty_w[s]), CONSUMERS / 32);   // one arrival a consumer warp
    }
#pragma unroll
    for (int s = 0; s < NX; ++s) {
      mbar_init(smem_u32(&full_x[s]), 1);
      mbar_init(smem_u32(&empty_x[s]), CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producers: one thread keeps the words' ring full (words, S and C of a group),
    // another the x ring (x and xg of a (group, plane)), each running as far ahead as
    // its ring allows
    if (threadIdx.x == CONSUMERS) {
      prefetch_map(&wmap);
      prefetch_map(&smap);
      prefetch_map(&cmap);
      for (int g = g_lo, wi = 0; g < g_hi; ++g, ++wi) {
        const int sw = wi % NW;
        mbar_wait(smem_u32(&empty_w[sw]), ((wi / NW) & 1) ^ 1);
        const uint32_t bw = smem_u32(&full_w[sw]);
        mbar_expect_tx(bw, C::W_STAGE);
        const uint32_t wd = base + sw * C::W_STAGE;
#pragma unroll
        for (int b = 0; b < BN / 32; ++b)
          tma_load(wd + b * (GS / 2) * 128, &wmap, n0 + 32 * b, g * (GS / 2), bw);
        tma_load(wd + C::S_OFF, &smap, n0, g, 0, bw);
        tma_load(wd + C::C_OFF, &cmap, n0, g, 0, bw);
      }
    } else if (threadIdx.x == CONSUMERS + 32) {
      prefetch_map(&xmap);
      prefetch_map(&gmap);
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
            tma_load(xd + a * NTOK * 128, &xmap, j * Kq + g * GS + 64 * a, m0, bx);
          tma_load(xd + C::XG_OFF, &gmap, (j * Gq + g) & ~3, m0, bx);
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
    for (int p = 0; p < 2; ++p)
      woff[h][p] = box * (GS / 2) * 128 + sw128_offset(tig + 4 * p, (cc >> 2) + h)
                   + (gid & 3) * 4;

  float acc[R], part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = part[i] = 0.f;

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
#pragma unroll
    for (int j = 0; j < 4; ++j, ++xi) {
      const int sx = xi % NX;
      const uint32_t xs = xbase + sx * C::X_STAGE;
      // plane j's A fragments of KH k steps, decoded from the words and pinned in
      // registers, then their wgmmas; at 128 tokens a plane goes in two such halves,
      // so that its fragments, the partial and the running sum fit the registers
      uint32_t a[KH][4];
      auto decode_part = [&](int k0) {
#pragma unroll
        for (int kk = 0; kk < KH; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[kk][i] = decode(HOLD ? w[HOLD ? k0 + kk : 0][i]
                                   : ld_shared(wst + (k0 + kk) * 8 * 128 + woff[i & 1][i >> 1]),
                              j);
        fence_frags(a);
      };
      auto issue_part = [&](int k0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KH; ++kk)   // the group's first k step overwrites the partial
          wgmma_rs<true, 0>(part, a[kk],
                            sw128_desc(xs + ((k0 + kk) / 4) * NTOK * 128 + ((k0 + kk) % 4) * 32),
                            k0 + kk > 0);
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
      // the plane's S and C of the thread's two columns, then acc += s * part - xg * C
      // in f32 once the partial has landed
      const uint32_t srow = wst + C::S_OFF + j * BN * 4 + (32 * box + cc) * 4;
      const uint32_t crow = wst + C::C_OFF + j * BN * 4 + (32 * box + cc) * 4;
      const float s0 = ld_shared_f32(srow), s1 = ld_shared_f32(srow + 16);
      const float c0 = ld_shared_f32(crow), c1 = ld_shared_f32(crow + 16);
      const uint32_t xgs = xs + C::XG_OFF + ((j * Gq + g) & 3) * 4;
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int jn = 0; jn < NTOK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xv = ld_shared_f32(xgs + (8 * jn + 2 * tig + e) * 16);
          acc[4 * jn + e] = fmaf(-xv, c0, fmaf(part[4 * jn + e], s0, acc[4 * jn + e]));
          acc[4 * jn + 2 + e] =
              fmaf(-xv, c1, fmaf(part[4 * jn + 2 + e], s1, acc[4 * jn + 2 + e]));
        }
      mbar_release_warp(&empty_x[sx], lane);
    }
    mbar_release_warp(&empty_w[sw], lane);
  }

  if (S > 1) {
    // split-K: publish this split's partial ([N][Mp], tokens contiguous); the tile's
    // last block sums them all in split order
    const long long Mp = (long long)gridDim.y * NTOK;
    float* mine = ws + (long long)split * N * Mp;
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
      const int arrived = atomicAdd(counters + tile, 1);
      last_block = arrived == S - 1;
      if (last_block) counters[tile] = 0;   // every split has arrived: ready to reuse
    }
    consumers_sync();
    if (!last_block) return;
    __threadfence();
    // the splits in split order, each split's loads all in flight together
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* part_s = ws + (long long)s * N * Mp + m0 + 2 * tig;
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
        if (row < M) out[(long long)row * N + col] = __float2bfloat16_rn(acc[4 * jn + 2 * h + e]);
      }
  }
}

template <int GS, int NTOK>
cudaError_t launch(const void* x, const void* packed, const void* sb, const void* corr,
                   const void* xg, void* out, void* ws, void* counters, int M, int N, int K,
                   int S, cudaStream_t stream) {
  using C = Cfg<GS, NTOK>;
  const int G = K / GS;
  CUtensorMap xmap, wmap, smap, cmap, gmap;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {64, NTOK};
  const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K / 8};
  const cuuint64_t ts[1] = {(cuuint64_t)N * 4};
  const cuuint32_t wb[2] = {32, GS / 2};
  const cuuint64_t td[3] = {(cuuint64_t)N, (cuuint64_t)G / 4, 4};
  const cuuint64_t tst[2] = {(cuuint64_t)N * 4, (cuuint64_t)G / 4 * N * 4};
  const cuuint32_t tb[3] = {BN, 1, 4};
  const cuuint64_t gd[2] = {(cuuint64_t)G, (cuuint64_t)M};
  const cuuint64_t gs[1] = {(cuuint64_t)G * 4};
  const cuuint32_t gb[2] = {4, NTOK};
  if (!tile_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb,
                CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, packed, wd, ts, wb,
                   CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, sb, td, tst, tb,
                   CU_TENSOR_MAP_SWIZZLE_NONE)
      || !tile_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, corr, td, tst, tb,
                   CU_TENSOR_MAP_SWIZZLE_NONE)
      || !tile_map(&gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xg, gd, gs, gb,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static cudaError_t configured = set_smem(w4a16_gd_kernel<GS, NTOK>, C::SMEM);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((N + BN - 1) / BN, (M + NTOK - 1) / NTOK, S);
  w4a16_gd_kernel<GS, NTOK><<<grid, THREADS, C::SMEM, stream>>>(
      xmap, wmap, smap, cmap, gmap, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, S);
  return cudaGetLastError();
}

// the token tile: 16 rows up to M 16, 64 up to 64, else 128 (ops/quant_matmul.token_tile)
template <int GS>
cudaError_t launch_m(const void* x, const void* packed, const void* sb, const void* corr,
                     const void* xg, void* out, void* ws, void* counters, int M, int N, int K,
                     int S, cudaStream_t st) {
  if (M <= 16)
    return launch<GS, 16>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, S, st);
  if (M <= 64)
    return launch<GS, 64>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, S, st);
  return launch<GS, 128>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, S, st);
}

}  // namespace

// x [M,K] bf16; packed [K/8,N] i32; sb, corr [K/gs,N] f32; xg [M,K/gs] f32; out [M,N]
// bf16; ws [splits, N, ceil(M/T)*T] f32 (unused when splits == 1); counters
// [ceil(N/128) * ceil(M/T)] i32, zero on entry and on return (T = the token tile: 16,
// 64 or 128 rows for M <= 16, <= 64, else); launches that may run at once need their
// own counters (the wrapper keeps one buffer per stream).  All contiguous, 16-byte
// aligned.  K % (4*gs) == 0, N % 8 == 0, 1 <= splits <= K/(4*gs), group_size 32, 64 or
// 128.  Returns the CUDA error code of the launch (0 = launched).
extern "C" int w4a16_gemm_gd(const void* x, const void* packed, const void* sb,
                             const void* corr, const void* xg, void* out, void* ws,
                             void* counters, int M, int N, int K, int group_size,
                             int splits, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (N % 8 || group_size <= 0 || K % (4 * group_size) || splits < 1
      || splits > K / (4 * group_size) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group_size) {
    case 32:
      return (int)launch_m<32>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, splits, s);
    case 64:
      return (int)launch_m<64>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, splits, s);
    case 128:
      return (int)launch_m<128>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
