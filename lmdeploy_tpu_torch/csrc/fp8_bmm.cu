// Blocked-fp8 expert-batched GEMM for Hopper (sm_90a): the routed-expert products of a
// dense-combine MoE step over fp8-e4m3-resident expert stacks (DeepSeek-V3's native
// checkpoint format, 128 x 128 scale blocks).
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/quant_bmm.py (fp8_bmm, body
// _fp8_kernel, decode _decode_fp8_e4m3).  Same function:
//   out[e, m, n] = sum_k bf16(x(@e)[m, k]) * bf16(e4m3(w8[e, k, n]) * gscale[e, k/g, n])
// with f32 accumulation, written once as f32 [E, M, N].
//
// Layout: w8 e4m3 bytes [E, K, N]; gscale f32 [E, K/g, N], the checkpoint's
// [N/128, K/128] scale_inv grid transposed and expanded along N at load, so a weight
// takes the scale of its K group and its own column.  The group g = K / (K/g) is read
// from the shapes (128 on DeepSeek checkpoints, 32 in the tiny test checkpoints).  x
// is bf16 [M, K] shared by every expert (the gate and up products) or [E, M, K], one
// slice per expert (the down product); the wrapper rounds an f32 x to bf16 first, as
// the reference does.
//
// Numerics: each weight is decoded to f32, multiplied by its f32 scale and rounded once
// to bf16, as the reference does (val * s_row -> bf16); the products take bf16
// operands (an fp8 wgmma would need x in e4m3 and the scale outside the sum: another
// function).  The decode is the reference's arithmetic one, in the f32 bit fields: the
// byte's exponent and mantissa bits (em) shifted to bits 20-26 and its sign to bit 31
// read as decode(b) * 2^-120 for every code (normals land on f32 normals, subnormals
// m 2^-9 on f32 subnormals m 2^-129, zero on zero, and the NaN code 0x7f / 0xff on
// +-480 * 2^-120, as the reference reads it), so times 2^120 (exact) it is the decoded
// value, then times the scale in f32 and one rounding to bf16.  The products run on
// wgmma with one f32 accumulator per output over all of K; only the f32 summation order
// differs from the plain version.
//
// What bounds it on an H100: bytes.  DeepSeek-V2-Lite (H 2048, Ie 1408, E 64) at the
// decode path's M = 64, one layer's gate + up + down: 553.6 MB of e4m3 weights,
// 17 MB of f32 scales, 80 MB of f32 outputs and 11.5 MB of down input ~ 0.66 GB,
// 0.198 ms at 3.35 TB/s; 70.9 GFLOP, 0.072 ms at 989 TFLOP/s (H100 SXM data sheet).
// The weights cross the card once; what stands between them and the tensor cores is
// their decode (three integer operations, two multiplies and half a conversion a weight).
//
// Design: the product is computed transposed, out^T = W^T x^T: the decoded weights are
// wgmma's A operand in registers, x its B operand in shared memory.
//   * Persistent, warp-specialised blocks of 288 threads, one an SM, walking work items
//     (expert, 256-column tile, token tile) in turn.  A producer warp (one thread)
//     streams each item's K in stages of 128 rows into a ring
//     of shared memory (3-5 stages, ~220 KB) by TMA, against full / empty mbarriers,
//     running on into the next item while the consumers finish one.  A stage holds the
//     128 x 256 weight bytes (two [128 rows][128 B] boxes, 128-byte swizzle), the x tile
//     ([tokens][64 columns] boxes, 128-byte swizzle, rows past M read as zeros; one 3-D
//     tensor map serves a shared x and the per-expert down input) and the scale rows
//     of the groups its 128 K rows touch (scale_rows: up to 8, at group 16; a group
//     that neither divides 128 nor is a multiple of it straddles stages).
//   * Two consumer warpgroups own 128 columns each, two m64 tiles.  A lane
//     reads 32-bit words of 4 adjacent columns from the 4 k rows of its A fragments
//     (rows 2 tig, 2 tig + 1, + 8, + 9 of a k16 step: conflict-free under the swizzle)
//     and decodes them into the fragments of both tiles: column 4 gid + q is row gid
//     (q even) or gid + 8 (q odd) of tile q / 2.  So the epilogue writes 4 adjacent f32
//     columns a token.  The decode of k step i + 1 runs while the wgmmas of step i are
//     in flight (A double-buffered and pinned in registers, hopper::fence_frags); a
//     stage is released, one arrival a consumer warp, as soon as its last wgmmas have
//     completed.  At 128 tokens the two accumulators take 128 of the 168 registers, and
//     ptxas waits for each k step's wgmmas before the next decode.
//   * The token tile is 16, 64 or 128 rows by M; larger M (prefill chunks up to 767
//     rows) takes several token tiles, each an item.
//   * A group that divides 128 or is a multiple of it gives k step kk of every stage
//     the same scale row; a group that straddles stages (48, 96, 192, ...) runs its own
//     build, which counts the row on from the stage's first group.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BN = 256;               // output columns an item: 2 consumers x 2 m64 tiles
constexpr int KS = 128;               // K rows a stage
constexpr int SR = 8;                 // scale rows a stage holds at most (group 16)
constexpr int CONSUMERS = 256;        // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp

template <int NTOK>
struct Cfg {
  static constexpr int W_BYTES = KS * BN;              // two [128 rows][128 B] boxes
  static constexpr int X_OFF = W_BYTES;
  static constexpr int X_BYTES = NTOK * KS * 2;        // two [NTOK][128 B] boxes
  static constexpr int S_OFF = X_OFF + X_BYTES;
  static constexpr int STAGE = S_OFF + SR * BN * 4;
  static constexpr int NST_FIT = 225 * 1024 / STAGE;
  static constexpr int NST = NST_FIT > 6 ? 6 : NST_FIT;
  static constexpr int SMEM = NST * STAGE + 1024;
  static constexpr int R = NTOK / 2;
  static_assert(NST >= 2, "ring too small");
};

// scale rows a stage's box holds: the most groups 128 consecutive K rows starting at a
// multiple of 128 touch, 1 + (127 + group - gcd(128, group)) / group (<= SR for any
// group % 16 == 0)
__host__ __device__ inline int scale_rows(int group) {
  int a = KS, b = group;
  while (b) { const int t = a % b; a = b; b = t; }
  return 1 + (KS - 1 + group - a) / group;
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// byte Q of w (an e4m3 code) decoded and times 2^-120, exactly, in f32
template <int Q>
__device__ __forceinline__ float e4m3_scaled(uint32_t w) {
  uint32_t b;
  if constexpr (Q == 3) b = ((w >> 4) & 0x07F00000u) | (w & 0x80000000u);
  else b = ((w << (20 - 8 * Q)) & 0x07F00000u) | ((w << (24 - 8 * Q)) & 0x80000000u);
  return __uint_as_float(b);
}

// bf16(decode(byte Q) * s): the exact decoded value, times the scale in f32, rounded once
template <int Q>
__device__ __forceinline__ float weight(uint32_t w, float s) {
  return __fmul_rn(__fmul_rn(e4m3_scaled<Q>(w), 0x1p120f), s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// the A fragments of both m64 tiles for one k16 step, from the lane's words of rows
// 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 (4 columns each) and the columns' scales
template <int Q0>
__device__ __forceinline__ void fragment(uint32_t (&a)[4], const uint32_t (&w)[4], float s0,
                                         float s1) {
  a[0] = pack_bf16(weight<Q0>(w[0], s0), weight<Q0>(w[1], s0));
  a[1] = pack_bf16(weight<Q0 + 1>(w[0], s1), weight<Q0 + 1>(w[1], s1));
  a[2] = pack_bf16(weight<Q0>(w[2], s0), weight<Q0>(w[3], s0));
  a[3] = pack_bf16(weight<Q0 + 1>(w[2], s1), weight<Q0 + 1>(w[3], s1));
}

// STRADDLE: the group neither divides 128 nor is a multiple of it, so a stage's K rows
// start inside a group
template <int NTOK, bool STRADDLE>
__global__ void __launch_bounds__(THREADS, 1)
fp8_bmm_kernel(const __grid_constant__ CUtensorMap wmap,   // w8 [E, K, N] bytes
               const __grid_constant__ CUtensorMap xmap,   // x [E or 1, M, K] bf16
               const __grid_constant__ CUtensorMap smap,   // gscale [E, K/group, N] f32
               float* __restrict__ out,                    // [E, M, N]
               int E, int M, int N, int K, int group, int x_per_expert) {
  using C = Cfg<NTOK>;
  constexpr int NST = C::NST, R = C::R;
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  extern __shared__ __align__(128) uint8_t raw[];
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  const int n_kst = (K + KS - 1) / KS;
  const int n_nt = (N + BN - 1) / BN;
  const int n_mt = (M + NTOK - 1) / NTOK;
  const int n_items = E * n_nt * n_mt;
  const int srows = scale_rows(group);
  const int gq = group / 16;           // k16 steps a group
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS / 32);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the ring's TMA loads in flight
    if (threadIdx.x == CONSUMERS) {
      const int tx = C::W_BYTES + C::X_BYTES + srows * BN * 4;
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int mt = w % n_mt;
        const int nt = (w / n_mt) % n_nt;
        const int e = w / (n_mt * n_nt);
        for (int ks = 0; ks < n_kst; ++ks, ++it) {
          const int s = it % NST;
          mbar_wait(smem_u32(&empty[s]), ((it / NST) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]);
          mbar_expect_tx(bar, tx);
          const uint32_t st = base + s * C::STAGE;
          tma_load(st, &wmap, nt * BN, ks * KS, e, bar);
          tma_load(st + KS * 128, &wmap, nt * BN + 128, ks * KS, e, bar);
          tma_load(st + C::X_OFF, &xmap, ks * KS, mt * NTOK, x_per_expert ? e : 0, bar);
          tma_load(st + C::X_OFF + NTOK * 128, &xmap, ks * KS + 64, mt * NTOK,
                   x_per_expert ? e : 0, bar);
          tma_load(st + C::S_OFF, &smap, nt * BN, ks * KS / group, e, bar);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg (0, 1) owns the item's columns 128 wg ..
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // the lane's 4 columns in the warpgroup's weight box, and their words' byte offsets
  // in a stage for rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of k step 0
  const int cb = 32 * warp + 4 * gid;
  uint32_t woff[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = 2 * tig + (p & 1) + 8 * (p >> 1);
    woff[p] = wg * KS * 128 + sw128_offset(r, cb >> 4) + (cb & 15);
  }
  const uint32_t soff = C::S_OFF + (128 * wg + cb) * 4;

  float acc0[R], acc1[R];
  int it = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int mt = w % n_mt;
    const int nt = (w / n_mt) % n_nt;
    const int e = w / (n_mt * n_nt);
#pragma unroll
    for (int i = 0; i < R; ++i) acc0[i] = acc1[i] = 0.f;
    for (int ks = 0; ks < n_kst; ++ks, ++it) {
      const int s = it % NST;
      mbar_wait(smem_u32(&full[s]), (it / NST) & 1);
      const uint32_t st = base + s * C::STAGE;
      uint32_t a[2][2][4];        // [k step parity][tile][fragment]
      // the stage's first scale row is that of K row 128 ks; k step kk reads the row of
      // its group, counted on from there.  Unless the group straddles stages, that row
      // is a function of kk alone: a row that depends on the stage makes ptxas
      // serialise the wgmmas
      const int rem0 = STRADDLE ? ks * (KS / 16) % gq : 0;
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const int srow = STRADDLE ? (rem0 + kk) / gq : group >= KS ? 0 : 16 * kk / group;
        const float4 sc = ld_shared_f4(st + soff + srow * BN * 4);
        uint32_t wv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) wv[p] = ld_shared(st + kk * 16 * 128 + woff[p]);
        fragment<0>(a[kk & 1][0], wv, sc.x, sc.y);
        fragment<2>(a[kk & 1][1], wv, sc.z, sc.w);
        fence_frags(a[kk & 1]);
        wgmma_fence();
        const uint64_t desc =
            sw128_desc(st + C::X_OFF + (kk / 4) * NTOK * 128 + (kk % 4) * 32);
        wgmma_rs<true, 0>(acc0, a[kk & 1][0], desc, 1);
        wgmma_rs<true, 0>(acc1, a[kk & 1][1], desc, 1);
        wgmma_commit();
        // k step kk - 1 has completed: its A registers may be refilled; at kk == 0 the
        // previous stage's last products are done, so that stage is free
        wgmma_wait<1>();
        if (kk == 0 && ks > 0) mbar_release_warp(&empty[(it - 1) % NST], lane);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    mbar_release_warp(&empty[(it - 1) % NST], lane);
    // out[e, token, col .. col + 3] = (tile 0 row gid, row gid + 8, tile 1 row gid,
    // row gid + 8)
    const int col = nt * BN + 128 * wg + cb;
    if (col < N) {
      float* dst = out + ((long long)e * M + mt * NTOK) * N + col;
#pragma unroll
      for (int jn = 0; jn < NTOK / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 8 * jn + 2 * tig + h;
          if (mt * NTOK + row < M)
            *reinterpret_cast<float4*>(dst + (long long)row * N) =
                make_float4(acc0[4 * jn + h], acc0[4 * jn + 2 + h], acc1[4 * jn + h],
                            acc1[4 * jn + 2 + h]);
        }
    }
  }
}

template <int NTOK, bool STRADDLE>
cudaError_t launch_grid(const void* x, const void* w8, const void* gscale, void* out, int E,
                        int M, int N, int K, int group, int x_per_expert,
                        cudaStream_t stream) {
  using C = Cfg<NTOK>;
  const int G = K / group;
  CUtensorMap wmap, xmap, smap;
  const cuuint64_t wd[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t wb[3] = {128, KS, 1};
  const cuuint64_t xd[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)(x_per_expert ? E : 1)};
  const cuuint64_t xs[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t xb[3] = {64, NTOK, 1};
  const cuuint64_t sd[3] = {(cuuint64_t)N, (cuuint64_t)G, (cuuint64_t)E};
  const cuuint64_t ss[2] = {(cuuint64_t)N * 4, (cuuint64_t)G * N * 4};
  const cuuint32_t sb[3] = {BN, (cuuint32_t)scale_rows(group), 1};
  if (!tile_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w8, wd, ws, wb,
                CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, xd, xs, xb,
                   CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, gscale, sd, ss, sb,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static cudaError_t configured = set_smem(fp8_bmm_kernel<NTOK, STRADDLE>, C::SMEM);
  if (configured != cudaSuccess) return configured;
  const long long items =
      (long long)E * ((N + BN - 1) / BN) * ((M + NTOK - 1) / NTOK);
  const int grid = (int)(items < sm_count() ? items : sm_count());
  fp8_bmm_kernel<NTOK, STRADDLE><<<grid, THREADS, C::SMEM, stream>>>(
      wmap, xmap, smap, static_cast<float*>(out), E, M, N, K, group, x_per_expert);
  return cudaGetLastError();
}

template <int NTOK>
cudaError_t launch(const void* x, const void* w8, const void* gscale, void* out, int E,
                   int M, int N, int K, int group, int x_per_expert, cudaStream_t stream) {
  return group % KS && KS % group
             ? launch_grid<NTOK, true>(x, w8, gscale, out, E, M, N, K, group, x_per_expert,
                                       stream)
             : launch_grid<NTOK, false>(x, w8, gscale, out, E, M, N, K, group, x_per_expert,
                                        stream);
}

}  // namespace

// x bf16 [M, K] (x_per_expert 0) or [E, M, K] (1); w8 e4m3 bytes [E, K, N]; gscale
// f32 [E, K/group, N]; out f32 [E, M, N].  All contiguous, 16-byte aligned.  K % 32 ==
// 0, group % 16 == 0 dividing K, N % 16 == 0, 1 <= E <= 65535.  The token tile is 16
// rows up to M 16, 64 up to 64, else 128 (ops/quant_matmul.token_tile).  Returns the
// CUDA error code of the launch (0 = launched; nothing is launched for M == 0).
extern "C" int fp8_bmm(const void* x, const void* w8, const void* gscale, void* out,
                       int E, int M, int N, int K, int group, int x_per_expert,
                       void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (M < 0 || N <= 0 || K <= 0 || K % 32 || group <= 0 || group % 16 || K % group
      || N % 16 || E <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return (int)launch<16>(x, w8, gscale, out, E, M, N, K, group, x_per_expert, s);
  if (M <= 64) return (int)launch<64>(x, w8, gscale, out, E, M, N, K, group, x_per_expert, s);
  return (int)launch<128>(x, w8, gscale, out, E, M, N, K, group, x_per_expert, s);
}
