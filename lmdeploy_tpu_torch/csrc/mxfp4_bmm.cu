// MXFP4 expert-batched GEMM for Hopper (sm_90a): the routed-expert products of a
// dense-combine MoE step over MXFP4-resident expert stacks (gpt-oss).
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/quant_bmm.py (mxfp4_bmm, body
// _mxfp4_kernel).  Same function:
//   out[e, m, n] = sum_k bf16(x(@e)[m, k]) * bf16(e2m1(code[e, k, n]) * scale[e, k/32, n])
// with f32 accumulation, written once as f32 [E, M, N].
//
// Layout ("half-split"): nib u8 [E, K/2, N]; byte row r holds weight row r in its low
// nibble and weight row K/2 + r in its high nibble.  scale f32 [E, K/32, N] (ue8m0
// decoded at load): the low nibbles of byte rows [32g, 32g+32) take scale row g, the
// high nibbles scale row K/64 + g.  x is bf16 [M, K] shared by every expert (the gate
// and up products) or [E, M, K], one slice per expert (the down product).
//
// Numerics: each weight is decoded to f32, multiplied by its f32 group scale and
// rounded once to bf16, as the reference does (val * s_row -> bf16), for any f32
// scale; e2m1 times a power of two is exact in bf16, so for real (ue8m0) scales
// nothing rounds.  Code 8 is -0.0 and code 1 the subnormal 0.5 (e2m1x2() below).
// The products run on wgmma with one f32 accumulator per output over all of K; only
// the f32 summation order differs from the plain version.
//
// What bounds it on an H100: bytes.  gpt-oss-20b (H = Ie = 2880, E = 32) at the
// decode path's M = 64, one layer's gate + up + down: 398 MB of codes, 100 MB of f32
// scales, 71 MB of f32 outputs ~ 0.58 GB, 0.173 ms at 3.35 TB/s; 102 GFLOP, 0.103 ms
// at 989 TFLOP/s (H100 SXM data sheet).  The f32 scales are a fifth of the bytes.  A
// byte holds two weights, so the decode's operations per byte are twice fp8_bmm's:
// with one block of 8 consumer warps an SM it is the decode, not the bytes, that sets
// the time (chip_steps.py).  So two codes are decoded together: one byte permute brings
// a byte of two k rows side by side (serving both nibbles), two or three integer
// operations and one f16x2 product give both values exactly in f16, and each then takes
// one conversion to f32, its product by the scale and half a packing conversion to
// bf16; no compares or selects.
//
// Design (fp8_bmm.cu's, on hopper.cuh): the product is computed transposed,
// out^T = W^T x^T: the decoded weights are wgmma's A operand in registers, x its B
// operand in shared memory.
//   * Persistent, warp-specialised blocks of 288 threads, one an SM, walking work items
//     (expert, 256-column tile, token tile) in turn, the token tile fastest, so the
//     blocks that read one weight tile run side by side and share it through L2.  A
//     producer warp (one thread) streams each item's K/2 byte rows in stages of 64 (two
//     scale groups of each half) into a ring of shared memory (4-6 stages) by TMA,
//     against full / empty mbarriers, running on into the next item while the consumers
//     finish one.  A stage holds the 64 x 256 code bytes (two [64 rows][128 B] boxes,
//     128-byte swizzle), the two x tiles its byte rows meet ([tokens][64 columns] boxes
//     of the low half and of the high half, 128-byte swizzle, from one 4-D tensor map
//     [E or 1][M][2][K/2] that serves a shared x and the per-expert down input) and the
//     four scale rows (low g, g + 1, high g, g + 1) of each warpgroup's 128 columns.
//     K/2 need not be a multiple of 64 (gpt-oss: 1440 = 22.5 stages): the last stage's
//     missing byte rows, x columns and scale rows lie past the half in their tensor
//     maps and read as zeros, so they add nothing.  Rows past M and columns past N
//     (2880 = 11.25 tiles) read as zeros too and are not written.
//   * Two consumer warpgroups own 128 columns each, two m64 tiles.  A lane reads 32-bit
//     words of 4 adjacent columns from the 4 byte rows of its A fragments (rows 2 tig,
//     2 tig + 1, + 8, + 9 of a 16-row step: conflict-free under the swizzle). A byte's
//     low nibble is weight row r and its high nibble row K/2 + r, so the 4 words give
//     the fragments of two k steps: one against the low half's x tile, one against the
//     high half's, each for both m64 tiles (column 4 gid + q is row gid (q even) or gid
//     + 8 (q odd) of tile q / 2).  The decode of step i + 1 runs while the four wgmmas
//     of step i are in flight (A double-buffered and pinned in registers,
//     hopper::fence_frags); a stage is released, one arrival a consumer thread, as soon
//     as its last wgmmas have completed.
//   * The token tile is 16, 64 or 128 rows by M (ops/quant_matmul.token_tile); larger M
//     (prefill chunks up to 767 rows) takes several token tiles, each an item.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CWG = 2;                    // consumer warpgroups, 128 columns each
constexpr int BN = 128 * CWG;             // output columns an item
constexpr int KB = 64;                    // byte rows a stage: two scale groups a half
constexpr int CONSUMERS = 128 * CWG;
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp

template <int NTOK>
struct Cfg {
  static constexpr int W_BYTES = KB * BN;              // CWG [64 rows][128 B] boxes
  static constexpr int X_OFF = W_BYTES;
  static constexpr int X_BYTES = 2 * NTOK * 128;       // [NTOK][64] bf16: low, high half
  static constexpr int S_OFF = X_OFF + X_BYTES;
  static constexpr int STAGE = S_OFF + 4 * BN * 4;     // scale rows [wg][half][group][128]
  static constexpr int NST_FIT = 225 * 1024 / STAGE;
  static constexpr int NST = NST_FIT > 6 ? 6 : NST_FIT;
  static constexpr int SMEM = NST * STAGE + 1024;
  static constexpr int R = NTOK / 2;
  static_assert(NST >= 1 && STAGE % 1024 == 0, "ring of 1 KB aligned stages");
};

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// the two e2m1 codes in the high (H = 1) or low (H = 0) nibbles of bytes 1 and 3 of z,
// as an f16x2 of their values (the byte-1 code in the low half), exactly: each code's
// magnitude bits e1 e0 m at f16 bits 11..9 read as the value times 2^-14 (e >= 1 gives
// 2^(e-15) (1 + m/2), e = 0 the f16 subnormal m 2^-15), its sign at bit 15, then one
// f16x2 product by 2^14.  Code 8 is -0.0 and code 1 the subnormal 0.5 (f16 subnormals
// are kept: cuda_build.py passes no --use_fast_math, and mul.rn.f16x2 has no .ftz)
template <int H>
__device__ __forceinline__ uint32_t e2m1x2(uint32_t z) {
  const uint32_t y = H ? z : z << 4;
  uint32_t h = (y & 0x80008000u) | ((y >> 3) & 0x0E000E00u);
  asm("mul.rn.f16x2 %0, %0, %1;\n" : "+r"(h) : "r"(0x74007400u));   // 2^14, 2^14
  return h;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// bf16(v * s) of both values of an f16x2 h: exact in f32 (f16 -> f32 is), times the
// scale in f32, rounded once
__device__ __forceinline__ uint32_t scaled(uint32_t h, float s) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack_bf16(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
}

// bytes q of words a (to byte 1) and b (to byte 3), by one byte permute
template <int Q>
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, Q | Q << 4 | (4 + Q) << 8 | (4 + Q) << 12);
}

// the A fragment of m64 tile T for one k step of half H (0: the low nibbles, weight
// rows r; 1: the high nibbles, rows K/2 + r), from the lane's words of byte rows
// 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 (4 columns each) and the scales of the
// tile's columns 2 T (row gid) and 2 T + 1 (row gid + 8)
template <int H, int T>
__device__ __forceinline__ void fragment(uint32_t (&a)[4], const uint32_t (&w)[4], float s0,
                                         float s1) {
  a[0] = scaled(e2m1x2<H>(pair<2 * T>(w[0], w[1])), s0);
  a[1] = scaled(e2m1x2<H>(pair<2 * T + 1>(w[0], w[1])), s1);
  a[2] = scaled(e2m1x2<H>(pair<2 * T>(w[2], w[3])), s0);
  a[3] = scaled(e2m1x2<H>(pair<2 * T + 1>(w[2], w[3])), s1);
}

template <int NTOK>
__global__ void __launch_bounds__(THREADS, 1)
mxfp4_bmm_kernel(const __grid_constant__ CUtensorMap wmap,   // nib [E, K/2, N] bytes
                 const __grid_constant__ CUtensorMap xmap,   // x [E or 1, M, 2, K/2] bf16
                 const __grid_constant__ CUtensorMap smap,   // scale [E, 2, K/64, N] f32
                 float* __restrict__ out,                    // [E, M, N]
                 int E, int M, int N, int K, int x_per_expert) {
  using C = Cfg<NTOK>;
  constexpr int NST = C::NST, R = C::R;
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  extern __shared__ __align__(128) uint8_t raw[];
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  const int n_kst = (K / 2 + KB - 1) / KB;
  const int n_nt = (N + BN - 1) / BN;
  const int n_mt = (M + NTOK - 1) / NTOK;
  const int n_items = E * n_nt * n_mt;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);        // one arrival a consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the ring's TMA loads in flight
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const int mt = w % n_mt;
        const int nt = (w / n_mt) % n_nt;
        const int e = w / (n_mt * n_nt);
        for (int ks = 0; ks < n_kst; ++ks, ++it) {
          const int s = it % NST;
          mbar_wait(smem_u32(&empty[s]), ((it / NST) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]);
          const uint32_t st = base + s * C::STAGE;
          mbar_expect_tx(bar, C::STAGE);
#pragma unroll
          for (int c = 0; c < CWG; ++c)
            tma_load(st + c * KB * 128, &wmap, nt * BN + 128 * c, ks * KB, e, bar);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load(st + C::X_OFF + h * NTOK * 128, &xmap, ks * KB, h, mt * NTOK,
                     x_per_expert ? e : 0, bar);
#pragma unroll
          for (int c = 0; c < CWG; ++c)
            tma_load(st + C::S_OFF + c * 4 * 128 * 4, &smap, nt * BN + 128 * c, 2 * ks, 0, e,
                     bar);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns the item's columns 128 wg ..
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // the lane's 4 columns in the warpgroup's code box, and their words' byte offsets in
  // a stage for rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of step 0
  const int cb = 32 * warp + 4 * gid;
  uint32_t woff[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = 2 * tig + (p & 1) + 8 * (p >> 1);
    woff[p] = wg * KB * 128 + sw128_offset(r, cb >> 4) + (cb & 15);
  }
  const uint32_t soff = C::S_OFF + (4 * 128 * wg + cb) * 4;

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
      // A fragments [step parity][low t0, low t1, high t0, high t1][4]
      uint32_t a[2][4][4];
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        uint32_t wv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) wv[p] = ld_shared(st + kk * 16 * 128 + woff[p]);
        // the scale rows (low half, high half) of group kk / 2 of the stage: a function
        // of kk alone
        const float4 lo = ld_shared_f4(st + soff + (kk / 2) * 128 * 4);
        const float4 hi = ld_shared_f4(st + soff + (2 + kk / 2) * 128 * 4);
        fragment<0, 0>(a[kk & 1][0], wv, lo.x, lo.y);
        fragment<0, 1>(a[kk & 1][1], wv, lo.z, lo.w);
        fragment<1, 0>(a[kk & 1][2], wv, hi.x, hi.y);
        fragment<1, 1>(a[kk & 1][3], wv, hi.z, hi.w);
        fence_frags(a[kk & 1]);
        wgmma_fence();
        // the low nibbles against the low half's x tile, the high ones against the high's
        const uint64_t dlo = sw128_desc(st + C::X_OFF + kk * 32);
        const uint64_t dhi = sw128_desc(st + C::X_OFF + NTOK * 128 + kk * 32);
        wgmma_rs<true, 0>(acc0, a[kk & 1][0], dlo, 1);
        wgmma_rs<true, 0>(acc1, a[kk & 1][1], dlo, 1);
        wgmma_rs<true, 0>(acc0, a[kk & 1][2], dhi, 1);
        wgmma_rs<true, 0>(acc1, a[kk & 1][3], dhi, 1);
        wgmma_commit();
        // step kk - 1 has completed: its A registers may be refilled; at kk == 0 the
        // previous stage's last products are done, so that stage is free (each thread
        // arrives for itself: a warp barrier or a lane's branch here makes ptxas
        // serialise every wgmma, C7513)
        wgmma_wait<1>();
        if (kk == 0 && ks > 0) mbar_arrive(smem_u32(&empty[(it - 1) % NST]));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    mbar_arrive(smem_u32(&empty[(it - 1) % NST]));
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

template <int NTOK>
cudaError_t launch(const void* x, const void* nib, const void* scale, void* out, int E,
                   int M, int N, int K, int x_per_expert, cudaStream_t stream) {
  using C = Cfg<NTOK>;
  const int K2 = K / 2, G2 = K / 64;
  CUtensorMap wmap, xmap, smap;
  const cuuint64_t wd[3] = {(cuuint64_t)N, (cuuint64_t)K2, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)N, (cuuint64_t)K2 * N};
  const cuuint32_t wb[3] = {128, KB, 1};
  // x [E or 1][M][K] read as [E or 1][M][2 halves][K/2]: a box never crosses a half
  const cuuint64_t xd[4] = {(cuuint64_t)K2, 2, (cuuint64_t)M,
                            (cuuint64_t)(x_per_expert ? E : 1)};
  const cuuint64_t xs[3] = {(cuuint64_t)K2 * 2, (cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t xb[4] = {64, 1, NTOK, 1};
  // scale [E][K/32][N] read as [E][2 halves][K/64][N]
  const cuuint64_t sd[4] = {(cuuint64_t)N, (cuuint64_t)G2, 2, (cuuint64_t)E};
  const cuuint64_t ss[3] = {(cuuint64_t)N * 4, (cuuint64_t)G2 * N * 4,
                            (cuuint64_t)2 * G2 * N * 4};
  const cuuint32_t sb[4] = {128, 2, 2, 1};
  if (!tile_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, nib, wd, ws, wb,
                CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xd, xs, xb,
                   CU_TENSOR_MAP_SWIZZLE_128B)
      || !tile_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale, sd, ss, sb,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static cudaError_t configured = set_smem(mxfp4_bmm_kernel<NTOK>, C::SMEM);
  if (configured != cudaSuccess) return configured;
  const long long items = (long long)E * ((N + BN - 1) / BN) * ((M + NTOK - 1) / NTOK);
  const int grid = (int)(items < sm_count() ? items : sm_count());
  mxfp4_bmm_kernel<NTOK><<<grid, THREADS, C::SMEM, stream>>>(
      wmap, xmap, smap, static_cast<float*>(out), E, M, N, K, x_per_expert);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K] (x_per_expert 0) or [E, M, K] (1); nib u8 [E, K/2, N] half-split e2m1
// codes; scale f32 [E, K/32, N]; out f32 [E, M, N].  All contiguous, 16-byte aligned.
// K % 64 == 0, N % 16 == 0, 1 <= E <= 65535.  The token tile is 16 rows up to M 16, 64
// up to 64, else 128 (ops/quant_matmul.token_tile).  Returns the CUDA error code of the
// launch (0 = launched; nothing is launched for M == 0).
extern "C" int mxfp4_bmm(const void* x, const void* nib, const void* scale, void* out,
                         int E, int M, int N, int K, int x_per_expert, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (M < 0 || N <= 0 || K <= 0 || K % 64 || N % 16 || E <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return (int)launch<16>(x, nib, scale, out, E, M, N, K, x_per_expert, s);
  if (M <= 64) return (int)launch<64>(x, nib, scale, out, E, M, N, K, x_per_expert, s);
  return (int)launch<128>(x, nib, scale, out, E, M, N, K, x_per_expert, s);
}
