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
// to bf16, as the reference does (val * s_row -> bf16).  The decode is Hopper's native
// e4m3 conversion (two bytes at once to f16, exact, then f32), except for the e4m3 NaN
// code 0x7f / 0xff: the reference's arithmetic decode reads it as +-480 (exponent 15,
// mantissa 7), so a select maps it there.  The products run on mma.sync m16n8k16 bf16
// with one f32 accumulator per output over all of K; only the f32 summation order
// differs from the plain version.
//
// What bounds it on an H100: bytes.  DeepSeek-V2-Lite (H 2048, Ie 1408, E 64) at the
// decode path's M = 64, one layer's gate + up + down: 553.6 MB of e4m3 weights,
// 17 MB of f32 scales, 80 MB of f32 outputs and 11.5 MB of down input ~ 0.66 GB,
// 0.198 ms at 3.35 TB/s; 70.9 GFLOP, 0.072 ms at 989 TFLOP/s (H100 SXM data sheet).
//
// Design (simple and right first: mxfp4_bmm.cu's tiling; wgmma, TMA and feeding the
// tensor cores straight from fp8 are later work):
//   * One block of 8 warps per (128-column tile, 16*MT-row tile, expert); each warp
//     owns 16 columns (two n8 tiles) of all the tile's rows.  Columns past N load
//     zeros and are not written; rows past M load zeros and are not written.
//   * One stage = 32 rows of K: the stage's 32 x 128 weight bytes, the two scale rows
//     of its two 16-row k-steps (a group is a multiple of 16 rows) and the 32-column x
//     slice go to shared memory by cp.async, NS stages in flight.
//   * Each lane reads the 4 bytes its B fragments need (rows 2q, 2q+1, 2q+8, 2q+9 of a
//     k-step, one column), decodes them in pairs and scales them into two bf16x2 B
//     registers.  A fragments by ldmatrix from the x slice.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int BN = NWARPS * 16;        // columns per block tile
constexpr int KS = 32;                 // K rows per stage
constexpr int WSTRIDE = BN + 16;       // byte-tile row stride: 16-B aligned rows, and
                                       // rows 2q land on banks 8q (conflict-free reads)
constexpr int XSTRIDE = KS + 8;        // x-slice row stride in bf16 (80 B, ldmatrix
                                       // conflict-free)

template <int MT>
struct Stage {
  uint8_t w[KS][WSTRIDE];                       // e4m3 bytes, 32 rows x 128 columns
  float s[2][BN];                               // scale rows of the two k-steps
  __nv_bfloat16 x[16 * MT][XSTRIDE];            // x columns of the stage
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared; zeros when not valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// the reference's reading of the NaN code: exponent 15, mantissa 7 -> 480
__device__ __forceinline__ float nan_code(uint32_t b, float f) {
  return (b & 0x7Fu) == 0x7Fu ? ((b & 0x80u) ? -480.f : 480.f) : f;
}

// two e4m3 bytes (lower k first) times the column's scale, each rounded once to bf16
__device__ __forceinline__ uint32_t dequant_pair(uint32_t b0, uint32_t b1, float s) {
  const __nv_fp8x2_storage_t x2 = static_cast<__nv_fp8x2_storage_t>(b0 | (b1 << 8));
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(x2, __NV_E4M3)));
  const __nv_bfloat162 v = __floats2bfloat162_rn(nan_code(b0, f.x) * s,
                                                 nan_code(b1, f.y) * s);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int MT, int NS>
__global__ void __launch_bounds__(NT)
fp8_bmm_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K] or [E, M, K]
               const uint8_t* __restrict__ w8,         // [E, K, N]
               const float* __restrict__ gscale,       // [E, K/group, N]
               float* __restrict__ out,                // [E, M, N]
               int M, int N, int K, int group, int x_per_expert) {
  constexpr int BM = 16 * MT;
  const int G = K / group;
  const int stages = K / KS;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int quad = lane & 3;            // fragment k pair / column pair
  const int grp = lane >> 2;            // fragment column / row

  const __nv_bfloat16* xe = x + (x_per_expert ? (long long)e * M * K : 0LL);
  const uint8_t* w_e = w8 + (long long)e * K * N;
  const float* s_e = gscale + (long long)e * G * N;

  __shared__ __align__(16) Stage<MT> st_buf[NS];

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // stage g: weight rows [32g, 32g+32), the scale rows of rows 32g and 32g + 16, x
  // columns [32g, 32g+32)
  auto load_stage = [&](int g, int buf) {
    Stage<MT>& st = st_buf[buf];
    {
      const int r = tid >> 3;                 // 32 rows x 8 chunks of 16 bytes
      const int c = (tid & 7) * 16;
      const bool ok = n0 + c < N;             // N % 16 == 0: a chunk is all in or out
      cp_async16(&st.w[r][c], w_e + (long long)(g * KS + r) * N + (ok ? n0 + c : 0), ok);
    }
    if (tid < 2 * BN / 4) {
      const int h = tid / (BN / 4);
      const int c = (tid % (BN / 4)) * 4;
      const bool ok = n0 + c < N;
      const int srow = (g * KS + h * 16) / group;
      cp_async16(&st.s[h][c], s_e + (long long)srow * N + (ok ? n0 + c : 0), ok);
    }
    for (int i = tid; i < BM * (KS / 8); i += NT) {
      const int r = i / (KS / 8);
      const int c = (i % (KS / 8)) * 8;
      const int row = m0 + r;
      const bool ok = row < M;
      cp_async16(&st.x[r][c], xe + (long long)(ok ? row : 0) * K + g * KS + c, ok);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < stages) load_stage(s, s);
    else cp_async_commit();
  }
  for (int g = 0; g < stages; ++g) {
    cp_async_wait<NS - 2>();             // stage g has landed
    __syncthreads();                     // ... for every thread; stage g-1 is consumed
    if (g + NS - 1 < stages) load_stage(g + NS - 1, (g + NS - 1) % NS);
    else cp_async_commit();
    const Stage<MT>& st = st_buf[g % NS];
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = warp * 16 + nt * 8 + grp;
        const int r = ks * 16 + 2 * quad;
        const float s = st.s[ks][c];
        b[nt][0] = dequant_pair(st.w[r][c], st.w[r + 1][c], s);
        b[nt][1] = dequant_pair(st.w[r + 8][c], st.w[r + 9][c], s);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, &st.x[mt * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }

  float* out_e = out + (long long)e * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + grp + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + warp * 16 + nt * 8 + quad * 2;
        if (col >= N) continue;
        *reinterpret_cast<float2*>(out_e + (long long)row * N + col) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

template <int MT, int NS>
cudaError_t launch(const void* x, const void* w8, const void* gscale, void* out, int E,
                   int M, int N, int K, int group, int x_per_expert, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + 16 * MT - 1) / (16 * MT), E);
  fp8_bmm_kernel<MT, NS><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w8),
      static_cast<const float*>(gscale), static_cast<float*>(out), M, N, K, group,
      x_per_expert);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K] (x_per_expert 0) or [E, M, K] (1); w8 e4m3 bytes [E, K, N]; gscale
// f32 [E, K/group, N]; out f32 [E, M, N].  All contiguous.  K % 32 == 0, group % 16
// == 0 dividing K, N % 16 == 0, 1 <= E <= 65535.  Returns the CUDA error code of the
// launch (0 = launched; nothing is launched for M == 0).
extern "C" int fp8_bmm(const void* x, const void* w8, const void* gscale, void* out,
                       int E, int M, int N, int K, int group, int x_per_expert,
                       void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (M < 0 || N <= 0 || K <= 0 || K % KS || group <= 0 || group % 16 || K % group
      || N % 16 || E <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return (int)launch<1, 4>(x, w8, gscale, out, E, M, N, K, group, x_per_expert, s);
  if (M <= 32) return (int)launch<2, 4>(x, w8, gscale, out, E, M, N, K, group, x_per_expert, s);
  return (int)launch<4, 4>(x, w8, gscale, out, E, M, N, K, group, x_per_expert, s);
}
