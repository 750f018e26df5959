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
// rounded once to bf16, as the reference does (val * s_row -> bf16); e2m1 times a
// power of two is exact in bf16, so for real (ue8m0) scales nothing rounds.  Code 8 is
// -0.0 and code 1 the subnormal 0.5 (see e2m1() below).  The products run on
// mma.sync m16n8k16 bf16 with one f32 accumulator per output over all of K.
//
// What bounds it on an H100: bytes.  gpt-oss-20b (H = Ie = 2880, E = 32) at the
// decode path's M = 64, one gate call: 132.7 MB of codes + 33.2 MB of f32 scales +
// 23.6 MB of f32 output ~ 190 MB, 0.057 ms at 3.35 TB/s; 34 GFLOP, 0.034 ms at 989
// TFLOP/s (H100 SXM data sheet).  The f32 scales are a fifth of the bytes.  The
// decode's integer / float operations per weight take about as much issue time as
// the bytes take, so each code is decoded once, by one subnormal product and a sign
// OR (e2m1() below), with no compares or selects.
//
// Design (simple and right first; a wgmma / TMA pipeline and a cheaper decode are
// later work):
//   * One block of 8 warps per (128-column tile, 16*MT-row tile, expert); each warp
//     owns 16 columns (two n8 tiles) of all the tile's rows.  N need not be a
//     multiple of 128 (gpt-oss: 2880 = 22.5 tiles): columns past N load zeros and
//     are not written.  Rows past M load zeros (x is not padded) and are not written.
//   * One stage = one scale group: 32 byte rows (64 weight rows: 32 low, 32 high).
//     The stage's 32 x 128 bytes, its two scale rows and the two 32-column x slices
//     go to shared memory by cp.async, NS stages in flight (4 for up to 32 rows, 3
//     for 64: the 48 KB of static shared memory).
//   * Each lane reads the 4 bytes its B fragments need (rows 2q, 2q+1, 2q+8, 2q+9 of
//     a 16-row k-step, one column) and decodes both nibbles: the low nibbles form the
//     B fragment against x[:, r:r+16], the high nibbles the one against
//     x[:, K/2+r : K/2+r+16].  A fragments by ldmatrix from the x slices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int BN = NWARPS * 16;        // columns per block tile
constexpr int GROUP = 32;              // e2m1 values per scale = byte rows per stage
constexpr int WSTRIDE = BN + 16;       // byte-tile row stride: 16-B aligned rows, and
                                       // rows 2q land on banks 8q (conflict-free reads)
constexpr int XSTRIDE = GROUP + 8;     // x-slice row stride in bf16 (80 B, ldmatrix
                                       // conflict-free)

template <int MT>
struct Stage {
  uint8_t w[GROUP][WSTRIDE];                    // codes, 32 byte rows x 128 columns
  float s[2][BN];                               // scale rows: low half, high half
  __nv_bfloat16 x[2][16 * MT][XSTRIDE];         // x columns of the low / high half
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

// e2m1 code (0..15) -> f32.  The magnitude bits e1 e0 m at f32 bits 24..22 read as
// the value times 2^-126: e >= 1 gives 2^(e-127) * (1 + m/2), and e = 0 the f32
// subnormal m * 2^-127 (code 1: 0.5 after the product).  Times 2^126 is exact.  This
// needs subnormals kept, nvcc's default (-ftz=false; cuda_build.py passes no
// --use_fast_math); a flushed code 1 would read 0, which the kernel check catches.
// Bit 3 is the sign (code 8 is -0.0).
__device__ __forceinline__ float e2m1(uint32_t code) {
  const float mag = __uint_as_float((code & 7u) << 22) * 0x1p126f;
  return __uint_as_float(__float_as_uint(mag) | ((code & 8u) << 28));
}

// two codes (lower k first) times the column's scale, each rounded once to bf16
__device__ __forceinline__ uint32_t dequant_pair(uint32_t c0, uint32_t c1, float s) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(e2m1(c0) * s, e2m1(c1) * s);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int MT, int NS>
__global__ void __launch_bounds__(NT)
mxfp4_bmm_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K] or [E, M, K]
                 const uint8_t* __restrict__ nib,        // [E, K/2, N]
                 const float* __restrict__ scale,        // [E, K/32, N]
                 float* __restrict__ out,                // [E, M, N]
                 int M, int N, int K, int x_per_expert) {
  constexpr int BM = 16 * MT;
  const int K2 = K / 2;
  const int G = K / GROUP;
  const int G2 = G / 2;                 // stages: scale groups of the low half
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int quad = lane & 3;            // fragment k pair / column pair
  const int grp = lane >> 2;            // fragment column / row

  const __nv_bfloat16* xe = x + (x_per_expert ? (long long)e * M * K : 0LL);
  const uint8_t* nib_e = nib + (long long)e * K2 * N;
  const float* scale_e = scale + (long long)e * G * N;

  __shared__ __align__(16) Stage<MT> stages[NS];

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // stage g: byte rows [32g, 32g+32), scale rows g and G2 + g, x columns
  // [32g, 32g+32) and [K2 + 32g, K2 + 32g + 32)
  auto load_stage = [&](int g, int buf) {
    Stage<MT>& st = stages[buf];
    {
      const int r = tid >> 3;                 // 32 rows x 8 chunks of 16 bytes
      const int c = (tid & 7) * 16;
      const bool ok = n0 + c < N;             // N % 16 == 0: a chunk is all in or out
      cp_async16(&st.w[r][c], nib_e + (long long)(g * GROUP + r) * N + (ok ? n0 + c : 0), ok);
    }
    if (tid < 2 * BN / 4) {
      const int h = tid / (BN / 4);
      const int c = (tid % (BN / 4)) * 4;
      const bool ok = n0 + c < N;
      cp_async16(&st.s[h][c], scale_e + (long long)(h * G2 + g) * N + (ok ? n0 + c : 0), ok);
    }
    for (int i = tid; i < 2 * BM * (GROUP / 8); i += NT) {
      const int h = i / (BM * (GROUP / 8));
      const int rem = i - h * BM * (GROUP / 8);
      const int r = rem / (GROUP / 8);
      const int c = (rem % (GROUP / 8)) * 8;
      const int row = m0 + r;
      const bool ok = row < M;
      cp_async16(&st.x[h][r][c], xe + (long long)(ok ? row : 0) * K + h * K2 + g * GROUP + c, ok);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < G2) load_stage(s, s);
    else cp_async_commit();
  }
  for (int g = 0; g < G2; ++g) {
    cp_async_wait<NS - 2>();             // stage g has landed
    __syncthreads();                     // ... for every thread; stage g-1 is consumed
    if (g + NS - 1 < G2) load_stage(g + NS - 1, (g + NS - 1) % NS);
    else cp_async_commit();
    const Stage<MT>& st = stages[g % NS];
    float s_lo[2], s_hi[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = warp * 16 + nt * 8 + grp;
      s_lo[nt] = st.s[0][c];
      s_hi[nt] = st.s[1][c];
    }
#pragma unroll
    for (int ks = 0; ks < GROUP / 16; ++ks) {
      uint32_t b_lo[2][2], b_hi[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = warp * 16 + nt * 8 + grp;
        const int r = ks * 16 + 2 * quad;
        const uint32_t v0 = st.w[r][c], v1 = st.w[r + 1][c];
        const uint32_t v8 = st.w[r + 8][c], v9 = st.w[r + 9][c];
        b_lo[nt][0] = dequant_pair(v0 & 15u, v1 & 15u, s_lo[nt]);
        b_lo[nt][1] = dequant_pair(v8 & 15u, v9 & 15u, s_lo[nt]);
        b_hi[nt][0] = dequant_pair(v0 >> 4, v1 >> 4, s_hi[nt]);
        b_hi[nt][1] = dequant_pair(v8 >> 4, v9 >> 4, s_hi[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a_lo[4], a_hi[4];
        const int ar = mt * 16 + (lane & 15);
        const int ac = ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a_lo, &st.x[0][ar][ac]);
        ldmatrix_x4(a_hi, &st.x[1][ar][ac]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(acc[mt][nt], a_lo, b_lo[nt][0], b_lo[nt][1]);
          mma_bf16(acc[mt][nt], a_hi, b_hi[nt][0], b_hi[nt][1]);
        }
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
cudaError_t launch(const void* x, const void* nib, const void* scale, void* out, int E,
                   int M, int N, int K, int x_per_expert, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + 16 * MT - 1) / (16 * MT), E);
  mxfp4_bmm_kernel<MT, NS><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(nib),
      static_cast<const float*>(scale), static_cast<float*>(out), M, N, K, x_per_expert);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K] (x_per_expert 0) or [E, M, K] (1); nib u8 [E, K/2, N] half-split e2m1
// codes; scale f32 [E, K/32, N]; out f32 [E, M, N].  All contiguous.  K % 64 == 0,
// N % 16 == 0, 1 <= E <= 65535.  Returns the CUDA error code of the launch (0 =
// launched; nothing is launched for M == 0).
extern "C" int mxfp4_bmm(const void* x, const void* nib, const void* scale, void* out,
                         int E, int M, int N, int K, int x_per_expert, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (M < 0 || N <= 0 || K <= 0 || K % 64 || N % 16 || E <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return (int)launch<1, 4>(x, nib, scale, out, E, M, N, K, x_per_expert, s);
  if (M <= 32) return (int)launch<2, 4>(x, nib, scale, out, E, M, N, K, x_per_expert, s);
  return (int)launch<4, 3>(x, nib, scale, out, E, M, N, K, x_per_expert, s);
}
