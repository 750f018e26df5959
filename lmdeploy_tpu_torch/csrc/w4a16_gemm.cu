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
// 2r+1) with no convert -- exactly the k-adjacent pair one register of an
// mma.m16n8k16 B fragment holds.  sb / corr f32 [K/gs, N]; xg f32 [M, K/gs] holds the
// per-group sums of the same bf16 x this kernel reads (made by torch ops before the
// launch, as the reference does).
//
// Numerics (ROADMAP.md section 3, traps 1-3): every group's partial product is an f32
// mma accumulator, scaled by s in f32; the correction sum_g xg * corr (~17-30x the
// signal) is f32 FMA here, never TF32; the output stays f32 until corr is subtracted.
//
// What bounds it on an H100: bytes.  At decode (M = 64) the weights dominate:
// K*N/2 bytes of nibbles plus 8*(K/gs)*N of sb and corr.  llama2-7b, gs 128, per
// layer (H100 SXM data sheet, 3.35 TB/s and 989 TFLOP/s; not measured):
//   wqkv     4096 x 12288   28.3 MB -> 8.5 us   (operations 6.4 us)
//   wo       4096 x  4096    9.4 MB -> 2.8 us   (2.2 us)
//   w_gateup 4096 x 22016   50.7 MB -> 15.1 us  (11.7 us)
//   w_down  11264 x  4096   26.0 MB -> 7.8 us   (6.0 us; K padded from 11008)
// about 34 us a layer, all bytes-bound.  At M = 128 (a decode batch of 65-128 rows)
// the operations double (13.0 / 4.3 / 23.3 / 11.9 us) and all four turn
// operations-bound, about 53 us a layer.
//
// Design (simple and right first; TMA, wgmma and a persistent stream-K schedule are
// later work):
//   * One block of 8 warps per (128-column tile, 16*MT-row tile, K split).  Each warp
//     owns 16 columns (two n8 tiles) of all the tile's rows.
//   * Per quant group g of the block's K split: the lane's packed words for the group
//     go straight from device memory to registers (each word feeds all 4 planes, so
//     every weight byte is read once); the x columns of the 4 planes go to shared
//     memory with cp.async, double-buffered across groups; A fragments by ldmatrix.
//     The group's rows of sb and corr (4 planes x 128 columns) and of xg (4 planes x
//     the tile's rows) ride in the same cp.async buffer.
//   * Per plane: a per-group f32 partial by mma.sync bf16, then, by f32 FMA,
//     acc += s * partial - xg * corr.  Subtracting each group's correction as it
//     goes keeps the running sum near the signal instead of ~30x above it.
//   * Narrow weights (wo, w_down: 32 column tiles on 132 SMs) split K over blocks.
//     Each split writes its f32 partial to a workspace; the last block of a tile to
//     arrive (a per-tile counter) sums the splits in split order, so the result does
//     not depend on which block came last, resets the counter and writes bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int BN = NWARPS * 16;             // columns per block tile
constexpr uint32_t NIBBLES = 0x000F000Fu;
constexpr uint32_t MAGIC = 0x43004300u;     // bf16 pair (128, 128): exponent 2^7, ulp 1

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

// 16 bytes global -> shared; a row outside the matrix copies zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(bytes));
}

// 4 bytes global -> shared, zeros when not valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// one buffer per group: x [4 planes][BM][GS + 8] bf16 (16-byte padded rows), then
// f32 sb [4][BN], corr [4][BN] and xg [4][BM]; the kernel keeps two
template <int MT, int GS>
__host__ __device__ constexpr int buf_floats() {
  return 4 * (16 * MT) * (GS + 8) / 2 + 2 * 4 * BN + 4 * (16 * MT);
}

template <int MT, int GS>
constexpr size_t smem_bytes() {
  return (size_t)2 * buf_floats<MT, GS>() * sizeof(float);
}

template <int MT, int GS>
__global__ void __launch_bounds__(NT)
w4a16_gd_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                const uint32_t* __restrict__ packed,   // [K/8, N]
                const float* __restrict__ sb,          // [G, N]
                const float* __restrict__ corr,        // [G, N]
                const float* __restrict__ xg,          // [M, G]
                __nv_bfloat16* __restrict__ out,       // [M, N]
                float* __restrict__ ws,                // [S, Mp, N] (S > 1)
                int* __restrict__ counters,            // [tiles]
                int M, int N, int K, int S) {
  constexpr int BM = 16 * MT;
  constexpr int XS = GS + 8;      // shared-memory row stride of the x tile (bf16)
  constexpr int KS = GS / 16;     // mma k-steps per group
  constexpr int WR = GS / 2;      // packed word rows per group
  constexpr int CH = GS / 8;      // 16-byte chunks per x row of a group
  const int Kq = K / 4;
  const int G = K / GS;
  const int Gq = G / 4;
  const int n_tile = blockIdx.x;
  const int m_tile = blockIdx.y;
  const int split = blockIdx.z;
  const int m0 = m_tile * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wn = n_tile * BN + warp * 16;   // the warp's first column
  const int quad = lane & 3;                // fragment k pair / column pair
  const int grp = lane >> 2;                // fragment row / column
  const bool col_ok[2] = {wn < N, wn + 8 < N};
  const int g_lo = (int)((long long)Gq * split / S);
  const int g_hi = (int)((long long)Gq * (split + 1) / S);

  extern __shared__ __align__(16) float smem[];
  constexpr int BUF = buf_floats<MT, GS>();
  __shared__ int last_block;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the group's operands into buffer ``buf``: x columns of the 4 planes, the 4 rows
  // of sb and corr for this column tile, and xg of the tile's rows for the 4 planes
  auto load_group = [&](int g, int buf) {
    float* base = smem + buf * BUF;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    for (int i = tid; i < 4 * BM * CH; i += NT) {
      const int j = i / (BM * CH);
      const int rem = i - j * BM * CH;
      const int r = rem / CH;
      const int c = rem - r * CH;
      const int row = m0 + r;
      const bool valid = row < M;
      const __nv_bfloat16* src =
          x + (long long)(valid ? row : 0) * K + j * Kq + g * GS + c * 8;
      cp_async16(xs + (j * BM + r) * XS + c * 8, src, valid);
    }
    float* ss = base + 4 * BM * XS / 2;     // [2][4][BN]: sb then corr
    for (int i = tid; i < 2 * 4 * (BN / 4); i += NT) {
      const int which = i / (4 * (BN / 4));
      const int rem = i - which * 4 * (BN / 4);
      const int j = rem / (BN / 4);
      const int c = rem - j * (BN / 4);
      const int col = n_tile * BN + c * 4;
      const bool valid = col < N;
      const float* src = (which ? corr : sb) + (long long)(j * Gq + g) * N + (valid ? col : 0);
      cp_async16(ss + (which * 4 + j) * BN + c * 4, src, valid);
    }
    float* xgs = ss + 2 * 4 * BN;           // [4][BM]
    for (int i = tid; i < 4 * BM; i += NT) {
      const int j = i / BM;
      const int r = i - j * BM;
      const bool valid = m0 + r < M;
      cp_async4(xgs + i, xg + (long long)(valid ? m0 + r : 0) * G + j * Gq + g, valid);
    }
    cp_async_commit();
  };

  if (g_lo < g_hi) load_group(g_lo, 0);
  for (int g = g_lo; g < g_hi; ++g) {
    const int buf = (g - g_lo) & 1;
    // the lane's B-fragment words of this group: rows quad and quad + 4 of each k-step
    uint32_t wv[KS][2][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const long long r0 = (long long)g * WR + ks * 8 + quad;
        const uint32_t* p = packed + r0 * N + wn + nt * 8 + grp;
        wv[ks][nt][0] = col_ok[nt] ? __ldg(p) : 0u;
        wv[ks][nt][1] = col_ok[nt] ? __ldg(p + 4LL * N) : 0u;
      }
    if (g + 1 < g_hi) {
      load_group(g + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float part[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
      const float* base = smem + buf * BUF;
      const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(base) + j * BM * XS;
      const float* ss = base + 4 * BM * XS / 2 + j * BN;     // sb row; corr 4 rows on
      const float* xgs = base + 4 * BM * XS / 2 + 2 * 4 * BN + j * BM;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) b[nt][h] = ((wv[ks][nt][h] >> (4 * j)) & NIBBLES) | MAGIC;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, xp + (mt * 16 + (lane & 15)) * XS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_bf16(part[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
      // acc += s[gi, n] * partial - xg[m, gi] * corr[gi, n], gi = j*Gq + g, in f32:
      // the +128 decode bias and the zero point leave with the group
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = warp * 16 + nt * 8 + quad * 2;        // column in the tile
        const float2 s = *reinterpret_cast<const float2*>(ss + c);
        const float2 cz = *reinterpret_cast<const float2*>(ss + 4 * BN + c);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float xv = xgs[mt * 16 + grp + h * 8];
            float& a0 = acc[mt][nt][2 * h];
            float& a1 = acc[mt][nt][2 * h + 1];
            a0 = fmaf(-xv, cz.x, fmaf(part[mt][nt][2 * h], s.x, a0));
            a1 = fmaf(-xv, cz.y, fmaf(part[mt][nt][2 * h + 1], s.y, a1));
          }
      }
    }
    __syncthreads();     // every warp is done with this buffer before it is refilled
  }

  if (S > 1) {
    // split-K: publish this split's partial; the tile's last block sums them all
    const long long Mp = (long long)gridDim.y * BM;
    float* mine = ws + split * Mp * N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (!col_ok[nt]) continue;
        const int col = wn + nt * 8 + quad * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + mt * 16 + grp + h * 8;
          *reinterpret_cast<float2*>(mine + row * N + col) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = m_tile * gridDim.x + n_tile;
      const int arrived = atomicAdd(counters + tile, 1);
      last_block = arrived == S - 1;
      if (last_block) counters[tile] = 0;   // every split has arrived: ready to reuse
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (!col_ok[nt]) continue;
        const int col = wn + nt * 8 + quad * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + mt * 16 + grp + h * 8;
          float2 sum = make_float2(0.f, 0.f);
          for (int s = 0; s < S; ++s) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(ws + s * Mp * N + row * N + col));
            sum.x += v.x;
            sum.y += v.y;
          }
          acc[mt][nt][2 * h] = sum.x;
          acc[mt][nt][2 * h + 1] = sum.y;
        }
      }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + grp + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (!col_ok[nt]) continue;
        const int col = wn + nt * 8 + quad * 2;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

template <int MT, int GS>
cudaError_t launch(const void* x, const void* packed, const void* sb, const void* corr,
                   const void* xg, void* out, void* ws, void* counters, int M, int N,
                   int K, int S, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<MT, GS>();
  static bool configured = false;
  if (!configured && bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(w4a16_gd_kernel<MT, GS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
  }
  configured = true;
  const dim3 grid((N + BN - 1) / BN, (M + 16 * MT - 1) / (16 * MT), S);
  w4a16_gd_kernel<MT, GS><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(packed),
      static_cast<const float*>(sb), static_cast<const float*>(corr),
      static_cast<const float*>(xg), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, S);
  return cudaGetLastError();
}

template <int GS>
cudaError_t launch_m(const void* x, const void* packed, const void* sb, const void* corr,
                     const void* xg, void* out, void* ws, void* counters, int M, int N,
                     int K, int S, cudaStream_t stream) {
  if (M <= 16) return launch<1, GS>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, S, stream);
  if (M <= 32) return launch<2, GS>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, S, stream);
  return launch<4, GS>(x, packed, sb, corr, xg, out, ws, counters, M, N, K, S, stream);
}

}  // namespace

// x [M,K] bf16; packed [K/8,N] i32; sb, corr [K/gs,N] f32; xg [M,K/gs] f32; out [M,N]
// bf16; ws [splits, ceil(M/BM)*BM, N] f32 (unused when splits == 1); counters
// [ceil(N/128) * ceil(M/BM)] i32, zero on entry and on return (BM = 16, 32 or 64 rows
// for M <= 16, <= 32, else); launches that may run at once need their own counters
// (the wrapper keeps one buffer per stream).  All contiguous.  K % (4*gs) == 0, N % 8 == 0,
// 1 <= splits <= K/(4*gs), group_size 32, 64 or 128.  Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int w4a16_gemm_gd(const void* x, const void* packed, const void* sb,
                             const void* corr, const void* xg, void* out, void* ws,
                             void* counters, int M, int N, int K, int group_size,
                             int splits, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (N % 8 || group_size <= 0 || K % (4 * group_size) || splits < 1 ||
      splits > K / (4 * group_size) || (splits > 1 && ws == nullptr))
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
