// Device code shared by the three W4A16 GEMMs over plane-packed int4 weights
// (w4a16_gemm.cu, w4a16_gemm_szc.cu, w4a16_gemm_unprepared.cu): one block body,
// specialised by the schedule, and the launch plumbing.  Each source defines its own
// __global__ entry with W4A16_DEFINE_KERNEL, so traces and launch counts name the
// three apart.
//
// Layout: packed i32 [K/8, N]; plane j (0..3) covers x columns [j*K/4, (j+1)*K/4),
// word r holds plane row 2r at bits [4j, 4j+4) and row 2r+1 at bits [16+4j, 20+4j).
// So ((w >> 4j) & 0x000F000F) | 0x43004300 is a bf16x2 pair (128+q for rows 2r and
// 2r+1) with no convert -- exactly the k-adjacent pair one register of an
// mma.m16n8k16 B fragment holds.  Per quant group g the kernels read two [K/gs, N]
// tables, a scale table S and a correction table C, and xg f32 [M, K/gs], the
// per-group sums of the same bf16 x the kernel reads (made by torch ops before the
// launch, as the reference does).  The schedules:
//   GD          S = f32 s, C = f32 (z+128)*s: acc += s * (x_g @ (128+q)_g) - xg*C
//   UNPREPARED  S = f32 s, C = f32 z (raw): the same, with (z+128)*s formed here in f32
//   FAST        S = bf16 s, C = f32 (z+128)*s: each weight's B register becomes the
//               bf16 product (128+q)*s, rounded once (bf16x2 FMA with -0); then one
//               mma chain over all groups; acc -= xg*C in f32
//   PRECISE     S = bf16 s, C = bf16 (z-7)*s: (128+q)-135 = q-7 (exact in bf16), then
//               times s as in FAST; xg arrives rounded to bf16, and the exact f32
//               products xg*C are summed in f32
// In every schedule the correction (~17-30x the signal in GD, UNPREPARED and FAST) is
// f32 FMA, never TF32, and is subtracted group by group, so the running sum stays
// near the signal; the output stays f32 until then (ROADMAP.md section 3, traps 1-3).
//
// Design (simple and right first; TMA, wgmma and a persistent stream-K schedule are
// later work):
//   * One block of 8 warps per (128-column tile, 16*MT-row tile, K split).  Each warp
//     owns 16 columns (two n8 tiles) of all the tile's rows.
//   * Per quant group g of the block's K split: the lane's packed words for the group
//     go straight from device memory to registers (each word feeds all 4 planes, so
//     every weight byte is read once); the x columns of the 4 planes go to shared
//     memory with cp.async, double-buffered across groups; A fragments by ldmatrix.
//     The group's rows of S and C (4 planes x 128 columns) and of xg (4 planes x the
//     tile's rows) ride in the same cp.async buffer.
//   * Narrow weights (32 column tiles on 132 SMs) split K over blocks.  Each split
//     writes its f32 partial to a workspace; the last block of a tile to arrive (a
//     per-tile counter) sums the splits in split order, so the result does not depend
//     on which block came last, resets the counter and writes bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w4a16 {

enum Mode { GD = 0, UNPREPARED = 1, FAST = 2, PRECISE = 3 };

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int BN = NWARPS * 16;                  // columns per block tile
constexpr uint32_t NIBBLES = 0x000F000Fu;
constexpr uint32_t MAGIC = 0x43004300u;          // bf16 pair (128, 128): exponent 2^7, ulp 1
constexpr uint32_t BF16X2_ONE = 0x3F803F80u;     // (1, 1)
constexpr uint32_t BF16X2_M135 = 0xC307C307u;    // (-135, -135)
constexpr uint32_t BF16X2_M0 = 0x80008000u;      // (-0, -0): a*b + -0 is a*b, rounded once

__host__ __device__ constexpr int s_bytes(int mode) { return mode >= FAST ? 2 : 4; }
__host__ __device__ constexpr int c_bytes(int mode) { return mode == PRECISE ? 2 : 4; }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a * b + c on a bf16 pair, rounded to nearest-even once
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
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

// one buffer per group, in bytes: x [4 planes][BM][GS + 8] bf16 (16-byte padded
// rows), then S [4][BN], C [4][BN] and xg f32 [4][BM]; the kernel keeps two
template <int MODE, int MT, int GS>
__host__ __device__ constexpr int buf_bytes() {
  return 4 * (16 * MT) * (GS + 8) * 2 + 4 * BN * (s_bytes(MODE) + c_bytes(MODE)) +
         4 * (16 * MT) * 4;
}

template <int MODE, int MT, int GS>
constexpr size_t smem_bytes() {
  return (size_t)2 * buf_bytes<MODE, MT, GS>();
}

template <int MODE, int MT, int GS>
__device__ __forceinline__ void body(const __nv_bfloat16* __restrict__ x,  // [M, K]
                                     const uint32_t* __restrict__ packed,  // [K/8, N]
                                     const void* __restrict__ tab_s,       // [G, N]
                                     const void* __restrict__ tab_c,       // [G, N]
                                     const float* __restrict__ xg,         // [M, G]
                                     __nv_bfloat16* __restrict__ out,      // [M, N]
                                     float* __restrict__ ws,               // [S, Mp, N]
                                     int* __restrict__ counters,           // [tiles]
                                     int M, int N, int K, int S,
                                     unsigned char* smem, int* last_block) {
  constexpr bool GROUP_DOT = MODE == GD || MODE == UNPREPARED;
  constexpr int SB = s_bytes(MODE);
  constexpr int CB = c_bytes(MODE);
  constexpr int BM = 16 * MT;
  constexpr int XS = GS + 8;      // shared-memory row stride of the x tile (bf16)
  constexpr int KS = GS / 16;     // mma k-steps per group
  constexpr int WR = GS / 2;      // packed word rows per group
  constexpr int CH = GS / 8;      // 16-byte chunks per x row of a group
  constexpr int BUF = buf_bytes<MODE, MT, GS>();
  constexpr int S_OFF = 4 * BM * XS * 2;
  constexpr int C_OFF = S_OFF + 4 * BN * SB;
  constexpr int XG_OFF = C_OFF + 4 * BN * CB;
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

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // one table's 4 rows of this group for the column tile, 16 bytes a copy
  auto load_rows = [&](unsigned char* dst, const void* tab, int bytes, int g) {
    const int per_row = BN * bytes / 16;
    for (int i = tid; i < 4 * per_row; i += NT) {
      const int j = i / per_row;
      const int c = i - j * per_row;
      const int col = n_tile * BN + c * (16 / bytes);
      const bool valid = col < N;
      const char* src = static_cast<const char*>(tab) +
                        ((long long)(j * Gq + g) * N + (valid ? col : 0)) * bytes;
      cp_async16(dst + j * BN * bytes + c * 16, src, valid);
    }
  };

  // the group's operands into buffer ``buf``: x columns of the 4 planes, the 4 rows
  // of S and C for this column tile, and xg of the tile's rows for the 4 planes
  auto load_group = [&](int g, int buf) {
    unsigned char* base = smem + buf * BUF;
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
    load_rows(base + S_OFF, tab_s, SB, g);
    load_rows(base + C_OFF, tab_c, CB, g);
    float* xgs = reinterpret_cast<float*>(base + XG_OFF);     // [4][BM]
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
      const unsigned char* base = smem + buf * BUF;
      const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(base) + j * BM * XS;
      const unsigned char* srow = base + S_OFF + j * BN * SB;
      const unsigned char* crow = base + C_OFF + j * BN * CB;
      const float* xgs = reinterpret_cast<const float*>(base + XG_OFF) + j * BM;
      if constexpr (GROUP_DOT) {
        // a per-group f32 partial by mma.sync, then acc += s * partial - xg * corr,
        // gi = j*Gq + g, in f32: the +128 decode bias and the zero point leave with
        // the group
        float part[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
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
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = warp * 16 + nt * 8 + quad * 2;        // column in the tile
          const float2 s = *reinterpret_cast<const float2*>(srow + c * 4);
          float2 cz = *reinterpret_cast<const float2*>(crow + c * 4);
          if constexpr (MODE == UNPREPARED) {
            // the reference's (z + 128) * s, each f32 operation rounded as there
            cz.x = __fmul_rn(__fadd_rn(cz.x, 128.f), s.x);
            cz.y = __fmul_rn(__fadd_rn(cz.y, 128.f), s.y);
          }
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
      } else {
        // each weight's B register times its column's bf16 scale, rounded once; the
        // lane's B columns are wn + nt*8 + grp
        uint32_t s2[2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t sv =
              reinterpret_cast<const uint16_t*>(srow)[warp * 16 + nt * 8 + grp];
          s2[nt] = sv | (sv << 16);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[2][2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t v = ((wv[ks][nt][h] >> (4 * j)) & NIBBLES) | MAGIC;
              if constexpr (MODE == PRECISE) v = bf16x2_fma(v, BF16X2_ONE, BF16X2_M135);
              b[nt][h] = bf16x2_fma(v, s2[nt], BF16X2_M0);
            }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, xp + (mt * 16 + (lane & 15)) * XS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
        // acc -= xg[m, gi] * corr[gi, n] in f32 (precise: exact products of bf16s)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = warp * 16 + nt * 8 + quad * 2;
          float2 cz;
          if constexpr (MODE == PRECISE) {
            const uint32_t pair = *reinterpret_cast<const uint32_t*>(crow + c * 2);
            cz = make_float2(__uint_as_float(pair << 16), __uint_as_float(pair & 0xFFFF0000u));
          } else {
            cz = *reinterpret_cast<const float2*>(crow + c * 4);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float xv = xgs[mt * 16 + grp + h * 8];
              acc[mt][nt][2 * h] = fmaf(-xv, cz.x, acc[mt][nt][2 * h]);
              acc[mt][nt][2 * h + 1] = fmaf(-xv, cz.y, acc[mt][nt][2 * h + 1]);
            }
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
      *last_block = arrived == S - 1;
      if (*last_block) counters[tile] = 0;   // every split has arrived: ready to reuse
    }
    __syncthreads();
    if (!*last_block) return;
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

// the C entry's argument checks: 0 when the launch may go ahead
inline int check_args(int M, int N, int K, int group_size, int splits, const void* ws) {
  if (N % 8 || group_size <= 0 || K % (4 * group_size) || splits < 1 ||
      splits > K / (4 * group_size) || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace w4a16

#define W4A16_PARAMS                                                                  \
  const __nv_bfloat16 *__restrict__ x, const uint32_t *__restrict__ packed,           \
      const void *__restrict__ tab_s, const void *__restrict__ tab_c,                 \
      const float *__restrict__ xg, __nv_bfloat16 *__restrict__ out,                  \
      float *__restrict__ ws, int *__restrict__ counters, int M, int N, int K, int S

// Defines the __global__ kernel NAME<MT, GS> running the MODE body, and
// NAME_dispatch(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N, K, group_size,
// splits, stream), which picks the row tile (16, 32 or 64 rows for M <= 16, <= 32,
// else) and the group size (32, 64, 128), sets the dynamic shared memory once, and
// returns the launch's CUDA error code.
#define W4A16_DEFINE_KERNEL(NAME, MODE)                                                   \
  template <int MT, int GS>                                                               \
  __global__ void __launch_bounds__(w4a16::NT) NAME(W4A16_PARAMS) {                       \
    extern __shared__ __align__(16) unsigned char smem[];                                 \
    __shared__ int last_block;                                                            \
    w4a16::body<MODE, MT, GS>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N, K, S, \
                              smem, &last_block);                                         \
  }                                                                                       \
  template <int MT, int GS>                                                               \
  cudaError_t NAME##_launch(const void* x, const void* packed, const void* tab_s,         \
                            const void* tab_c, const void* xg, void* out, void* ws,       \
                            void* counters, int M, int N, int K, int S,                   \
                            cudaStream_t stream) {                                        \
    constexpr size_t bytes = w4a16::smem_bytes<MODE, MT, GS>();                           \
    static bool configured = false;                                                       \
    if (!configured && bytes > 48 * 1024) {                                               \
      cudaError_t e = cudaFuncSetAttribute(                                               \
          NAME<MT, GS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);         \
      if (e != cudaSuccess) return e;                                                     \
    }                                                                                     \
    configured = true;                                                                    \
    const dim3 grid((N + w4a16::BN - 1) / w4a16::BN, (M + 16 * MT - 1) / (16 * MT), S);   \
    NAME<MT, GS><<<grid, w4a16::NT, bytes, stream>>>(                                     \
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(packed),       \
        tab_s, tab_c, static_cast<const float*>(xg), static_cast<__nv_bfloat16*>(out),    \
        static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, S);                \
    return cudaGetLastError();                                                            \
  }                                                                                       \
  template <int GS>                                                                       \
  cudaError_t NAME##_launch_m(const void* x, const void* packed, const void* tab_s,       \
                              const void* tab_c, const void* xg, void* out, void* ws,     \
                              void* counters, int M, int N, int K, int S,                 \
                              cudaStream_t st) {                                          \
    if (M <= 16)                                                                          \
      return NAME##_launch<1, GS>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N,   \
                                  K, S, st);                                              \
    if (M <= 32)                                                                          \
      return NAME##_launch<2, GS>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N,   \
                                  K, S, st);                                              \
    return NAME##_launch<4, GS>(x, packed, tab_s, tab_c, xg, out, ws, counters, M, N, K,  \
                                S, st);                                                   \
  }                                                                                       \
  int NAME##_dispatch(const void* x, const void* packed, const void* tab_s,               \
                      const void* tab_c, const void* xg, void* out, void* ws,             \
                      void* counters, int M, int N, int K, int group_size, int splits,    \
                      void* stream) {                                                     \
    if (M <= 0 || N <= 0) return (int)cudaSuccess;                                        \
    const int bad = w4a16::check_args(M, N, K, group_size, splits, ws);                   \
    if (bad) return bad;                                                                  \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                   \
    switch (group_size) {                                                                 \
      case 32:                                                                            \
        return (int)NAME##_launch_m<32>(x, packed, tab_s, tab_c, xg, out, ws, counters,   \
                                        M, N, K, splits, s);                              \
      case 64:                                                                            \
        return (int)NAME##_launch_m<64>(x, packed, tab_s, tab_c, xg, out, ws, counters,   \
                                        M, N, K, splits, s);                              \
      case 128:                                                                           \
        return (int)NAME##_launch_m<128>(x, packed, tab_s, tab_c, xg, out, ws, counters,  \
                                         M, N, K, splits, s);                             \
      default:                                                                            \
        return (int)cudaErrorInvalidValue;                                                \
    }                                                                                     \
  }
