// Causal GQA flash attention over a fresh prefill chunk's own K/V, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/flash_prefill.py
// (flash_prefill_attention, body _flash_kernel).  Same function: for each query
// row, softmax(q . k^T * scale) over the causal keys of the same chunk, times V,
// with an online softmax in f32, MASK_VALUE = -0.7 * FLT_MAX for masked scores,
// P cast to bf16 for the P.V product (as the reference casts p to v's dtype) and
// an l == 0 guard on the final division.
//
// What bounds it on an H100: operations.  At T = 2048 the causal work is
// 2 * Hq * D * T^2 = 17.2 GFLOP per layer (TinyLlama geometry) against ~19 MB of
// q/k/v/o traffic, far above the card's ~295 FLOP/byte balance point.  So both
// products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32).
//
// Design (right first; wgmma, TMA and a cp.async pipeline are later work):
//   * One block of 4 warps per (64 flattened query rows, kv head, batch row).  A
//     query row is one (position, head-of-the-GQA-group) pair, flattened as
//     t * G + g, so one K/V tile in shared memory serves all G heads of the group,
//     and any G >= 1 and any T work without padding: the ragged edge is masked here.
//   * Each warp owns 16 rows; its Q fragments stay in registers for the whole
//     loop.  Per 64-key tile: S = Q K^T as 8 m16n8 accumulators, scale + causal
//     mask, online softmax with quad shuffles, then P (repacked from the S
//     accumulators into A fragments, no shared-memory round trip) times V.
//   * Q, K and V tiles sit in shared memory as [row][d] with rows padded by 16
//     bytes: Q and K fragments are conflict-free 32-bit loads, V fragments come
//     transposed from ldmatrix.trans (also conflict-free).
//   * The K/V loop stops at the causal bound of the block's last row.  Query rows
//     past the chunk's valid length only see causal keys, so they stay finite.
//   * q/k/v are read through a per-token stride (heads contiguous inside a
//     token), so slices of a fused qkv projection need no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;                      // query rows per block
constexpr int TK = 64;                        // keys per tile
constexpr int NTHREADS = 128;                 // 4 warps x 16 rows
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

template <int D>
constexpr int smem_bytes() {
  return (ROWS + 2 * TK) * (D + 8) * (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices, transposed: B fragments of two n8 tiles of V
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     int T, int Hq, int Hkv,
                     long long q_stride, long long k_stride, long long v_stride,
                     float scale) {
  constexpr int KST = D + 8;           // padded Q/K row (bf16 elements)
  constexpr int CH = D / 8;            // 16-byte chunks per head row
  constexpr int KC = D / 16;           // k16 steps over D for S = Q K^T
  constexpr int DT = D / 8;            // n8 tiles over D for O = P V
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem;                 // [ROWS][KST]
  __nv_bfloat16* Ks = Qs + ROWS * KST;      // [TK][KST]
  __nv_bfloat16* Vs = Ks + TK * KST;        // [TK][KST]

  const int G = Hq / Hkv;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = T * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;           // fragment row (and n column) group
  const int tig = lane & 3;            // thread in group

  for (int i = tid; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = i - r * CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      const int t = (r0 + r) / G;
      const int g = (r0 + r) - t * G;
      x = *reinterpret_cast<const uint4*>(
          q + ((long long)b * T + t) * q_stride + (long long)(kvh * G + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * KST + c * 8) = x;
  }
  __syncthreads();

  // this warp's 16 rows as m16k16 A fragments, held for the whole loop
  uint32_t qa[KC][4];
  const __nv_bfloat16* qw = Qs + (warp * 16) * KST;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qa[kc][0] = ld32(qw + gid * KST + kc * 16 + 2 * tig);
    qa[kc][1] = ld32(qw + (gid + 8) * KST + kc * 16 + 2 * tig);
    qa[kc][2] = ld32(qw + gid * KST + kc * 16 + 8 + 2 * tig);
    qa[kc][3] = ld32(qw + (gid + 8) * KST + kc * 16 + 8 + 2 * tig);
  }

  // the two rows this thread owns in every accumulator: gid and gid + 8
  const int pos0 = (r0 + warp * 16 + gid) / G;
  const int pos1 = (r0 + warp * 16 + gid + 8) / G;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  const int last_row = min(r0 + ROWS, nrows) - 1;
  const int n_tiles = (last_row / G) / TK + 1;     // causal tile bound

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TK;
    __syncthreads();                               // previous tile fully consumed
    for (int i = tid; i < TK * CH; i += NTHREADS) {
      const int kk = i / CH;
      const int c = i - kk * CH;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + kk < T) {
        const long long tok = (long long)b * T + k0 + kk;
        kx = *reinterpret_cast<const uint4*>(k + tok * k_stride + (long long)kvh * D + c * 8);
        vx = *reinterpret_cast<const uint4*>(v + tok * v_stride + (long long)kvh * D + c * 8);
      }
      *reinterpret_cast<uint4*>(Ks + kk * KST + c * 8) = kx;
      *reinterpret_cast<uint4*>(Vs + kk * KST + c * 8) = vx;
    }
    __syncthreads();

    // S = Q K^T over this tile: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + gid) * KST + 2 * tig;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(s[nt], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    // scale, causal / ragged mask, online softmax (rows gid and gid + 8)
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const float x = (key <= pos && key < T) ? s[nt][e] * scale : MASK_VALUE;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn0);
      s[nt][1] = __expf(s[nt][1] - mn0);
      s[nt][2] = __expf(s[nt][2] - mn1);
      s[nt][3] = __expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + sum0;               // per-thread partial row sums (quad-reduced last)
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // O += P V: two adjacent S n-tiles form one k16 A fragment of P
#pragma unroll
    for (int kc = 0; kc < TK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      // lane l addresses row l % 8 of matrix l / 8: keys +0 / +8, d tiles dt / dt+1
      const __nv_bfloat16* vr = Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KST
                                + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vr + dt * 8);
        mma_bf16(o[dt], pa, vb[0], vb[1]);
        mma_bf16(o[dt + 1], pa, vb[2], vb[3]);
      }
    }
  }

  float lt0 = quad_sum(l0), lt1 = quad_sum(l1);
  lt0 = lt0 == 0.f ? 1.f : lt0;
  lt1 = lt1 == 0.f ? 1.f : lt1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + warp * 16 + gid + half * 8;
    if (row >= nrows) continue;
    const int t = row / G;
    const int g = row - t * G;
    const float inv = 1.f / (half ? lt1 : lt0);
    __nv_bfloat16* dst = out + (((long long)b * T + t) * Hq + kvh * G + g) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T, int Hq, int Hkv,
                   long long qs, long long ks, long long vs, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int G = Hq / Hkv;
  dim3 grid((T * G + ROWS - 1) / ROWS, Hkv, B);
  flash_prefill_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      T, Hq, Hkv, qs, ks, vs, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B,T,Hq,D], k/v [B,T,Hkv,D] bf16 with per-token strides q_stride/k_stride/v_stride
// (elements, multiples of 8) and heads contiguous inside a token, 16-byte aligned;
// out [B,T,Hq,D] contiguous bf16.  Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v, void* out,
                                  int B, int T, int Hq, int Hkv, int D,
                                  long long q_stride, long long k_stride, long long v_stride,
                                  float scale, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, out, B, T, Hq, Hkv, q_stride, k_stride, v_stride, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, out, B, T, Hq, Hkv, q_stride, k_stride, v_stride, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
