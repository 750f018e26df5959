// Causal GQA flash attention over a fresh prefill chunk's own K/V, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/flash_prefill.py
// (flash_prefill_attention, body _flash_kernel).  Same function: for each query
// row, softmax(q . k^T * scale) over the causal keys of the same chunk, times V,
// with an online softmax in f32, MASK_VALUE = -0.7 * FLT_MAX for masked scores,
// P cast to v's type for the P.V product (as the reference casts p to v's dtype) and
// an l == 0 guard on the final division.  Any head dim of the served families and
// MLA's latent D = 576 (the set the entry point below lists), and the three model
// dtypes; the operands enter the products in their own type, as the Pallas kernel
// feeds them:
//   * bf16 and f16: both products on the tensor cores, mma.sync m16n8k16 with f32
//     accumulation (the f16 instruction for f16);
//   * f32: plain f32 FMA (no TF32: the Pallas kernel's f32 dots are full f32), one warp
//     per query row with an online softmax over one key at a time.  It serves f32
//     checkpoints, which are a correctness configuration, not a fast one.
//
// What bounds it on an H100: operations.  At T = 2048 the causal work is
// 2 * Hq * D * T^2 = 17.2 GFLOP per layer (TinyLlama geometry) against ~19 MB of
// q/k/v/o traffic, far above the card's ~295 FLOP/byte balance point.  MLA (Hq 16,
// Hkv 1, D 576) at T = 1024: 19.3 GFLOP over 40 MB.
//
// Design (right first; wgmma, TMA and a cp.async pipeline are later work).  A query
// row is one (position, head-of-the-GQA-group) pair, flattened as t * G + g, so one
// K/V tile in shared memory serves all G heads of the group, and any G >= 1 and any T
// work without padding: the ragged edge is masked here.  The K/V loop stops at the
// causal bound of the block's last row; query rows past the chunk's valid length only
// see causal keys, so they stay finite.  q/k/v are read through a per-token stride
// (heads contiguous inside a token), so slices of a fused qkv projection need no copy.
//   * D <= 128 (narrow kernel): one block of 4 warps per 64 flattened query rows;
//     each warp owns 16 rows and the whole D, its Q fragments and its [16, D] f32
//     accumulator in registers.  Per 64-key tile: S = Q K^T as 8 m16n8 accumulators,
//     scale + mask, online softmax with quad shuffles, then P (repacked from the S
//     accumulators, no shared-memory round trip) times V.
//   * D > 128 (wide kernel: 192, 256, 576): a [16, D] f32 accumulator per warp would
//     not fit in registers, so one block of 4 warps takes 16 query rows, and the warps
//     split the work twice: for S = Q K^T each warp takes a quarter of the tile's keys
//     (the full D, Q fragments read from shared memory), the row max and row sum are
//     combined across the warps through shared memory (in a fixed order, so every warp
//     holds the same m and l), P goes to shared memory in v's type, and for O += P V
//     each warp owns a quarter of D's columns over all the tile's keys.  Key tiles are
//     32 wide at D = 576 (two 37 KB planes), 64 below.
//   * Q, K, V (and P) tiles sit in shared memory as [row][d] with rows padded by 16
//     bytes: fragments are conflict-free 32-bit loads, V fragments come transposed
//     from ldmatrix.trans (also conflict-free).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;                 // 4 warps
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices, transposed: B fragments of two n8 tiles of V
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// [nrows][D] rows of a head-contiguous [.., T, H, D] tensor into shared memory
// ([row][D + 8]), 16 bytes a thread; rows past the chunk (or the block) are zeros
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride,
                                          int first, int count, int limit, int head) {
  constexpr int CH = D / 8;
  constexpr int ST = D + 8;
  for (int i = threadIdx.x; i < count * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = i - r * CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < limit)
      x = *reinterpret_cast<const uint4*>(src + (long long)(first + r) * stride
                                          + (long long)head * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ST + c * 8) = x;
  }
}

// ------------------------------------------------------------------- narrow: D <= 128
constexpr int ROWS = 64;                      // query rows per block
constexpr int TK = 64;                        // keys per tile

template <typename T, int D>
__host__ __device__ constexpr int narrow_smem() {
  return (ROWS + 2 * TK) * (D + 8) * (int)sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_narrow_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    int T_, int Hq, int Hkv,
                    long long q_stride, long long k_stride, long long v_stride,
                    float scale) {
  constexpr int KST = D + 8;           // padded Q/K row (elements)
  constexpr int CH = D / 8;            // 16-byte chunks per head row
  constexpr int KC = D / 16;           // k16 steps over D for S = Q K^T
  constexpr int DT = D / 8;            // n8 tiles over D for O = P V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [ROWS][KST]
  T* Ks = Qs + ROWS * KST;                  // [TK][KST]
  T* Vs = Ks + TK * KST;                    // [TK][KST]

  const int G = Hq / Hkv;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = T_ * G;
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
          q + ((long long)b * T_ + t) * q_stride + (long long)(kvh * G + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * KST + c * 8) = x;
  }
  __syncthreads();

  // this warp's 16 rows as m16k16 A fragments, held for the whole loop
  uint32_t qa[KC][4];
  const T* qw = Qs + (warp * 16) * KST;
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
  const T* kb = k + (long long)b * T_ * k_stride;
  const T* vb = v + (long long)b * T_ * v_stride;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TK;
    __syncthreads();                               // previous tile fully consumed
    load_rows<T, D>(Ks, kb, k_stride, k0, TK, T_, kvh);
    load_rows<T, D>(Vs, vb, v_stride, k0, TK, T_, kvh);
    __syncthreads();

    // S = Q K^T over this tile: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* kr = Ks + (nt * 8 + gid) * KST + 2 * tig;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        Mma<T>::run(s[nt], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    // scale, causal / ragged mask, online softmax (rows gid and gid + 8)
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const float x = (key <= pos && key < T_) ? s[nt][e] * scale : MASK_VALUE;
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
      pa[0] = Mma<T>::pack(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = Mma<T>::pack(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = Mma<T>::pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = Mma<T>::pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      // lane l addresses row l % 8 of matrix l / 8: keys +0 / +8, d tiles dt / dt+1
      const T* vr = Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KST
                    + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb4[4];
        ldsm_x4_trans(vb4, vr + dt * 8);
        Mma<T>::run(o[dt], pa, vb4[0], vb4[1]);
        Mma<T>::run(o[dt + 1], pa, vb4[2], vb4[3]);
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
    T* dst = out + (((long long)b * T_ + t) * Hq + kvh * G + g) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          Mma<T>::pack(o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
  }
}

// ------------------------------------------------------------------- wide: D > 128
constexpr int WROWS = 16;                     // query rows per block

template <int D>
__host__ __device__ constexpr int wide_tk() { return D > 256 ? 32 : 64; }

template <typename T, int D>
__host__ __device__ constexpr int wide_smem() {
  return ((WROWS + 2 * wide_tk<D>()) * (D + 8) + WROWS * (wide_tk<D>() + 8))
             * (int)sizeof(T)
         + 2 * 4 * WROWS * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  int T_, int Hq, int Hkv,
                  long long q_stride, long long k_stride, long long v_stride,
                  float scale) {
  constexpr int TKW = wide_tk<D>();
  constexpr int KST = D + 8;
  constexpr int PST = TKW + 8;         // padded P row
  constexpr int KC = D / 16;           // k16 steps over D for S = Q K^T
  constexpr int NTW = TKW / 32;        // n8 key tiles per warp for S
  constexpr int DW = D / 4;            // columns of O per warp
  constexpr int DT = DW / 8;           // n8 tiles over them
  static_assert(DT % 2 == 0, "two n8 tiles per ldmatrix.x4");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [WROWS][KST]
  T* Ks = Qs + WROWS * KST;                 // [TKW][KST]
  T* Vs = Ks + TKW * KST;                   // [TKW][KST]
  T* Ps = Vs + TKW * KST;                   // [WROWS][PST]
  float* red = reinterpret_cast<float*>(Ps + WROWS * PST);   // [2][4 warps][WROWS]

  const int G = Hq / Hkv;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * WROWS;
  const int nrows = T_ * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  for (int i = tid; i < WROWS * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8);
    const int c = i - r * (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      const int t = (r0 + r) / G;
      const int g = (r0 + r) - t * G;
      x = *reinterpret_cast<const uint4*>(
          q + ((long long)b * T_ + t) * q_stride + (long long)(kvh * G + g) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * KST + c * 8) = x;
  }

  const int pos0 = (r0 + gid) / G;
  const int pos1 = (r0 + gid + 8) / G;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  const int last_row = min(r0 + WROWS, nrows) - 1;
  const int n_tiles = (last_row / G) / TKW + 1;
  const T* kb = k + (long long)b * T_ * k_stride;
  const T* vb = v + (long long)b * T_ * v_stride;
  float* rmax = red;                   // [4][WROWS]
  float* rsum = red + 4 * WROWS;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TKW;
    __syncthreads();                   // previous tile (and Q on the first) done
    load_rows<T, D>(Ks, kb, k_stride, k0, TKW, T_, kvh);
    load_rows<T, D>(Vs, vb, v_stride, k0, TKW, T_, kvh);
    __syncthreads();

    // S = Q K^T over this warp's keys [warp * 8 NTW, +8 NTW), the full D
    float s[NTW][4];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      qa[0] = ld32(Qs + gid * KST + kc * 16 + 2 * tig);
      qa[1] = ld32(Qs + (gid + 8) * KST + kc * 16 + 2 * tig);
      qa[2] = ld32(Qs + gid * KST + kc * 16 + 8 + 2 * tig);
      qa[3] = ld32(Qs + (gid + 8) * KST + kc * 16 + 8 + 2 * tig);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const T* kr = Ks + ((warp * NTW + nt) * 8 + gid) * KST + kc * 16 + 2 * tig;
        Mma<T>::run(s[nt], qa, ld32(kr), ld32(kr + 8));
      }
    }
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + (warp * NTW + nt) * 8 + 2 * tig + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const float x = (key <= pos && key < T_) ? s[nt][e] * scale : MASK_VALUE;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (tig == 0) {
      rmax[warp * WROWS + gid] = mx0;
      rmax[warp * WROWS + gid + 8] = mx1;
    }
    __syncthreads();
    float mn0 = m0, mn1 = m1;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      mn0 = fmaxf(mn0, rmax[w * WROWS + gid]);
      mn1 = fmaxf(mn1, rmax[w * WROWS + gid + 8]);
    }
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn0);
      s[nt][1] = __expf(s[nt][1] - mn0);
      s[nt][2] = __expf(s[nt][2] - mn1);
      s[nt][3] = __expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
      const int c = (warp * NTW + nt) * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(Ps + gid * PST + c) = Mma<T>::pack(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(Ps + (gid + 8) * PST + c) =
          Mma<T>::pack(s[nt][2], s[nt][3]);
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    if (tig == 0) {
      rsum[warp * WROWS + gid] = sum0;
      rsum[warp * WROWS + gid + 8] = sum1;
    }
    __syncthreads();
    // every warp sums the four partials in the same order: one l for all
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      t0 += rsum[w * WROWS + gid];
      t1 += rsum[w * WROWS + gid + 8];
    }
    l0 = l0 * a0 + t0;
    l1 = l1 * a1 + t1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }

    // O[:, warp's columns] += P V over all the tile's keys
#pragma unroll
    for (int kc = 0; kc < TKW / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = ld32(Ps + gid * PST + kc * 16 + 2 * tig);
      pa[1] = ld32(Ps + (gid + 8) * PST + kc * 16 + 2 * tig);
      pa[2] = ld32(Ps + gid * PST + kc * 16 + 8 + 2 * tig);
      pa[3] = ld32(Ps + (gid + 8) * PST + kc * 16 + 8 + 2 * tig);
      const T* vr = Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KST
                    + (lane >> 4) * 8 + warp * DW;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t vb4[4];
        ldsm_x4_trans(vb4, vr + dt * 8);
        Mma<T>::run(o[dt], pa, vb4[0], vb4[1]);
        Mma<T>::run(o[dt + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + gid + half * 8;
    if (row >= nrows) continue;
    const int t = row / G;
    const int g = row - t * G;
    const float inv = half ? inv1 : inv0;
    T* dst = out + (((long long)b * T_ + t) * Hq + kvh * G + g) * D + warp * DW + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          Mma<T>::pack(o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
  }
}

// ------------------------------------------------------------------- f32: any D
// one warp per flattened query row; lane l holds dims l, l + 32, ... of q and o
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int T_, int Hq, int Hkv,
                 long long q_stride, long long k_stride, long long v_stride,
                 float scale) {
  constexpr int NPL = (D + 31) / 32;
  const int G = Hq / Hkv;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T_ * G) return;
  const int t = row / G;
  const int g = row - t * G;
  const float* qr = q + ((long long)b * T_ + t) * q_stride + (long long)(kvh * G + g) * D;
  float qv[NPL], o[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? qr[d] : 0.f;
    o[i] = 0.f;
  }
  float m = MASK_VALUE, l = 0.f;
  for (int key = 0; key <= t; ++key) {
    const long long tok = (long long)b * T_ + key;
    const float* kr = k + tok * k_stride + (long long)kvh * D;
    const float* vr = v + tok * v_stride + (long long)kvh * D;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dot = fmaf(qv[i], kr[d], dot);
    }
    const float s = warp_sum(dot) * scale;
    const float mn = fmaxf(m, s);
    const float a = expf(m - mn);
    const float p = expf(s - mn);
    l = l * a + p;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      o[i] = o[i] * a + (d < D ? p * vr[d] : 0.f);
    }
    m = mn;
  }
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  float* dst = out + (((long long)b * T_ + t) * Hq + kvh * G + g) * D;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) dst[d] = o[i] * inv;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T_, int Hq, int Hkv,
                   long long qs, long long ks, long long vs, float scale,
                   cudaStream_t stream) {
  const int rows = T_ * (Hq / Hkv);
  if constexpr (D <= 128) {
    constexpr int bytes = narrow_smem<T, D>();
    static cudaError_t configured = set_smem(flash_narrow_kernel<T, D>, bytes);
    if (configured != cudaSuccess) return configured;
    dim3 grid((rows + ROWS - 1) / ROWS, Hkv, B);
    flash_narrow_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), T_, Hq, Hkv, qs, ks, vs, scale);
  } else {
    constexpr int bytes = wide_smem<T, D>();
    static cudaError_t configured = set_smem(flash_wide_kernel<T, D>, bytes);
    if (configured != cudaSuccess) return configured;
    dim3 grid((rows + WROWS - 1) / WROWS, Hkv, B);
    flash_wide_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), T_, Hq, Hkv, qs, ks, vs, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int T_, int Hq, int Hkv,
                       long long qs, long long ks, long long vs, float scale,
                       cudaStream_t stream) {
  const int rows = T_ * (Hq / Hkv);
  constexpr int WARPS = NTHREADS / 32;
  dim3 grid((rows + WARPS - 1) / WARPS, Hkv, B);
  flash_f32_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), T_, Hq, Hkv, qs, ks, vs,
      scale);
  return cudaGetLastError();
}

// dtype: 0 bf16, 1 f16, 2 f32
template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v,
                         void* out, int B, int T_, int Hq, int Hkv, long long qs,
                         long long ks, long long vs, float scale, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16, D>(q, k, v, out, B, T_, Hq, Hkv, qs, ks, vs, scale, s);
    case 1:
      return launch<__half, D>(q, k, v, out, B, T_, Hq, Hkv, qs, ks, vs, scale, s);
    case 2:
      return launch_f32<D>(q, k, v, out, B, T_, Hq, Hkv, qs, ks, vs, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,T,Hq,D], k/v [B,T,Hkv,D] of one dtype (0 bf16, 1 f16, 2 f32) with per-token
// strides q_stride/k_stride/v_stride (elements; 16-byte multiples) and heads
// contiguous inside a token, 16-byte aligned; out [B,T,Hq,D] contiguous, same dtype.
// D in {64, 80, 96, 128, 192, 256, 576}.  Returns the CUDA error code of the launch
// (0 = ok).
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out,
                             int dtype, int B, int T, int Hq, int Hkv, int D,
                             long long q_stride, long long k_stride, long long v_stride,
                             float scale, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DIM)                                                                \
  case DIM:                                                                            \
    return (int)launch_dtype<DIM>(dtype, q, k, v, out, B, T, Hq, Hkv, q_stride,       \
                                  k_stride, v_stride, scale, s);
  switch (D) {
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(128)
    FLASH_CASE(192)
    FLASH_CASE(256)
    FLASH_CASE(576)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
