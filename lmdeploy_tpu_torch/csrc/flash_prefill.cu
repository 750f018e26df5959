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
// feeds them.
//
// What bounds it on an H100: operations.  At T = 2048 the causal work is
// 2 * Hq * D * T^2 = 17.2 GFLOP per layer (TinyLlama geometry) against ~19 MB of
// q/k/v/o traffic, far above the card's ~295 FLOP/byte balance point.  MLA (Hq 16,
// Hkv 1, D 576) at T = 1024: 19.3 GFLOP over 40 MB.  So the design's job is to keep
// the tensor cores fed: the products on the instruction that reaches their full rate,
// the K/V loads off the compute warps' path, and no work on keys the mask removes.
//
// A query row is one (position, head-of-the-GQA-group) pair, flattened as t * G + g,
// so one K/V tile in shared memory serves all G heads of the group, and any G >= 1
// and any T work without padding: the ragged edge (rows past T * G, and a block's
// rows that are not a whole number of positions when G does not divide its row
// count, e.g. Qwen2's G = 7 or 6) is masked here.  The K/V loop stops at the causal
// bound of the block's last row; query rows past the chunk's valid length only see
// causal keys, so they stay finite.  q/k/v are read through a per-token stride (heads
// contiguous inside a token), so slices of a fused qkv projection need no copy.
//   * bf16 / f16, D = 64 and 128 (wgmma kernel; every served family but MLA and
//     D 80 / 96): a persistent, warp-specialised block of three warpgroups on each
//     SM, walking work items of 128 flattened query rows of one (batch row, kv head),
//     the longest (highest t) first, in a snake order over the blocks so that their
//     totals even out.  Warpgroup 0 is the producer: it gives up registers (setmaxnreg
//     40) and one of its threads streams each item's K and V tiles (128 keys) into a
//     3-stage ring in shared memory (225 KB with Q at D 128) with TMA
//     (cp.async.bulk.tensor over a [tokens, Hkv, D] tensor map, 128-byte swizzle, one
//     64-column box per chunk of D), completion on a "full" mbarrier, running on into
//     the next item while the consumers finish one; the consumers free a stage on its
//     "empty" mbarrier.  Warpgroups 1 and 2 (setmaxnreg 232) own 64 rows each: Q goes
//     to shared memory once an item, in the swizzled layout, by plain stores (a TMA
//     box cannot cut 64 flattened rows out of [position, head] when G does not divide
//     64); S = Q K^T is one wgmma m64nKk16 a k step with both operands in shared
//     memory; P is rounded to the model dtype and repacked from the S accumulators
//     into A fragments in registers (no shared-memory round trip); O += P V is wgmma
//     m64nDk16 with V from the same stage as the transposed (MN-major) B operand.
//     Each consumer issues tile j's S together with tile j - 1's P V and runs tile
//     j's softmax while that P V is in flight, and the two consumers take turns at
//     issuing (named barriers), so one's softmax overlaps the other's products.  Only
//     the tiles that cross a warpgroup's diagonal (or the chunk's end) are masked.
//     The registers setmaxnreg moves to the consumers hold S, P and O of a 128-key
//     tile at D 128 (~190 a thread); Q stays in shared memory to leave them room.
//     D 80 and 96 are not multiples of the 64-column swizzle atom the TMA boxes and
//     wgmma descriptors use, so they keep the mma.sync kernel below.
//   * bf16 / f16, D = 80 and 96 (narrow mma.sync kernel): one block of 4 warps per 64
//     flattened query rows; each warp owns 16 rows and the whole D, its Q fragments
//     and its [16, D] f32 accumulator in registers.  Per 64-key tile: S = Q K^T as 8
//     m16n8 accumulators, scale + mask, online softmax with quad shuffles, then P
//     (repacked from the S accumulators) times V.  Its loads go through registers
//     into shared memory between two __syncthreads.
//   * D > 128 (wide kernel: 192, 256, 576): a [16, D] f32 accumulator per warp would
//     not fit in registers, so one block of 4 warps takes 16 query rows, and the warps
//     split the work twice: for S = Q K^T each warp takes a quarter of the tile's keys
//     (the full D, Q fragments read from shared memory), the row max and row sum are
//     combined across the warps through shared memory (in a fixed order, so every warp
//     holds the same m and l), P goes to shared memory in v's type, and for O += P V
//     each warp owns a quarter of D's columns over all the tile's keys.  Key tiles are
//     32 wide at D = 576 (two 37 KB planes), 64 below.  It beats SDPA at MLA's 576.
//   * mma.sync kernels keep Q, K, V (and P) tiles in shared memory as [row][d] with
//     rows padded by 16 bytes: fragments are conflict-free 32-bit loads, V fragments
//     come transposed from ldmatrix.trans (also conflict-free).
//   * f32: plain f32 FMA (no TF32: the Pallas kernel's f32 dots are full f32), one warp
//     per query row with an online softmax over one key at a time.  It serves f32
//     checkpoints, which are a correctness configuration, not a fast one.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "hopper.cuh"

namespace {

using attn::ld32;
using attn::ldsm_x4_trans;
using attn::Mma;
using attn::quad_max;
using attn::quad_sum;
using namespace hopper;

constexpr int NTHREADS = 128;                 // 4 warps
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------------- wgmma: D 64 / 128
constexpr int WG_ROWS = 128;                  // flattened query rows per block
constexpr int WG_THREADS = 384;               // producer warpgroup + 2 consumers

constexpr int WG_TK = 128;                    // keys per K / V tile
constexpr int WG_STAGES = 3;                  // stages of the K / V ring

template <int D>
__host__ __device__ constexpr int wg_tile_bytes() { return WG_TK * D * 2; }   // K or V

template <int D>
__host__ __device__ constexpr int wg_smem() {
  // the K / V ring, each consumer's Q [64 rows][D], slack for 1 KB alignment
  return WG_STAGES * 2 * wg_tile_bytes<D>() + 2 * 64 * D * 2 + 1024;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int TRANS_B, int R>
__device__ __forceinline__ void wgmma(float (&d)[R], const uint32_t (&a)[4], uint64_t desc,
                                      int acc) {
  hopper::wgmma_rs<std::is_same<T, __nv_bfloat16>::value, TRANS_B>(d, a, desc, acc);
}

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) wgmma_ss128_bf16(d, da, db, acc);
  else wgmma_ss128_f16(d, da, db, acc);
}

// O += P V for one tile: P as A fragments of the keys' k16 steps, V [key][d] in the
// stage at vbase as the transposed B operand: one m64nDk16 a k step, the D columns'
// 64-column atoms KT * 128 bytes apart (LBO), 8-key groups 1,024 apart (SBO)
template <typename T, int KT, int R, int PC>
__device__ __forceinline__ void issue_pv(float (&o)[R], const uint32_t (&pa)[PC][4],
                                         uint32_t vbase) {
#pragma unroll
  for (int kc = 0; kc < PC; ++kc)
    wgmma<T, 1>(o, pa[kc], sw128_desc(vbase + kc * 16 * 128, KT * 128, 1024), 1);
}

// S = Q K^T for one tile: Q [64 rows][D] at qbase and K [key][d] in the stage at kbase,
// both K-major in 64-column chunks, one m64nKTk16 a k step over D; sc's old values are
// not read
template <typename T, int D, int KT>
__device__ __forceinline__ void issue_s(float (&sc)[KT / 2], uint32_t qbase, uint32_t kbase) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)     // the first k step overwrites the scores
    wgmma_ss<T>(sc, sw128_desc(qbase + (kc / 4) * 64 * 128 + (kc % 4) * 32),
                sw128_desc(kbase + (kc / 4) * KT * 128 + (kc % 4) * 32), kc > 0);
}

// the online softmax of one tile's scores, in base 2 (x = s * scale * log2(e), m the
// running max of x), for the two rows a thread holds: masked scores are -inf, which
// gives them p = 0 against any finite running max.  Leaves P (f32) in sc, the rows'
// rescale factors, and the new max and (per-thread partial) sums
template <int R>
__device__ __forceinline__ void softmax_tile(float (&sc)[R], float (&m)[2], float (&l)[2],
                                             float (&al)[2], bool diag, int k0, int tig,
                                             const int (&pos)[2], int T_, float c2) {
  if (diag) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = k0 + (i / 4) * 8 + 2 * tig + (i & 1);
      if (key > pos[(i >> 1) & 1] || key >= T_) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < R; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(mx[h]) * c2);
    al[h] = ex2(m[h] - mn);
    m[h] = mn;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float e = ex2(fmaf(sc[i], c2, -m[(i >> 1) & 1]));
    sc[i] = e;
    sum[(i >> 1) & 1] += e;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * al[h] + sum[h];
}

// P in the model dtype as A fragments: keys 16 kc .. 16 kc + 15 are the S accumulator's
// n8 tiles 2 kc and 2 kc + 1
template <typename T, int R, int PC>
__device__ __forceinline__ void pack_p(const float (&sc)[R], uint32_t (&pa)[PC][4]) {
#pragma unroll
  for (int kc = 0; kc < PC; ++kc) {
    const int i0 = 8 * kc;
    pa[kc][0] = Mma<T>::pack(sc[i0], sc[i0 + 1]);
    pa[kc][1] = Mma<T>::pack(sc[i0 + 2], sc[i0 + 3]);
    pa[kc][2] = Mma<T>::pack(sc[i0 + 4], sc[i0 + 5]);
    pa[kc][3] = Mma<T>::pack(sc[i0 + 6], sc[i0 + 7]);
  }
}

// the two consumer warpgroups take turns at issuing their products (named barriers 1
// and 2): one's softmax runs while the other's wgmmas own the tensor cores
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(3 - wg) : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const T* __restrict__ q, T* __restrict__ out, int B, int T_, int Hq,
                   int Hkv, long long q_stride, float scale) {
  constexpr int KT = WG_TK;
  constexpr int NST = WG_STAGES;
  constexpr int TILE = wg_tile_bytes<D>();
  constexpr int CHUNK = KT * 128;              // one 64-column chunk of a tile, bytes
  constexpr int PC = KT / 16;                  // k16 steps over keys for O = P V
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  extern __shared__ __align__(128) uint8_t wg_raw[];
  // stage s: K at base + 2 s TILE, V at + TILE; 128-byte swizzle wants 1 KB alignment
  const uint32_t base = (smem_u32(wg_raw) + 1023u) & ~1023u;

  const int G = Hq / Hkv;
  const int nrows = T_ * G;
  const int heads = Hkv * B;
  const int n_items = heads * ((nrows + WG_ROWS - 1) / WG_ROWS);
  // work item w -> (row tile, kv head, batch row), the longest row tiles (highest t)
  // first.  Block k takes item k of each round of gridDim.x items, counted from the
  // round's other end in every second round (a snake), so the rounds' falling lengths
  // even out over the blocks
  auto nth = [&](int r) {
    return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                                         : (int)blockIdx.x);
  };
  auto item = [&](int w, int& kvh, int& b, int& r0, int& n_tiles) {
    const int x = w % heads;
    kvh = x % Hkv;
    b = x / Hkv;
    r0 = ((nrows + WG_ROWS - 1) / WG_ROWS - 1 - w / heads) * WG_ROWS;
    n_tiles = ((min(r0 + WG_ROWS, nrows) - 1) / G) / KT + 1;   // causal bound
  };
  // the warpgroup, read through a shuffle so the compiler sees it is warp-uniform
  // (setmaxnreg and wgmma want uniform branches)
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);     // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: one thread keeps the ring's TMA loads in flight, running on into
    // the next item's tiles while the consumers finish an item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;                              // tiles loaded so far: ring position
      for (int r = 0, w = nth(0); w < n_items; w = nth(++r)) {
        int kvh, b, r0, n_tiles;
        item(w, kvh, b, r0, n_tiles);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % NST;
          mbar_wait(smem_u32(&empty[s]), ((it / NST) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]);
          mbar_expect_tx(bar, 2 * TILE);
          const uint32_t kd = base + s * 2 * TILE;
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load(kd + c * CHUNK, &kmap, c * 64, kvh, b * T_ + j * KT, bar);
            tma_load(kd + TILE + c * CHUNK, &vmap, c * 64, kvh, b * T_ + j * KT, bar);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows of an item each.  Tile j's S = Q K^T is issued
    // together with tile j - 1's O += P V, and the softmax of tile j runs while that
    // P.V is in flight
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x - 128 * wgi;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int wg = wgi;          // 1 or 2: this warpgroup's turn barrier
    const uint32_t qbase = base + NST * 2 * TILE + (wg - 1) * 64 * D * 2;
    const float c2 = scale * 1.4426950408889634f;     // scores to base-2 logits
    if (wg == 2) turn_pass(wg);           // the first warpgroup issues first
    int it = 0;                  // tiles consumed so far: ring position
    constexpr int QU = 64 * (D / 8) / 128;   // 16-byte units of Q a thread moves

    for (int r = 0, w = nth(0); w < n_items; w = nth(++r)) {
      int kvh, b, r0, n_tiles;
      item(w, kvh, b, r0, n_tiles);
      const bool last_item = nth(r + 1) >= n_items;
      const int wr0 = r0 + (wg - 1) * 64;
      const int pmin = wr0 / G;                        // this warpgroup's first position
      const int row_a = wr0 + warp * 16 + gid;         // the two rows this thread owns
      const int row_b = row_a + 8;
      const int pos[2] = {row_a / G, row_b / G};

      // the item's Q rows into shared memory, in the 128-byte-swizzled K-major layout
      // the S products read (64-column chunks of [64 rows][128 bytes]; 16-byte unit u of
      // row r sits at unit u ^ (r % 8)); rows past T * G are zeros.  All of a thread's
      // loads are in flight together.  The last item's S products, the only readers,
      // have all completed
      uint4 x[QU];
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int i = tid + k * 128;
        const int row = wr0 + i / (D / 8);
        x[k] = make_uint4(0u, 0u, 0u, 0u);
        if (row < nrows) {
          const int t = row / G;
          x[k] = *reinterpret_cast<const uint4*>(
              q + ((long long)b * T_ + t) * q_stride + (long long)(kvh * G + row - t * G) * D
              + (i % (D / 8)) * 8);
        }
      }
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int i = tid + k * 128;
        const int qr = i / (D / 8);
        const int u = i % (D / 8);
        const uint32_t dst = qbase + (u / 8) * 64 * 128 + qr * 128 + (((u % 8) ^ (qr % 8)) * 16);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(dst), "r"(x[k].x), "r"(x[k].y), "r"(x[k].z), "r"(x[k].w)
                     : "memory");
      }
      // visible to the tensor cores' (async proxy) reads, from every thread of the group
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 2) : "memory");

      float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f}, al[2];
      float o[D / 2];            // O [64 rows][D] of the warpgroup, f32
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float sc[KT / 2];          // S, then P, [64 rows][KT]
      uint32_t pa[PC][4];        // the previous tile's P, awaiting its P.V

      // Every warpgroup walks all the item's tiles (the one its rows do not reach is
      // fully masked), so each wgmma sits in control flow that is uniform over the
      // block.  Tile 0: S alone
      mbar_wait(smem_u32(&full[it % NST]), (it / NST) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_s<T, D, KT>(sc, qbase, base + (it % NST) * 2 * TILE);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, m, l, al, KT - 1 > pmin, 0, tig, pos, T_, c2);
      pack_p<T>(sc, pa);

      for (int j = 1; j < n_tiles; ++j) {
        const int sp = (it + j - 1) % NST;   // the previous tile's stage
        const int s = (it + j) % NST;
        const int k0 = j * KT;
        mbar_wait(smem_u32(&full[s]), ((it + j) / NST) & 1);
        // S of tile j, then the P.V of tile j - 1, both in flight together
        turn_wait(wg);
        fence_regs(o);
        wgmma_fence();
        issue_s<T, D, KT>(sc, qbase, base + s * 2 * TILE);
        wgmma_commit();
        issue_pv<T, KT>(o, pa, base + sp * 2 * TILE + TILE);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();                   // S has landed; the P.V may still run
        fence_regs(sc);
        softmax_tile(sc, m, l, al, k0 + KT - 1 > pmin, k0, tig, pos, T_, c2);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(smem_u32(&empty[sp]));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= al[(i >> 1) & 1];
        pack_p<T>(sc, pa);                 // only now: the P.V no longer reads pa
      }
      // the last tile's P.V
      {
        const int sp = (it + n_tiles - 1) % NST;
        turn_wait(wg);
        fence_regs(o);
        wgmma_fence();
        issue_pv<T, KT>(o, pa, base + sp * 2 * TILE + TILE);
        wgmma_commit();
        // every turn the other warpgroup waits for, and no more
        if (wg == 1 || !last_item) turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(smem_u32(&empty[sp]));
      }
      it += n_tiles;

      float lt_a = quad_sum(l[0]), lt_b = quad_sum(l[1]);
      lt_a = lt_a == 0.f ? 1.f : lt_a;
      lt_b = lt_b == 0.f ? 1.f : lt_b;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row_b : row_a;
        if (row >= nrows) continue;
        const int t = pos[half];
        const int g = row - t * G;
        const float inv = 1.f / (half ? lt_b : lt_a);
        T* dst = out + (((long long)b * T_ + t) * Hq + kvh * G + g) * D + 2 * tig;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          *reinterpret_cast<uint32_t*>(dst + n8 * 8) =
              Mma<T>::pack(o[n8 * 4 + 2 * half] * inv, o[n8 * 4 + 2 * half + 1] * inv);
      }
    }
  }
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

// k or v [B*T tokens, Hkv, D] with a token stride of `stride` elements, as boxes of
// [WG_TK tokens][1 head][64 columns] with the 128-byte swizzle the wgmma descriptors
// read; tokens past B*T read as zeros
template <typename T, int D>
bool kv_map(CUtensorMap* map, const void* ptr, int Hkv, long long tokens, long long stride) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)tokens};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T), (cuuint64_t)stride * sizeof(T)};
  const cuuint32_t box[3] = {64, 1, WG_TK};
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return tile_map(map, dt, 3, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T_, int Hq, int Hkv,
                   long long qs, long long ks, long long vs, float scale,
                   cudaStream_t stream) {
  const int rows = T_ * (Hq / Hkv);
  if constexpr (D == 64 || D == 128) {
    CUtensorMap kmap, vmap;
    if (!kv_map<T, D>(&kmap, k, Hkv, (long long)B * T_, ks)
        || !kv_map<T, D>(&vmap, v, Hkv, (long long)B * T_, vs))
      return cudaErrorInvalidValue;
    constexpr int bytes = wg_smem<D>();
    static cudaError_t configured = set_smem(flash_wgmma_kernel<T, D>, bytes);
    if (configured != cudaSuccess) return configured;
    const int sms = sm_count();
    // one persistent block an SM (each holds one), walking the items in turn
    const long long items = (long long)Hkv * B * ((rows + WG_ROWS - 1) / WG_ROWS);
    flash_wgmma_kernel<T, D><<<(int)(items < sms ? items : sms), WG_THREADS, bytes, stream>>>(
        kmap, vmap, static_cast<const T*>(q), static_cast<T*>(out), B, T_, Hq, Hkv, qs,
        scale);
  } else if constexpr (D <= 128) {
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
// contiguous inside a token, 16-byte aligned, a batch's tokens right after the last
// batch's (one token stride throughout); out [B,T,Hq,D] contiguous, same dtype.
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
