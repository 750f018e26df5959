// Hopper (sm_90a) building blocks shared by the warp-specialised kernels
// (flash_prefill.cu, w4a16_gemm.cu, fp8_bmm.cu, mxfp4_bmm.cu): mbarriers, TMA tile
// loads from tensor maps encoded on the host at run time, wgmma shared-memory
// descriptors for the 128-byte swizzle, and wgmma.mma_async with A in registers or in
// shared memory.
//
// wgmma accumulator layout (m64nNk16, f32): thread t of the warpgroup (warp w = t / 32,
// gid = lane / 4, tig = lane % 4) holds N / 2 floats; n8 tile j: d[4j], d[4j + 1] in
// row 16 w + gid, d[4j + 2], d[4j + 3] in row 16 w + gid + 8, columns 8j + 2 tig + 0 / 1.
// An A operand in registers takes the mma.m16n8k16 A layout per warp over its 16 rows:
// a0 (row gid, k 2 tig, 2 tig + 1), a1 (row gid + 8, same k), a2 (row gid, k + 8),
// a3 (row gid + 8, k + 8), the lower k in the lower half of each register.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// waits for the phase of the given parity to complete; a wait of more than 10 s can
// only be a lost arrival, and traps (a launch error) rather than hanging the stream
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// a warp's release of a ring stage: its lanes' reads are done, then one arrival on the
// stage's empty barrier (initialised with one count a warp)
__device__ __forceinline__ void mbar_release_warp(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(smem_u32(bar));
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// makes the mbarrier inits visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// brings a tensor map (a __grid_constant__ kernel parameter) into the TMA unit's cache
// ahead of its first use
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one box of a 2-D / 3-D / 4-D tensor map into shared memory at dst, coordinates innermost
// first, its bytes counted on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: rows of 128 bytes (64
// 16-bit elements, one swizzle atom wide), 8-row groups `sbo` bytes apart along the
// rows; `lbo` steps from one 64-element atom to the next across the rows' width, which
// only a transposed (MN-major) B wider than 64 crosses (a K-major operand ignores it)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo = 1024,
                                              uint32_t sbo = 1024) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// the byte offset of 16-byte unit `unit` of row `row` in a tile of 128-byte rows
// written by TMA with the 128-byte swizzle (1 KB aligned)
__device__ __forceinline__ uint32_t sw128_offset(int row, int unit) {
  return (uint32_t)(row * 128 + ((unit ^ (row & 7)) << 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous issue / wait points
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// pins A fragments computed on the CUDA cores in their registers before the wgmmas that
// read them are issued: without it ptxas may sink each fragment's computation down to
// its wgmma and reuse one set of registers, which forces a wait for every wgmma before
// the next (WARPGROUP.DEPBAR after each HGMMA in the SASS)
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    asm volatile("" : "+r"(a[k][0]), "+r"(a[k][1]), "+r"(a[k][2]), "+r"(a[k][3]) :: "memory");
}

// D[64 x N] = A[64 x 16] x B[16 x N] + (acc ? D : 0), D as N / 2 f32 a thread.  rs
// (N = 16 in bf16, 64, 128): A in registers, B in shared memory, TRANS_B = 0 for B
// stored [n][k] (K-major), 1 for [k][n]; ss (N = 128): both in shared memory, K-major.
#define HOPPER_WGMMA_RS16(NAME, TY)  \
  template <int TRANS_B>  \
  __device__ __forceinline__ void NAME(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int acc) {  \
    asm volatile(  \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"  \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"  \
        "%0, %1, %2, %3, %4, %5, %6, %7"  \
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"  \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
          "+f"(d[6]), "+f"(d[7])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc), "n"(TRANS_B));  \
  }
HOPPER_WGMMA_RS16(wgmma_rs16_bf16, "bf16")
#undef HOPPER_WGMMA_RS16
#define HOPPER_WGMMA_RS64(NAME, TY)  \
  template <int TRANS_B>  \
  __device__ __forceinline__ void NAME(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int acc) {  \
    asm volatile(  \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"  \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"  \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
          "+f"(d[30]), "+f"(d[31])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc), "n"(TRANS_B));  \
  }
HOPPER_WGMMA_RS64(wgmma_rs64_bf16, "bf16")
HOPPER_WGMMA_RS64(wgmma_rs64_f16, "f16")
#undef HOPPER_WGMMA_RS64
#define HOPPER_WGMMA_RS128(NAME, TY)  \
  template <int TRANS_B>  \
  __device__ __forceinline__ void NAME(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int acc) {  \
    asm volatile(  \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"  \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"  \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc), "n"(TRANS_B));  \
  }
HOPPER_WGMMA_RS128(wgmma_rs128_bf16, "bf16")
HOPPER_WGMMA_RS128(wgmma_rs128_f16, "f16")
#undef HOPPER_WGMMA_RS128
#define HOPPER_WGMMA_SS128(NAME, TY)  \
  __device__ __forceinline__ void NAME(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int acc) {  \
    asm volatile(  \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"  \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),  \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),  \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
        : "l"(desc_a), "l"(desc_b), "r"(acc));  \
  }
HOPPER_WGMMA_SS128(wgmma_ss128_bf16, "bf16")
HOPPER_WGMMA_SS128(wgmma_ss128_f16, "f16")
#undef HOPPER_WGMMA_SS128

// m64nNk16 with A in registers, N = 2 R: T is __nv_bfloat16 (BF true) or __half
template <bool BF, int TRANS_B, int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t desc,
                                         int acc) {
  if constexpr (R == 8) {
    static_assert(BF, "wgmma_rs: N 16 is built for bf16 only");
    wgmma_rs16_bf16<TRANS_B>(d, a, desc, acc);
  } else if constexpr (R == 32) {
    if constexpr (BF) wgmma_rs64_bf16<TRANS_B>(d, a, desc, acc);
    else wgmma_rs64_f16<TRANS_B>(d, a, desc, acc);
  } else {
    static_assert(R == 64, "wgmma_rs: N must be 16, 64 or 128");
    if constexpr (BF) wgmma_rs128_bf16<TRANS_B>(d, a, desc, acc);
    else wgmma_rs128_f16<TRANS_B>(d, a, desc, acc);
  }
}

// ------------------------------------------------------------------------ host side
template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the current device's SM count, read once
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a tiled tensor map of `rank` (<= 5) dims (innermost first, `dims` elements, `strides` the
// byte strides of dims 1..rank-1), boxes of `box` elements; elements past a dim's end
// read as zeros.  False when the driver refuses it.
inline bool tile_map(CUtensorMap* map, CUtensorMapDataType dt, int rank, const void* ptr,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, dt, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
