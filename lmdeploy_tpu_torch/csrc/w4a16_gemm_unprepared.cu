// W4A16 GEMM over plane-packed int4 weights with raw f32 scales and zeros, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/quant_matmul.py (w4a16_matmul,
// body _w4a16_kernel_groupdot), the product over unprepared leaves: under
// LMDEPLOY_TPU_W4_STACKED=0, for models that override forward, and under a mesh.
// Same function:
//   out[m, n] = sum_j sum_g (x_{j,g} @ (128 + q)_{j,g})[m, n] * s[j*Gq + g, n]
//             - sum_g xg[m, g] * ((z[g, n] + 128) * s[g, n])
// all in f32, written once as bf16 at the end.  The TPU kernel emits the f32 first
// term and its wrapper subtracts xg @ ((z + 128) * s) at HIGHEST precision; here the
// correction's table is formed per group from the raw scales and zeros in the block
// (each f32 operation rounded as the reference's) and enters by f32 FMA, never TF32,
// so no prepared table is read or written.
//
// What bounds it on an H100: bytes at decode.  K*N/2 bytes of nibbles plus 8 bytes of
// f32 scale and zero per (group, column): Mixtral-8x7B's wqkv (4096 x 6144) 14.2 MB,
// 4.2 us, and wo (4096 x 4096) 9.4 MB, 2.8 us, at 3.35 TB/s (H100 SXM data sheet;
// not measured); at the decode bucket of 64 rows the operations take 3.3 and 2.2 us.
//
// Design: w4a16_gemm.cuh (the block body shared with the gd and fast / precise W4A16
// GEMMs) in its UNPREPARED schedule: the gd kernel's per-group f32 partials, with
// the correction table made in registers from the zeros the buffer carries in place
// of a prepared corr.
#include "w4a16_gemm.cuh"

namespace {
W4A16_DEFINE_KERNEL(w4a16_unprepared_kernel, w4a16::UNPREPARED)
}  // namespace

// x [M,K] bf16; packed [K/8,N] i32; scales, zeros [K/gs,N] f32 (raw); xg [M,K/gs] f32;
// out [M,N] bf16; ws, counters, shapes and the return code as w4a16_gemm_gd
// (w4a16_gemm.cu).
extern "C" int w4a16_gemm_unprepared(const void* x, const void* packed, const void* scales,
                                     const void* zeros, const void* xg, void* out, void* ws,
                                     void* counters, int M, int N, int K, int group_size,
                                     int splits, void* stream) {
  return w4a16_unprepared_kernel_dispatch(x, packed, scales, zeros, xg, out, ws, counters,
                                          M, N, K, group_size, splits, stream);
}
