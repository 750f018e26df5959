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
// correction's entries are formed in registers from the raw scales and zeros (each f32
// operation rounded as the reference's) and enter by f32 FMA, never TF32, so no
// prepared table is read or written.
//
// What bounds it on an H100: bytes at decode.  K*N/2 bytes of nibbles plus 8 bytes of
// f32 scale and zero per (group, column): Mixtral-8x7B's wqkv (4096 x 6144) 14.2 MB,
// 4.2 us, and wo (4096 x 4096) 9.4 MB, 2.8 us, at 3.35 TB/s (H100 SXM data sheet;
// not measured); at the decode bucket of 64 rows the operations take 3.3 and 2.2 us.
//
// Design: w4a16_gemm.cuh (the wgmma body shared with the gd and fast / precise W4A16
// GEMMs) in its UNPREPARED schedule: the gd schedule's per-(group, plane) f32 partials
// and fold, with the zeros in the C stage in place of a prepared corr; the bytes are
// the gd kernel's.
#include "w4a16_gemm.cuh"

namespace {

template <int GS, int NTOK>
__global__ void __launch_bounds__(w4a16::THREADS, 1)
w4a16_unprepared_kernel(const __grid_constant__ w4a16::Params p) {
  w4a16::gemm_body<w4a16::UNPREPARED, GS, NTOK>(p);
}

struct Unprepared {
  static constexpr int MODE = w4a16::UNPREPARED;
  template <int GS, int NTOK>
  static cudaError_t run(const w4a16::Params& p, dim3 grid, int smem, cudaStream_t s) {
    static const cudaError_t configured =
        hopper::set_smem(w4a16_unprepared_kernel<GS, NTOK>, smem);
    if (configured != cudaSuccess) return configured;
    w4a16_unprepared_kernel<GS, NTOK><<<grid, w4a16::THREADS, smem, s>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// x [M,K] bf16; packed [K/8,N] i32; scales, zeros [K/gs,N] f32 (raw); xg [M,K/gs] f32;
// out [M,N] bf16; ws, counters, shapes and the return code as w4a16::dispatch
// (w4a16_gemm.cuh).
extern "C" int w4a16_gemm_unprepared(const void* x, const void* packed, const void* scales,
                                     const void* zeros, const void* xg, void* out, void* ws,
                                     void* counters, int M, int N, int K, int group_size,
                                     int splits, void* stream) {
  return w4a16::dispatch<Unprepared>(x, packed, scales, zeros, xg, out, ws, counters, M, N,
                                     K, group_size, splits, stream);
}
