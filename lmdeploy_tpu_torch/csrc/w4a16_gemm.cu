// W4A16 GEMM over plane-packed int4 weights, group-dot schedule, for Hopper (sm_90a).
//
// Replaces the group-dot body of the TPU kernel lmdeploy_tpu/ops/pallas/quant_matmul.py
// (w4a16_matmul_stacked, body _w4a16_kernel_stacked_gd).  Same function:
//   out[m, n] = sum_j sum_g (x_{j,g} @ (128 + q)_{j,g})[m, n] * s[j*Gq + g, n]
//             - sum_g xg[m, g] * corr[g, n]
// all in f32, written once as bf16 at the end; sb / corr f32 [K/gs, N].  Every group's
// partial product is an f32 wgmma accumulator, scaled by s in f32; groups are folded in
// a fixed order (group-major, then plane).
//
// What bounds it on an H100: at M = 128 (the e2e decode bucket) operations.  llama2-7b,
// gs 128, per layer (H100 SXM data sheet, 3.35 TB/s and 989 TFLOP/s; not measured):
//   wqkv     4096 x 12288   28.3 MB -> 8.5 us   (operations 13.0 us at M = 128)
//   wo       4096 x  4096    9.4 MB -> 2.8 us   (4.3 us)
//   w_gateup 4096 x 22016   50.7 MB -> 15.1 us  (23.3 us)
//   w_down  11264 x  4096   26.0 MB -> 7.8 us   (11.9 us; K padded from 11008)
// about 53 us a layer at M = 128; at M = 64 and below the weight bytes bound it.
//
// Design: w4a16_gemm.cuh (the wgmma body shared with the fast / precise and unprepared
// W4A16 GEMMs) in its GD schedule: per (group, plane) the gs/16 wgmma k steps into a
// zeroed f32 partial, a wait, and acc += s * part - xg * corr in f32.
#include "w4a16_gemm.cuh"

namespace {

template <int GS, int NTOK>
__global__ void __launch_bounds__(w4a16::THREADS, 1)
w4a16_gd_kernel(const __grid_constant__ w4a16::Params p) {
  w4a16::gemm_body<w4a16::GD, GS, NTOK>(p);
}

struct Gd {
  static constexpr int MODE = w4a16::GD;
  template <int GS, int NTOK>
  static cudaError_t run(const w4a16::Params& p, dim3 grid, int smem, cudaStream_t s) {
    static const cudaError_t configured = hopper::set_smem(w4a16_gd_kernel<GS, NTOK>, smem);
    if (configured != cudaSuccess) return configured;
    w4a16_gd_kernel<GS, NTOK><<<grid, w4a16::THREADS, smem, s>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// x [M,K] bf16; packed [K/8,N] i32; sb, corr [K/gs,N] f32; xg [M,K/gs] f32; out [M,N]
// bf16; ws, counters, shapes and the return code as w4a16::dispatch (w4a16_gemm.cuh).
extern "C" int w4a16_gemm_gd(const void* x, const void* packed, const void* sb,
                             const void* corr, const void* xg, void* out, void* ws,
                             void* counters, int M, int N, int K, int group_size,
                             int splits, void* stream) {
  return w4a16::dispatch<Gd>(x, packed, sb, corr, xg, out, ws, counters, M, N, K,
                             group_size, splits, stream);
}
