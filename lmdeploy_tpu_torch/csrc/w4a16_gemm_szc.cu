// W4A16 GEMM over plane-packed int4 weights, fast and precise schedules, for Hopper
// (sm_90a).
//
// Replaces the fast / precise body of the TPU kernel
// lmdeploy_tpu/ops/pallas/quant_matmul.py (w4a16_matmul_stacked, body
// _w4a16_kernel_stacked), selected by LMDEPLOY_TPU_W4_FAST / LMDEPLOY_TPU_W4_SCHED.
// Same function:
//   fast:    out = x @ bf16((128 + q) * sb) - xg @ corr,   corr f32 (z + 128) * sb
//   precise: out = x @ bf16((q - 7) * sb) - bf16(xg) @ corr, corr bf16 (z - 7) * sb
// with sb the bf16 scales [K/gs, N], each weight's product rounded to bf16 once
// before the dot (as the TPU kernel's bf16 multiply does; f32 scales on the dot
// outputs would be the gd schedule's numerics, not these), f32 sums, and the output
// cast to bf16 once, after the correction.  Fast's correction (~30x the signal) is
// f32 FMA, never TF32; precise's operands are bf16, their exact products summed in
// f32.
//
// What bounds it on an H100: bytes at decode.  K*N/2 bytes of nibbles plus 2 (sb) and
// 4 (fast corr) or 2 (precise corr) bytes per (group, column).  Mixtral-8x7B's
// attention projections, gs 128, per layer (H100 SXM data sheet, 3.35 TB/s and
// 989 TFLOP/s; not measured):
//   wqkv  4096 x 6144   13.8 MB (fast) -> 4.1 us   (operations at M = 64: 3.3 us)
//   wo    4096 x 4096    9.2 MB        -> 2.7 us   (2.2 us)
// so about 7 us a layer at the decode bucket of 64 rows, bytes-bound.
//
// Design: w4a16_gemm.cuh (the wgmma body shared with the gd and unprepared W4A16
// GEMMs) in its FAST and PRECISE schedules: the nibble pair decodes into an A register
// as 128 + q by the 0x4300 magic number (precise: minus 135 by a bf16x2 FMA, exact
// since (128 + q) - 135 = q - 7 lies in [-7, 8]), a bf16x2 FMA with -0 multiplies it
// by the column's scale with one rounding, and one wgmma chain runs over all groups
// and planes into one accumulator; the correction is summed in f32 registers of its
// own and subtracted once at the end.
#include "w4a16_gemm.cuh"

namespace {

template <int GS, int NTOK>
__global__ void __launch_bounds__(w4a16::THREADS, 1)
w4a16_fast_kernel(const __grid_constant__ w4a16::Params p) {
  w4a16::gemm_body<w4a16::FAST, GS, NTOK>(p);
}

template <int GS, int NTOK>
__global__ void __launch_bounds__(w4a16::THREADS, 1)
w4a16_precise_kernel(const __grid_constant__ w4a16::Params p) {
  w4a16::gemm_body<w4a16::PRECISE, GS, NTOK>(p);
}

struct Fast {
  static constexpr int MODE = w4a16::FAST;
  template <int GS, int NTOK>
  static cudaError_t run(const w4a16::Params& p, dim3 grid, int smem, cudaStream_t s) {
    static const cudaError_t configured = hopper::set_smem(w4a16_fast_kernel<GS, NTOK>, smem);
    if (configured != cudaSuccess) return configured;
    w4a16_fast_kernel<GS, NTOK><<<grid, w4a16::THREADS, smem, s>>>(p);
    return cudaGetLastError();
  }
};

struct Precise {
  static constexpr int MODE = w4a16::PRECISE;
  template <int GS, int NTOK>
  static cudaError_t run(const w4a16::Params& p, dim3 grid, int smem, cudaStream_t s) {
    static const cudaError_t configured =
        hopper::set_smem(w4a16_precise_kernel<GS, NTOK>, smem);
    if (configured != cudaSuccess) return configured;
    w4a16_precise_kernel<GS, NTOK><<<grid, w4a16::THREADS, smem, s>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// x [M,K] bf16; packed [K/8,N] i32; sb [K/gs,N] bf16; corr [K/gs,N] f32 (fast) or bf16
// (precise); xg [M,K/gs] f32 (precise: values rounded to bf16); out [M,N] bf16; ws,
// counters, shapes and the return code as w4a16::dispatch (w4a16_gemm.cuh).
extern "C" int w4a16_gemm_fast(const void* x, const void* packed, const void* sb,
                               const void* corr, const void* xg, void* out, void* ws,
                               void* counters, int M, int N, int K, int group_size,
                               int splits, void* stream) {
  return w4a16::dispatch<Fast>(x, packed, sb, corr, xg, out, ws, counters, M, N, K,
                               group_size, splits, stream);
}

extern "C" int w4a16_gemm_precise(const void* x, const void* packed, const void* sb,
                                  const void* corr, const void* xg, void* out, void* ws,
                                  void* counters, int M, int N, int K, int group_size,
                                  int splits, void* stream) {
  return w4a16::dispatch<Precise>(x, packed, sb, corr, xg, out, ws, counters, M, N, K,
                                  group_size, splits, stream);
}
