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
// Design: w4a16_gemm.cuh (the block body this kernel shares with the fast / precise
// and unprepared W4A16 GEMMs, in its GD schedule).  Per plane of each quant group: a
// per-group f32 partial by mma.sync bf16, then, by f32 FMA, acc += s * partial -
// xg * corr; subtracting each group's correction as it goes keeps the running sum
// near the signal instead of ~30x above it.  Narrow weights (wo, w_down: 32 column
// tiles on 132 SMs) split K over blocks, with a deterministic fix-up.
#include "w4a16_gemm.cuh"

namespace {
W4A16_DEFINE_KERNEL(w4a16_gd_kernel, w4a16::GD)
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
  return w4a16_gd_kernel_dispatch(x, packed, sb, corr, xg, out, ws, counters, M, N, K,
                                  group_size, splits, stream);
}
