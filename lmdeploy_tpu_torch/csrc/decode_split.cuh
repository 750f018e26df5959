// The second pass of the paged decodes that split a row's pages over blocks
// (paged_decode.cu's wide and narrow paths, the int8 / int4 wide paths, and the int4 and
// TurboQuant narrow paths).  Each block of the
// first pass writes the unnormalized (acc, m, l) of its query heads over its share of
// the row's pages to part [B, S, Hq, D + 2]; decode_split_combine joins a (row, query
// head)'s S splits in a fixed order -- m = max m_s, l = sum l_s e^(m_s - m), acc
// likewise, no atomics -- then adds the sinks, if any, and divides (l == 0 -> 1).
#pragma once

#include "attn_types.cuh"

namespace attn {

constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

// the finished output of one query head from its (acc, m, l): sink logits join the
// denominator only while the row max m is above 0.5 * MASK_VALUE
__device__ __forceinline__ float finish(float acc, float m, float l, const float* sinks,
                                        int h) {
  if (sinks != nullptr && m > 0.5f * MASK_VALUE) l += expf(sinks[h] - m);
  return acc / (l == 0.f ? 1.f : l);
}

// one block per (query head, row); sinks [Hq] f32 or null
template <typename TQ>
__global__ void __launch_bounds__(128)
decode_split_combine(const float* __restrict__ part, const float* __restrict__ sinks,
                     TQ* __restrict__ out, int Hq, int D, int S) {
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const float* pr = part + ((long long)b * S * Hq + hq) * (D + 2);
  const long long sstride = (long long)Hq * (D + 2);
  float m = MASK_VALUE;
  for (int s = 0; s < S; ++s) m = fmaxf(m, pr[s * sstride + D]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) l += pr[s * sstride + D + 1] * expf(pr[s * sstride + D] - m);
  TQ* orow = out + ((long long)b * Hq + hq) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += pr[s * sstride + d] * expf(pr[s * sstride + D] - m);
    orow[d] = from_f<TQ>(finish(acc, m, l, sinks, hq));
  }
}

// As decode_split_combine, for first passes that write only a row's non-empty splits
// (the narrow paths of paged_decode.cu, paged_decode_int4.cu and paged_decode_turbo.cu):
// row b's splits [s_lo, n), n = ceil(pages / split_pages), pages = min(ceil(len / BS),
// W) (0 for an inactive row, whose output is 0), s_lo = (ws / BS) / split_pages with
// ws = max(len - window, 0) the window's start (0 without one): the splits wholly
// before the window hold no position.  The sums are decode_split_combine's over those
// splits, in the same order (an empty split adds nothing there), then the sinks, if
// any.  The block loads the (m, l) pairs side by side into shared memory (dynamic,
// 2 S floats) and weighs each split once.
template <typename TQ>
__global__ void __launch_bounds__(128)
decode_split_combine_rows(const float* __restrict__ part, const int* __restrict__ kv_lens,
                          TQ* __restrict__ out, int Hq, int D, int S, int BS, int W,
                          int split_pages, const float* __restrict__ sinks = nullptr,
                          int window = 0) {
  extern __shared__ float sw[];       // [S] m, then the weights e^(m_s - m)
  float* sl = sw + S;                 // [S] l
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int len = kv_lens[b];
  const int pages = min((len + BS - 1) / BS, W);
  const int n = pages > 0 ? min(S, (pages + split_pages - 1) / split_pages) : 0;
  const int s_lo = window > 0 ? min(n, (max(len - window, 0) / BS) / split_pages) : 0;
  const float* pr = part + ((long long)b * S * Hq + hq) * (D + 2);
  const long long sstride = (long long)Hq * (D + 2);
  for (int s = s_lo + threadIdx.x; s < n; s += blockDim.x) {
    sw[s] = pr[s * sstride + D];
    sl[s] = pr[s * sstride + D + 1];
  }
  __syncthreads();
  float m = MASK_VALUE;
  for (int s = s_lo; s < n; ++s) m = fmaxf(m, sw[s]);
  __syncthreads();
  for (int s = s_lo + threadIdx.x; s < n; s += blockDim.x) sw[s] = expf(sw[s] - m);
  __syncthreads();
  float l = 0.f;
  for (int s = s_lo; s < n; ++s) l += sl[s] * sw[s];
  TQ* orow = out + ((long long)b * Hq + hq) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int s = s_lo; s < n; ++s) acc += pr[s * sstride + d] * sw[s];
    orow[d] = from_f<TQ>(finish(acc, m, l, sinks, hq));
  }
}

}  // namespace attn
