// The second pass of the paged decodes that split a row's pages over blocks
// (paged_decode.cu's wide and narrow paths, the int8 / int4 wide paths, the int8, int4 and
// TurboQuant narrow paths, and a context-parallel rank's partials).  Each block of the
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

// The slots of a row that a decode counts, as indices into its pages' slots: [ws, n) --
// n the slots below the row's length, ws those below the window's start (0 without one).
// Plain pages (stride 0): a slot index is its position.  A context-parallel rank's stripe
// holds the bsl slots [pos_off, pos_off + bsl) of every page of stride slots: its local
// slot j of page p is position p * stride + pos_off + j, which rises with the local index
// p * bsl + j, so the positions in [ws, len) are the local indices [local(ws), local(len)).
struct Positions {
  int pos_off = 0, stride = 0, bsl = 0;
  // the slots below position x
  __device__ __forceinline__ int local(int x) const {
    if (stride == 0) return x;
    if (x <= pos_off) return 0;
    const int y = x - pos_off;
    return (y / stride) * bsl + min(y - (y / stride) * stride, bsl);
  }
  // a row of length len under window (<= 0: none) -> its counted slots [ws, n)
  __device__ __forceinline__ void window(int len, int window, int& n, int& ws) const {
    n = local(len);
    ws = window > 0 ? local(max(len - window, 0)) : 0;
  }
};

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

// As decode_split_combine, for first passes that write only a row's non-empty splits,
// [s_lo, n): one block per (query head, row) joins them into out[row, head] -- the
// finished output (l == 0 -> 1, sinks [Hq] if any), or with RAW a context-parallel
// rank's unnormalized (acc, m, l), planar: acc [B, Hq, D], then m [B, Hq], then l [B, Hq]
// ((0, MASK_VALUE, 0) where n <= s_lo).  The sums are decode_split_combine's over those
// splits, in the same order (an empty split adds nothing there).  The block loads the
// (m, l) pairs side by side into shared memory (dynamic, 2 S floats) and weighs each
// split once.
template <typename TQ, bool RAW>
__device__ __forceinline__ void combine_splits(const float* __restrict__ part,
                                               TQ* __restrict__ out, int Hq, int D, int S,
                                               int s_lo, int n,
                                               const float* __restrict__ sinks) {
  extern __shared__ float sw[];       // [S] m, then the weights e^(m_s - m)
  float* sl = sw + S;                 // [S] l
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
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
  const long long head = (long long)b * Hq + hq;
  TQ* orow = out + head * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int s = s_lo; s < n; ++s) acc += pr[s * sstride + d] * sw[s];
    if constexpr (RAW) orow[d] = acc;
    else orow[d] = from_f<TQ>(finish(acc, m, l, sinks, hq));
  }
  if constexpr (RAW) {
    if (threadIdx.x == 0) {
      const long long bh = (long long)gridDim.y * Hq;
      out[bh * D + head] = m;
      out[bh * (D + 1) + head] = l;
    }
  }
}

// The combine of the paged decodes' split paths (the narrow paths of paged_decode.cu,
// paged_decode_int8.cu, paged_decode_int4.cu and paged_decode_turbo.cu): row b's splits
// [s_lo, n), n = ceil(pages / split_pages), pages = min(ceil(len / BS), W) (0 for an
// inactive row, whose output is 0), s_lo = (ws / BS) / split_pages with ws = max(len -
// window, 0) the window's start (0 without one): the splits wholly before the window
// hold no position.
template <typename TQ>
__global__ void __launch_bounds__(128)
decode_split_combine_rows(const float* __restrict__ part, const int* __restrict__ kv_lens,
                          TQ* __restrict__ out, int Hq, int D, int S, int BS, int W,
                          int split_pages, const float* __restrict__ sinks = nullptr,
                          int window = 0) {
  const int len = kv_lens[blockIdx.y];
  const int pages = min((len + BS - 1) / BS, W);
  const int n = pages > 0 ? min(S, (pages + split_pages - 1) / split_pages) : 0;
  const int s_lo = window > 0 ? min(n, (max(len - window, 0) / BS) / split_pages) : 0;
  combine_splits<TQ, false>(part, out, Hq, D, S, s_lo, n, sinks);
}

// The combine of a context-parallel rank's splits (paged_decode_cp.cu): as
// decode_split_combine_rows over the rank's local slots -- row b counts [ws, len) of
// pos.window's local indices, none where len <= ws (the rank holds no slot of the row's
// window) -- into the rank's planar (acc, m, l).
__global__ void __launch_bounds__(128)
decode_split_combine_rank(const float* __restrict__ part, const int* __restrict__ kv_lens,
                          float* __restrict__ out, int Hq, int D, int S, int BS, int W,
                          int split_pages, int window, Positions pos) {
  int len, ws;
  pos.window(kv_lens[blockIdx.y], window, len, ws);
  const int pages = len > ws ? min((len + BS - 1) / BS, W) : 0;
  const int n = pages > 0 ? min(S, (pages + split_pages - 1) / split_pages) : 0;
  const int s_lo = min(n, (ws / BS) / split_pages);
  combine_splits<float, true>(part, out, Hq, D, S, s_lo, n, nullptr);
}

}  // namespace attn
