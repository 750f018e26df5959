// One context-parallel rank's T = 1 attention partials over its stripe of a paged KV
// cache, for Hopper (sm_90a).
//
// Replaces the partial pass of the TPU kernel lmdeploy_tpu/ops/pallas/paged_decode.py
// (paged_decode_attention_cp, body _decode_kernel_cp).  Under context parallelism the
// cache's slot axis is striped over the 'cp' ranks: rank r holds the BSl = BS / cp
// slots [r * BSl, (r + 1) * BSl) of every page, so local slot j of page p sits at the
// global position p * stride + pos_off + j (stride = BS, pos_off = r * BSl).  This
// kernel computes, for every (row, query head), the UNNORMALIZED flash partials of
// the rank's own tokens:
//   s = (q . k) * scale;  optional softcap tanh(s / c) * c;  positions pos < len and
//   pos >= ws (ws = max(len - window, 0) when window > 0) count, the rest take
//   MASK_VALUE = -0.7 * FLT_MAX (not -inf);  m = max s;  l = sum e^(s - m);
//   acc = sum e^(s - m) v, all f32.
// A rank with no local token (or an inactive row, len 0) gives m = MASK_VALUE, l = 0,
// acc = 0, so its weight e^(m - m_global) in the cross-rank combine
// (ops/paged_decode.py cp_combine: max of m, sums of l and acc weighted in rank
// order, sinks once after) is 0 and no NaN appears.  Sinks never enter here.
//
// Stripe layout: [L, NB, 2, BSl, Hkv * D] -- each page's K plane and V plane of
// head-major token rows, the rank's slots only, in q's dtype (bf16, f16 or f32).
// Block 0 is the padding block; tables [B, W] i32 map a row's page index to its
// block (the same tables on every rank).
//
// What bounds it on an H100: bytes of K/V read -- each rank reads its share of every
// row's in-window K and V rows once (Hkv * D * 2 planes * element bytes a token), the
// ranks together the whole cache's.  At Llama-3.1-8B heads (Hkv 8, D 128, bf16) that
// is 4 KiB a token and layer, split over the ranks.
//
// Design.  Rank r's local slot j of page p is position p * stride + pos_off + j, which
// rises with the local index p * BSl + j, so the row's positions in the window [ws,
// len) are one contiguous range of local indices [n(ws), n(len)), n(x) the local slots
// below position x (attn::Positions::local).  Both bodies walk the stripe as a cache of
// BSl-slot pages over that range, split over blocks (split_pages pages each; a
// 16,384-token row would otherwise walk serially while the short rows' blocks idle):
// each block whose split holds a counted slot writes its partial, and a second kernel
// (decode_split_combine_rank) combines a row's non-empty splits -- found by the
// same n() -- in a fixed order (m = max m_s, l = sum l_s e^(m_s - m), acc likewise)
// into the rank's (acc, m, l), written planar (acc [B, Hq, D], then m and l [B, Hq]).
// No atomics.  One split writes them itself.
//   * Tensor cores (bf16 / f16 stripes at D 64 / 128: Llama-3.1-8B and gpt-oss heads):
//     narrow_decode.cuh's body over the stripe's 2-byte pages -- per-warp 3-stage
//     cp.async rings of 64-slot sub-chunks with no block barrier in the loop, S = Q K^T
//     and O^T += V^T P^T on mma.sync m16n8k16 with up to 8 query heads of a kv head as
//     the A rows (each K element read once for the group), P as hi + lo in the stripe's
//     type, and the tail writing the unnormalized partials.  A stripe page of BSl = 64
//     (cp 2) or 32 (cp 4) slots takes the build with one page lookup a warp; a stripe
//     whose BSl is no multiple of 16 the one with a lookup a row.
//   * CUDA cores (f32 stripes; D 80 / 96 / 192 / 256): one block of 128 threads per (kv
//     head, group of up to 16 query heads, row, split); each page's BSl local slots go
//     through in sub-chunks of TC = 32 tokens: the head's [TC, D] slices of the K and V
//     planes to shared memory with 16-byte loads; each thread scores one token for 1 / 4
//     of the group's heads, reading the token's K row once, 16 bytes at a time; online
//     softmax per query head (warp reductions); P.V with one thread per (head, column),
//     the accumulator in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "attn_types.cuh"
#include "decode_split.cuh"
#include "narrow_decode.cuh"
#include "quant_decode.cuh"

namespace {

constexpr int NT = 128;           // threads a block
constexpr int TC = 32;            // tokens a sub-chunk
constexpr int HP = NT / TC;       // head parts: the threads that share a token
constexpr int GB = 16;            // query heads a block at most
constexpr int ACC = (GB + HP - 1) / HP;
using attn::MASK_VALUE;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ inline int float_words(int gb, int D) {
  // qs [gb][D] + os [gb][D] + ps [gb][TC] + m, l, alpha [gb], rounded to 16 bytes
  return (2 * gb * D + gb * TC + 3 * gb + 3) & ~3;
}

template <typename T>
size_t smem_bytes(int gb, int D) {
  return (size_t)float_words(gb, D) * sizeof(float)
       + (size_t)TC * (D + attn::epc<T>()) * sizeof(T)    // K slice, padded rows
       + (size_t)TC * D * sizeof(T);                      // V slice
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_decode_cp_kernel(const T* __restrict__ q,                 // [B, Hq, D]
                       const T* __restrict__ stripe,            // [L, NB, 2, BSl, Hkv*D]
                       const int* __restrict__ tables,          // [B, W]
                       const int* __restrict__ kv_lens,         // [B]
                       float* __restrict__ out,                 // planar (acc, m, l)
                       float* __restrict__ part,                // [B, S, Hq, D + 2] or null
                       int Hq, int Hkv, int D, int NB, int BSl, int W, int layer,
                       attn::Positions pos, float scale, float softcap, int window,
                       int split_pages) {
  constexpr int EPC = attn::epc<T>();   // elements per 16-byte chunk
  const int KSTR = D + EPC;             // 16-byte padded K rows: conflict-free row reads
  const int CH = D / EPC;               // 16-byte chunks per head row
  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const int h = blockIdx.x / hsplits;
  const int g0 = (blockIdx.x - h * hsplits) * GB;
  const int gb = min(GB, G - g0);
  const int b = blockIdx.y;
  const int S = gridDim.z;
  const int sp = blockIdx.z;
  const int HD = Hkv * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = kv_lens[b];
  const int ws = window > 0 ? max(len - window, 0) : 0;
  const int pos_off = pos.pos_off, stride = pos.stride;
  // the row's pages that hold a local slot of [ws, len): local indices [n(ws), n(len))
  int n_len, n_ws;
  pos.window(len, window, n_len, n_ws);
  const bool any = n_len > n_ws;
  const int p_lo = max(any ? n_ws / BSl : 0, sp * split_pages);
  const int p_hi = min(any ? min((n_len + BSl - 1) / BSl, W) : 0, (sp + 1) * split_pages);
  // a split with no page of the row writes nothing: the combine skips it
  if (S > 1 && p_lo >= p_hi) return;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [gb][D]
  float* os = qs + gb * D;          // [gb][D]
  float* ps = os + gb * D;          // [gb][TC]
  float* ms = ps + gb * TC;         // [gb]
  float* ls = ms + gb;              // [gb]
  float* as = ls + gb;              // [gb]
  T* ks = reinterpret_cast<T*>(smem + float_words(gb, D));
  T* vs = ks + TC * KSTR;

  const long long head0 = (long long)b * Hq + (long long)h * G + g0;
  const T* qrow = q + head0 * D;
  for (int i = tid; i < gb * D; i += NT) {
    qs[i] = attn::to_f(qrow[i]);
    os[i] = 0.f;
  }
  for (int g = tid; g < gb; g += NT) {
    ms[g] = MASK_VALUE;
    ls[g] = 0.f;
  }
  __syncthreads();

  const long long plane = (long long)BSl * HD;
  const int tt = tid % TC;          // this thread's token in the sub-chunk
  const int hp = tid / TC;          // and its heads hp, hp + HP, ...
  for (int p = p_lo; p < p_hi; ++p) {
    const int blk = min(max(tables[(long long)b * W + p], 0), NB - 1);
    const T* kpage = stripe + ((long long)layer * NB + blk) * 2 * plane + (long long)h * D;
    const T* vpage = kpage + plane;
    for (int t0 = 0; t0 < BSl; t0 += TC) {
      const int c0 = p * stride + pos_off + t0;   // the sub-chunk's first position
      if (c0 >= len) break;
      const int nt = min(TC, BSl - t0);
      if (c0 + nt <= ws) continue;
      // every sub-chunk that gets here holds a token in [ws, len): m turns real
      for (int i = tid; i < nt * CH; i += NT) {
        const int t = i / CH;
        const int c = i - t * CH;
        const long long off = (long long)(t0 + t) * HD + c * EPC;
        *reinterpret_cast<uint4*>(ks + t * KSTR + c * EPC) =
            *reinterpret_cast<const uint4*>(kpage + off);
        *reinterpret_cast<uint4*>(vs + t * D + c * EPC) =
            *reinterpret_cast<const uint4*>(vpage + off);
      }
      __syncthreads();

      {
        const int pos = c0 + tt;
        const bool valid = tt < nt && pos < len && pos >= ws;
        float acc[ACC];
#pragma unroll
        for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
        if (tt < nt) {
          const T* kr = ks + tt * KSTR;
          for (int c = 0; c < CH; ++c) {
            float kf[EPC];
            attn::widen16<T>(*reinterpret_cast<const uint4*>(kr + c * EPC), kf);
#pragma unroll
            for (int j = 0; j < ACC; ++j) {
              const int g = hp + HP * j;
              if (g < gb) {
                const float* qg = qs + g * D + c * EPC;
                float a = acc[j];
#pragma unroll
                for (int e = 0; e < EPC; e += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qg + e);
                  a = fmaf(qv.x, kf[e], fmaf(qv.y, kf[e + 1],
                           fmaf(qv.z, kf[e + 2], fmaf(qv.w, kf[e + 3], a))));
                }
                acc[j] = a;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < ACC; ++j) {
          const int g = hp + HP * j;
          if (g < gb) {
            float s = acc[j] * scale;
            if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
            ps[g * TC + tt] = valid ? s : MASK_VALUE;
          }
        }
      }
      __syncthreads();

      for (int g = warp; g < gb; g += NT / 32) {
        float* prow = ps + g * TC;
        float mx = MASK_VALUE;
        for (int t = lane; t < TC; t += 32) mx = fmaxf(mx, prow[t]);
        mx = warp_max(mx);
        const float m_old = ms[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < TC; t += 32) {
          const float e = t < nt ? expf(prow[t] - m_new) : 0.f;
          prow[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          as[g] = alpha;
          ls[g] = ls[g] * alpha + sum;
          ms[g] = m_new;
        }
      }
      __syncthreads();

      for (int i = tid; i < gb * D; i += NT) {
        const int g = i / D;
        const int d = i - g * D;
        const float* prow = ps + g * TC;
        float a = os[i] * as[g];
        for (int t = 0; t < nt; ++t) a = fmaf(prow[t], attn::to_f(vs[t * D + d]), a);
        os[i] = a;
      }
      __syncthreads();
    }
  }

  if (S == 1) {
    // the rank's unnormalized (acc, m, l), planar
    const long long bh = (long long)gridDim.y * Hq;
    for (int i = tid; i < gb * D; i += NT) out[head0 * D + i] = os[i];
    for (int g = tid; g < gb; g += NT) {
      out[bh * D + head0 + g] = ms[g];
      out[bh * (D + 1) + head0 + g] = ls[g];
    }
    return;
  }
  // this split's unnormalized (acc, m, l) for the combine
  float* dst = part + (((long long)b * S + sp) * Hq + h * G + g0) * (D + 2);
  for (int i = tid; i < gb * (D + 2); i += NT) {
    const int g = i / (D + 2);
    const int d = i - g * (D + 2);
    dst[i] = d < D ? os[g * D + d] : (d == D ? ms[g] : ls[g]);
  }
}

// ------------------------------------------------------- tensor-core kernel
template <typename T, int D, bool ONE_PAGE>
__global__ void __launch_bounds__(qdec::NT, qdec::min_blocks<D>())
paged_decode_cp_mma(const ndec::Args a) {
  ndec::narrow_body<T, ndec::Pages16<T>, D, ONE_PAGE, true>(a);
}

// the second pass of a launch of more than one split: a row's non-empty splits into the
// rank's (acc, m, l), (0, MASK_VALUE, 0) where none counts
cudaError_t combine(float* part, const int* kv_lens, float* out, int B, int Hq, int D,
                    int splits, int BSl, int W, int split_pages, int window,
                    attn::Positions pos, cudaStream_t stream) {
  attn::decode_split_combine_rank<<<dim3(Hq, B), 128, 2 * splits * sizeof(float), stream>>>(
      part, kv_lens, out, Hq, D, splits, BSl, W, split_pages, window, pos);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* stripe, const int* tables, const int* kv_lens,
                   float* out, float* part, int B, int Hq, int Hkv, int D, int NB, int BSl,
                   int W, int layer, attn::Positions pos, float scale, float softcap,
                   int window, int splits, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int hsplits = (G + GB - 1) / GB;
  const size_t bytes = smem_bytes<T>(G < GB ? G : GB, D);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_cp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  const int split_pages = (W + splits - 1) / splits;
  paged_decode_cp_kernel<T><<<dim3(Hkv * hsplits, B, splits), NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(stripe), tables, kv_lens, out, part,
      Hq, Hkv, D, NB, BSl, W, layer, pos, scale, softcap, window, split_pages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine(part, kv_lens, out, B, Hq, D, splits, BSl, W, split_pages, window, pos,
                 stream);
}

template <typename T, int D, bool ONE_PAGE>
cudaError_t launch_mma(const void* q, const void* stripe, const int* tables,
                       const int* kv_lens, float* out, float* part, int B, int Hq, int Hkv,
                       int NB, int BSl, int W, int layer, attn::Positions pos, float scale,
                       float softcap, int window, int splits, cudaStream_t stream) {
  constexpr int bytes = ndec::smem_bytes<ndec::Pages16<T>, D>();
  static cudaError_t configured = cudaFuncSetAttribute(
      paged_decode_cp_mma<T, D, ONE_PAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (configured != cudaSuccess) return configured;
  const int hsplits = (Hq / Hkv + qdec::GQ - 1) / qdec::GQ;
  const int split_pages = (W + splits - 1) / splits;
  const ndec::Args args{q,      stripe,  nullptr, tables,  kv_lens, nullptr, out,  part,
                        Hq,     Hkv,     NB,      BSl,     W,       layer,   scale, softcap,
                        window, split_pages, pos};
  paged_decode_cp_mma<T, D, ONE_PAGE><<<dim3(Hkv * hsplits, B, splits), qdec::NT, bytes,
                                        stream>>>(args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return combine(part, kv_lens, out, B, Hq, D, splits, BSl, W, split_pages, window, pos,
                 stream);
}

// bf16 / f16 stripes at D 64 / 128: the tensor-core body (the build with one page lookup
// a warp where BSl is a multiple of 16); f32 stripes and the other head dims: the CUDA
// cores'
template <typename T>
int by_dim(const void* q, const void* stripe, const int* tb, const int* kl, float* out,
           float* part, int B, int Hq, int Hkv, int D, int NB, int BSl, int W, int layer,
           attn::Positions pos, float scale, float softcap, int window, int splits,
           cudaStream_t s) {
#define MMA_CASE(DIM)                                                                  \
  case DIM:                                                                            \
    return (int)(BSl % qdec::WT == 0 ? launch_mma<T, DIM, true>                        \
                                     : launch_mma<T, DIM, false>)(                     \
        q, stripe, tb, kl, out, part, B, Hq, Hkv, NB, BSl, W, layer, pos, scale,        \
        softcap, window, splits, s);
  if constexpr (!std::is_same<T, float>::value) {
    switch (D) {
      MMA_CASE(64)
      MMA_CASE(128)
      default:
        break;
    }
  }
#undef MMA_CASE
  switch (D) {
    case 64: case 80: case 96: case 128: case 192: case 256:
      return (int)launch<T>(q, stripe, tb, kl, out, part, B, Hq, Hkv, D, NB, BSl, W, layer,
                            pos, scale, softcap, window, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Hq,D] contiguous of dtype 0 bf16, 1 f16 or 2 f32; stripe [L,NB,2,BSl,Hkv*D]
// contiguous in q's dtype; tables [B,W] i32; kv_lens [B] i32; out f32, planar: acc
// [B,Hq,D], then m [B,Hq], then l [B,Hq].  A local slot j of page p sits at position p *
// stride + pos_off + j.  softcap <= 0 and window <= 0 disable those options.  splits:
// the split of each row's W pages over blocks (1 for none), with part f32 [B, splits,
// Hq, D + 2] scratch when it is above 1; a split launch is followed by the combine.  D in
// {64, 80, 96, 128, 192, 256}.  Returns the CUDA error code of the launches (0 =
// launched).
extern "C" int paged_decode_cp(const void* q, const void* stripe, const void* tables,
                               const void* kv_lens, void* out, void* part, int dtype, int B,
                               int Hq, int Hkv, int D, int NB, int BSl, int W, int layer,
                               int pos_off, int stride, float scale, float softcap,
                               int window, int splits, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || BSl <= 0 || W <= 0 || stride < BSl || pos_off < 0
      || splits <= 0 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  const attn::Positions pos{pos_off, stride, BSl};
  switch (dtype) {
    case 0:
      return by_dim<__nv_bfloat16>(q, stripe, tb, kl, o, pt, B, Hq, Hkv, D, NB, BSl, W,
                                   layer, pos, scale, softcap, window, splits, s);
    case 1:
      return by_dim<__half>(q, stripe, tb, kl, o, pt, B, Hq, Hkv, D, NB, BSl, W, layer, pos,
                            scale, softcap, window, splits, s);
    case 2:
      return by_dim<float>(q, stripe, tb, kl, o, pt, B, Hq, Hkv, D, NB, BSl, W, layer, pos,
                           scale, softcap, window, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
