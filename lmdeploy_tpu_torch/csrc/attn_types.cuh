// Element types of the attention kernels: the model's dtypes (bf16, f16, f32) for q,
// k, v and the output, and e4m3 (its raw byte) for an fp8 KV cache.  Every kernel
// widens each element to f32 on load and rounds once on store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace attn {

using fp8_t = __nv_fp8_storage_t;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
// e4m3 -> f16 is exact, and so is f16 -> f32
__device__ __forceinline__ float to_f(fp8_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// elements per 16-byte chunk
template <typename T>
__host__ __device__ constexpr int epc() { return 16 / (int)sizeof(T); }

// one 16-byte chunk of T elements -> f32
template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < epc<T>(); ++i) f[i] = to_f(e[i]);
}

template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // a bf16 is the high half of its f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <>
__device__ __forceinline__ void widen16<fp8_t>(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_fp8x2_storage_t x2 = static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * j));
      const float2 v = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(x2, __NV_E4M3)));
      f[4 * i + 2 * j] = v.x;
      f[4 * i + 2 * j + 1] = v.y;
    }
  }
}

}  // namespace attn
