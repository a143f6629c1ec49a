// Helpers shared by the attention forward and backward kernels: type
// conversion, warp reductions and the staging of a [rows, HD] tile of one
// head into shared memory as float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mimrl {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a float32 value rounded to the input dtype, as the reference casts P
// and dS before their products
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

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

// rows [r0, r0 + rows) of one head's [T, HD] slice -> a float tile with
// row stride `stride`; rows at or past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          int r0, int rows, int t_len) {
  const int base = r0 * HD;
  const int limit = t_len * HD;
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * stride + d] = base + i < limit ? to_float(src[base + i]) : 0.f;
  }
}

}  // namespace mimrl
