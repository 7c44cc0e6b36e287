// Shared helpers of the port's CUDA kernels (plain C interface, no PyTorch
// headers: the library is built by one plain nvcc call and bound with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LEDNET_API extern "C" __attribute__((visibility("default")))

namespace lednet {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : a * v;
}

inline unsigned ceil_div(long long a, long long b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

// Up to four dilation rates, passed to a kernel by value.
struct Rates {
  int r[4];
};

}  // namespace lednet
