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

// cp.async copies global -> shared; an invalid source copies zeros.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
// 16 bytes; dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src,
                                               bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Let `kernel` use `smem` bytes of dynamic shared memory.  Done once per
// device (bit d of `done`, kept by the caller for one kernel whose launches
// all ask for the same amount).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

// Up to four dilation rates, passed to a kernel by value.
struct Rates {
  int r[4];
};

}  // namespace lednet
