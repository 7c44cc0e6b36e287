// Kernel A: input normalization for LED-Net inference.
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/s2d_input.py:80
// (normalize_s2d).  That kernel fuses (x - mean) / std, the bf16 cast and a
// 4x4 space-to-depth relayout, the last routed through one-hot MXU products
// because 128-lane TPU tiles cannot regroup 3-channel pixels.  Here the
// relayout that matters is NHWC -> NCHW: one pass reads the (B, H, W, 3) f32
// image, applies the BGR->RGB flip, normalizes with IEEE division (the file
// is compiled without --use_fast_math), rounds to the output type with
// round-to-nearest-even and writes the (B, 3, H, W) map the stem kernel
// reads.  Bit-exact against its plain version.
//
// Bound: bytes (12 B read and 6 or 12 B written per pixel, 2 flops per
// element); one thread per pixel, stores coalesced along W.
#include "common.cuh"

namespace lednet {

template <typename Tout>
__global__ void normalize_kernel(const float* __restrict__ x,
                                 Tout* __restrict__ out, long long hw,
                                 long long total, float m0, float m1,
                                 float m2, float s0, float s1, float s2,
                                 int flip) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  long long b = i / hw, p = i - b * hw;
  const float* px = x + i * 3;
  float v0 = px[0], v1 = px[1], v2 = px[2];
  if (flip) {
    float t = v0;
    v0 = v2;
    v2 = t;
  }
  Tout* o = out + b * 3 * hw + p;
  o[0] = from_float<Tout>((v0 - m0) / s0);
  o[hw] = from_float<Tout>((v1 - m1) / s1);
  o[2 * hw] = from_float<Tout>((v2 - m2) / s2);
}

}  // namespace lednet

LEDNET_API int lednet_normalize_image(const float* x, void* out, int B, int H,
                                      int W, float m0, float m1, float m2,
                                      float s0, float s1, float s2, int flip,
                                      int out_bf16, cudaStream_t stream) {
  using namespace lednet;
  long long hw = static_cast<long long>(H) * W;
  long long total = hw * B;
  const int threads = 256;
  unsigned blocks = ceil_div(total, threads);
  if (out_bf16) {
    normalize_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        x, static_cast<__nv_bfloat16*>(out), hw, total, m0, m1, m2, s0, s1,
        s2, flip);
  } else {
    normalize_kernel<float><<<blocks, threads, 0, stream>>>(
        x, static_cast<float*>(out), hw, total, m0, m1, m2, s0, s1, s2, flip);
  }
  return static_cast<int>(cudaGetLastError());
}
