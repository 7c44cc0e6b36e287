// Kernel B: a LED-Net stem conv, 3x3 / stride 2 / pad 1 with the eval
// BatchNorm folded into the weights, fused bias and ReLU.  Launched twice per
// forward: stem_conv1 (3 -> c, reading the normalized bf16 or f32 image) and
// stem_conv2 (c -> c).  Accumulates in f32 and writes f32.
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/stem_conv.py:57
// (stem_convs_packed), which runs both convs on a space-to-depth packed input
// so that the 3- and 32-channel contractions fill the 128-lane MXU.  On
// Hopper that packing buys nothing: this is a direct convolution.
//
// Bound: operations (f32 FMAs on the CUDA cores; the write of the 1/2-scale
// map is the largest byte term).  Design: one thread per output pixel and a
// tile of COT output channels held in registers; a block covers 32 x 8
// output pixels and one channel tile, whose folded weights sit in shared
// memory as [ci*9 + tap][COT] so that every weight read is a broadcast.  The
// input is read straight from global memory (L1/L2 keep the 3x3 halo).
#include "common.cuh"

namespace lednet {

constexpr int kStemCot = 16;

template <typename Tin, int COT>
__global__ void __launch_bounds__(256)
stem_conv3x3_s2_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int Cin, int H, int W, int Cout, int Ho, int Wo,
                       int cgroups) {
  extern __shared__ float ws[];  // [Cin * 9][COT]
  const int b = blockIdx.z / cgroups;
  const int co0 = (blockIdx.z % cgroups) * COT;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < Cin * 9 * COT; i += nthreads) {
    int co = i % COT, k = i / COT;  // k = ci * 9 + tap
    ws[i] = (co0 + co < Cout) ? w[static_cast<size_t>(co0 + co) * Cin * 9 + k]
                              : 0.f;
  }
  __syncthreads();
  const int ow = blockIdx.x * blockDim.x + threadIdx.x;
  const int oh = blockIdx.y * blockDim.y + threadIdx.y;
  if (ow >= Wo || oh >= Ho) return;

  float acc[COT];
#pragma unroll
  for (int j = 0; j < COT; ++j) acc[j] = 0.f;
  const Tin* xb = x + static_cast<size_t>(b) * Cin * H * W;
  for (int ci = 0; ci < Cin; ++ci) {
    const Tin* xc = xb + static_cast<size_t>(ci) * H * W;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int ih = 2 * oh + ky - 1;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int iw = 2 * ow + kx - 1;
        if (iw < 0 || iw >= W) continue;
        const float v = to_float(xc[static_cast<size_t>(ih) * W + iw]);
        const float* wk = ws + (ci * 9 + ky * 3 + kx) * COT;
#pragma unroll
        for (int j = 0; j < COT; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
      }
    }
  }
  const size_t plane = static_cast<size_t>(Ho) * Wo;
  float* ob = out + static_cast<size_t>(b) * Cout * plane +
              static_cast<size_t>(oh) * Wo + ow;
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    const int co = co0 + j;
    if (co < Cout) ob[co * plane] = fmaxf(acc[j] + bias[co], 0.f);
  }
}

template <typename Tin>
int launch_stem(const void* x, const float* w, const float* bias, float* out,
                int B, int Cin, int H, int W, int Cout, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int cgroups = (Cout + kStemCot - 1) / kStemCot;
  const size_t smem = static_cast<size_t>(Cin) * 9 * kStemCot * sizeof(float);
  auto kernel = stem_conv3x3_s2_kernel<Tin, kStemCot>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 block(32, 8);
  dim3 grid(ceil_div(Wo, 32), ceil_div(Ho, 8), B * cgroups);
  kernel<<<grid, block, smem, stream>>>(static_cast<const Tin*>(x), w, bias,
                                        out, Cin, H, W, Cout, Ho, Wo, cgroups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lednet

LEDNET_API int lednet_stem_conv3x3_s2(const void* x, const float* w,
                                      const float* bias, float* out, int B,
                                      int Cin, int H, int W, int Cout,
                                      int in_bf16, cudaStream_t stream) {
  using namespace lednet;
  if (in_bf16)
    return launch_stem<__nv_bfloat16>(x, w, bias, out, B, Cin, H, W, Cout,
                                      stream);
  return launch_stem<float>(x, w, bias, out, B, Cin, H, W, Cout, stream);
}
