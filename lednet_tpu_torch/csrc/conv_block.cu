// Kernel C: a shared-memory-tiled 3x3 / stride 1 / pad 1 convolution at
// C = 32 with the eval BatchNorm folded in, fused bias, optional residual
// and ReLU:  out = relu(conv(x, w) + bias [+ res]).
// Four launches make the stem's two BasicBlocks and its trailing ReLU:
//   h = relu(conv(x) + b0); b1 = relu(conv(h) + b1 + x)
//   h = relu(conv(b1) + b2); out = relu(conv(h) + b3 + b1)
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/conv_block.py:73
// (basic_pair_packed, through basic_pair :126), which packs four pixels into
// 128 lanes so that the 32-channel convs fill the MXU and keeps all four
// convs in VMEM.  That packing exists for the TPU's lane width; here each
// conv is a direct convolution over tiles in shared memory, and the two
// intermediates go through device memory (fusing the four launches is later
// work).
//
// Bound: operations (2*9*32*32 f32 flops per pixel and conv against 256 B of
// traffic).  Design: a block computes 32 x 8 output pixels for COT = 32
// output channels (32 accumulators per thread); input channels are streamed
// through shared memory in chunks of 8 channels with a one-pixel halo
// (8 x 10 x 34 floats) together with the matching folded weights
// ([ci*9 + tap][COT], broadcast reads).
#include "common.cuh"

namespace lednet {

constexpr int kTileW = 32, kTileH = 8, kCot = 32, kChunk = 8;

__global__ void __launch_bounds__(kTileW * kTileH)
conv3x3_c32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ res, float* __restrict__ out,
                   int C, int H, int W, int cgroups) {
  __shared__ float tile[kChunk][kTileH + 2][kTileW + 2];
  __shared__ float ws[kChunk * 9][kCot];
  const int b = blockIdx.z / cgroups;
  const int co0 = (blockIdx.z % cgroups) * kCot;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int ow0 = blockIdx.x * kTileW, oh0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + static_cast<size_t>(b) * C * plane;
  constexpr int kTileElems = kChunk * (kTileH + 2) * (kTileW + 2);

  float acc[kCot];
#pragma unroll
  for (int j = 0; j < kCot; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    for (int i = tid; i < kTileElems; i += kTileW * kTileH) {
      const int cc = i / ((kTileH + 2) * (kTileW + 2));
      const int r = (i / (kTileW + 2)) % (kTileH + 2);
      const int col = i % (kTileW + 2);
      const int ci = c0 + cc, ih = oh0 + r - 1, iw = ow0 + col - 1;
      tile[cc][r][col] = (ci < C && ih >= 0 && ih < H && iw >= 0 && iw < W)
                             ? xb[ci * plane + static_cast<size_t>(ih) * W + iw]
                             : 0.f;
    }
    for (int i = tid; i < kChunk * 9 * kCot; i += kTileW * kTileH) {
      const int co = i % kCot, k = i / kCot;  // k = cc * 9 + tap
      const int ci = c0 + k / 9, cog = co0 + co;
      ws[k][co] = (ci < C && cog < C)
                      ? w[(static_cast<size_t>(cog) * C + ci) * 9 + k % 9]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kChunk; ++cc) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = tile[cc][ty + ky][tx + kx];
          const float* wk = ws[cc * 9 + ky * 3 + kx];
#pragma unroll
          for (int j = 0; j < kCot; ++j) acc[j] = fmaf(v, wk[j], acc[j]);
        }
      }
    }
    __syncthreads();
  }

  const int ow = ow0 + tx, oh = oh0 + ty;
  if (ow >= W || oh >= H) return;
  const size_t base = static_cast<size_t>(b) * C * plane +
                      static_cast<size_t>(oh) * W + ow;
#pragma unroll
  for (int j = 0; j < kCot; ++j) {
    const int co = co0 + j;
    if (co >= C) break;
    float v = acc[j] + bias[co];
    if (res != nullptr) v += res[base + co * plane];
    out[base + co * plane] = fmaxf(v, 0.f);
  }
}

}  // namespace lednet

LEDNET_API int lednet_conv3x3_c32(const float* x, const float* w,
                                  const float* bias, const float* res,
                                  float* out, int B, int C, int H, int W,
                                  cudaStream_t stream) {
  using namespace lednet;
  const int cgroups = (C + kCot - 1) / kCot;
  dim3 block(kTileW, kTileH);
  dim3 grid(ceil_div(W, kTileW), ceil_div(H, kTileH), B * cgroups);
  conv3x3_c32_kernel<<<grid, block, 0, stream>>>(x, w, bias, res, out, C, H,
                                                 W, cgroups);
  return static_cast<int>(cudaGetLastError());
}
