// Kernel D: one eval-mode SESP block (LED-Net's core primitive) in three
// launches:
//   1. reduce:  red = prelu(Wred @ x + bred, a1)           (dense-grouped 1x1,
//               BatchNorm folded)
//   2. pyramid: k dilated 3x3 depthwise branches over red with the
//               hierarchical-feature-fusion prefix sum b_g += b_{g-1},
//               stride 1 or 2, written as the channel concat (k*n channels)
//   3. merge:   the optional v2 depthwise stage at rates d+1 on the
//               pyramid's map, BatchNorm + PReLU, the dense (C, C) 1x1
//               expand (BatchNorm folded) and the tail:
//               'residual' prelu(z + x, a3) / 'act' prelu(z, a3) / 'plain' z.
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/sesp_pyramid.py:207
// (sesp_block), which holds a whole block in VMEM, merges the k branches'
// taps into lane rows and does the prefix sum with lane rolls.  Those are
// 128-lane TPU layout tricks; here a thread walks the k branches of one
// channel in order, so the prefix sum is a running sum in a register.  The
// two 1x1 products are computed in the kernel bodies.  The pyramid stage is
// also the port's base for sesp_pyramid (:79), which no model calls.
//
// Bound: bytes at LED-Net's widths (the 1x1 products do at most 2*C flops
// per byte moved).  Fusing the three launches, which would keep red and the
// pyramid map out of device memory, is later work.
#include "common.cuh"

namespace lednet {

constexpr int kReduceThreads = 128, kReduceOt = 16, kReduceChunk = 128;

// grid: (ceil(HW / 128), ceil(n / OT), B); one thread per pixel, OT output
// channels in registers; weight chunks in shared memory (broadcast reads).
__global__ void __launch_bounds__(kReduceThreads)
sesp_reduce_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ alpha, float* __restrict__ out,
                   int Cin, int HW, int n) {
  __shared__ float ws[kReduceOt][kReduceChunk];
  const int b = blockIdx.z, o0 = blockIdx.y * kReduceOt;
  const int p = blockIdx.x * kReduceThreads + threadIdx.x;
  const float* xb = x + static_cast<size_t>(b) * Cin * HW;
  float acc[kReduceOt];
#pragma unroll
  for (int j = 0; j < kReduceOt; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < Cin; c0 += kReduceChunk) {
    const int cn = min(kReduceChunk, Cin - c0);
    for (int i = threadIdx.x; i < kReduceOt * kReduceChunk;
         i += kReduceThreads) {
      const int j = i / kReduceChunk, cc = i % kReduceChunk;
      ws[j][cc] = (o0 + j < n && cc < cn)
                      ? w[static_cast<size_t>(o0 + j) * Cin + c0 + cc]
                      : 0.f;
    }
    __syncthreads();
    if (p < HW) {
      for (int cc = 0; cc < cn; ++cc) {
        const float v = xb[static_cast<size_t>(c0 + cc) * HW + p];
#pragma unroll
        for (int j = 0; j < kReduceOt; ++j) acc[j] = fmaf(ws[j][cc], v, acc[j]);
      }
    }
    __syncthreads();
  }
  if (p >= HW) return;
#pragma unroll
  for (int j = 0; j < kReduceOt; ++j) {
    const int o = o0 + j;
    if (o < n)
      out[(static_cast<size_t>(b) * n + o) * HW + p] =
          prelu(acc[j] + bias[o], alpha[o]);
  }
}

// grid: (ceil(H2*W2 / 256), n, B); one thread per output pixel of one
// channel j, walking the k branches in order (running HFF sum).
__global__ void __launch_bounds__(256)
sesp_pyramid_kernel(const float* __restrict__ red, const float* __restrict__ dw,
                    float* __restrict__ out, int n, int H, int W, int H2,
                    int W2, int k, Rates rates, int stride) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= H2 * W2) return;
  const int j = blockIdx.y, b = blockIdx.z;
  const int oh = q / W2, ow = q % W2;
  const float* r = red + (static_cast<size_t>(b) * n + j) * H * W;
  float acc = 0.f;
  for (int g = 0; g < k; ++g) {
    const int d = rates.r[g];
    const float* wk = dw + (static_cast<size_t>(g) * n + j) * 9;
    float s = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int ih = oh * stride + (ky - 1) * d;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int iw = ow * stride + (kx - 1) * d;
        if (iw < 0 || iw >= W) continue;
        s = fmaf(r[ih * W + iw], wk[ky * 3 + kx], s);
      }
    }
    acc = (g == 0) ? s : acc + s;
    out[((static_cast<size_t>(b) * k + g) * n + j) * H2 * W2 + q] = acc;
  }
}

constexpr int kMergePix = 32, kMergeThreads = 256;

// grid: (ceil(HW / 32), B); dynamic shared memory y[C][32].  Phase 1 builds
// y = prelu(bn(v2(pyr))) for the block's 32 pixels and every channel; phase 2
// computes the expand z[o] = sum_c Wexp[o][c] y[c] (a warp shares o, so the
// weight reads are broadcasts) and the tail.
__global__ void __launch_bounds__(kMergeThreads)
sesp_merge_kernel(const float* __restrict__ pyr, const float* __restrict__ dw2,
                  const float* __restrict__ s2, const float* __restrict__ b2,
                  const float* __restrict__ a2,
                  const float* __restrict__ wexp,
                  const float* __restrict__ bexp,
                  const float* __restrict__ a3, const float* __restrict__ res,
                  float* __restrict__ out, int C, int n, int H, int W,
                  Rates rates, int tail) {
  extern __shared__ float y[];  // [C][kMergePix]
  const int HW = H * W;
  const int p0 = blockIdx.x * kMergePix, b = blockIdx.y;
  const float* pb = pyr + static_cast<size_t>(b) * C * HW;
  for (int i = threadIdx.x; i < C * kMergePix; i += kMergeThreads) {
    const int c = i / kMergePix, q = p0 + i % kMergePix;
    float v = 0.f;
    if (q < HW) {
      const float* src = pb + static_cast<size_t>(c) * HW;
      if (dw2 != nullptr) {
        const int d = rates.r[c / n] + 1, oh = q / W, ow = q % W;
        const float* wk = dw2 + static_cast<size_t>(c) * 9;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int ih = oh + (ky - 1) * d;
          if (ih < 0 || ih >= H) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int iw = ow + (kx - 1) * d;
            if (iw < 0 || iw >= W) continue;
            v = fmaf(src[ih * W + iw], wk[ky * 3 + kx], v);
          }
        }
      } else {
        v = src[q];
      }
      v = prelu(v * s2[c] + b2[c], a2[c]);
    }
    y[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * kMergePix; i += kMergeThreads) {
    const int o = i / kMergePix, pp = i % kMergePix, q = p0 + pp;
    if (q >= HW) continue;
    const float* wr = wexp + static_cast<size_t>(o) * C;
    float z = 0.f;
    for (int c = 0; c < C; ++c) z = fmaf(wr[c], y[c * kMergePix + pp], z);
    z += bexp[o];
    const size_t idx = (static_cast<size_t>(b) * C + o) * HW + q;
    if (tail == 2) z += res[idx];
    if (tail >= 1) z = prelu(z, a3[o]);
    out[idx] = z;
  }
}

inline Rates make_rates(int r0, int r1, int r2, int r3) {
  Rates r;
  r.r[0] = r0;
  r.r[1] = r1;
  r.r[2] = r2;
  r.r[3] = r3;
  return r;
}

}  // namespace lednet

LEDNET_API int lednet_sesp_reduce(const float* x, const float* w,
                                  const float* bias, const float* alpha,
                                  float* out, int B, int Cin, int HW, int n,
                                  cudaStream_t stream) {
  using namespace lednet;
  dim3 grid(ceil_div(HW, kReduceThreads), ceil_div(n, kReduceOt), B);
  sesp_reduce_kernel<<<grid, kReduceThreads, 0, stream>>>(x, w, bias, alpha,
                                                          out, Cin, HW, n);
  return static_cast<int>(cudaGetLastError());
}

LEDNET_API int lednet_sesp_pyramid(const float* red, const float* dw,
                                   float* out, int B, int n, int H, int W,
                                   int k, int r0, int r1, int r2, int r3,
                                   int stride, cudaStream_t stream) {
  using namespace lednet;
  const int H2 = (H + stride - 1) / stride, W2 = (W + stride - 1) / stride;
  dim3 grid(ceil_div(static_cast<long long>(H2) * W2, 256), n, B);
  sesp_pyramid_kernel<<<grid, 256, 0, stream>>>(
      red, dw, out, n, H, W, H2, W2, k, make_rates(r0, r1, r2, r3), stride);
  return static_cast<int>(cudaGetLastError());
}

LEDNET_API int lednet_sesp_merge(const float* pyr, const float* dw2,
                                 const float* s2, const float* b2,
                                 const float* a2, const float* wexp,
                                 const float* bexp, const float* a3,
                                 const float* res, float* out, int B, int C,
                                 int H, int W, int k, int r0, int r1, int r2,
                                 int r3, int tail, cudaStream_t stream) {
  using namespace lednet;
  const size_t smem = static_cast<size_t>(C) * kMergePix * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sesp_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(ceil_div(static_cast<long long>(H) * W, kMergePix), B);
  sesp_merge_kernel<<<grid, kMergeThreads, smem, stream>>>(
      pyr, dw2, s2, b2, a2, wexp, bexp, a3, res, out, C, C / k, H, W,
      make_rates(r0, r1, r2, r3), tail);
  return static_cast<int>(cudaGetLastError());
}
