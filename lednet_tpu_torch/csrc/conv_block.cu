// Kernel C: the stem's two BasicBlocks and trailing ReLU at 1/4 scale, four
// 3x3 / stride 1 / pad 1 convs at C = 32 (or 16) with the eval BatchNorm
// folded, fused bias, two residuals and ReLU:
//   h = relu(conv0(x) + b0);  b1 = relu(conv1(h) + b1 + x)
//   h = relu(conv2(b1) + b2); out = relu(conv3(h) + b3 + b1)
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/conv_block.py:73
// (basic_pair_packed, through basic_pair :126), which packs four pixels into
// 128 lanes so that the 32-channel convs fill the MXU and keeps the whole
// chain in VMEM (_pair_kernel :48-70).
//
// Bound on the H100: operations.  At the flagship's 1 x 32 x 256 x 256 the
// four convs are 4.83 GFLOP; in 3xTF32 that is three TF32 products each,
// 14.5 GFLOP / 495 TFLOP/s = 0.029 ms, against 0.005 ms of bytes (x, out).
//
// Design: one launch per BasicBlock (two per op), on 16 x 32 output tiles
// (one wave of 128 CTAs at the flagship's 256 x 256), through the 3xTF32
// tensor-core core of conv3x3_core.cuh.  The block's input x with a
// 2-pixel halo is staged with cp.async (16-byte copies of aligned row spans
// where the width allows); the first conv computes h over the tile grown
// by one pixel and keeps it in shared memory (zero outside the image: the
// second conv's padding); the second conv adds the residual x from shared
// memory and writes the tile.  The block's weights stream through a ring
// of two chunk slots (one chunk = 8 input channels x 9 taps of B
// fragments), each refilled by cp.async as soon as every warp is done with
// it, so the next chunk's loads overlap this chunk's MMAs.
//
// Measured alternatives (PERF.md section 6): four launches of one conv each
// (no recompute, two CTAs per SM) and one launch of all four convs (43%
// recompute on 16 x 16 tiles) were both slower on the flagship.
#include "conv3x3_core.cuh"

namespace lednet {

template <int C>
struct Block {
  static constexpr int NT = C / 8, CH = C / 8;
  static constexpr int TH = 16, TW = 32;             // output tile
  static constexpr int S = 2;                        // weight ring slots
  // input region of stage s (0: x, 1: h): the tile with a (2 - s)-pixel halo
  __host__ __device__ static constexpr int in_h(int s) { return TH + 2 * (2 - s); }
  __host__ __device__ static constexpr int in_w(int s) { return TW + 2 * (2 - s); }
  // its rows in shared memory: x's start at the 16-byte aligned column
  // ow0 - 4 and span whole float4s, the region starting coff(0) = 2
  // columns in; h's hold just the region
  __host__ __device__ static constexpr int rw(int s) {
    return s == 0 ? (TW + 6 + 3) / 4 * 4 : in_w(s);
  }
  __host__ __device__ static constexpr int coff(int s) { return s == 0 ? 2 : 0; }
  __host__ __device__ static constexpr int cs(int s) { return pad_cs(in_h(s) * rw(s)); }
  __host__ __device__ static constexpr int off(int s) { return s == 0 ? 0 : C * cs(0); }
  static constexpr int smem_bytes() {
    return S * chunk_frags(C) * 16 + C * (cs(0) + cs(1)) * 4;
  }
};

template <int C>
struct BlockCtx {
  float4* ring;
  float* bufs;
  const float* xb;
  float* outb;
  const float4* wf;
  const float* bias;
  int H, W, oh0, ow0, conv0, tid, lane, warp;
  size_t plane;

  // cp.async group g: weight chunk g of the block into slot g % S and, for
  // its first conv, input chunk g of the tile with its 2-pixel halo: as
  // float4s when rows are 16-byte aligned (W % 4 == 0), else as floats.
  __device__ __forceinline__ void issue(int g) const {
    using K = Block<C>;
    constexpr int RW = K::rw(0), A0 = K::in_h(0) * RW;
    if (g < 2 * K::CH) {
      const int i = conv0 + g / K::CH, q = g % K::CH;
      stage_frags(ring + (g % K::S) * chunk_frags(C),
                  wf + (static_cast<size_t>(i) * K::CH + q) * chunk_frags(C),
                  chunk_frags(C), tid);
      if (g < K::CH) {
        const int gx0 = ow0 - 4;
        if ((W & 3) == 0) {
          for (int e = tid; e < 8 * A0 / 4; e += kConvThreads) {
            const int c = 8 * q + e / (A0 / 4), rv = e % (A0 / 4);
            const int r = rv / (RW / 4), gx = gx0 + 4 * (rv % (RW / 4));
            const int gy = oh0 - 2 + r;
            const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
            cp_async_f32x4(
                bufs + c * K::cs(0) + 4 * rv,
                ok ? xb + c * plane + static_cast<size_t>(gy) * W + gx : xb,
                ok);
          }
        } else {
          for (int e = tid; e < 8 * A0; e += kConvThreads) {
            const int c = 8 * q + e / A0, rc = e % A0;
            const int gy = oh0 - 2 + rc / RW, gx = gx0 + rc % RW;
            const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
            cp_async_f32(
                bufs + c * K::cs(0) + rc,
                ok ? xb + c * plane + static_cast<size_t>(gy) * W + gx : xb,
                ok);
          }
        }
      }
    }
    cp_async_commit();
  }
};

// Stage s of the block: conv (conv0 + s) from buffer s; stage 0 writes h to
// buffer 1, stage 1 adds the residual x (buffer 0) and writes the output.
template <int C, int s>
__device__ __forceinline__ void block_stage(const BlockCtx<C>& x) {
  using K = Block<C>;
  constexpr int NT = K::NT;
  constexpr int OW = K::in_w(s) - 2, OH = K::in_h(s) - 2;
  constexpr int RW = K::rw(s), CO = K::coff(s);      // input row layout
  // 16-pixel m-tiles of this stage's output, warp w taking w, w + 8, ...
  constexpr int NPIX = OH * OW, MT = (NPIX + 16 * 8 - 1) / (16 * 8);
  const int g8 = x.lane >> 2, t = x.lane & 3;

  int poff[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = (x.warp + 8 * m) * 16 + g8 + 8 * h;
      p = p < NPIX ? p : 0;
      poff[m][h] = (p / OW) * RW + p % OW + CO;
    }

  float acc[MT][NT][4];
  zero_acc(acc);
  const float* in = x.bufs + K::off(s);
#pragma unroll 1
  for (int q = 0; q < K::CH; ++q) {
    const int g = s * K::CH + q;
    cp_async_wait<K::S - 1>();
    __syncthreads();
    conv_chunk<NT, MT, 3>(acc, in + 8 * q * K::cs(s), K::cs(s), poff, RW, 1,
                          2, x.ring + (g % K::S) * chunk_frags(C), x.lane);
    __syncthreads();
    x.issue(g + K::S);
  }

  // epilogue: bias, the residual x (second conv), ReLU
  const int i = x.conv0 + s, r = 1 - s;
  float bv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[n][j] = __ldg(x.bias + i * C + n * 8 + 2 * t + j);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (x.warp + 8 * m) * 16 + g8 + 8 * h;
      if (p >= NPIX) continue;
      const int py = p / OW, px = p % OW;
      const int gy = x.oh0 - r + py, gx = x.ow0 - r + px;
      const bool inside = gy >= 0 && gy < x.H && gx >= 0 && gx < x.W;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = n * 8 + 2 * t + j;
          float v = acc[m][n][2 * h + j] + bv[n][j];
          if constexpr (s == 0) {
            x.bufs[K::off(1) + co * K::cs(1) + p] = inside ? fmaxf(v, 0.f) : 0.f;
          } else if (inside) {
            v += x.bufs[co * K::cs(0) + (py + 2) * K::rw(0) + px + 2 + K::coff(0)];
            x.outb[co * x.plane + static_cast<size_t>(gy) * x.W + gx] =
                fmaxf(v, 0.f);
          }
        }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kConvThreads, 1)
basic_block_kernel(const float* __restrict__ x, const float4* __restrict__ wf,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int conv0) {
  using K = Block<C>;
  extern __shared__ float4 smem4[];
  BlockCtx<C> ctx;
  ctx.ring = smem4;
  ctx.bufs = reinterpret_cast<float*>(smem4 + K::S * chunk_frags(C));
  ctx.plane = static_cast<size_t>(H) * W;
  const size_t boff = static_cast<size_t>(blockIdx.z) * C * ctx.plane;
  ctx.xb = x + boff;
  ctx.outb = out + boff;
  ctx.wf = wf;
  ctx.bias = bias;
  ctx.H = H;
  ctx.W = W;
  ctx.oh0 = blockIdx.y * K::TH;
  ctx.ow0 = blockIdx.x * K::TW;
  ctx.conv0 = conv0;
  ctx.tid = threadIdx.x;
  ctx.lane = threadIdx.x & 31;
  ctx.warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < K::S; ++g) ctx.issue(g);
  block_stage<C, 0>(ctx);
  block_stage<C, 1>(ctx);
}

template <int C>
int launch_block(const float* x, const void* wf, const float* bias,
                 float* out, int B, int H, int W, int conv0, int th, int tw,
                 int smem, cudaStream_t stream) {
  using K = Block<C>;
  if (th != K::TH || tw != K::TW || smem != K::smem_bytes() ||
      (conv0 != 0 && conv0 != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = basic_block_kernel<C>;
  static unsigned smem_set = 0;
  cudaError_t e = allow_smem(kernel, smem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(W, K::TW), ceil_div(H, K::TH), B);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      x, static_cast<const float4*>(wf), bias, out, H, W, conv0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lednet

// One BasicBlock of the pair: convs conv0 and conv0 + 1 (conv0 = 0 or 2).
// wf: B fragments of all four convs (conv3x3.py::pair_fragments); bias
// (4, C).  th, tw and smem are the Python geometry
// (conv3x3.py::block_config); a mismatch with the compiled one is refused.
LEDNET_API int lednet_basic_block(const float* x, const void* wf,
                                  const float* bias, float* out, int B, int C,
                                  int H, int W, int conv0, int th, int tw,
                                  int smem, cudaStream_t stream) {
  using namespace lednet;
  if (C == 32)
    return launch_block<32>(x, wf, bias, out, B, H, W, conv0, th, tw, smem,
                            stream);
  if (C == 16)
    return launch_block<16>(x, wf, bias, out, B, H, W, conv0, th, tw, smem,
                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
