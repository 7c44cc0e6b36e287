// Kernel B: both LED-Net stem convs in one launch, each 3x3 / stride 2 /
// pad 1 with the eval BatchNorm folded, fused bias and ReLU:
//   x1 = relu(conv_s2(x, w1) + b1)    (3 -> C, the 1/2-scale map)
//   x2 = relu(conv_s2(x1, w2) + b2)   (C -> C, the 1/4-scale map)
// x is the normalized image (bfloat16 or float32); x1 and x2 are float32.
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/stem_conv.py:57
// (stem_convs_packed), which runs both convs on a space-to-depth packed input
// so that the 3- and 32-channel contractions fill the 128-lane MXU, and keeps
// h in VMEM for stem_conv2 while it writes it out (:41-47).
//
// Bound on the H100: bytes.  At the flagship's 1 x 3 x 1024 x 1024 bf16 input
// the op must read 6.3 MB and write x1 (33.5 MB) and x2 (8.4 MB): 48.2 MB /
// 3.35 TB/s = 0.0144 ms, above its operations in 3xTF32 (0.0092 ms).
//
// Design: 8 x 16 tiles of x2, walked by one persistent CTA per SM, which
// stages both convs' weight fragments once (cp.async).  Per tile:
// - the image rows the tile needs (35 x 67 pixels, 3 channels) arrive by
//   cp.async into one of two buffers while the previous tile computes: a
//   bfloat16 image in 16-byte spans, kept as column pairs (read as such by
//   stem_conv1's stride-2 taps), a float32 one with its even and odd columns
//   apart (so that those reads are unit-stride).  A bfloat16 image whose
//   rows are not 16-byte aligned (width not a multiple of 8) is staged
//   element by element, at the start of each tile;
// - stem_conv1 computes the 17 x 33 region of x1 that the tile's stem_conv2
//   reads (10% recompute at the tile edges) on the tensor cores: K = 27
//   taps x channels padded to 32, two TF32 products for a bf16 input (exact
//   in TF32, so its lo part is zero), three for float32.  The region stays
//   in shared memory (zero outside x1: conv2's padding) with even and odd
//   columns apart; the tile's own 16 x 32 x1 pixels go out as 16-byte
//   stores, a share after each of stem_conv2's chunks;
// - stem_conv2 runs the stride-2 3xTF32 core (conv3x3_core.cuh) from there
//   and writes x2.  x1 is never read back from device memory.
#include "conv3x3_core.cuh"

namespace lednet {

template <typename Tin, int C>
struct Stem {
  static constexpr bool BF16 = sizeof(Tin) == 2;
  static constexpr int NT = C / 8, CH = C / 8;
  static constexpr int CIN = 3, KS1 = 4;                // K1 = 27, padded to 32
  static constexpr int TH = 8, TW = 16;                 // x2 tile
  static constexpr int XH = 2 * TH + 1, XW = 2 * TW + 1;  // x1 region
  static constexpr int XHALF = TW + 1, XRW = 2 * XHALF;   // even | odd columns
  static constexpr int XCS = pad_cs(XH * XRW);
  // image region: IH x IW pixels from row 4*oy0 - 3, column 4*ox0 - 3; a
  // row is IRW 32-bit words: bf16 column pairs from the 16-byte aligned
  // column 4*ox0 - 8 (the region starts 5 columns in), or float32 even
  // columns | odd columns (IHALF each)
  static constexpr int IH = 2 * XH + 1, IW = 2 * XW + 1;
  static constexpr int IHALF = (IW + 1) / 2;
  static constexpr int IRW = BF16 ? (IW + 5 + 7) / 8 * 4 : 2 * IHALF;
  static constexpr int ICS = IH * IRW, IMG = CIN * ICS;  // words
  static constexpr int W1F = KS1 * NT * 32;      // float4 of conv1's fragments
  static constexpr int W2F = CH * chunk_frags(C);
  static_assert(TH * TW == 16 * 8, "stem_conv2: one m-tile per warp");
  static_assert(IRW % 4 == 0 && ICS % 4 == 0, "16-byte image rows");
  static constexpr int smem_bytes() {
    return (W2F + W1F) * 16 + (C * XCS + 2 * IMG + 2 * C) * 4;
  }
};

// Stage one tile's image region into buffer `img` (zero outside the image).
// async: cp.async copies (16-byte spans of a bf16 row, 4-byte floats of a
// float32 one); else plain loads and stores, for a bf16 image whose rows
// are not 16-byte aligned (W % 8 != 0).
template <typename Tin, int C>
__device__ __forceinline__ void stage_image(const Tin* __restrict__ xb,
                                            int H, int W, int oy0, int ox0,
                                            uint32_t* img, int tid,
                                            bool async) {
  using K = Stem<Tin, C>;
  const int r0 = 4 * oy0 - 3, c0 = 4 * ox0 - 3;
  if constexpr (K::BF16) {
    if (async) {        // 8 columns per copy from column c0 - 5
      for (int e = tid; e < K::IMG / 4; e += kConvThreads) {
        const int c = e / (K::ICS / 4), rv = e % (K::ICS / 4);
        const int gy = r0 + rv / (K::IRW / 4);
        const int gx = c0 - 5 + 8 * (rv % (K::IRW / 4));
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        cp_async_f32x4(reinterpret_cast<float*>(img + 4 * e),
                       reinterpret_cast<const float*>(
                           ok ? xb + (static_cast<size_t>(c) * H + gy) * W + gx
                              : xb),
                       ok);
      }
    } else {
      uint16_t* h = reinterpret_cast<uint16_t*>(img);
      for (int e = tid; e < K::CIN * K::IH * K::IW; e += kConvThreads) {
        const int c = e / (K::IH * K::IW), rc = e % (K::IH * K::IW);
        const int r = rc / K::IW, col = rc % K::IW;
        const int gy = r0 + r, gx = c0 + col;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        // column col sits in word (col + 5) / 2, half (col + 5) & 1
        h[2 * (c * K::ICS + r * K::IRW) + col + 5] =
            ok ? reinterpret_cast<const uint16_t*>(
                     xb)[(static_cast<size_t>(c) * H + gy) * W + gx]
               : 0;
      }
    }
  } else {
    for (int e = tid; e < K::CIN * K::IH * K::IW; e += kConvThreads) {
      const int c = e / (K::IH * K::IW), rc = e % (K::IH * K::IW);
      const int r = rc / K::IW, col = rc % K::IW;
      const int gy = r0 + r, gx = c0 + col;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async_f32(reinterpret_cast<float*>(img) + c * K::ICS + r * K::IRW +
                       (col & 1) * K::IHALF + (col >> 1),
                   reinterpret_cast<const float*>(xb) +
                       (ok ? (static_cast<size_t>(c) * H + gy) * W + gx : 0),
                   ok);
    }
  }
}

// Persistent: CTA i walks tiles i, i + gridDim.x, ... of all B images.
template <typename Tin, int C>
__global__ void __launch_bounds__(kConvThreads, 1)
stem_fused_kernel(const Tin* __restrict__ x, const float4* __restrict__ w1f,
                  const float* __restrict__ b1,
                  const float4* __restrict__ w2f,
                  const float* __restrict__ b2, float* __restrict__ x1,
                  float* __restrict__ x2, int H, int W, int H1, int W1,
                  int B, int H2, int W2, int tiles_x, int tiles_y) {
  using K = Stem<Tin, C>;
  constexpr int NT = K::NT;
  constexpr int NPROD1 = K::BF16 ? 2 : 3;
  constexpr int NPIX1 = K::XH * K::XW, NM1 = (NPIX1 + 15) / 16;
  constexpr int MT1 = (NM1 + 7) / 8;   // conv1 m-tiles per warp (all run)
  extern __shared__ float4 smem4[];
  float4* w2s = smem4;
  float4* w1s = w2s + K::W2F;
  float* xs = reinterpret_cast<float*>(w1s + K::W1F);
  uint32_t* imgs = reinterpret_cast<uint32_t*>(xs + C * K::XCS);  // 2 buffers
  float* bias = reinterpret_cast<float*>(imgs + 2 * K::IMG);       // b1 | b2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  const int per_image = tiles_x * tiles_y;
  const int ntiles = per_image * B;
  const size_t plane1 = static_cast<size_t>(H1) * W1;
  const size_t plane2 = static_cast<size_t>(H2) * W2;
  const bool async = !K::BF16 || (W & 7) == 0;
  auto image_of = [&](int tl) {
    return x + static_cast<size_t>(tl / per_image) * K::CIN * H * W;
  };
  auto oy_of = [&](int tl) { return (tl % per_image) / tiles_x * K::TH; };
  auto ox_of = [&](int tl) { return tl % tiles_x * K::TW; };

  stage_frags(w1s, w1f, K::W1F, tid);
  stage_frags(w2s, w2f, K::W2F, tid);
  for (int i = tid; i < C; i += kConvThreads) {
    cp_async_f32(bias + i, b1 + i, true);
    cp_async_f32(bias + C + i, b2 + i, true);
  }
  if (async && blockIdx.x < ntiles)
    stage_image<Tin, C>(image_of(blockIdx.x), H, W, oy_of(blockIdx.x),
                        ox_of(blockIdx.x), imgs, tid, true);
  cp_async_commit();

  // per-lane constants: conv1's word offsets of k = cin * 9 + tap and, for
  // bf16, which half of the word k reads;
  // conv2's pixel offsets in the x1 region
  int koff[K::KS1][2], ksh[K::KS1][2];
#pragma unroll
  for (int ks = 0; ks < K::KS1; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // k >= 27 has zero weights; it reads k = 0's element, which is
      // staged (a stale, possibly non-finite word would give 0 * NaN)
      const int k = 8 * ks + t + 4 * h < 27 ? 8 * ks + t + 4 * h : 0;
      const int tap = k % 9, ky = tap / 3, kx = tap % 3;
      koff[ks][h] = (k / 9) * K::ICS + ky * K::IRW +
                    (K::BF16 ? (kx + 5) >> 1 : (kx & 1) * K::IHALF + (kx >> 1));
      ksh[ks][h] = ((kx + 5) & 1) ? 0 : 16;   // high half : low half
    }
  int poff2[1][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = warp * 16 + g8 + 8 * h;
    poff2[0][h] = 2 * (p / K::TW) * K::XRW + p % K::TW;
  }

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int b = tile / per_image, oy0 = oy_of(tile), ox0 = ox_of(tile);
    const uint32_t* img = imgs + buf * K::IMG;
    if (!async)
      stage_image<Tin, C>(image_of(tile), H, W, oy0, ox0, imgs + buf * K::IMG,
                          tid, false);
    cp_async_wait<0>();
    __syncthreads();
    // the next tile's image arrives while this one computes
    const int next = tile + gridDim.x;
    if (async && next < ntiles) {
      stage_image<Tin, C>(image_of(next), H, W, oy_of(next), ox_of(next),
                          imgs + (buf ^ 1) * K::IMG, tid, true);
      cp_async_commit();
    }

    // stem_conv1 over the x1 region (rows 2*oy0 - 1 .., columns 2*ox0 - 1
    // ..), zero outside x1; warp w takes m-tiles w, w + 8, ...
    {
      int po[MT1][2];
#pragma unroll
      for (int m = 0; m < MT1; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int p = (warp + 8 * m) * 16 + g8 + 8 * h;
          p = p < NPIX1 ? p : 0;
          po[m][h] = 2 * (p / K::XW) * K::IRW + p % K::XW;
        }
      float acc[MT1][NT][4];
      zero_acc(acc);
#pragma unroll
      for (int ks = 0; ks < K::KS1; ++ks) {
        uint32_t bh[NT][2], bl[NT][2];
        load_b<NT>(w1s + ks * NT * 32 + lane, bh, bl);
#pragma unroll
        for (int m = 0; m < MT1; ++m) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t w = img[po[m][i & 1] + koff[ks][i >> 1]];
            a[i] = K::BF16 ? __uint_as_float((w << ksh[ks][i >> 1]) &
                                             0xffff0000u)
                           : __uint_as_float(w);
          }
          mma_3xtf32<NT, NPROD1>(acc[m], a, bh, bl);
        }
      }
#pragma unroll
      for (int m = 0; m < MT1; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (warp + 8 * m) * 16 + g8 + 8 * h;
          if (p >= NPIX1) continue;
          const int py = p / K::XW, px = p % K::XW;
          const int gy = 2 * oy0 - 1 + py, gx = 2 * ox0 - 1 + px;
          const bool inside = gy >= 0 && gy < H1 && gx >= 0 && gx < W1;
          float* xsp = xs + py * K::XRW + (px & 1) * K::XHALF + (px >> 1);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int co = n * 8 + 2 * t + j;
              xsp[co * K::XCS] =
                  inside ? fmaxf(acc[m][n][2 * h + j] + bias[co], 0.f)
                         : 0.f;
            }
        }
      }
    }
    __syncthreads();

    // the tile's own x1 pixels (region rows and columns 1 .. 2T), four
    // columns per thread, as 16-byte stores where the row allows it; a
    // share of them after each of stem_conv2's chunks, so that they drain
    // while the MMAs run
    float* x1b = x1 + static_cast<size_t>(b) * C * plane1;
    constexpr int Q = K::TW / 2;                 // float4 per own row
    constexpr int NV = C * 2 * K::TH * Q / kConvThreads;
    static_assert(NV * kConvThreads == C * 2 * K::TH * Q && NV % K::CH == 0,
                  "whole rounds");
    const bool vec = (W1 & 3) == 0;
    auto store_x1 = [&](int part) {
#pragma unroll
      for (int kk = 0; kk < NV / K::CH; ++kk) {
        const int i = tid + (part * (NV / K::CH) + kk) * kConvThreads;
        const int q = i % Q, py = 1 + (i / Q) % (2 * K::TH);
        const int co = i / (Q * 2 * K::TH);
        const int gy = 2 * oy0 - 1 + py, gx = 2 * ox0 + 4 * q;
        if (gy >= H1 || gx >= W1) continue;
        // columns px = 4q + 1 (odd), 4q + 2 (even), 4q + 3, 4q + 4
        const float* r = xs + co * K::XCS + py * K::XRW;
        const float4 val = make_float4(r[K::XHALF + 2 * q], r[2 * q + 1],
                                       r[K::XHALF + 2 * q + 1], r[2 * q + 2]);
        float* dst = x1b + co * plane1 + static_cast<size_t>(gy) * W1 + gx;
        if (vec && gx + 3 < W1) {
          *reinterpret_cast<float4*>(dst) = val;
        } else {
          const float e4[4] = {val.x, val.y, val.z, val.w};
          for (int u = 0; u < 4 && gx + u < W1; ++u) dst[u] = e4[u];
        }
      }
    };

    // stem_conv2 (stride 2) from the x1 region to the tile of x2
    {
      float acc[1][NT][4];
      zero_acc(acc);
#pragma unroll 1
      for (int q = 0; q < K::CH; ++q) {
        conv_chunk<NT, 1, 3>(acc, xs + 8 * q * K::XCS, K::XCS, poff2,
                             K::XRW, K::XHALF, 1, w2s + q * chunk_frags(C),
                             lane);
        store_x1(q);
      }
      float* x2b = x2 + static_cast<size_t>(b) * C * plane2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = warp * 16 + g8 + 8 * h;
        const int gy = oy0 + p / K::TW, gx = ox0 + p % K::TW;
        if (gy >= H2 || gx >= W2) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            x2b[(n * 8 + 2 * t + j) * plane2 + static_cast<size_t>(gy) * W2 +
                gx] = fmaxf(acc[0][n][2 * h + j] + bias[C + n * 8 + 2 * t + j],
                            0.f);
      }
    }
    __syncthreads();
  }
}

template <typename Tin, int C>
int launch_stem(const void* x, const void* w1f, const float* b1,
                const void* w2f, const float* b2, float* x1, float* x2, int B,
                int H, int W, int th, int tw, int smem, int ctas,
                cudaStream_t stream) {
  using K = Stem<Tin, C>;
  if (th != K::TH || tw != K::TW || smem != K::smem_bytes() || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = stem_fused_kernel<Tin, C>;
  static unsigned smem_set = 0;
  cudaError_t e = allow_smem(kernel, smem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
  const int H2 = (H1 + 1) / 2, W2 = (W1 + 1) / 2;
  const int tiles_x = ceil_div(W2, K::TW), tiles_y = ceil_div(H2, K::TH);
  kernel<<<ctas, kConvThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float4*>(w1f), b1,
      static_cast<const float4*>(w2f), b2, x1, x2, H, W, H1, W1, B, H2, W2,
      tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lednet

// Both stem convs of a (B, 3, H, W) image (bf16 if in_bf16, else float32)
// in one launch of `ctas` persistent CTAs.  w1f / w2f: B fragments
// (conv3x3.py::conv1_fragments and conv_fragments); th, tw and smem are the
// Python geometry (conv3x3.py::stem_config), refused if they differ from
// the compiled one.
LEDNET_API int lednet_stem_fused(const void* x, const void* w1f,
                                 const float* b1, const void* w2f,
                                 const float* b2, float* x1, float* x2, int B,
                                 int Cin, int C, int H, int W, int in_bf16,
                                 int th, int tw, int smem, int ctas,
                                 cudaStream_t stream) {
  using namespace lednet;
  if (Cin != 3) return static_cast<int>(cudaErrorInvalidValue);
#define LEDNET_STEM(CC)                                                      \
  if (C == CC)                                                               \
    return in_bf16 ? launch_stem<__nv_bfloat16, CC>(x, w1f, b1, w2f, b2, x1, \
                                                    x2, B, H, W, th, tw,     \
                                                    smem, ctas, stream)      \
                   : launch_stem<float, CC>(x, w1f, b1, w2f, b2, x1, x2, B,  \
                                            H, W, th, tw, smem, ctas,        \
                                            stream);
  LEDNET_STEM(32)
  LEDNET_STEM(16)
#undef LEDNET_STEM
  return static_cast<int>(cudaErrorInvalidValue);
}
