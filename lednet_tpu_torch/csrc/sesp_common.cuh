// The SESP pyramid of one output tile in kernel D's fused launch
// (sesp_block.cu).  Kernel E (sesp_pyramid.cu) shared it until its Hopper
// redesign, which has a core of its own (persistent CTAs, a TMA ring,
// register strips); the TPU package shares _pyramid_body
// (lednet_tpu/ops/pallas/sesp_pyramid.py:135) between its two kernels.
//
// A CTA owns an output tile of th x tw pixels of the H2 x W2 map and walks a
// chunk of jc red channels at a time through shared memory:
//   R  the chunk's red tile with every halo the tile needs;
//   S  the running HFF sum b_g = b_{g-1} + dw1_g * red over the tile grown
//      by m2 = max rate + 1 on each side (the v2 stage's halo; m2 = 0 without
//      v2).  Positions outside H2 x W2 hold zero: they are the v2 stage's
//      zero padding, not computed values.
// S holds every branch's sum (one pass over the grown tile computes all k);
// the v2 stage (dilation rates[g] + 1) then reads S[g] at the tile's pixels
// (sesp_block.cu has its own loop for that step).  Every step is per red
// channel, so a chunk of channels needs only its own halo tiles, never the
// whole C-channel map.
//
// Global loads are cp.async copies (zero-filled where out of range), issued
// all at once so that their latencies overlap.  Index decoding divides by
// float reciprocals (FastDiv) and rates are selected without indexing, so
// the kernels keep few registers and no stack frame.
#pragma once

#include "common.cuh"

namespace lednet {

constexpr int kThreads = 256;   // every launch of kernels D and E

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

struct PyrTile {
  int H, W, H2, W2, stride, rmax, m2;
  int th, tw;   // output tile
  int eh, ew;   // the tile grown by m2 (where S lives)
  int rh, rw;   // the red region stage 1 reads for S
  int oh0, ow0; // output origin of the tile

  __host__ __device__ void init(int H_, int W_, int stride_, int rmax_,
                                bool v2, int th_, int tw_) {
    H = H_;
    W = W_;
    stride = stride_;
    H2 = (H + stride - 1) / stride;
    W2 = (W + stride - 1) / stride;
    rmax = rmax_;
    m2 = v2 ? rmax + 1 : 0;
    th = th_;
    tw = tw_;
    eh = th + 2 * m2;
    ew = tw + 2 * m2;
    rh = (eh - 1) * stride + 1 + 2 * rmax;
    rw = (ew - 1) * stride + 1 + 2 * rmax;
    oh0 = ow0 = 0;
  }
  __host__ __device__ int red_floats() const { return rh * rw; }
  __host__ __device__ int sum_floats() const { return eh * ew; }
};

// floor(a / b) for 0 <= a < 2^22 through a float reciprocal: exact there
// (the quotient's distance to the next integer, at least 0.5 / b, is far
// above the float rounding, at most a / b * 2^-23), and a few instructions
// where an integer division by a runtime divisor takes some twenty.
struct FastDiv {
  float inv;
  __device__ __forceinline__ explicit FastDiv(int b) : inv(1.f / b) {}
  __device__ __forceinline__ int operator()(int a) const {
    return static_cast<int>((a + 0.5f) * inv);
  }
};

__device__ __forceinline__ int rate_of(const Rates& r, int g) {
  return g == 0 ? r.r[0] : g == 1 ? r.r[1] : g == 2 ? r.r[2] : r.r[3];
}

// Issue R[j] <- red channel j0 + j on the tile's region, zero outside H x W
// (stage 1's zero padding) and for j0 + j >= n.  red: one image (n, H, W).
__device__ __forceinline__ void stage_red_tile(const float* __restrict__ red,
                                               float* R, int j0, int jc, int n,
                                               const PyrTile& t) {
  const int r0 = (t.oh0 - t.m2) * t.stride - t.rmax;
  const int c0 = (t.ow0 - t.m2) * t.stride - t.rmax;
  const int per = t.red_floats(), total = jc * per;
  const FastDiv by_per(per), by_rw(t.rw);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int j = by_per(i), q = i - j * per;
    const int rr = by_rw(q), r = r0 + rr, c = c0 + q - rr * t.rw;
    const bool ok = j0 + j < n && r >= 0 && r < t.H && c >= 0 && c < t.W;
    cp_async_f32(R + i,
                 ok ? red + (static_cast<size_t>(j0 + j) * t.H + r) * t.W + c
                    : red,
                 ok);
  }
}

// Issue Wd[g][j][9] <- dw[g][j0 + j][9] (zero for j0 + j >= n).
__device__ __forceinline__ void stage_dw(const float* __restrict__ dw,
                                         float* Wd, int k, int j0, int jc,
                                         int n) {
  const FastDiv by_j9(jc * 9), by_9(9);
  for (int i = threadIdx.x; i < k * jc * 9; i += kThreads) {
    const int g = by_j9(i), rem = i - g * jc * 9, j = by_9(rem);
    const bool ok = j0 + j < n;
    const size_t src = (static_cast<size_t>(g) * n + j0 + j) * 9 + rem - j * 9;
    cp_async_f32(Wd + i, ok ? dw + src : dw, ok);
  }
}

// S[g] = b_g for every branch g over the grown tile of the chunk: the
// running HFF sum of the 3x3 depthwise branches at dilations rates[g] and
// stride t.stride.  S is [k][jc][grown tile]; positions outside H2 x W2
// hold 0.  Each warp takes one channel at a time (several warps share one
// when jc < 8) and keeps its 9*k taps in registers; branches at one rate
// share a 3x3 window of R, and the k branch sums are independent chains.
__device__ __forceinline__ void hff_sums(const float* R, float* S,
                                         const float* W1d, int k,
                                         const Rates& rates, int jc,
                                         const PyrTile& t) {
  constexpr int kWarps = kThreads / 32;
  const int per = t.sum_floats(), total = jc * per, rper = t.red_floats();
  const int e0h = t.oh0 - t.m2, e0w = t.ow0 - t.m2;
  const FastDiv by_ew(t.ew);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpj = jc >= kWarps ? 1 : kWarps / jc;   // warps per channel
  for (int j = warp / wpj; j < jc; j += kWarps) {
    float w[4][9];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        w[g][tap] = g < k ? W1d[(g * jc + j) * 9 + tap] : 0.f;
    for (int q = (warp % wpj) * 32 + lane; q < per; q += 32 * wpj) {
      const int a = by_ew(q), b = q - a * t.ew;
      const int oh = e0h + a, ow = e0w + b, i = j * per + q;
      if (oh < 0 || oh >= t.H2 || ow < 0 || ow >= t.W2) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (g < k) S[g * total + i] = 0.f;
        continue;
      }
      const float* rc = R + j * rper + (a * t.stride + t.rmax) * t.rw +
                        b * t.stride + t.rmax;
      float conv[4], win[9];
      int dwin = 0;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        conv[g] = 0.f;
        if (g >= k) continue;
        const int d = rate_of(rates, g);
        if (d != dwin) {   // branches at one rate share the 3x3 window
          const float* r = rc - d * (t.rw + 1);
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              win[ky * 3 + kx] = r[ky * d * t.rw + kx * d];
          dwin = d;
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          conv[g] = fmaf(win[tap], w[g][tap], conv[g]);
      }
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (g >= k) break;
        s = g == 0 ? conv[0] : conv[g] + s;
        S[g * total + i] = s;
      }
    }
  }
}

__host__ __device__ inline int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

inline Rates make_rates(int r0, int r1, int r2, int r3) {
  Rates r;
  r.r[0] = r0;
  r.r[1] = r1;
  r.r[2] = r2;
  r.r[3] = r3;
  return r;
}

inline int max_rate(const Rates& rates, int k) {
  int m = 0;
  for (int g = 0; g < k; ++g) m = rates.r[g] > m ? rates.r[g] : m;
  return m;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lednet
