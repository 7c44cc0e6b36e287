// The 3x3 convolution core of kernels B (stem_conv.cu) and C
// (conv_block.cu): a C -> C conv (C = 16 or 32) as an implicit GEMM on the
// tensor cores, in 3xTF32 so that it keeps float32 accuracy.
//
//   M = output pixels (m-tiles of 16 pixels), N = the C output channels
//   (n-tiles of 8), K = 9 taps x C input channels, walked as chunks of 8
//   input channels; one chunk is 9 k-steps of mma.m16n8k8 (one per tap).
//
// 3xTF32: each operand is split as v = hi + lo with hi = tf32(v) and
// lo = tf32(v - hi) (rounded as cvt.rna does), and a*b is summed as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in the f32 accumulators (a_lo*b_lo,
// about 2^-22 relative, is dropped).  A bfloat16 operand is exact in TF32,
// so its lo is zero and two products suffice (NPROD = 2).
//
// Operands:
// - the input tile (with its halo) lies in shared memory as float32,
//   [channel][row][column] with a channel stride CS = 8 or 24 (mod 32), so
//   that an A-fragment load (8 pixels of a row x 4 channels per warp) hits
//   32 distinct banks;
// - the weights are BN-folded, split and permuted on the host into
//   B-fragment order, one float4 {b0_hi, b1_hi, b0_lo, b1_lo} per lane:
//   float4 [C/8 chunks][9 taps][C/8 n-tiles][32 lanes]
//   (conv3x3.py::conv_fragments), so a B fragment is one 16-byte load.
// The A operand is split on the fly.  Where a pixel's input sits is given
// by per-m-tile pixel offsets and per-tap offsets, so one routine serves
// stride 1 and stride 2 (a stride-2 input is stored with its even and odd
// columns apart, so its A loads stay conflict-free too).
#pragma once

#include "common.cuh"

namespace lednet {

constexpr int kConvThreads = 256;   // 8 warps in every launch of B and C

// m16n8k8 TF32 fragment positions (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), lane = 4 * g + t:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   D (16 x 8):            d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
//                          d3 (g + 8, 2t + 1)

// float32 -> TF32 bits, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 computes), in two integer ops: cvt runs at a fraction of
// their rate on this card.  Finite inputs only.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step: acc[n] += A * B_n for every n-tile, in NPROD products.
// a: the A fragment as float32 values; bh/bl: this k-step's B fragments.
template <int NT, int NPROD>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NT][4],
                                           const float (&a)[4],
                                           const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_rna(a[i]);
    al[i] = tf32_rna(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (NPROD == 3) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
    mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
    mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
  }
}

template <int NT>
__device__ __forceinline__ void load_b(const float4* __restrict__ wf,
                                       uint32_t (&bh)[NT][2],
                                       uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 v = wf[n * 32];
    bh[n][0] = __float_as_uint(v.x);
    bh[n][1] = __float_as_uint(v.y);
    bl[n][0] = __float_as_uint(v.z);
    bl[n][1] = __float_as_uint(v.w);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
}

// One chunk of 8 input channels (9 k-steps) for the warp's m-tiles, added
// to acc.  The chunk is summed in fresh accumulators and then added to acc
// with a rounded float add: the MMA's own accumulation truncates, and a
// chain of 27 MMAs per chunk instead of 27 x C/8 per conv keeps that error
// near float32 rounding.  With several m-tiles only the three taps of a
// kernel row are unrolled: fully unrolled, kernel C's code outgrows
// the instruction cache.
//   src   shared input: the chunk's first channel plane
//   cs    channel stride of src, in floats
//   poff  per m-tile, the offsets of the lane's two pixels (rows g, g + 8);
//         every warp runs all MT m-tiles (a warp with one fewer computes a
//         clamped copy and drops it), so no branch splits the MMAs
//   tap (ky, kx) sits at ky * row + (kx & 1) * odd + (kx >> 1) * two from a
//         pixel's offset (stride 1: odd = 1, two = 2; a stride-2 input with
//         its even and odd columns apart: odd = the odd columns' offset,
//         two = 1)
//   wf    shared B fragments of the chunk: [9 taps][NT][32 lanes]
template <int NT, int MT, int NPROD>
__device__ __forceinline__ void conv_chunk(float (&acc)[MT][NT][4],
                                           const float* __restrict__ src,
                                           int cs, const int (&poff)[MT][2],
                                           int row, int odd, int two,
                                           const float4* __restrict__ wf,
                                           int lane) {
  const float* s0 = src + (lane & 3) * cs;
  const float* s1 = s0 + 4 * cs;
  auto tap = [&](int t) {
    const int ky = t / 3, kx = t - 3 * ky;
    return ky * row + (kx & 1) * odd + (kx >> 1) * two;
  };
  float part[MT][NT][4];
  zero_acc(part);
  if constexpr (MT == 1) {
    // one m-tile gives the MMAs no independent work to hide the shared
    // loads behind: load tap t + 1's fragments while tap t multiplies
    // (unrolled: with one m-tile the nine taps are short code)
    uint32_t bh[2][NT][2], bl[2][NT][2];
    float a[2][4];
    auto load = [&](int t, int u) {
      load_b<NT>(wf + t * NT * 32 + lane, bh[u], bl[u]);
      const int o = tap(t), o0 = poff[0][0] + o, o1 = poff[0][1] + o;
      a[u][0] = s0[o0];
      a[u][1] = s0[o1];
      a[u][2] = s1[o0];
      a[u][3] = s1[o1];
    };
    load(0, 0);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (t < 8) load(t + 1, (t + 1) & 1);
      mma_3xtf32<NT, NPROD>(part[0], a[t & 1], bh[t & 1], bl[t & 1]);
    }
  } else {
    // kernel rows rolled, the three taps of a row unrolled
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t bh[NT][2], bl[NT][2];
        load_b<NT>(wf + (3 * ky + kx) * NT * 32 + lane, bh, bl);
        const int o = ky * row + (kx & 1) * odd + (kx >> 1) * two;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int o0 = poff[m][0] + o, o1 = poff[m][1] + o;
          const float a[4] = {s0[o0], s0[o1], s1[o0], s1[o1]};
          mma_3xtf32<NT, NPROD>(part[m], a, bh, bl);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];
}

// The smallest channel stride >= area that is 8 or 24 (mod 32).
__host__ __device__ constexpr int pad_cs(int area) {
  return (area % 32 == 8 || area % 32 == 24) ? area : pad_cs(area + 1);
}

// float4s of one chunk's B fragments: 9 taps x NT n-tiles x 32 lanes.
__host__ __device__ constexpr int chunk_frags(int C) { return 9 * (C / 8) * 32; }

// Copy n float4 of B fragments to shared memory (cp.async, 16 bytes each).
__device__ __forceinline__ void stage_frags(float4* dst,
                                            const float4* __restrict__ src,
                                            int n, int tid) {
  for (int i = tid; i < n; i += kConvThreads)
    cp_async_f32x4(reinterpret_cast<float*>(dst + i),
                   reinterpret_cast<const float*>(src + i), true);
}

}  // namespace lednet
