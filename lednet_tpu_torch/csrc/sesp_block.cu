// Kernel D: one eval-mode SESP block (LED-Net's core primitive) in two
// launches:
//   1. reduce: red = prelu(Wred @ x + bred, a1)   (dense-grouped 1x1,
//              BatchNorm folded), a register-tiled float32 product that
//              reads x once;
//   2. fused:  the pyramid of sesp_common.cuh (k dilated 3x3 depthwise
//              branches over red at stride 1 or 2, the HFF running sum, the
//              optional v2 stage at rates d+1), BatchNorm + PReLU, the dense
//              (C, C) 1x1 expand (BatchNorm folded) and the tail:
//              'residual' prelu(z + x, a3) / 'act' prelu(z, a3) / 'plain' z.
// The pyramid map and y = prelu(bn(pyramid)) never reach device memory: a
// CTA owns an output tile and a slice of output channels and walks the red
// channels in chunks; per chunk it computes the HFF sums of all k branches,
// then their y, and folds that slice of y into the expand's register
// accumulators at once: acc[o][p] += Wexp[o][g*n + j] * y[g*n + j][p].
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/sesp_pyramid.py:207
// (sesp_block), which holds a whole block in VMEM (one grid step per image).
// On Hopper a block is far larger than shared memory, so the design tiles
// space and output channels; where tiles alone give too few CTAs (LED-Net's
// 64x64 to 16x16 maps) the red channels of a tile are split over a cluster
// of up to 8 CTAs, which sum their partial expands through distributed
// shared memory.  Tile, channel split, chunk and cluster sizes are chosen on
// the host (lednet_tpu_torch/ops/kernels/sesp_pyramid.py, fused_config).
//
// Operands reach shared memory by cp.async copies issued ahead of the
// compute (a ring of three chunks of x in the reduce; the next chunk of red
// channels in the fused launch).  The expand reads its weights, transposed
// once on the host, straight from L1/L2 as vectors of a thread's output
// channels; staging them per chunk cost more than the FMAs they fed.
//
// Bound: bytes at LED-Net's widths (the 1x1 products do at most 2*C flops
// per byte moved).  Everything is float32 FMAs (no TF32).
#include <cooperative_groups.h>

#include "sesp_common.cuh"

namespace lednet {

namespace cg = cooperative_groups;

constexpr int kRedKC = 32, kRedStages = 3;
constexpr int kFusedOpt = 4;   // output channels per thread of the fused launch

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// Floats of one reduce stage: x[kRedKC][16*PPT] and w[kRedKC][16*OPT + 4].
template <int PPT, int OPT>
__host__ __device__ constexpr int reduce_stage_floats() {
  return kRedKC * (16 * PPT + 16 * OPT + 4);
}

// grid: (ceil(HW / (16*PPT)), ceil(n / (16*OPT)), B).  A CTA computes
// 16*PPT pixels x 16*OPT output channels, a thread PPT x OPT of them in
// registers; chunks of kRedKC input channels of x and of the weights go
// through a ring of kRedStages shared-memory stages.  With n <= 16*OPT
// every x element is read once.
template <int PPT, int OPT>
__global__ void __launch_bounds__(kThreads)
sesp_reduce_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ alpha, float* __restrict__ out,
                   int Cin, int HW, int n) {
  constexpr int TPIX = 16 * PPT, TOUT = 16 * OPT, WROW = TOUT + 4;
  constexpr int STAGE = reduce_stage_floats<PPT, OPT>();
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int p0 = blockIdx.x * TPIX, o0 = blockIdx.y * TOUT, b = blockIdx.z;
  const float* xb = x + static_cast<size_t>(b) * Cin * HW;
  const int chunks = (Cin + kRedKC - 1) / kRedKC;
  // rows of x whose length is a multiple of 4 floats are copied 16 bytes at
  // a time (a CTA's 16*PPT pixels start at a multiple of 4)
  const bool vec = HW % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  auto issue = [&](int ci) {
    float* xs = smem + (ci % kRedStages) * STAGE;
    float* ws = xs + kRedKC * TPIX;
    const int c0 = ci * kRedKC;
    const int step = vec ? 4 : 1;
    for (int i = threadIdx.x * step; i < kRedKC * TPIX; i += kThreads * step) {
      const int c = i / TPIX, q = i % TPIX;
      const bool ok = c0 + c < Cin && p0 + q < HW;
      const float* src = ok ? xb + static_cast<size_t>(c0 + c) * HW + p0 + q
                            : x;
      if (vec) {
        cp_async_f32x4(xs + i, src, ok);
      } else {
        cp_async_f32(xs + i, src, ok);
      }
    }
    for (int i = threadIdx.x; i < kRedKC * TOUT; i += kThreads) {
      const int o = i / kRedKC, c = i % kRedKC;
      const bool ok = c0 + c < Cin && o0 + o < n;
      cp_async_f32(ws + c * WROW + o,
                   ok ? w + static_cast<size_t>(o0 + o) * Cin + c0 + c : w, ok);
    }
  };
  float acc[OPT][PPT];
#pragma unroll
  for (int a = 0; a < OPT; ++a)
#pragma unroll
    for (int q = 0; q < PPT; ++q) acc[a][q] = 0.f;
#pragma unroll
  for (int ci = 0; ci < kRedStages - 1; ++ci) {
    if (ci < chunks) issue(ci);
    cp_async_commit();
  }
  for (int ci = 0; ci < chunks; ++ci) {
    cp_async_wait<kRedStages - 2>();
    __syncthreads();   // chunk ci has landed; chunk ci - 1's stage is free
    if (ci + kRedStages - 1 < chunks) issue(ci + kRedStages - 1);
    cp_async_commit();
    const float* xs = smem + (ci % kRedStages) * STAGE;
    const float* ws = xs + kRedKC * TPIX;
#pragma unroll 8
    for (int c = 0; c < kRedKC; ++c) {
      float xv[PPT], wv[OPT];
      load_vec(xs + c * TPIX + tx * PPT, xv);
      load_vec(ws + c * WROW + ty * OPT, wv);
#pragma unroll
      for (int a = 0; a < OPT; ++a)
#pragma unroll
        for (int q = 0; q < PPT; ++q) acc[a][q] = fmaf(wv[a], xv[q], acc[a][q]);
    }
  }
  const int p = p0 + tx * PPT;
  const bool vec_out = PPT > 1 && HW % PPT == 0 && p + PPT <= HW &&
                       (reinterpret_cast<size_t>(out) & 15) == 0;
#pragma unroll
  for (int a = 0; a < OPT; ++a) {
    const int o = o0 + ty * OPT + a;
    if (o >= n) continue;
    const float bo = bias[o], ao = alpha[o];
    float* dst = out + (static_cast<size_t>(b) * n + o) * HW + p;
    float v[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      v[q] = prelu(acc[a][q] + bo, ao);
      if (!vec_out && p + q < HW) dst[q] = v[q];
    }
    if (vec_out) store_vec(dst, v);
  }
}

struct FusedArgs {
  const float *red, *dw1, *dw2, *s2, *b2, *a2, *wexpT, *bexp, *a3, *res;
  float* out;
  int n, k, oc, jc, tail, cs;
  Rates rates;
};

// Floats of one staging buffer of the fused launch: the chunk's red tile R
// and its dw1 / dw2 taps.
__host__ __device__ inline int fused_stage_floats(const PyrTile& t, int k,
                                                  int jc) {
  return round4(jc * t.red_floats()) + 2 * round4(k * jc * 9);
}

// Shared memory of the fused launch, in floats: Y[k][jc][tp], two staging
// buffers, S[k][jc][grown tile], the BatchNorm vectors s2, b2, a2 (3*k*n)
// and, in a cluster, the partial expand P[oc][tp].
__host__ __device__ inline int fused_smem_floats(const PyrTile& t, int n,
                                                 int k, int oc, int jc,
                                                 int cs) {
  return round4(k * jc * t.th * t.tw) + 2 * fused_stage_floats(t, k, jc) +
         round4(k * jc * t.sum_floats()) + round4(3 * k * n) +
         (cs > 1 ? oc * t.th * t.tw : 0);
}

// The v2 stage (3x3 depthwise at dilation D) of four consecutive pixels of
// one tile row, added to v: c points at S at the first pixel, w9 at its
// taps.  Each of the three rows of S is read once, as one segment.
template <int D>
__device__ __forceinline__ void v2_run4(const float* c, int ew,
                                        const float* w9, float (&v)[4]) {
  float w[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) w[tap] = w9[tap];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const float* row = c + (ky - 1) * D * ew - D;
    float seg[4 + 2 * D];
#pragma unroll
    for (int q = 0; q < 4 + 2 * D; ++q) seg[q] = row[q];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        v[p] = fmaf(seg[p + kx * D], w[ky * 3 + kx], v[p]);
  }
}

__device__ __forceinline__ void v2_run4(const float* c, int ew,
                                        const float* w9, int d,
                                        float (&v)[4]) {
  switch (d) {
    case 2: v2_run4<2>(c, ew, w9, v); return;
    case 3: v2_run4<3>(c, ew, w9, v); return;
    case 4: v2_run4<4>(c, ew, w9, v); return;
    case 5: v2_run4<5>(c, ew, w9, v); return;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        v[p] = fmaf(c[(ky - 1) * d * ew + p + (kx - 1) * d], w9[ky * 3 + kx],
                    v[p]);
}

// Issue one chunk's staging buffer: the red tile and the dw1 / dw2 taps.
__device__ __forceinline__ void stage_chunk(const FusedArgs& A,
                                            const float* __restrict__ red,
                                            float* buf, int j0,
                                            const PyrTile& t) {
  const int n = A.n, k = A.k, jc = A.jc;
  stage_red_tile(red, buf, j0, jc, n, t);
  float* W1d = buf + round4(jc * t.red_floats());
  stage_dw(A.dw1, W1d, k, j0, jc, n);
  if (A.dw2 != nullptr) stage_dw(A.dw2, W1d + round4(k * jc * 9), k, j0, jc, n);
}

__device__ __forceinline__ void load_global_vec(const float* __restrict__ p,
                                                float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// grid: (tiles * cs, ceil(C / oc), B), kThreads threads, clusters of cs
// CTAs along x.  tp = th*tw pixels x oc output channels per tile; a thread
// holds PPT pixels (of one tile row) x 4 output channels, so
// tp / PPT * oc / 4 == kThreads.  The cs CTAs of a cluster split the red
// channels of one tile (on small maps, where tiles alone give few CTAs),
// and sum their partial expands through distributed shared memory.  Per
// chunk of red channels: the HFF sums of all k branches, then y for all of
// them, then the expand over the chunk's k*jc concat channels (three
// barriers); meanwhile the next chunk is staged into the other buffer.
template <int PPT>
__global__ void __launch_bounds__(kThreads, 2)
sesp_fused_kernel(FusedArgs A, PyrTile t) {
  constexpr int OPT = kFusedOpt;
  extern __shared__ __align__(16) float smem[];
  const int n = A.n, k = A.k, C = k * n, oc = A.oc, jc = A.jc, cs = A.cs;
  const int tp = t.th * t.tw, tpx = tp / PPT, kj = k * jc;
  const bool v2 = A.dw2 != nullptr;
  const int stage = fused_stage_floats(t, k, jc);
  float* Y = smem;                                 // [k][jc][tp]
  float* bufs = Y + round4(kj * tp);
  float* S = bufs + 2 * stage;                     // [k][jc][grown tile]
  float* bn = S + round4(kj * t.sum_floats());     // s2[C], b2[C], a2[C]
  float* P = bn + round4(3 * C);                   // [oc][tp], cs > 1
  const int tile = blockIdx.x / cs, rank = blockIdx.x - tile * cs;
  const int tiles_w = (t.W2 + t.tw - 1) / t.tw;
  t.oh0 = (tile / tiles_w) * t.th;
  t.ow0 = (tile % tiles_w) * t.tw;
  const int o0 = blockIdx.y * oc, b = blockIdx.z;
  const int tx = threadIdx.x % tpx, ty = threadIdx.x / tpx;
  const float* rb = A.red + static_cast<size_t>(b) * n * t.H * t.W;
  const int chunks = (n + jc - 1) / jc;
  const int c_beg = rank * chunks / cs, c_end = (rank + 1) * chunks / cs;

  for (int i = threadIdx.x; i < C; i += kThreads) {
    cp_async_f32(bn + i, A.s2 + i, true);
    cp_async_f32(bn + C + i, A.b2 + i, true);
    cp_async_f32(bn + 2 * C + i, A.a2 + i, true);
  }
  if (c_beg < c_end) stage_chunk(A, rb, bufs, c_beg * jc, t);
  cp_async_commit();
  const int per = t.sum_floats(), lrow = log2i(t.tw) - 2;
  const int lrun = log2i(t.th) + lrow, ljc = log2i(jc), runs = kj * tp / 4;

  float acc[OPT][PPT];
#pragma unroll
  for (int a = 0; a < OPT; ++a)
#pragma unroll
    for (int q = 0; q < PPT; ++q) acc[a][q] = 0.f;

  for (int ci = c_beg; ci < c_end; ++ci) {
    const int j0 = ci * jc, nb = (ci - c_beg) & 1;
    cp_async_wait<0>();
    __syncthreads();   // chunk ci has landed; every thread is past chunk ci-1
    if (ci + 1 < c_end) {
      stage_chunk(A, rb, bufs + (nb ^ 1) * stage, j0 + jc, t);
      cp_async_commit();
    }
    const float* R = bufs + nb * stage;
    const float* W1d = R + round4(jc * t.red_floats());
    const float* W2d = W1d + round4(kj * 9);
    hff_sums(R, S, W1d, k, A.rates, jc, t);
    __syncthreads();
    // y of every (branch, channel) of the chunk, by runs of four pixels
    for (int r = threadIdx.x; r < runs; r += kThreads) {
      const int gj = r >> lrun, rem = r & ((1 << lrun) - 1);
      const int ph = rem >> lrow, pw = (rem & ((1 << lrow) - 1)) << 2;
      const int g = gj >> ljc, j = gj & (jc - 1);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j0 + j < n) {
        const float* c = S + gj * per + (ph + t.m2) * t.ew + pw + t.m2;
        if (v2) {
          v2_run4(c, t.ew, W2d + gj * 9, rate_of(A.rates, g) + 1, v);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = c[q];
        }
        const int ch = g * n + j0 + j;
        const float sc = bn[ch], bi = bn[C + ch], al = bn[2 * C + ch];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = prelu(fmaf(v[q], sc, bi), al);
      }
      *reinterpret_cast<float4*>(Y + gj * tp + ph * t.tw + pw) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    // the expand: weights straight from the transposed matrix (L1/L2),
    // OPT consecutive output channels per load
    const int jn = min(jc, n - j0);
    const float* wt = A.wexpT + static_cast<size_t>(j0) * C + o0 + ty * OPT;
    const bool wok = o0 + ty * OPT < C;
    for (int g = 0; g < k; ++g) {
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        float yv[PPT], wv[OPT];
        load_vec(Y + (g * jc + j) * tp + tx * PPT, yv);
        if (wok) {
          load_global_vec(wt + static_cast<size_t>(g * n + j) * C, wv);
        } else {
#pragma unroll
          for (int a = 0; a < OPT; ++a) wv[a] = 0.f;
        }
#pragma unroll
        for (int a = 0; a < OPT; ++a)
#pragma unroll
          for (int q = 0; q < PPT; ++q)
            acc[a][q] = fmaf(wv[a], yv[q], acc[a][q]);
      }
    }
  }

  if (cs == 1) {
    const int p = tx * PPT, ph = p / t.tw, oh = t.oh0 + ph;
    const int ow = t.ow0 + p - ph * t.tw;
    if (oh >= t.H2) return;
    // a thread's PPT pixels move as one vector where they lie inside the map
    // at an aligned offset (ow is a multiple of PPT)
    const size_t align = sizeof(float) * PPT - 1;
    const size_t res = A.tail == 2 ? reinterpret_cast<size_t>(A.res) : 0;
    const bool vec = t.W2 % PPT == 0 && ow + PPT <= t.W2 &&
                     ((reinterpret_cast<size_t>(A.out) | res) & align) == 0;
#pragma unroll
    for (int a = 0; a < OPT; ++a) {
      const int o = o0 + ty * OPT + a;
      if (o >= C) continue;
      const float bo = A.bexp[o], ao = A.a3[o];
      const size_t at =
          ((static_cast<size_t>(b) * C + o) * t.H2 + oh) * t.W2 + ow;
      float z[PPT], r[PPT];
      if (A.tail == 2 && vec) load_vec(A.res + at, r);
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        if (!vec && ow + q >= t.W2) continue;
        z[q] = acc[a][q] + bo;
        if (A.tail == 2) z[q] += vec ? r[q] : A.res[at + q];
        if (A.tail >= 1) z[q] = prelu(z[q], ao);
        if (!vec) A.out[at + q] = z[q];
      }
      if (vec) store_vec(A.out + at, z);
    }
    return;
  }

  // Cluster: publish the partial expand, then each CTA sums and finishes
  // oc / cs of the tile's output channels over the cluster's CTAs.
#pragma unroll
  for (int a = 0; a < OPT; ++a)
#pragma unroll
    for (int q = 0; q < PPT; ++q)
      P[(ty * OPT + a) * tp + tx * PPT + q] = acc[a][q];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = oc / cs, lt = log2i(tp), ltw = log2i(t.tw);
  for (int i = threadIdx.x; i < rows * tp; i += kThreads) {
    const int ol = rank * rows + (i >> lt), p = i & (tp - 1);
    const int o = o0 + ol, oh = t.oh0 + (p >> ltw);
    const int ow = t.ow0 + (p & (t.tw - 1));
    float z = 0.f;
    for (int r = 0; r < cs; ++r)
      z += cluster.map_shared_rank(P, r)[ol * tp + p];
    if (o >= C || oh >= t.H2 || ow >= t.W2) continue;
    z += A.bexp[o];
    const size_t idx =
        ((static_cast<size_t>(b) * C + o) * t.H2 + oh) * t.W2 + ow;
    if (A.tail == 2) z += A.res[idx];
    if (A.tail >= 1) z = prelu(z, A.a3[o]);
    A.out[idx] = z;
  }
  cluster.sync();   // no CTA leaves while another reads its P
}

template <int PPT, int OPT>
int launch_reduce(const float* x, const float* w, const float* bias,
                  const float* alpha, float* out, int B, int Cin, int HW,
                  int n, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kRedStages * reduce_stage_floats<PPT, OPT>();
  cudaError_t e = allow_smem(sesp_reduce_kernel<PPT, OPT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(HW, 16 * PPT), ceil_div(n, 16 * OPT), B);
  sesp_reduce_kernel<PPT, OPT><<<grid, kThreads, smem, stream>>>(
      x, w, bias, alpha, out, Cin, HW, n);
  return static_cast<int>(cudaGetLastError());
}

template <int PPT>
int launch_fused(const FusedArgs& A, const PyrTile& t, int B,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * fused_smem_floats(t, A.n, A.k, A.oc, A.jc, A.cs);
  cudaError_t e = allow_smem(sesp_fused_kernel<PPT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(t.H2, t.th) * ceil_div(t.W2, t.tw) * A.cs,
                     ceil_div(A.n * A.k, A.oc), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = A.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = A.cs > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, sesp_fused_kernel<PPT>, A, t);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lednet

// ppt in {1, 4} pixels and opt in {1, 2, 4} output channels per thread.
LEDNET_API int lednet_sesp_reduce(const float* x, const float* w,
                                  const float* bias, const float* alpha,
                                  float* out, int B, int Cin, int HW, int n,
                                  int ppt, int opt, cudaStream_t stream) {
  using namespace lednet;
#define LEDNET_REDUCE(P, O)                                                  \
  if (ppt == P && opt == O)                                                  \
    return launch_reduce<P, O>(x, w, bias, alpha, out, B, Cin, HW, n, stream);
  LEDNET_REDUCE(1, 1)
  LEDNET_REDUCE(1, 2)
  LEDNET_REDUCE(1, 4)
  LEDNET_REDUCE(4, 1)
  LEDNET_REDUCE(4, 2)
  LEDNET_REDUCE(4, 4)
#undef LEDNET_REDUCE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ppt in {2, 4} pixels x 4 output channels per thread, with
// th*tw / ppt * oc / 4 == kThreads and tw % ppt == 0; th, tw (at least 4)
// and jc powers of two; cs (a power of two up to 8) CTAs per cluster split
// the red channels of a tile.  wexpT is the expand weight transposed,
// (C in, C out), so that a thread loads its output channels as one vector.
LEDNET_API int lednet_sesp_fused(
    const float* red, const float* dw1, const float* dw2, const float* s2,
    const float* b2, const float* a2, const float* wexpT, const float* bexp,
    const float* a3, const float* res, float* out, int B, int n, int H, int W,
    int k, int r0, int r1, int r2, int r3, int stride, int tail, int th,
    int tw, int oc, int jc, int cs, int ppt, cudaStream_t stream) {
  using namespace lednet;
  FusedArgs A{red, dw1, dw2, s2, b2, a2, wexpT, bexp, a3, res, out,
              n, k, oc, jc, tail, cs, make_rates(r0, r1, r2, r3)};
  PyrTile t;
  t.init(H, W, stride, max_rate(A.rates, k), dw2 != nullptr, th, tw);
  if (!pow2(th) || !pow2(tw) || tw < 4 || !pow2(jc) || !pow2(cs) || cs > 8 ||
      oc % cs != 0 || tw % ppt != 0 || oc % kFusedOpt != 0 ||
      (k * n) % kFusedOpt != 0 ||
      (th * tw / ppt) * (oc / kFusedOpt) != kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ppt == 2) return launch_fused<2>(A, t, B, stream);
  if (ppt == 4) return launch_fused<4>(A, t, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
