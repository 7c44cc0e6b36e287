// Kernel E: the SESP branch pyramid on its own.  From a reduced map red
// (B, n, H, W) it computes k 3x3 depthwise branches at dilations rates[g]
// and stride 1 or 2, their hierarchical feature fusion (running sum
// b_g += b_{g-1}) and, optionally, the v2 stage (a second 3x3 depthwise per
// branch at dilation rates[g] + 1, zero-padded at the H2 x W2 border), and
// writes the concat (B, k*n, H2, W2) in float32.
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/sesp_pyramid.py:79
// (sesp_pyramid), which holds the whole plane in a padded VMEM scratch with
// the k branches side by side in lanes (HFF as lane rolls).  Here one CTA
// owns an output tile and a chunk of channels; the red tile with its halo
// and the running sum over the tile grown by the v2 halo live in shared
// memory (sesp_common.cuh); one pass over the grown tile computes the k
// branches' running sums, and one pass over the tile their outputs.
//
// Bound: bytes (red read once, the output written once; about 20 FMAs per
// output element with v2).  The red tile's loads are cp.async copies, all in
// flight at once.
#include "sesp_common.cuh"

namespace lednet {

// One output element of the chunk, all branches laid out [g][j][pixel]:
// i -> branch g, chunk channel j and tile pixel (ph, pw).
struct OutElem {
  int g, j, ph, pw;
};

// Decodes i by shifts: the tile's pixel count tp, its width tw and the
// chunk size jc are powers of two.
struct OutDecoder {
  int ltp, ljc, ltw;
  __device__ __forceinline__ OutDecoder(int tp, int jc, int tw)
      : ltp(log2i(tp)), ljc(log2i(jc)), ltw(log2i(tw)) {}
  __device__ __forceinline__ OutElem operator()(int i) const {
    const int gj = i >> ltp, q = i & ((1 << ltp) - 1);
    return OutElem{gj >> ljc, gj & ((1 << ljc) - 1), q >> ltw,
                   q & ((1 << ltw) - 1)};
  }
};

// Branch g's output of chunk channel j at tile pixel (ph, pw): the v2 stage
// (dilation rates[g] + 1, zero padding at H2 x W2) over S[g], or S[g]
// itself without v2.
__device__ __forceinline__ float pyramid_at(const float* S, const float* W2d,
                                            const Rates& rates, int jc,
                                            const OutElem& e, bool v2,
                                            const PyrTile& t) {
  const int gj = e.g * jc + e.j;
  const float* s =
      S + gj * t.sum_floats() + (e.ph + t.m2) * t.ew + e.pw + t.m2;
  if (!v2) return *s;
  const int d2 = rate_of(rates, e.g) + 1;
  const float* w = W2d + gj * 9;
  const float* c = s - d2 * (t.ew + 1);
  float v = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
      v = fmaf(c[ky * d2 * t.ew + kx * d2], w[ky * 3 + kx], v);
  return v;
}

// grid: (tiles, ceil(n / jc), B), kThreads threads; dynamic shared memory
// S, R and the chunk's dw1 / dw2 taps.
__global__ void __launch_bounds__(kThreads)
sesp_pyramid_kernel(const float* __restrict__ red,
                    const float* __restrict__ dw1,
                    const float* __restrict__ dw2, float* __restrict__ out,
                    int n, int k, Rates rates, PyrTile t, int jc) {
  extern __shared__ float smem[];
  const bool v2 = dw2 != nullptr;
  float* S = smem;
  float* R = S + round4(k * jc * t.sum_floats());
  float* W1d = R + round4(jc * t.red_floats());
  float* W2d = W1d + k * jc * 9;
  const int tiles_w = (t.W2 + t.tw - 1) / t.tw;
  t.oh0 = (blockIdx.x / tiles_w) * t.th;
  t.ow0 = (blockIdx.x % tiles_w) * t.tw;
  const int j0 = blockIdx.y * jc, b = blockIdx.z, C = k * n;
  stage_dw(dw1, W1d, k, j0, jc, n);
  if (v2) stage_dw(dw2, W2d, k, j0, jc, n);
  stage_red_tile(red + static_cast<size_t>(b) * n * t.H * t.W, R, j0, jc, n,
                 t);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  hff_sums(R, S, W1d, k, rates, jc, t);
  __syncthreads();
  const int total = k * jc * t.th * t.tw;
  const size_t plane = static_cast<size_t>(t.H2) * t.W2;
  const OutDecoder decode(t.th * t.tw, jc, t.tw);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const OutElem e = decode(i);
    const int oh = t.oh0 + e.ph, ow = t.ow0 + e.pw;
    if (j0 + e.j >= n || oh >= t.H2 || ow >= t.W2) continue;
    out[(static_cast<size_t>(b) * C + e.g * n + j0 + e.j) * plane +
        static_cast<size_t>(oh) * t.W2 + ow] =
        pyramid_at(S, W2d, rates, jc, e, v2, t);
  }
}

}  // namespace lednet

LEDNET_API int lednet_sesp_pyramid(const float* red, const float* dw1,
                                   const float* dw2, float* out, int B, int n,
                                   int H, int W, int k, int r0, int r1, int r2,
                                   int r3, int stride, int th, int tw, int jc,
                                   cudaStream_t stream) {
  using namespace lednet;
  const Rates rates = make_rates(r0, r1, r2, r3);
  if (!pow2(th) || !pow2(tw) || !pow2(jc))
    return static_cast<int>(cudaErrorInvalidValue);
  PyrTile t;
  t.init(H, W, stride, max_rate(rates, k), dw2 != nullptr, th, tw);
  const size_t smem = sizeof(float) * (round4(k * jc * t.sum_floats()) +
                                       round4(jc * t.red_floats()) +
                                       2 * k * jc * 9);
  cudaError_t e = allow_smem(sesp_pyramid_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(t.H2, th) * ceil_div(t.W2, tw), ceil_div(n, jc), B);
  sesp_pyramid_kernel<<<grid, kThreads, smem, stream>>>(red, dw1, dw2, out, n,
                                                        k, rates, t, jc);
  return static_cast<int>(cudaGetLastError());
}
