// Kernel E: the SESP branch pyramid on its own.  From a reduced map red
// (B, n, H, W) it computes k 3x3 depthwise branches at dilations rates[g]
// and stride 1 or 2, their hierarchical feature fusion (running sum
// b_g += b_{g-1}) and, optionally, the v2 stage (a second 3x3 depthwise per
// branch at dilation rates[g] + 1, zero-padded at the H2 x W2 border), and
// writes the concat (B, k*n, H2, W2) in float32.
//
// Replaces the TPU kernel lednet_tpu/ops/pallas/sesp_pyramid.py:79
// (sesp_pyramid), which holds the whole plane in a padded VMEM scratch with
// the k branches side by side in lanes (HFF as lane rolls).
//
// Bound: bytes.  Each output element costs 9 FMAs per stage and reads no
// other channel, so red is read once and the k-times larger output written
// once; no tensor core has work here.  The design keeps the card's memory
// busy:
//   - Persistent CTAs (two per SM) walk items (one plane of red, one output
//     tile th x tw; tile fastest, so neighbouring tiles' halos meet in L2).
//   - Each item's red box (the tile with every halo, rh x rw) comes into a
//     ring of 2-3 shared-memory stages by one TMA load (cp.async.bulk.tensor
//     over red seen as (B*n, H, W); one thread issues it, one mbarrier per
//     stage), so the loads of the next items are in flight while this one
//     computes.  TMA's out-of-bounds zero fill is stage 1's zero padding.
//     Where W % 4 != 0 (TMA needs 16-byte row strides) the same ring is fed
//     by 4-byte cp.async copies with zero fill: rows that start at every
//     alignment admit no wider copy.  The wrapper picks by shape.  (At the
//     same tiles that path takes 1.31x TMA's device time over the val
//     set's 16 calls on an H100 80GB HBM3 at 700 W: the copies' issue and
//     index math fall on the threads that compute; measured by
//     tools/torch_port_profile.py --pyramid-sweep --val.)
//   - A thread computes 8 adjacent outputs of one plane in registers
//     (an 8-wide strip).  Stage 1 does so for all k branches: it reads each
//     window row of red once per rate as aligned float4s and uses it for
//     every tap and every branch at that rate, and keeps the HFF running
//     sum in registers.  With v2 it runs over the tile grown by the v2 halo
//     (m2 = max rate + 1 rows, ca = m2 rounded up to 4 columns) and leaves
//     its sums in shared memory, zero outside H2 x W2 (the v2 stage's
//     padding); stage 2 then computes one branch's strip from aligned
//     float4 windows of its sums.  Outputs leave as float4s (two lanes
//     swap halves first, so that every store writes whole 32-byte sectors).
//   - Shared memory traffic, not FMAs, bounds the compute: row pitches of 4
//     mod 8 floats and the order of the units make eight lanes' 16-byte
//     reads hit 32 distinct banks (stride 1), and the taps are read as
//     float4s.
//   - Rates and the v2 dilation are compile-time inside the unrolled loops
//     (a loop over the four possible rates, a switch over the four v2
//     dilations), so every window index is static and stays in registers.
// The geometry (tiles, halos, box, ring depth, shared memory, grid, TMA or
// cp.async) has one source, the host's pyramid_geometry
// (lednet_tpu_torch/ops/kernels/sesp_pyramid.py); the kernel takes it as
// given and refuses one that breaks what its reads and writes rely on
// (Ring::valid).
#include <cuda.h>

#include "common.cuh"

namespace lednet {
namespace ring {

constexpr int kThreads = 256;
constexpr int kMaxStages = 3;
constexpr int kTap = 24;                      // one branch's taps, see tap_of
constexpr int kTapFloats = 4 * kTap;          // k <= 4 branches
constexpr int kHeadFloats = 224;              // mbarriers (32) + 2 tap buffers
constexpr int kSmemMax = 232448;              // one CTA's shared memory

// The launch's geometry: the shape, and the layout from the host
struct Ring {
  int H, W, H2, W2, n, planes, k, stride, rmax;
  int th, tw, stages;
  int m2, ca;      // v2 halo: rows, and columns rounded up to 4
  int sh, su, sp;  // stage-1 rows and columns (grown tile), sums' pitch
  int rh, rw;      // the red box of one item
  int box;         // floats of one ring stage (128-byte multiple)
  int smem;        // bytes of dynamic shared memory
  int tiles_w, tiles, items;
  int vec_out;     // W2 % 4 == 0: float4 stores
  int lg_strips, lg_per_g;  // stage 2: log2 of tw / 8, of th * tw / 8

  static int log2_of(int v) {
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
  }
  // What the loads, the unit loops and the float4 windows below rely on:
  // the grown tile is the tile with the v2 halo on every side; sum rows
  // and box rows are whole float4s; the box holds every window of stage 1
  // (rows of every rate, 16 or 24 columns from column stride * u); the
  // stages start 128 bytes apart (TMA); the shared memory holds the head,
  // the ring and the sums.
  __host__ bool valid(bool v2) const {
    const long need =
        static_cast<long>(sizeof(float)) *
        (kHeadFloats + static_cast<long>(stages) * box +
         (v2 ? static_cast<long>(k) * sh * sp : 0));
    return (th == 8 || th == 16 || th == 32 || th == 64) &&
           (tw == 16 || tw == 32) && m2 >= (v2 ? rmax + 1 : 0) &&
           ca % 4 == 0 && ca >= m2 && sh == th + 2 * m2 &&
           su == tw + 2 * ca && sp % 4 == 0 && sp >= su &&
           rh >= (sh - 1) * stride + 1 + 2 * rmax && rw % 4 == 0 &&
           rw >= stride * su + 8 && box % 32 == 0 &&
           box >= static_cast<long>(rh) * rw && smem >= need &&
           smem <= kSmemMax;
  }
};

// ---------------------------------------------------------------- TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// box of the 3D map at (column c0, row c1, plane c2) -> dst; completion
// (the box's bytes) is reported to bar
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------- items
struct Item {
  int plane, oh0, ow0;
};
__device__ __forceinline__ Item item_at(const Ring& G, int item) {
  const int plane = item / G.tiles, t = item - plane * G.tiles;
  const int ty = t / G.tiles_w;
  return Item{plane, ty * G.th, (t - ty * G.tiles_w) * G.tw};
}

// Bring item `item`'s red box into ring stage `s`: by TMA (thread 0), or
// by every thread's 4-byte cp.async copies, zero outside H x W.
__device__ __forceinline__ void load_box(const Ring& G, const CUtensorMap* map,
                                         const float* __restrict__ red,
                                         float* R, uint64_t* bars, int s,
                                         int item, bool tma) {
  const Item it = item_at(G, item);
  const int r0 = (it.oh0 - G.m2) * G.stride - G.rmax;
  const int c0 = (it.ow0 - G.ca) * G.stride - 4;
  float* dst = R + s * G.box;
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars + s, G.rh * G.rw * sizeof(float));
      tma_load_3d(dst, map, bars + s, c0, r0, it.plane);
    }
    return;
  }
  const float* src = red + static_cast<size_t>(it.plane) * G.H * G.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < G.rh; r += kThreads / 32) {
    const int gr = r0 + r;
    const bool row_ok = gr >= 0 && gr < G.H;
    for (int c = lane; c < G.rw; c += 32) {
      const int gc = c0 + c;
      const bool ok = row_ok && gc >= 0 && gc < G.W;
      cp_async_f32(dst + r * G.rw + c,
                   ok ? src + static_cast<size_t>(gr) * G.W + gc : src, ok);
    }
  }
}

// This thread's tap of item `item` (threads t < kTap k): taps[g][0..8] =
// dw1[g][c], taps[g][12..20] = dw2[g][c] of the item's channel c (16-byte
// aligned, read as two float4s and a float), zeros between.  Loaded into a
// register when the item before it starts, stored to shared memory when
// that item ends, so no item waits on the load.
__device__ __forceinline__ float tap_of(const Ring& G,
                                        const float* __restrict__ dw1,
                                        const float* __restrict__ dw2,
                                        int item) {
  const int t = threadIdx.x;
  if (t >= G.k * kTap) return 0.f;
  const int c = item_at(G, item).plane % G.n;
  const int g = t / kTap, tap = t - g * kTap;
  const bool second = tap >= 12 && tap < 21;
  if (!(tap < 9 || (second && dw2 != nullptr))) return 0.f;
  return __ldg((second ? dw2 : dw1) + (static_cast<size_t>(g) * G.n + c) * 9 +
               (second ? tap - 12 : tap));
}

// The 9 taps at w (16-byte aligned)
__device__ __forceinline__ void taps9(const float* w, float (&t)[9]) {
  const float4 a = *reinterpret_cast<const float4*>(w);
  const float4 b = *reinterpret_cast<const float4*>(w + 4);
  t[0] = a.x;
  t[1] = a.y;
  t[2] = a.z;
  t[3] = a.w;
  t[4] = b.x;
  t[5] = b.y;
  t[6] = b.z;
  t[7] = b.w;
  t[8] = w[8];
}

__device__ __forceinline__ int rate_of(const Rates& r, int g) {
  return g == 0 ? r.r[0] : g == 1 ? r.r[1] : g == 2 ? r.r[2] : r.r[3];
}

// ---------------------------------------------------------------- compute
// acc[g][i] = branch g's conv at the strip's 8 outputs, then their HFF
// running sums.  rc: the box at the strip's first output (row of its
// centre, column 4 before its first tap at rate 0).  Window row q of a rate
// d: float4s from rc + (ky - 1) * d * rw; tap (ky, kx) of output i is
// element 4 + (kx - 1) * d + S * i.
template <int S>
__device__ __forceinline__ void branch_sums(const float* rc, int rw,
                                            const float* taps,
                                            const Rates& rates, int k,
                                            unsigned dmask,
                                            float (&acc)[4][8]) {
  constexpr int kWin = S == 1 ? 16 : 24;
  float w[4][9];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (g < k) taps9(taps + g * kTap, w[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }
#pragma unroll
  for (int d = 1; d <= 4; ++d) {
    if (!(dmask >> d & 1u)) continue;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const float4* row =
          reinterpret_cast<const float4*>(rc + (ky - 1) * d * rw);
      float win[kWin];
#pragma unroll
      for (int q = 0; q < kWin / 4; ++q) {
        const float4 v = row[q];
        win[4 * q] = v.x;
        win[4 * q + 1] = v.y;
        win[4 * q + 2] = v.z;
        win[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (g >= k || rate_of(rates, g) != d) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = fmaf(win[4 + (kx - 1) * d + S * i], w[g][ky * 3 + kx],
                             acc[g][i]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 1; g < 4; ++g)
    if (g < k)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] += acc[g - 1][i];
}

// o[i] = the v2 stage at dilation D2 over one branch's sums at the strip's
// 8 outputs.  sc: the sums at the strip's first output; window row of ky:
// float4s from sc + (ky - 1) * D2 * sp - A, output i's tap kx is element
// A + (kx - 1) * D2 + i.
template <int D2>
__device__ __forceinline__ void v2_strip(const float* sc, int sp,
                                         const float* w, float (&o)[8]) {
  constexpr int A = (D2 + 3) & ~3;
  constexpr int kWin = 8 + 2 * A;
  float t[9];
  taps9(w, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const float4* row =
        reinterpret_cast<const float4*>(sc + (ky - 1) * D2 * sp - A);
    float win[kWin];
#pragma unroll
    for (int q = 0; q < kWin / 4; ++q) {
      const float4 v = row[q];
      win[4 * q] = v.x;
      win[4 * q + 1] = v.y;
      win[4 * q + 2] = v.z;
      win[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = fmaf(win[A + (kx - 1) * D2 + i], t[ky * 3 + kx], o[i]);
  }
}

// A strip's 8 outputs (one row, columns ow.., ow >= 0), masked at H2 x W2
// (row_ok: the row is inside).  Lanes 2j and 2j+1 hold adjacent strips of
// one row (columns base and base + 8); they swap halves (4 shuffles) so
// that each of the two float4 stores writes whole 32-byte sectors: first
// columns base.. (the even lane) and base + 4.. (the odd lane, the even
// lane's second half), then base + 8.. and base + 12..
__device__ __forceinline__ void store_pair(float* row, int ow, int W2,
                                           bool vec, bool row_ok,
                                           const float (&v)[8]) {
  const int lane = threadIdx.x & 31, odd = lane & 1;
  const unsigned pair = 3u << (lane & 30);
  float got[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    got[j] = __shfl_xor_sync(pair, odd ? v[j] : v[4 + j], 1);
  if (!row_ok) return;
  const int base = ow - 8 * odd;
  if (vec && base + 16 <= W2) {
    const float4 a = odd ? make_float4(got[0], got[1], got[2], got[3])
                         : make_float4(v[0], v[1], v[2], v[3]);
    const float4 b = odd ? make_float4(v[4], v[5], v[6], v[7])
                         : make_float4(got[0], got[1], got[2], got[3]);
    __stcs(reinterpret_cast<float4*>(row + base + 4 * odd), a);
    __stcs(reinterpret_cast<float4*>(row + base + 8 + 4 * odd), b);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (ow + i < W2) row[ow + i] = v[i];
}

}  // namespace ring

// grid: persistent CTAs, each walking items blockIdx.x, + gridDim.x, ...;
// dynamic shared memory: mbarriers, 2 tap buffers, the ring, the sums.
template <int S>
__global__ void __launch_bounds__(ring::kThreads, 2)
pyramid_ring_kernel(const __grid_constant__ CUtensorMap map,
                    const float* __restrict__ red,
                    const float* __restrict__ dw1,
                    const float* __restrict__ dw2, float* __restrict__ out,
                    Rates rates, ring::Ring G, int tma) {
  using namespace ring;
  extern __shared__ __align__(128) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* taps = smem + 32;
  float* R = smem + kHeadFloats;
  float* Sum = R + G.stages * G.box;
  const bool v2 = dw2 != nullptr;
  const int first = blockIdx.x, step = gridDim.x;
  const int mine = first < G.items ? (G.items - 1 - first) / step + 1 : 0;
  unsigned dmask = 0;
  for (int g = 0; g < G.k; ++g) dmask |= 1u << rate_of(rates, g);

  if (tma && threadIdx.x == 0) {
    for (int s = 0; s < G.stages; ++s) mbar_init(bars + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int j = 0; j < G.stages - 1; ++j) {
    if (j < mine) load_box(G, &map, red, R, bars, j, first + j * step, tma);
    if (!tma) cp_async_commit();
  }
  if (mine > 0 && threadIdx.x < G.k * kTap)
    taps[threadIdx.x] = tap_of(G, dw1, dw2, first);
  __syncthreads();

  const size_t plane_out = static_cast<size_t>(G.H2) * G.W2;
  for (int it = 0; it < mine; ++it) {
    const int s = it % G.stages;
    {  // the next item into the stage the last item freed
      const int j = it + G.stages - 1;
      if (j < mine)
        load_box(G, &map, red, R, bars, j % G.stages, first + j * step, tma);
    }
    if (tma) {
      mbar_wait(bars + s, (it / G.stages) & 1);
    } else {
      cp_async_commit();
      if (G.stages == 3)
        cp_async_wait<2>();
      else
        cp_async_wait<1>();
      __syncthreads();
    }
    const Item item = item_at(G, first + it * step);
    const int b = item.plane / G.n, c = item.plane - b * G.n;
    float* out_c = out + (static_cast<size_t>(b) * G.k * G.n + c) * plane_out;
    const float* box = R + s * G.box;
    const float* tp = taps + (it & 1) * kTapFloats;
    const float next_tap =
        it + 1 < mine ? tap_of(G, dw1, dw2, first + (it + 1) * step) : 0.f;

    // stage 1: the k branch sums over the grown tile (v2) or the tile.
    // Units: first the first `lead` (<= 4) strips of every row, row by row,
    // then the rest strip by strip: eight lanes then read 16-byte windows
    // 8 floats apart in two rows whose pitch is 4 mod 8 floats, or in eight
    // rows, and hit 32 distinct banks (stride 1).
    const int strips = G.su >> 3, lead = strips < 4 ? strips : 4;
    const int n_lead = G.sh * lead;
    const float by_lead = 1.f / lead, by_sh = 1.f / G.sh;  // exact quotients
    for (int u = threadIdx.x; u < G.sh * strips; u += kThreads) {
      int v, q;
      if (u < n_lead) {
        v = static_cast<int>((u + 0.5f) * by_lead);
        q = u - v * lead;
      } else {
        const int e = static_cast<int>((u - n_lead + 0.5f) * by_sh);
        v = u - n_lead - e * G.sh;
        q = lead + e;
      }
      const int q8 = q * 8;
      float acc[4][8];
      branch_sums<S>(box + (v * S + G.rmax) * G.rw + q8 * S, G.rw, tp, rates,
                     G.k, dmask, acc);
      const int oh = item.oh0 - G.m2 + v, ow = item.ow0 - G.ca + q8;
      if (v2) {
        const bool row_in = oh >= 0 && oh < G.H2;
        const bool inside = row_in && ow >= 0 && ow + 8 <= G.W2;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (g >= G.k) break;
          if (!inside)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (!(row_in && ow + i >= 0 && ow + i < G.W2)) acc[g][i] = 0.f;
          float4* dst = reinterpret_cast<float4*>(
              Sum + (g * G.sh + v) * G.sp + q8);
          dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
          dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
        }
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (g >= G.k) break;
          store_pair(out_c + g * G.n * plane_out +
                         static_cast<size_t>(oh) * G.W2,
                     ow, G.W2, G.vec_out, oh < G.H2, acc[g]);
        }
      }
    }

    if (v2) {  // stage 2: branch g's v2 at dilation rates[g] + 1
      __syncthreads();
      // units (g, r, q8) of th x tw / 8 strips per branch; th and tw are
      // powers of two
      for (int u = threadIdx.x; u < G.k << G.lg_per_g; u += kThreads) {
        const int g = u >> G.lg_per_g, rem = u & ((1 << G.lg_per_g) - 1);
        const int r = rem >> G.lg_strips;
        const int q8 = (rem & ((1 << G.lg_strips) - 1)) * 8;
        const int oh = item.oh0 + r, ow = item.ow0 + q8;
        const float* sc = Sum + (g * G.sh + r + G.m2) * G.sp + q8 + G.ca;
        const float* w = tp + g * kTap + 12;
        float o[8];
        switch (rate_of(rates, g)) {
          case 1: v2_strip<2>(sc, G.sp, w, o); break;
          case 2: v2_strip<3>(sc, G.sp, w, o); break;
          case 3: v2_strip<4>(sc, G.sp, w, o); break;
          default: v2_strip<5>(sc, G.sp, w, o); break;
        }
        store_pair(out_c + g * G.n * plane_out +
                       static_cast<size_t>(oh) * G.W2,
                   ow, G.W2, G.vec_out, oh < G.H2, o);
      }
    }
    if (it + 1 < mine && threadIdx.x < G.k * kTap)
      taps[((it + 1) & 1) * kTapFloats + threadIdx.x] = next_tap;
    __syncthreads();  // the box and the sums are free, the next taps in
  }
}

namespace ring {

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda at build time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <int S>
cudaError_t launch(const float* red, const float* dw1, const float* dw2,
                   float* out, const Rates& rates, const Ring& G, int grid,
                   bool tma, cudaStream_t stream) {
  static unsigned done = 0;
  cudaError_t e = allow_smem(pyramid_ring_kernel<S>, kSmemMax, done);
  if (e != cudaSuccess) return e;
  CUtensorMap map{};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(G.W),
                                static_cast<cuuint64_t>(G.H),
                                static_cast<cuuint64_t>(G.planes)};
    const cuuint64_t strides[2] = {sizeof(float) * G.W,
                                   sizeof(float) * G.W * G.H};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(G.rw),
                               static_cast<cuuint32_t>(G.rh), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
               const_cast<float*>(red), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  pyramid_ring_kernel<S><<<grid, kThreads, G.smem, stream>>>(
      map, red, dw1, dw2, out, rates, G, tma ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace ring
}  // namespace lednet

// The shape and the launch's layout from pyramid_geometry (th .. tma, in the
// order of its fields); a layout that breaks Ring::valid is refused.
LEDNET_API int lednet_sesp_pyramid(const float* red, const float* dw1,
                                   const float* dw2, float* out, int B, int n,
                                   int H, int W, int k, int r0, int r1, int r2,
                                   int r3, int stride, int th, int tw,
                                   int stages, int m2, int ca, int sh, int su,
                                   int sp, int rh, int rw, int box, int smem,
                                   int grid, int tma, cudaStream_t stream) {
  using namespace lednet;
  Rates rates;
  rates.r[0] = r0;
  rates.r[1] = r1;
  rates.r[2] = r2;
  rates.r[3] = r3;
  int rmax = 0;
  for (int g = 0; g < k; ++g) rmax = rates.r[g] > rmax ? rates.r[g] : rmax;
  ring::Ring G;
  G.H = H;
  G.W = W;
  G.n = n;
  G.planes = B * n;
  G.k = k;
  G.stride = stride;
  G.rmax = rmax;
  G.H2 = (H + stride - 1) / stride;
  G.W2 = (W + stride - 1) / stride;
  G.th = th;
  G.tw = tw;
  G.stages = stages;
  G.m2 = m2;
  G.ca = ca;
  G.sh = sh;
  G.su = su;
  G.sp = sp;
  G.rh = rh;
  G.rw = rw;
  G.box = box;
  G.smem = smem;
  G.tiles_w = (G.W2 + tw - 1) / tw;
  G.tiles = ((G.H2 + th - 1) / th) * G.tiles_w;
  G.items = G.planes * G.tiles;
  G.vec_out = G.W2 % 4 == 0;
  G.lg_strips = ring::Ring::log2_of(tw / 8);
  G.lg_per_g = ring::Ring::log2_of(th) + G.lg_strips;
  if (k < 1 || k > 4 || rmax < 1 || rmax > 4 || (stride != 1 && stride != 2) ||
      stages < 2 || stages > ring::kMaxStages || grid < 1 ||
      !G.valid(dw2 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tma && (W % 4 != 0 || reinterpret_cast<uintptr_t>(red) % 16 != 0 ||
              rh > 256 || rw > 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      stride == 1
          ? ring::launch<1>(red, dw1, dw2, out, rates, G, grid, tma, stream)
          : ring::launch<2>(red, dw1, dw2, out, rates, G, grid, tma, stream);
  return static_cast<int>(e);
}
