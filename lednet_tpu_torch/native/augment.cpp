// Host-side image routines of the PyTorch port's data pipeline.
//
// The port's stand-in for the parts of OpenCV that the JAX package's data
// pipeline calls (the GPU machine has neither cv2 nor PIL):
//
// - resize_linear_u8 / resize_nearest_u8: cv2.resize on uint8 HWC images
//   with INTER_LINEAR and INTER_NEAREST.  The bilinear resize takes cv2's
//   half-pixel source coordinates, its 11-bit fixed-point weights and the
//   rounding of its vectorized vertical pass, so it lands on cv2's pixels;
//   an exact 2x reduction is cv2's 2x2 box average, as there.  The nearest
//   resize floors dst * (1 / (dst_size / src_size)), cv2's indexing.
// - png_unfilter: the five PNG row filters undone (Paeth and Average run
//   along each row, which numpy cannot vectorize).
// - fused_resize_crop_flip_u8: the JAX package's one-pass resize, crop and
//   horizontal flip (lednet_tpu/native/augment.cpp:144): half-pixel
//   bilinear with double-precision scales, source coordinates clamped at 0
//   and rounded to float, each lerp a fused multiply-add (that library is
//   built with -march=native, and GCC contracts a * b + c there), +0.5
//   truncation; or nearest, floor(dst * scale).  Its arithmetic, not cv2's.
// - bgr2hsv_u8 / hsv2bgr_u8: cv2.cvtColor's 8-bit BGR<->HSV (H in 0..179).
//   BGR2HSV is cv2's integer table method.  HSV2BGR is cv2's float method:
//   its vectorized body, in blocks of 32 pixels of a row, truncates; the
//   rest of the row rounds to nearest; both with fused multiply-adds where
//   cv2's build has them.
//
// A plain C ABI, loaded with ctypes (lednet_tpu_torch/native/__init__.py),
// which also holds numpy versions of the same arithmetic for the tests.
// Build with -ffp-contract=off: the float arithmetic is spelled out.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kCoefBits = 11;
constexpr int kCoefScale = 1 << kCoefBits;     // INTER_RESIZE_COEF_SCALE
constexpr int kHsvShift = 12;
constexpr int kHsvBlock = 32;                  // pixels per vector block

inline short round_coef(float v) {
  // saturate_cast<short>(float): round half to even
  return static_cast<short>(std::nearbyint(v));
}

struct LinearTaps {
  std::vector<int> ofs;       // first source index per destination index
  std::vector<short> a0, a1;  // fixed-point weights
  int xmax;                   // first index whose second tap is clamped away
};

// cv2's per-axis bilinear coefficients (resizeGeneric, INTER_LINEAR).
// Horizontal taps clamp the coordinate at both ends; vertical ones keep the
// fraction and clamp only the rows (clamp_frac = false).
LinearTaps linear_taps(int dsize, int ssize, bool clamp_frac) {
  LinearTaps t;
  t.ofs.resize(dsize);
  t.a0.resize(dsize);
  t.a1.resize(dsize);
  t.xmax = dsize;
  const double scale = 1.0 / (static_cast<double>(dsize) / ssize);
  for (int d = 0; d < dsize; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    if (clamp_frac) {
      if (s < 0) f = 0.f, s = 0;
      if (s + 1 >= ssize) {
        t.xmax = std::min(t.xmax, d);
        if (s >= ssize - 1) f = 0.f, s = ssize - 1;
      }
    }
    t.ofs[d] = s;
    t.a0[d] = round_coef((1.f - f) * kCoefScale);
    t.a1[d] = round_coef(f * kCoefScale);
  }
  return t;
}

inline uint8_t sat_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// one source row resampled horizontally into fixed-point sums
void hresize_row(const uint8_t* src, int c, const LinearTaps& tx, int dw,
                 int* out) {
  for (int x = 0; x < dw; ++x) {
    const uint8_t* p = src + static_cast<size_t>(tx.ofs[x]) * c;
    int* o = out + static_cast<size_t>(x) * c;
    if (x < tx.xmax) {
      const int a0 = tx.a0[x], a1 = tx.a1[x];
      for (int k = 0; k < c; ++k) o[k] = p[k] * a0 + p[k + c] * a1;
    } else {
      for (int k = 0; k < c; ++k) o[k] = p[k] * kCoefScale;
    }
  }
}

// The fused pass's source coordinate: (dst + 0.5) * scale - 0.5, clamped
// at 0, as float.
inline float fused_src_coord(int dst, double scale) {
  double s = (dst + 0.5) * scale - 0.5;
  return s < 0.0 ? 0.0f : static_cast<float>(s);
}

}  // namespace

extern "C" {

// uint8 HWC bilinear resize, cv2.resize(..., INTER_LINEAR).
void resize_linear_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                      int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * c);
    return;
  }
  if (sh == 2 * dh && sw == 2 * dw) {  // cv2 takes INTER_AREA here
    const size_t step = static_cast<size_t>(sw) * c;
    for (int y = 0; y < dh; ++y) {
      const uint8_t* r0 = src + 2 * y * step;
      const uint8_t* r1 = r0 + step;
      uint8_t* o = dst + static_cast<size_t>(y) * dw * c;
      for (int x = 0; x < dw; ++x)
        for (int k = 0; k < c; ++k) {
          const size_t i = static_cast<size_t>(2 * x) * c + k;
          o[static_cast<size_t>(x) * c + k] = static_cast<uint8_t>(
              (r0[i] + r0[i + c] + r1[i] + r1[i + c] + 2) >> 2);
        }
    }
    return;
  }
  const LinearTaps tx = linear_taps(dw, sw, true);
  const LinearTaps ty = linear_taps(dh, sh, false);
  const size_t n = static_cast<size_t>(dw) * c;
  std::vector<int> rows(2 * n);
  int cached[2] = {-1, -1};     // the source row each slot holds
  auto find = [&](int row) { return cached[0] == row ? 0 : (cached[1] == row ? 1 : -1); };
  auto fill = [&](int slot, int row) {
    hresize_row(src + static_cast<size_t>(row) * sw * c, c, tx, dw,
                rows.data() + slot * n);
    cached[slot] = row;
  };
  for (int y = 0; y < dh; ++y) {
    const int r0 = std::clamp(ty.ofs[y], 0, sh - 1);
    const int r1 = std::clamp(ty.ofs[y] + 1, 0, sh - 1);
    int s0 = find(r0);
    if (s0 < 0) {
      s0 = find(r1) == 0 ? 1 : 0;
      fill(s0, r0);
    }
    int s1 = find(r1);
    if (s1 < 0) {
      s1 = 1 - s0;
      fill(s1, r1);
    }
    const int* buf[2] = {rows.data() + s0 * n, rows.data() + s1 * n};
    const int b0 = ty.a0[y], b1 = ty.a1[y];
    uint8_t* o = dst + static_cast<size_t>(y) * n;
    for (size_t i = 0; i < n; ++i) {
      // cv2's vectorized vertical pass: 16-bit high products, then a
      // rounding shift by 2
      const int t = (((buf[0][i] >> 4) * b0) >> 16) +
                    (((buf[1][i] >> 4) * b1) >> 16);
      o[i] = sat_u8((t + 2) >> 2);
    }
  }
}

// uint8 HWC nearest resize, cv2.resize(..., INTER_NEAREST).
void resize_nearest_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  const double ifx = 1.0 / (static_cast<double>(dw) / sw);
  const double ify = 1.0 / (static_cast<double>(dh) / sh);
  std::vector<int> xs(dw);
  for (int x = 0; x < dw; ++x)
    xs[x] = std::min(static_cast<int>(std::floor(x * ifx)), sw - 1);
  for (int y = 0; y < dh; ++y) {
    const int sy = std::min(static_cast<int>(std::floor(y * ify)), sh - 1);
    const uint8_t* row = src + static_cast<size_t>(sy) * sw * c;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x)
      std::memcpy(out + static_cast<size_t>(x) * c,
                  row + static_cast<size_t>(xs[x]) * c, c);
  }
}

// Undo the PNG row filters: src holds height rows of (1 filter byte +
// rowbytes), dst gets height x rowbytes.  bpp: bytes per whole pixel.
// Returns 0, or the 1-based row of an unknown filter type.
int png_unfilter(const uint8_t* src, int height, int rowbytes, int bpp,
                 uint8_t* dst) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + static_cast<size_t>(y) * (rowbytes + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + static_cast<size_t>(y) * rowbytes;
    switch (type) {
      case 0:
        std::memcpy(out, in, rowbytes);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int cc = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - cc;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - cc);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
  }
  return 0;
}

// cv2.cvtColor(COLOR_BGR2HSV) on n uint8 BGR pixels.
void bgr2hsv_u8(const uint8_t* src, long long n, uint8_t* dst) {
  struct Tables {
    int sdiv[256], hdiv[256];
    Tables() {
      sdiv[0] = hdiv[0] = 0;
      for (int i = 1; i < 256; ++i) {
        sdiv[i] = static_cast<int>(std::nearbyint((255 << kHsvShift) / (1. * i)));
        hdiv[i] = static_cast<int>(std::nearbyint((180 << kHsvShift) / (6. * i)));
      }
    }
  };
  static const Tables tables;   // initialised once, thread-safe
  const int* sdiv = tables.sdiv;
  const int* hdiv = tables.hdiv;
  const int half = 1 << (kHsvShift - 1);
  for (long long i = 0; i < n; ++i) {
    const int b = src[3 * i], g = src[3 * i + 1], r = src[3 * i + 2];
    const int v = std::max(std::max(b, g), r);
    const int vmin = std::min(std::min(b, g), r);
    const int diff = v - vmin;
    const int s = (diff * sdiv[v] + half) >> kHsvShift;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * hdiv[diff] + half) >> kHsvShift;
    if (h < 0) h += 180;
    dst[3 * i] = static_cast<uint8_t>(h);
    dst[3 * i + 1] = static_cast<uint8_t>(s);
    dst[3 * i + 2] = static_cast<uint8_t>(v);
  }
}

// cv2.cvtColor(COLOR_HSV2BGR) on rows x width uint8 HSV pixels.
void hsv2bgr_u8(const uint8_t* src, int rows, int width, uint8_t* dst) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.f / 180.f, inv255 = 1.f / 255.f;
  const int body = width / kHsvBlock * kHsvBlock;
  for (int y = 0; y < rows; ++y) {
    for (int x = 0; x < width; ++x) {
      const uint8_t* p = src + (static_cast<size_t>(y) * width + x) * 3;
      uint8_t* o = dst + (static_cast<size_t>(y) * width + x) * 3;
      const float s = p[1] * inv255, v = p[2] * inv255;
      float h = p[0] * hscale;
      float bgr[3];
      if (x < body) {             // cv2's vector body
        const float pre = std::trunc(h);
        h -= pre;
        const float tab[4] = {v, v * (1.f - s), v * std::fma(-s, h, 1.f),
                              v * std::fma(-s, 1.f - h, 1.f)};
        int sector = static_cast<int>(pre - std::trunc(pre * (1.f / 6.f)) * 6.f);
        for (int k = 0; k < 3; ++k) bgr[k] = tab[sector_data[sector][k]];
        for (int k = 0; k < 3; ++k) {
          const float t = std::trunc(bgr[k] * 255.f);
          o[k] = static_cast<uint8_t>(t < 0.f ? 0.f : (t > 255.f ? 255.f : t));
        }
      } else {                    // cv2's scalar tail
        if (s == 0.f) {
          bgr[0] = bgr[1] = bgr[2] = v;
        } else {
          h = std::fmod(h, 6.f);
          if (h < 0.f) h += 6.f;
          int sector = static_cast<int>(std::floor(h));
          h -= sector;
          if (sector < 0 || sector >= 6) sector = 0, h = 0.f;
          const float tab[4] = {v, v * (1.f - s), v * std::fma(-s, h, 1.f),
                                v * std::fma(-s, 1.f - h, 1.f)};
          for (int k = 0; k < 3; ++k) bgr[k] = tab[sector_data[sector][k]];
        }
        for (int k = 0; k < 3; ++k) {
          const float t = std::nearbyint(bgr[k] * 255.f);
          o[k] = static_cast<uint8_t>(t < 0.f ? 0.f : (t > 255.f ? 255.f : t));
        }
      }
    }
  }
}

// Resize (sh, sw) -> (rh, rw), crop [cy, cy + ch) x [cx, cx + cw), and flip
// horizontally when `flip`: one pass over the crop's pixels.
void fused_resize_crop_flip_u8(const uint8_t* src, int sh, int sw, int c,
                               int rh, int rw, int cy, int cx, int ch, int cw,
                               int flip, int nearest, uint8_t* dst) {
  const double scale_y = static_cast<double>(sh) / rh;
  const double scale_x = static_cast<double>(sw) / rw;
  for (int y = 0; y < ch; ++y) {
    const int ry = y + cy;
    uint8_t* out = dst + static_cast<size_t>(y) * cw * c;
    if (nearest) {
      const int sy = std::min(static_cast<int>(ry * scale_y), sh - 1);
      const uint8_t* row = src + static_cast<size_t>(sy) * sw * c;
      for (int x = 0; x < cw; ++x) {
        const int rx = flip ? (cx + cw - 1 - x) : (x + cx);
        const int sx = std::min(static_cast<int>(rx * scale_x), sw - 1);
        std::memcpy(out + static_cast<size_t>(x) * c,
                    row + static_cast<size_t>(sx) * c, c);
      }
      continue;
    }
    const float sy = fused_src_coord(ry, scale_y);
    const int y0 = std::min(static_cast<int>(sy), sh - 1);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = sy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * c;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * c;
    for (int x = 0; x < cw; ++x) {
      const int rx = flip ? (cx + cw - 1 - x) : (x + cx);
      const float sx = fused_src_coord(rx, scale_x);
      const int x0 = std::min(static_cast<int>(sx), sw - 1);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float fx = sx - x0;
      const uint8_t* p00 = r0 + static_cast<size_t>(x0) * c;
      const uint8_t* p01 = r0 + static_cast<size_t>(x1) * c;
      const uint8_t* p10 = r1 + static_cast<size_t>(x0) * c;
      const uint8_t* p11 = r1 + static_cast<size_t>(x1) * c;
      for (int k = 0; k < c; ++k) {
        const float top = std::fma(static_cast<float>(p01[k] - p00[k]), fx,
                                   static_cast<float>(p00[k]));
        const float bot = std::fma(static_cast<float>(p11[k] - p10[k]), fx,
                                   static_cast<float>(p10[k]));
        const float v = std::fma(bot - top, wy, top);
        out[static_cast<size_t>(x) * c + k] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // extern "C"
