// Baseline JPEG decoding and encoding for the port's host library.
//
// The decoder reproduces libjpeg-turbo's default decode (what cv2.imread and
// PIL give), step for step:
//
// - baseline and extended sequential Huffman scans (SOF0, SOF1), 8-bit, one
//   or three components, interleaved or not, restart intervals, byte
//   stuffing and fill bytes; every block's coefficients are kept until the
//   last scan, so non-interleaved files decode too;
// - the "islow" integer inverse DCT of jidctint.c (13-bit constants, two
//   passes) with its range limit;
// - fancy (triangle-filter) upsampling of jdsample.c for h2v1, h1v2 and h2v2
//   chroma, box replication for other integral factors and for h2 planes of
//   two columns or fewer, edge columns and rows as libjpeg pads them;
// - the fixed-point YCbCr -> RGB tables of jdcolor.c, written out as BGR;
//   a YCbCr file read as gray gives its luma plane, an RGB file (Adobe
//   transform 0 or component ids 'R','G','B') its jdcolor.c luma formula.
//
// Progressive, arithmetic-coded, lossless, 12-bit and 4-component files are
// refused with a message naming the feature.  EXIF orientation is parsed
// here and applied by the caller.
//
// The encoder writes baseline files: JFIF, an optional EXIF orientation,
// libjpeg's quality-scaled Annex K quantization tables, the standard Huffman
// tables, 4:2:0 or 4:4:4 chroma (or one gray component), a float DCT.
//
// A plain C ABI (lednet_tpu_torch/native/__init__.py); every entry point
// returns 0 on success or writes a message into `err` (256 bytes) and
// returns a nonzero code.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kErrLen = 256;

// zigzag position -> natural (row-major) index; the 16 extra entries absorb
// a run past the last coefficient in corrupt data, as libjpeg's table does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// ------------------------------------------------------------ Huffman tables
constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[17];     // largest code of each length, -1 if none
  int32_t valoffset[17];
  // (code length << 8) | symbol for codes of kLookBits bits or fewer; 0 none
  uint16_t look[1 << kLookBits];

  void derive() {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lookbits = huffcode[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); ++c)
          look[lookbits + c] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
  }
};

// ------------------------------------------------------------ the bit reader
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int nbits = 0;
  int marker = 0;  // a marker met inside entropy-coded data (0: none yet)
  size_t marker_at = 0;  // where the parser resumes after it (its 0xFF)

  void fill() {
    while (nbits <= 56) {
      int c = 0;
      if (!marker) {
        if (pos >= size) {
          marker = 0xD9;  // data ends: libjpeg inserts zero bits
          marker_at = size;
        } else {
          c = data[pos++];
          if (c == 0xFF) {
            int c2;
            do {  // 0xFF fill bytes may precede a marker
              c2 = pos < size ? data[pos++] : 0xD9;
            } while (c2 == 0xFF);
            if (c2 == 0) {
              c = 0xFF;
            } else {
              marker = c2;
              marker_at = pos - 2;
              c = 0;
            }
          }
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - nbits);
      nbits += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }

  int decode(const HuffTable& t) {
    if (nbits < 16) fill();
    int peek = static_cast<int>(buf >> (64 - kLookBits));
    int entry = t.look[peek];
    if (entry) {
      int l = entry >> 8;
      buf <<= l;
      nbits -= l;
      return entry & 0xFF;
    }
    int l = kLookBits + 1;
    int code = static_cast<int>(buf >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int>(buf >> (64 - l));
    }
    if (l > 16) {  // corrupt data: libjpeg warns and takes symbol 0
      buf <<= 16;
      nbits -= 16;
      return 0;
    }
    buf <<= l;
    nbits -= l;
    return t.vals[code + t.valoffset[l]];
  }

  // Byte-align, then find and consume the next marker.
  int next_marker() {
    buf = 0;
    nbits = 0;
    if (marker) {
      int m = marker;
      marker = 0;
      return m;
    }
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return 0xD9;
      int c = data[pos++];
      if (c != 0) return c;
    }
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------- the decoder
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks allocated (MCU-padded)
  int wblocks = 0, hblocks = 0;  // blocks that hold image samples
  int dw = 0, dh = 0;          // downsampled width and height in samples
  int dc_table = 0, ac_table = 0;
  int dc_pred = 0;
  std::vector<int16_t> coefs;  // bh * bw blocks of 64, natural order
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  int width = 0, height = 0, ncomp = 0, precision = 8;
  int maxh = 1, maxv = 1, mcusx = 0, mcusy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false, frame = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool exif_seen = false;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  Component comp[3];
  size_t pos = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) fail("truncated JPEG header");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void parse_exif(size_t at, size_t len) {
    // APP1: "Exif\0\0", then a TIFF header and IFD0; tag 0x0112 is the
    // orientation.  Only the first EXIF segment counts.
    if (exif_seen || len < 14 || std::memcmp(data + at, "Exif\0\0", 6) != 0)
      return;
    exif_seen = true;
    const uint8_t* t = data + at + 6;
    size_t n = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](size_t o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      return le ? (t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                   (static_cast<uint32_t>(t[o + 3]) << 24))
                : ((static_cast<uint32_t>(t[o]) << 24) | (t[o + 1] << 16) |
                   (t[o + 2] << 8) | t[o + 3]);
    };
    if (rd16(2) != 42) return;
    uint32_t ifd = rd32(4);
    if (ifd + 2 > n) return;
    int count = rd16(ifd);
    for (int i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
      if (e + 12 > n) return;
      if (rd16(e) == 0x0112 && rd16(e + 2) == 3) {
        orientation = rd16(e + 8);
        return;
      }
    }
  }

  void read_sof() {
    if (frame) fail("JPEG with two frames");
    frame = true;
    int len = u16();
    size_t end = pos + len - 2;
    precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG precision is not supported "
           "(8-bit only)");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG (CMYK/YCCK) is not "
           "supported (1 or 3 components only)");
    if (height == 0) fail("JPEG with a DNL-defined height is not supported");
    if (width == 0) fail("JPEG of width 0");
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 ||
          comp[i].tq > 3)
        fail("bad JPEG sampling factors or table index");
      maxh = std::max(maxh, comp[i].h);
      maxv = std::max(maxv, comp[i].v);
    }
    mcusx = (width + 8 * maxh - 1) / (8 * maxh);
    mcusy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      // jdinput.c: ceil(image size * factor / max factor)
      c.dw = static_cast<int>((static_cast<long>(width) * c.h + maxh - 1) / maxh);
      c.dh = static_cast<int>((static_cast<long>(height) * c.v + maxv - 1) / maxv);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcusx * c.h;
      c.bh = mcusy * c.v;
      c.coefs.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    pos = end;
  }

  void read_dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = u8();
      int tq = pq_tq & 15;
      if (tq > 3) fail("bad JPEG quantization table index");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] =
            static_cast<uint16_t>((pq_tq >> 4) ? u16() : u8());
      qt_defined[tq] = true;
    }
    pos = end;
  }

  void read_dht() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad JPEG Huffman table index");
      HuffTable& t = tc ? ac[th] : dc[th];
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        t.bits[l] = static_cast<uint8_t>(u8());
        count += t.bits[l];
      }
      if (count > 256) fail("bad JPEG Huffman table");
      for (int i = 0; i < count; ++i) t.vals[i] = static_cast<uint8_t>(u8());
      t.derive();
      t.defined = true;
    }
    pos = end;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    const HuffTable& dct = dc[c.dc_table];
    const HuffTable& act = ac[c.ac_table];
    int s = br.decode(dct);
    int diff = s ? extend(br.get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get_bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void read_sos() {
    if (!frame) fail("JPEG scan before its frame header");
    int len = u16();
    size_t end = pos + len - 2;
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("bad JPEG scan header");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8();
      int tables = u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) found = &comp[j];
      if (!found) fail("JPEG scan names an unknown component");
      found->dc_table = tables >> 4;
      found->ac_table = tables & 15;
      if (found->dc_table > 3 || found->ac_table > 3 ||
          !dc[found->dc_table].defined || !ac[found->ac_table].defined)
        fail("JPEG scan uses an undefined Huffman table");
      sc[i] = found;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("bad spectral selection in a sequential JPEG scan");
    pos = end;

    BitReader br{data, size, pos};
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    int mcus_x, mcus_y;
    if (ns == 1) {  // non-interleaved: one block per MCU, image blocks only
      mcus_x = sc[0]->wblocks;
      mcus_y = sc[0]->hblocks;
    } else {
      mcus_x = mcusx;
      mcus_y = mcusy;
    }
    long total = static_cast<long>(mcus_x) * mcus_y;
    int todo = restart_interval;
    for (long m = 0; m < total; ++m) {
      if (restart_interval) {
        if (todo == 0) {
          int mk = br.next_marker();
          if (mk < 0xD0 || mk > 0xD7)
            fail("JPEG restart marker missing (corrupt data)");
          for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
          todo = restart_interval;
        }
        --todo;
      }
      int mx = static_cast<int>(m % mcus_x), my = static_cast<int>(m / mcus_x);
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(br, c,
                     &c.coefs[(static_cast<size_t>(my) * c.bw + mx) * 64]);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              size_t row = static_cast<size_t>(my) * c.v + by;
              size_t col = static_cast<size_t>(mx) * c.h + bx;
              decode_block(br, c, &c.coefs[(row * c.bw + col) * 64]);
            }
        }
      }
    }
    // the parser goes on at the marker that ended the scan's data
    pos = br.marker ? br.marker_at : br.pos;
  }

  // Parse the whole stream (headers only if `header_only`).
  void parse(bool header_only) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      // find the next marker, skipping fill bytes
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) break;
      int m = data[pos++];
      if (m == 0xD9) break;  // EOI
      // stuffed zeros and restart markers between segments, TEM: no body
      if (m == 0x00 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof();
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG is not supported (baseline only)");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG is not supported (baseline only)");
        case 0xC5:
          fail("hierarchical JPEG is not supported (baseline only)");
        case 0xC9:
        case 0xCC:
        case 0xCD:
          fail("arithmetic-coded JPEG is not supported (Huffman only)");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          int len = u16();
          restart_interval = u16();
          pos += len - 4;
          break;
        }
        case 0xDA:
          if (header_only) return;
          for (int i = 0; i < ncomp; ++i)
            if (!qt_defined[comp[i].tq])
              fail("JPEG component uses an undefined quantization table");
          read_sos();
          scanned = true;
          break;
        default: {
          int len = u16();
          if (len < 2) fail("bad JPEG marker length");
          size_t body = pos;
          if (m == 0xE0 && len >= 7 && body + 5 <= size &&
              std::memcmp(data + body, "JFIF\0", 5) == 0)
            jfif = true;
          if (m == 0xE1 && body + len - 2 <= size) parse_exif(body, len - 2);
          if (m == 0xEE && len >= 14 && body + 12 <= size &&
              std::memcmp(data + body, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[body + 11];
          }
          pos = body + len - 2;
        }
      }
      if (pos > size) fail("truncated JPEG file");
    }
    if (!frame) fail("JPEG without a frame header");
    if (!header_only && !scanned) fail("JPEG without image data");
  }

  // 0 gray, 1 YCbCr, 2 RGB (jdapimin.c default_decompress_parms)
  int color_space() const {
    if (ncomp == 1) return 0;
    if (jfif) return 1;
    if (adobe) return adobe_transform == 0 ? 2 : 1;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return 2;
    return 1;
  }
};

// ------------------------------------------------------- inverse DCT (islow)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr long FIX_0_298631336 = 2446;
constexpr long FIX_0_390180644 = 3196;
constexpr long FIX_0_541196100 = 4433;
constexpr long FIX_0_765366865 = 6270;
constexpr long FIX_0_899976223 = 7373;
constexpr long FIX_1_175875602 = 9633;
constexpr long FIX_1_501321110 = 12299;
constexpr long FIX_1_847759065 = 15137;
constexpr long FIX_1_961570560 = 16069;
constexpr long FIX_2_053119869 = 16819;
constexpr long FIX_2_562915447 = 20995;
constexpr long FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

// The post-IDCT range limit: the descaled value, centered on 0, to 0..255.
inline uint8_t idct_limit(long v) {
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jidctint.c jpeg_idct_islow: one 8x8 block of quantized coefficients
// (natural order) and its table -> 8x8 samples at out (row stride `stride`).
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  long ws[64];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    long* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      long dcval = static_cast<long>(ip[0]) * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
      continue;
    }
    long z2 = static_cast<long>(ip[16]) * qp[16];
    long z3 = static_cast<long>(ip[48]) * qp[48];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * (-FIX_1_847759065);
    long tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<long>(ip[0]) * qp[0];
    z3 = static_cast<long>(ip[32]) * qp[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<long>(ip[56]) * qp[56];
    tmp1 = static_cast<long>(ip[40]) * qp[40];
    tmp2 = static_cast<long>(ip[24]) * qp[24];
    tmp3 = static_cast<long>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    const long* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * FIX_0_541196100;
    long tmp2 = z1 + z3 * (-FIX_1_847759065);
    long tmp3 = z1 + z2 * FIX_0_765366865;
    long tmp0 = (wp[0] + wp[4]) * (1L << kConstBits);
    long tmp1 = (wp[0] - wp[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// One component's sample plane: (bh * 8) x (bw * 8), of which dh x dw hold
// the image.
std::vector<uint8_t> component_plane(const Component& c, const uint16_t* q) {
  size_t stride = static_cast<size_t>(c.bw) * 8;
  std::vector<uint8_t> plane(stride * c.bh * 8);
  for (int by = 0; by < c.hblocks; ++by)
    for (int bx = 0; bx < c.wblocks; ++bx)
      idct_islow(&c.coefs[(static_cast<size_t>(by) * c.bw + bx) * 64], q,
                 &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  return plane;
}

// ------------------------------------------------------------- upsampling
// Upsample one component plane to the full image grid (rows x out_w, with
// out_w >= width), as jdsample.c does.  Rows outside the component's dh are
// libjpeg's replicated context rows (clamped), and the first context row
// above the image is row 0.
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane,
                              const Component& c, int maxh, int maxv,
                              int width, int height, size_t& out_stride) {
  const size_t in_stride = static_cast<size_t>(c.bw) * 8;
  const int hf = maxh / c.h, vf = maxv / c.v;
  out_stride = static_cast<size_t>(c.dw) * hf + 8;
  std::vector<uint8_t> out(out_stride * height);
  auto row = [&](int y) {  // context row y of the component, clamped
    y = std::max(0, std::min(y, c.dh - 1));
    return &plane[static_cast<size_t>(y) * in_stride];
  };
  const int dw = c.dw;
  if (hf == 1 && vf == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(&out[y * out_stride], row(y), width);
  } else if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y);
      uint8_t* o = &out[y * out_stride];
      int v = in[0];
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        v = in[i] * 3;
        *o++ = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      *o++ = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
    }
  } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = (y & 1) ? row(iy + 1) : row(iy - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[y * out_stride];
      for (int i = 0; i < dw; ++i)
        o[i] = static_cast<uint8_t>((in0[i] * 3 + in1[i] + bias) >> 2);
    }
  } else if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = (y & 1) ? row(iy + 1) : row(iy - 1);
      uint8_t* o = &out[y * out_stride];
      int thiscol = in0[0] * 3 + in1[0];
      int nextcol = in0[1] * 3 + in1[1];
      *o++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int i = 2; i < dw; ++i) {
        nextcol = in0[i] * 3 + in1[i];
        *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
    }
  } else {  // int_upsample (and h2v1/h2v2 on planes of <= 2 columns)
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y / vf);
      uint8_t* o = &out[y * out_stride];
      for (int i = 0; i < dw; ++i)
        for (int k = 0; k < hf; ++k) *o++ = in[i];
    }
  }
  return out;
}

// ------------------------------------------------------- color conversion
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  long r_y[256], g_y[256], b_y[256];
  YccTables() {
    const int kScale = 16;
    const long half = 1L << (kScale - 1);
    auto fix = [&](double x) { return static_cast<long>(x * (1L << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + half;
    }
  }
};

const YccTables& ycc() {
  static const YccTables t;
  return t;
}

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

int decode_into(const uint8_t* src, size_t n, int gray_out, uint8_t* out,
                char* err) {
  try {
    Decoder d(src, n);
    d.parse(false);
    const int W = d.width, H = d.height;
    const int cs = d.color_space();
    const int needed = (gray_out && cs != 2) ? 1 : d.ncomp;
    std::vector<uint8_t> planes[3];
    size_t strides[3];
    for (int i = 0; i < needed; ++i) {
      Component& c = d.comp[i];
      if (d.maxh % c.h || d.maxv % c.v)
        fail("JPEG with non-integral sampling factors is not supported");
      std::vector<uint8_t> p = component_plane(c, d.qt[c.tq]);
      planes[i] = upsample(p, c, d.maxh, d.maxv, W, H, strides[i]);
    }
    const YccTables& t = ycc();
    const int oc = gray_out ? 1 : 3;
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * W * oc;
      const uint8_t* p0 = &planes[0][y * strides[0]];
      if (needed == 1) {
        if (gray_out) {
          std::memcpy(o, p0, W);
        } else {
          for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = p0[x];
        }
        continue;
      }
      const uint8_t* p1 = &planes[1][y * strides[1]];
      const uint8_t* p2 = &planes[2][y * strides[2]];
      if (cs == 2) {  // RGB file
        for (int x = 0; x < W; ++x) {
          if (gray_out) {
            o[x] = static_cast<uint8_t>(
                (t.r_y[p0[x]] + t.g_y[p1[x]] + t.b_y[p2[x]]) >> 16);
          } else {
            o[3 * x] = p2[x];
            o[3 * x + 1] = p1[x];
            o[3 * x + 2] = p0[x];
          }
        }
        continue;
      }
      for (int x = 0; x < W; ++x) {
        int yy = p0[x], cb = p1[x], cr = p2[x];
        o[3 * x + 2] = clamp_u8(yy + t.cr_r[cr]);
        o[3 * x + 1] = clamp_u8(
            yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * x] = clamp_u8(yy + t.cb_b[cb]);
      }
    }
    return 0;
  } catch (const JpegError& e) {
    std::snprintf(err, kErrLen, "%s", e.msg.c_str());
    return 1;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, kErrLen, "out of memory decoding a JPEG");
    return 2;
  }
}

// ---------------------------------------------------------------- encoder
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 Huffman tables: bits[1..16], then the values
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t len[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(len, 0, sizeof(len));
    int c = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        code[vals[p]] = static_cast<uint16_t>(c++);
        len[vals[p]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buf = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int bits) {
    for (int i = bits - 1; i >= 0; --i) {
      buf = (buf << 1) | ((v >> i) & 1);
      if (++n == 8) {
        out.push_back(static_cast<uint8_t>(buf));
        if (buf == 0xFF) out.push_back(0);
        buf = 0;
        n = 0;
      }
    }
  }
  void flush() {  // pad with 1-bits
    if (n) put((1u << (8 - n)) - 1, 8 - n);
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

// libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  quality = std::max(1, std::min(100, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    out[i] = static_cast<uint16_t>(std::max(1L, std::min(255L, t)));
  }
}

struct DctBasis {
  double c[8][8];  // c[u][x] = a(u) / 2 * cos((2x + 1) u pi / 16)
  DctBasis() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? std::sqrt(0.5) : 1.0) / 2.0 *
                  std::cos((2 * x + 1) * u * M_PI / 16.0);
  }
};

// Forward DCT of one 8x8 block of level-shifted samples, quantized.
void fdct_quant(const double* blk, const uint16_t* q, int* out) {
  static const DctBasis b;
  double tmp[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += b.c[u][x] * blk[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += b.c[v][y] * tmp[y * 8 + u];
      out[v * 8 + u] = static_cast<int>(std::lround(s / q[v * 8 + u]));
    }
}

int bit_size(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int* coef, int& pred,
                  const EncTable& dct, const EncTable& act) {
  int diff = coef[0] - pred;
  pred = coef[0];
  int s = bit_size(diff);
  bw.put(dct.code[s], dct.len[s]);
  if (s) bw.put(diff < 0 ? diff + (1 << s) - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(act.code[0xF0], act.len[0xF0]);
      run -= 16;
    }
    s = bit_size(v);
    int sym = (run << 4) | s;
    bw.put(act.code[sym], act.len[sym]);
    bw.put(v < 0 ? v + (1 << s) - 1 : v, s);
    run = 0;
  }
  if (run) bw.put(act.code[0], act.len[0]);
}

}  // namespace

extern "C" {

// Header of a JPEG in memory: info = [width, height, components,
// color space (0 gray, 1 YCbCr, 2 RGB), EXIF orientation (1 if none),
// max h, max v, then h, v per component (3 slots)].
int jpeg_header(const uint8_t* src, long long n, int* info, char* err) {
  try {
    Decoder d(src, static_cast<size_t>(n));
    d.parse(true);
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    info[3] = d.color_space();
    info[4] = d.orientation;
    info[5] = d.maxh;
    info[6] = d.maxv;
    for (int i = 0; i < 3; ++i) {
      info[7 + 2 * i] = i < d.ncomp ? d.comp[i].h : 0;
      info[8 + 2 * i] = i < d.ncomp ? d.comp[i].v : 0;
    }
    return 0;
  } catch (const JpegError& e) {
    std::snprintf(err, kErrLen, "%s", e.msg.c_str());
    return 1;
  }
}

// Decode to (height, width, 3) BGR, or (height, width) gray when `gray`,
// before any EXIF orientation.
int jpeg_decode(const uint8_t* src, long long n, int gray, uint8_t* out,
                char* err) {
  return decode_into(src, static_cast<size_t>(n), gray, out, err);
}

// The entropy-decoded, still quantized coefficients: for each component in
// frame order, its (MCU-padded) block rows x block columns x 64 in natural
// order, concatenated into `coefs`; `qtables` gets each component's table
// (3 x 64, natural order).
int jpeg_coefficients(const uint8_t* src, long long n, int16_t* coefs,
                      uint16_t* qtables, char* err) {
  try {
    Decoder d(src, static_cast<size_t>(n));
    d.parse(false);
    size_t off = 0;
    for (int i = 0; i < d.ncomp; ++i) {
      const Component& c = d.comp[i];
      std::memcpy(coefs + off, c.coefs.data(), c.coefs.size() * 2);
      off += c.coefs.size();
      std::memcpy(qtables + 64 * i, d.qt[c.tq], 128);
    }
    return 0;
  } catch (const JpegError& e) {
    std::snprintf(err, kErrLen, "%s", e.msg.c_str());
    return 1;
  }
}

// Encode (height, width, channels) pixels (channels 3: BGR, 1: gray) as a
// baseline JPEG.  subsample: 1 for 4:2:0 chroma, 0 for 4:4:4.  orientation
// 1-8 writes an EXIF segment with that tag; 0 writes none.  Returns the
// byte count written into `out` (capacity `cap`), or a negative count when
// `out` is too small.
long long jpeg_encode(const uint8_t* src, int height, int width, int channels,
                      int quality, int subsample, int orientation,
                      uint8_t* out, long long cap) {
  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(height) * width * channels / 4 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  // APP0 JFIF 1.01, no density units, aspect 1:1
  const uint8_t app0[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1,
                          0,    0,    1, 0,  1,   0,   0};
  o.insert(o.end(), app0, app0 + sizeof(app0));
  if (orientation >= 1 && orientation <= 8) {
    // APP1 Exif, big-endian TIFF, IFD0 with one SHORT entry: 0x0112
    const uint8_t app1[] = {
        0xFF, 0xE1, 0, 34, 'E', 'x', 'i', 'f', 0, 0,
        'M', 'M', 0, 42, 0, 0, 0, 8,                   // TIFF header
        0, 1,                                          // one entry
        0x01, 0x12, 0, 3, 0, 0, 0, 1,                  // orientation SHORT x1
        0, static_cast<uint8_t>(orientation), 0, 0,    // its value
        0, 0, 0, 0};                                   // no next IFD
    o.insert(o.end(), app1, app1 + sizeof(app1));
  }
  uint16_t ql[64], qc[64];
  scaled_table(kStdLumaQ, quality, ql);
  scaled_table(kStdChromaQ, quality, qc);
  const int ntab = channels == 3 ? 2 : 1;
  o.push_back(0xFF);
  o.push_back(0xDB);
  put16(o, 2 + 65 * ntab);
  for (int t = 0; t < ntab; ++t) {
    o.push_back(static_cast<uint8_t>(t));
    const uint16_t* q = t ? qc : ql;
    for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>(q[kNatural[k]]));
  }
  const int ncomp = channels == 3 ? 3 : 1;
  const int hs = (ncomp == 3 && subsample) ? 2 : 1;
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back(static_cast<uint8_t>(ncomp));
  for (int i = 0; i < ncomp; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(static_cast<uint8_t>(i == 0 ? (hs << 4) | hs : 0x11));
    o.push_back(static_cast<uint8_t>(i == 0 ? 0 : 1));
  }
  auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, 3 + 16 + count);
    o.push_back(static_cast<uint8_t>((cls << 4) | id));
    for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
    o.insert(o.end(), vals, vals + count);
  };
  dht(0, 0, kDcLumaBits, kDcLumaVals);
  dht(1, 0, kAcLumaBits, kAcLumaVals);
  if (ncomp == 3) {
    dht(0, 1, kDcChromaBits, kDcChromaVals);
    dht(1, 1, kAcChromaBits, kAcChromaVals);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * ncomp);
  o.push_back(static_cast<uint8_t>(ncomp));
  for (int i = 0; i < ncomp; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(static_cast<uint8_t>(i == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  // color planes (YCbCr, float), edge-replicated to whole MCUs
  const int mw = 8 * hs, mh = 8 * hs;
  const int mcusx = (width + mw - 1) / mw, mcusy = (height + mh - 1) / mh;
  const int pw = mcusx * mw, ph = mcusy * mh;
  std::vector<double> plane[3];
  for (int i = 0; i < ncomp; ++i) plane[i].resize(static_cast<size_t>(pw) * ph);
  for (int y = 0; y < ph; ++y) {
    int sy = std::min(y, height - 1);
    for (int x = 0; x < pw; ++x) {
      int sx = std::min(x, width - 1);
      const uint8_t* p = src + (static_cast<size_t>(sy) * width + sx) * channels;
      size_t at = static_cast<size_t>(y) * pw + x;
      if (ncomp == 1) {
        plane[0][at] = p[0];
      } else {
        double b = p[0], g = p[1], r = p[2];
        plane[0][at] = 0.299 * r + 0.587 * g + 0.114 * b;
        plane[1][at] = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0;
        plane[2][at] = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0;
      }
    }
  }
  static const EncTable dcl(kDcLumaBits, kDcLumaVals), acl(kAcLumaBits, kAcLumaVals);
  static const EncTable dcc(kDcChromaBits, kDcChromaVals),
      acc(kAcChromaBits, kAcChromaVals);
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  double blk[64];
  int coef[64];
  for (int my = 0; my < mcusy; ++my)
    for (int mx = 0; mx < mcusx; ++mx) {
      for (int by = 0; by < hs; ++by)
        for (int bx = 0; bx < hs; ++bx) {
          int x0 = mx * mw + bx * 8, y0 = my * mh + by * 8;
          for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x)
              blk[y * 8 + x] =
                  plane[0][static_cast<size_t>(y0 + y) * pw + x0 + x] - 128.0;
          fdct_quant(blk, ql, coef);
          encode_block(bw, coef, pred[0], dcl, acl);
        }
      for (int c = 1; c < ncomp; ++c) {
        int x0 = mx * mw, y0 = my * mh;
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) {
            double s = 0;
            for (int dy = 0; dy < hs; ++dy)
              for (int dx = 0; dx < hs; ++dx)
                s += plane[c][static_cast<size_t>(y0 + y * hs + dy) * pw + x0 +
                              x * hs + dx];
            blk[y * 8 + x] = s / (hs * hs) - 128.0;
          }
        fdct_quant(blk, qc, coef);
        encode_block(bw, coef, pred[c], dcc, acc);
      }
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  if (static_cast<long long>(o.size()) > cap)
    return -static_cast<long long>(o.size());
  std::memcpy(out, o.data(), o.size());
  return static_cast<long long>(o.size());
}

}  // extern "C"
