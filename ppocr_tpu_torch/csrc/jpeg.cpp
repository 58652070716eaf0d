// Baseline JPEG decoder with libjpeg-turbo's arithmetic (host code).
//
// Decodes what cv2.imdecode(buf, IMREAD_COLOR) decodes through
// libjpeg-turbo for sequential 8-bit Huffman JPEGs (SOF0, SOF1), and gives
// the same pixels:
//
//  * the islow integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2)
//    with the post-IDCT range-limit table of jdmaster.c;
//  * jdsample.c's upsampling: "fancy" triangle filters for h2v1, h1v2 and
//    h2v2 (h2v1 and h2v2 fall back to replication when the component is
//    at most 2 samples wide), replication for other integral ratios; rows
//    above the first and below the last repeat the edge row (jdmainct.c);
//  * jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS 16) with range
//    limiting; written in BGR order;
//  * the colour space rule of jdapimin.c (JFIF -> YCbCr, Adobe transform
//    0 -> RGB, component ids 'R','G','B' -> RGB, else YCbCr); one
//    component is grey, written as three equal channels.
//
// It also reports the EXIF orientation from the first APP1 segment as
// OpenCV's ExifReader reads it; the caller applies the transform.
//
// Refused with a status code: progressive, lossless, arithmetic-coded and
// hierarchical frames, precision other than 8 bits, 2 or 4 components,
// non-integral sampling ratios, DNL heights. Truncated or corrupt data is
// refused as well (libjpeg would warn and fill in grey): every read is
// bounds-checked, every Huffman code and coefficient index validated.
//
// C interface (ctypes):
//   int jpeg_header(const uint8_t* data, int64_t n, int32_t info[3]);
//       info = {width, height, exif orientation (1..8, 0 when absent)}
//   int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap,
//                   int32_t info[3]);
//       out: height x width x 3 BGR, row-major, before the orientation;
//       info as above, the orientation from the whole stream
// Both return 0 on success or one of the Status codes below.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Status {
  OK = 0,
  CORRUPT = 1,
  TRUNCATED = 2,
  PROGRESSIVE = 3,
  ARITHMETIC = 4,
  LOSSLESS = 5,
  HIERARCHICAL = 6,
  PRECISION = 7,
  COMPONENTS = 8,
  SAMPLING = 9,
  DNL = 10,
  TOO_LARGE = 11,
  NO_FRAME = 12,
  SMALL_BUFFER = 13,
};

// zigzag position -> natural (row-major) index; 16 guard entries
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valoff[17];   // vals index of a length's first code minus that code
  uint16_t fast[1 << kLookBits];  // (length << 8) | symbol, 0 = slow path
};

bool build_huff(Huff& h, const uint8_t counts[17], const uint8_t* vals, int nvals) {
  std::memset(h.fast, 0, sizeof h.fast);
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    h.valoff[len] = k - code;
    int c = counts[len];
    if (c) {
      if (code + c > (1 << len)) return false;  // over-subscribed
      for (int i = 0; i < c; i++, k++, code++) {
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int f = 0; f < (1 << shift); f++)
            h.fast[(code << shift) | f] = uint16_t((len << 8) | vals[k]);
        }
      }
      h.maxcode[len] = code - 1;
    } else {
      h.maxcode[len] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
  return true;
}

// Entropy-coded data: byte stuffing removed, stops at a marker. Past the
// data it shifts in zero bits and counts them; consuming one is an error.
struct Bits {
  const uint8_t* d;
  int64_t n;
  int64_t pos;  // next byte
  int64_t mpos = -1, mend = -1;  // the marker: its first 0xFF, the byte after its code
  uint64_t acc = 0;  // bits, MSB first
  int nbits = 0;
  int fake = 0;  // zero bits appended past the data
  int marker = -1;  // the marker that ended the data, -1 before
  bool overrun = false;

  void fill() {
    while (nbits <= 56) {
      unsigned byte = 0;
      if (marker < 0 && pos < n) {
        byte = d[pos];
        if (byte != 0xFF) {
          pos++;
        } else {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;  // fill bytes
          if (q < n && d[q] == 0x00) {
            pos = q + 1;  // a stuffed 0xFF data byte
          } else {
            marker = q < n ? d[q] : 0x100;  // 0x100: the data ended
            mpos = pos;
            mend = q + 1;
            byte = 0;
            fake += 8;
          }
        }
      } else {
        fake += 8;
      }
      acc |= uint64_t(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  void consume(int k) {
    acc <<= k;
    nbits -= k;
    if (nbits < fake) overrun = true;
  }
  int get(int k) {  // k in 1..16, nbits >= k guaranteed by the caller
    int v = int(acc >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huff& h) {
    if (nbits < 32) fill();
    int e = h.fast[acc >> (64 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int code = int(acc >> (64 - 16));
    for (int len = kLookBits + 1; len <= 16; len++) {
      int c = code >> (16 - len);
      if (c <= h.maxcode[len]) {
        consume(len);
        return h.vals[h.valoff[len] + c];
      }
    }
    return -1;
  }
  // drop the buffered bits and find the marker after the data (skipping
  // any bytes left before it); false when the data ends first
  bool to_marker() {
    acc = 0;
    nbits = fake = 0;
    if (marker < 0) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)) pos++;
      if (pos + 1 >= n) return false;
      marker = d[pos + 1];
      mpos = pos;
      mend = pos + 2;
    }
    return marker != 0x100;
  }
  // past a restart marker: the data goes on
  void resume() {
    pos = mend;
    marker = -1;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int dw, dh;  // downsampled size (jdinput.c)
  int stride, rows;  // plane size in samples (whole MCUs)
  std::vector<uint8_t> plane;
  int pred = 0;
  bool scanned = false;
};

// jdmaster.c prepare_range_limit_table, seen from the IDCT's output:
// idct_limit[x & 1023] for the level-unshifted value x
struct RangeLimit {
  uint8_t idct[1024];
  uint8_t simple[768];  // simple[x + 256] = clamp(x, 0, 255)
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      idct[i] = uint8_t(v);
    }
    for (int i = 0; i < 768; i++) simple[i] = uint8_t(i < 256 ? 0 : i > 511 ? 255 : i - 256);
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = int(int64_t(int(in[0]) * int(qt[0])) * (1 << P1));
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int(in[16]) * int(qt[16]), z3 = int(in[48]) * int(qt[48]);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = int(in[0]) * int(qt[0]);
    z3 = int(in[32]) * int(qt[32]);
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(in[56]) * int(qt[56]);
    tmp1 = int(in[40]) * int(qt[40]);
    tmp2 = int(in[24]) * int(qt[24]);
    tmp3 = int(in[8]) * int(qt[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB - P1;
    constexpr int64_t R = int64_t(1) << (S - 1);
    w[0] = int((tmp10 + tmp3 + R) >> S);
    w[56] = int((tmp10 - tmp3 + R) >> S);
    w[8] = int((tmp11 + tmp2 + R) >> S);
    w[48] = int((tmp11 - tmp2 + R) >> S);
    w[16] = int((tmp12 + tmp1 + R) >> S);
    w[40] = int((tmp12 - tmp1 + R) >> S);
    w[24] = int((tmp13 + tmp0 + R) >> S);
    w[32] = int((tmp13 - tmp0 + R) >> S);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = kRange.idct[int((int64_t(w[0]) + (1 << (P1 + 2))) >> (P1 + 3)) & 1023];
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CB);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB + P1 + 3;
    constexpr int64_t R = int64_t(1) << (S - 1);
    o[0] = kRange.idct[int((tmp10 + tmp3 + R) >> S) & 1023];
    o[7] = kRange.idct[int((tmp10 - tmp3 + R) >> S) & 1023];
    o[1] = kRange.idct[int((tmp11 + tmp2 + R) >> S) & 1023];
    o[6] = kRange.idct[int((tmp11 - tmp2 + R) >> S) & 1023];
    o[2] = kRange.idct[int((tmp12 + tmp1 + R) >> S) & 1023];
    o[5] = kRange.idct[int((tmp12 - tmp1 + R) >> S) & 1023];
    o[3] = kRange.idct[int((tmp13 + tmp0 + R) >> S) & 1023];
    o[4] = kRange.idct[int((tmp13 - tmp0 + R) >> S) & 1023];
  }
}

struct Decoder {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;
  bool want_pixels;  // false: stop after the frame header

  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 0;
  bool app1_seen = false;
  int restart_interval = 0;
  int16_t qt[4][64];  // as libjpeg-turbo's SIMD builds keep them (ISLOW_MULT_TYPE short)
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[3];

  Decoder(const uint8_t* data, int64_t size, bool pixels) : d(data), n(size), want_pixels(pixels) {}

  int u16(int64_t at) const { return (d[at] << 8) | d[at + 1]; }

  // OpenCV's ExifReader on the first APP1: a TIFF header 6 bytes in,
  // IFD0's entries, tag 0x0112's first 16-bit value
  void read_exif(int64_t at, int64_t len) {
    if (app1_seen) return;
    app1_seen = true;
    if (len <= 6) return;
    const uint8_t* t = d + at + 6;
    int64_t tn = len - 6;
    if (tn < 8) return;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto g16 = [&](int64_t o) -> int { return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1]; };
    auto g32 = [&](int64_t o) -> uint32_t {
      return le ? uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) | (uint32_t(t[o + 2]) << 16) |
                      (uint32_t(t[o + 3]) << 24)
                : (uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) | (uint32_t(t[o + 2]) << 8) |
                      uint32_t(t[o + 3]);
    };
    int64_t ifd = g32(4);
    if (ifd + 2 > tn) return;
    int entries = g16(ifd);
    for (int i = 0; i < entries; i++) {
      int64_t e = ifd + 2 + 12 * int64_t(i);
      if (e + 12 > tn) return;
      if (g16(e) == 0x0112) {
        int o = g16(e + 8);
        orientation = (o >= 1 && o <= 8) ? o : 0;
        return;
      }
    }
  }

  int read_sof(int64_t at, int64_t len) {
    if (frame) return CORRUPT;  // one frame per image
    if (len < 6) return CORRUPT;
    if (d[at] != 8) return PRECISION;
    height = u16(at + 1);
    width = u16(at + 3);
    ncomp = d[at + 5];
    if (height == 0) return DNL;
    if (width == 0) return CORRUPT;
    if (ncomp == 4) return COMPONENTS;
    if (ncomp != 1 && ncomp != 3) return COMPONENTS;
    if (len < 6 + 3 * ncomp) return CORRUPT;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = d[at + 6 + 3 * i];
      c.h = d[at + 7 + 3 * i] >> 4;
      c.v = d[at + 7 + 3 * i] & 15;
      c.tq = d[at + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return CORRUPT;
      if (hmax < c.h) hmax = c.h;
      if (vmax < c.v) vmax = c.v;
    }
    if (int64_t(width) * height > (int64_t(1) << 30)) return TOO_LARGE;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return SAMPLING;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
    }
    frame = true;
    return OK;
  }

  int read_dqt(int64_t at, int64_t len) {
    int64_t end = at + len;
    while (at < end) {
      int pq = d[at] >> 4, tq = d[at] & 15;
      if (pq > 1 || tq > 3) return CORRUPT;
      int64_t need = 1 + 64 * (pq + 1);
      if (at + need > end) return CORRUPT;
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] = int16_t(pq ? u16(at + 1 + 2 * k) : d[at + 1 + k]);
      qt_defined[tq] = true;
      at += need;
    }
    return OK;
  }

  int read_dht(int64_t at, int64_t len) {
    int64_t end = at + len;
    while (at < end) {
      if (at + 17 > end) return CORRUPT;
      int tc = d[at] >> 4, th = d[at] & 15;
      if (tc > 1 || th > 3) return CORRUPT;
      uint8_t counts[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; i++) total += counts[i] = d[at + i];
      if (total > 256 || at + 17 + total > end) return CORRUPT;
      if (!build_huff(tc ? ac[th] : dc[th], counts, d + at + 17, total)) return CORRUPT;
      at += 17 + total;
    }
    return OK;
  }

  int decode_block(Bits& b, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof coef);
    int s = b.decode(dc[c.td]);
    if (s < 0 || s > 15) return CORRUPT;
    if (s) {
      if (b.nbits < 16) b.fill();
      c.pred += extend(b.get(s), s);
    }
    coef[0] = int16_t(c.pred);
    for (int k = 1; k < 64; k++) {
      int rs = b.decode(ac[c.ta]);
      if (rs < 0) return CORRUPT;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return CORRUPT;
        if (b.nbits < 16) b.fill();
        coef[kNatural[k]] = int16_t(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    if (b.overrun) return TRUNCATED;
    idct_islow(coef, qt[c.tq], c.plane.data() + int64_t(by) * 8 * c.stride + bx * 8, c.stride);
    return OK;
  }

  int read_scan(int64_t at, int64_t len) {
    if (!frame) return NO_FRAME;
    if (len < 1) return CORRUPT;
    int ns = d[at];
    if (ns < 1 || ns > ncomp || len < 4 + 2 * ns) return CORRUPT;
    Component* sc[3];
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; i++) {
      int id = d[at + 1 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) return CORRUPT;
      for (int j = 0; j < i; j++)
        if (sc[j] == c) return CORRUPT;
      c->td = d[at + 2 + 2 * i] >> 4;
      c->ta = d[at + 2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined) return CORRUPT;
      if (!qt_defined[c->tq]) return CORRUPT;
      sc[i] = c;
      blocks_per_mcu += c->h * c->v;
    }
    int64_t tail = at + 1 + 2 * ns;
    int ss = d[tail], se = d[tail + 1], ahal = d[tail + 2];
    if (ss != 0 || se != 63 || ahal != 0) return CORRUPT;  // not a sequential scan
    if (ns > 1 && blocks_per_mcu > 10) return CORRUPT;
    int64_t nmcu, per_row;
    if (ns == 1) {
      per_row = (sc[0]->dw + 7) / 8;
      nmcu = per_row * ((sc[0]->dh + 7) / 8);
      blocks_per_mcu = 1;
    } else {
      per_row = mcux;
      nmcu = int64_t(mcux) * mcuy;
    }
    // every block takes at least two bits (a DC and an AC code): a
    // header that promises more blocks than the data can hold is cut off
    if (nmcu * blocks_per_mcu * 2 > (n - (at + len)) * 8) return TRUNCATED;
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (c.plane.empty()) {
        try {
          c.plane.assign(size_t(c.stride) * c.rows, 0);
        } catch (const std::bad_alloc&) {
          return TOO_LARGE;
        }
      }
      c.pred = 0;
      c.scanned = true;
    }
    Bits b{d, n, at + len};
    int next_rst = 0;
    for (int64_t m = 0; m < nmcu; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        if (!b.to_marker()) return TRUNCATED;
        if (b.marker != 0xD0 + next_rst) return CORRUPT;
        b.resume();
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      }
      int mx = int(m % per_row), my = int(m / per_row);
      if (ns == 1) {
        int st = decode_block(b, *sc[0], mx, my);
        if (st) return st;
      } else {
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++) {
              int st = decode_block(b, c, mx * c.h + h, my * c.v + v);
              if (st) return st;
            }
        }
      }
    }
    if (!b.to_marker()) {
      pos = n;  // the data ends without a marker
      return OK;
    }
    pos = b.mpos;  // the marker loop reads it
    return OK;
  }

  // the marker loop; stops at EOI, at the end of the data, or after the
  // frame header when no pixels are wanted
  int run() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return CORRUPT;
    pos = 2;
    bool ended = false;
    while (!ended) {
      if (pos >= n) break;
      if (d[pos] != 0xFF) return CORRUPT;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) break;
      int m = d[pos++];
      if (m == 0xD9) {
        ended = true;
        break;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return CORRUPT;
      if (pos + 2 > n) break;
      int64_t len = u16(pos);
      if (len < 2 || pos + len > n) return TRUNCATED;
      int64_t at = pos + 2, body = len - 2;
      pos += len;
      int st = OK;
      if (m == 0xC0 || m == 0xC1) {
        st = read_sof(at, body);
        if (st == OK && !want_pixels) return OK;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        return m == 0xC2 ? PROGRESSIVE : m == 0xCA ? ARITHMETIC : HIERARCHICAL;
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        return m == 0xC3 ? LOSSLESS : m == 0xCB ? ARITHMETIC : HIERARCHICAL;
      } else if (m == 0xC5) {
        return HIERARCHICAL;
      } else if (m == 0xC9 || m == 0xCD || m == 0xCC) {
        return ARITHMETIC;
      } else if (m == 0xDE || m == 0xDF) {
        return HIERARCHICAL;
      } else if (m == 0xC4) {
        st = read_dht(at, body);
      } else if (m == 0xDB) {
        st = read_dqt(at, body);
      } else if (m == 0xDD) {
        if (body < 2) return CORRUPT;
        restart_interval = u16(at);
      } else if (m == 0xDC) {
        return DNL;
      } else if (m == 0xDA) {
        if (!want_pixels) return NO_FRAME;
        st = read_scan(at, body);
      } else if (m == 0xE0) {
        if (body >= 5 && std::memcmp(d + at, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xE1) {
        read_exif(at, body);
      } else if (m == 0xEE) {
        if (body >= 12 && std::memcmp(d + at, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[at + 11];
        }
      } else if ((m >= 0xE2 && m <= 0xEF) || m == 0xFE) {
        // other APPn and COM: skipped
      } else {
        return CORRUPT;  // an unknown marker
      }
      if (st) return st;
    }
    if (!frame) return want_pixels ? NO_FRAME : TRUNCATED;
    for (int i = 0; i < ncomp; i++)
      if (!comp[i].scanned) return TRUNCATED;
    return OK;
  }

  bool rgb_space() const {
    if (ncomp != 3 || jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // one component at full size, width x height (jdsample.c)
  void upsample(const Component& c, uint8_t* out) const {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int W = width, H = height, dw = c.dw, dh = c.dh;
    const uint8_t* p = c.plane.data();
    const int st = c.stride;
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; y++) std::memcpy(out + int64_t(y) * W, p + int64_t(y) * st, W);
    } else if (rh == 2 && rv == 1 && dw > 2) {
      for (int y = 0; y < H; y++) {
        const uint8_t* in = p + int64_t(y) * st;
        uint8_t* o = out + int64_t(y) * W;
        for (int x = 0; x < W; x++) {
          int i = x >> 1, v3 = 3 * in[i];
          if (x & 1) o[x] = uint8_t(i == dw - 1 ? in[i] : (v3 + in[i + 1] + 2) >> 2);
          else o[x] = uint8_t(i == 0 ? in[0] : (v3 + in[i - 1] + 1) >> 2);
        }
      }
    } else if (rh == 1 && rv == 2) {
      for (int y = 0; y < H; y++) {
        int i = y >> 1;
        int j = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
        int bias = (y & 1) ? 2 : 1;
        const uint8_t* a = p + int64_t(i) * st;
        const uint8_t* b = p + int64_t(j) * st;
        uint8_t* o = out + int64_t(y) * W;
        for (int x = 0; x < W; x++) o[x] = uint8_t((3 * a[x] + b[x] + bias) >> 2);
      }
    } else if (rh == 2 && rv == 2 && dw > 2) {
      std::vector<int> col(dw);
      for (int y = 0; y < H; y++) {
        int i = y >> 1;
        int j = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
        const uint8_t* a = p + int64_t(i) * st;
        const uint8_t* b = p + int64_t(j) * st;
        for (int k = 0; k < dw; k++) col[k] = 3 * a[k] + b[k];
        uint8_t* o = out + int64_t(y) * W;
        for (int x = 0; x < W; x++) {
          int k = x >> 1;
          int v;
          if (x & 1) v = k == dw - 1 ? (col[k] * 4 + 7) >> 4 : (col[k] * 3 + col[k + 1] + 7) >> 4;
          else v = k == 0 ? (col[0] * 4 + 8) >> 4 : (col[k] * 3 + col[k - 1] + 8) >> 4;
          o[x] = uint8_t(v);
        }
      }
    } else {  // replication (int_upsample, and h2v1 / h2v2 at dw <= 2)
      for (int y = 0; y < H; y++) {
        const uint8_t* in = p + int64_t(y / rv) * st;
        uint8_t* o = out + int64_t(y) * W;
        for (int x = 0; x < W; x++) o[x] = in[x / rh];
      }
    }
  }

  int write_bgr(uint8_t* out) const {
    const int64_t np = int64_t(width) * height;
    if (ncomp == 1) {
      std::vector<uint8_t> g(np);
      upsample(comp[0], g.data());
      for (int64_t i = 0; i < np; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return OK;
    }
    std::vector<uint8_t> ch[3];
    for (int k = 0; k < 3; k++) {
      ch[k].resize(np);
      upsample(comp[k], ch[k].data());
    }
    if (rgb_space()) {
      for (int64_t i = 0; i < np; i++) {
        out[3 * i] = ch[2][i];
        out[3 * i + 1] = ch[1][i];
        out[3 * i + 2] = ch[0][i];
      }
      return OK;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    const uint8_t* lim = kRange.simple + 256;
    for (int64_t i = 0; i < np; i++) {
      int y = ch[0][i], cb = ch[1][i], cr = ch[2][i];
      out[3 * i + 2] = lim[y + cr_r[cr]];
      out[3 * i + 1] = lim[y + int((cb_g[cb] + cr_g[cr]) >> SB)];
      out[3 * i] = lim[y + cb_b[cb]];
    }
    return OK;
  }
};

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, int64_t n, int32_t* info) {
  Decoder dec(data, n, false);
  int st = dec.run();
  if (st) return st;
  info[0] = dec.width;
  info[1] = dec.height;
  info[2] = dec.orientation;
  return OK;
}

int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* info) {
  Decoder dec(data, n, true);
  int st = dec.run();
  if (st) return st;
  info[0] = dec.width;
  info[1] = dec.height;
  info[2] = dec.orientation;
  if (cap < int64_t(dec.width) * dec.height * 3) return SMALL_BUFFER;
  try {
    return dec.write_bgr(out);
  } catch (const std::bad_alloc&) {
    return TOO_LARGE;
  }
}

}  // extern "C"
