// Radiance HDR scanlines (RGBE) as OpenCV 5.0's bundled rgbe.cpp reads them
// under cv2.imdecode(buf, IMREAD_COLOR), then converted to 8 bits as
// HdrDecoder::readData converts them (host code).
//
// The pixels follow the resolution line. A width below 8 or above 0x7fff
// is read flat: 4 bytes (R, G, B, E) per pixel. Otherwise each scanline
// opens with 4 bytes:
//
//  * 2, 2, then the width as 16 bits (high byte without its top bit): a
//    new-style run-length scanline. Each of the four channels in turn is a
//    sequence of (count, value) pairs: count > 128 is a run of count - 128
//    copies of value; 0 < count <= 128 is value followed by count - 1
//    literal bytes. A count of 0 (or 128 + 0), or one past the end of the
//    channel, fails the decode ("bad scanline data"), and so does another
//    width ("wrong scanline width").
//  * anything else: that pixel is read as a flat one, and so is every
//    pixel of the image after it (rgbe.cpp has no old-style run-length
//    codes).
//
// Bytes past the end of the data fail the decode. Bytes after the image are
// ignored.
//
// A pixel with E = 0 is black; otherwise each channel is
// m * 2^(E - 136) as a float, times 255 as a float, rounded as cvRound
// rounds (half to even; NaN, inf and anything at or past 2^31 give INT_MIN,
// which saturates to 0), saturated to 0..255. Channels come out B, G, R.
//
// C interface (ctypes):
//   int hdr_decode(const uint8_t* data, int64_t n, int64_t offset,
//                  int32_t width, int32_t height, uint8_t* out);
//     offset: the first byte after the resolution line; out: height x
//     width x 3 BGR, top row first.
//   Returns 0, 1 (the data ends before the image does), 2 (a scanline of
//   another width) or 3 (a run count of 0 or past the end of its channel).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { OK = 0, END_OF_DATA = 1, WRONG_WIDTH = 2, BAD_RUN = 3 };

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool bytes(uint8_t* dst, int64_t count) {
    if (end - p < count) return false;
    std::memcpy(dst, p, count);
    p += count;
    return true;
  }
};

inline uint8_t to_u8(float v) {
  if (!(std::fabs(v) < 2147483648.f)) return 0;
  const float r = std::nearbyint(v);  // the default rounding mode: half to even
  return r <= 0.f ? 0 : r >= 255.f ? 255 : uint8_t(r);
}

// out[e][m]: the 8-bit value of mantissa m under exponent e
struct Lut {
  uint8_t out[256][256];
  Lut() {
    for (int e = 0; e < 256; e++) {
      const float f = e ? float(std::ldexp(1.0, e - 136)) : 0.f;
      for (int m = 0; m < 256; m++) out[e][m] = e ? to_u8(float(m) * f * 255.f) : 0;
    }
  }
};

const Lut& lut() {
  static const Lut table;
  return table;
}

inline void convert(const uint8_t* rgbe, uint8_t* bgr) {
  const uint8_t* row = lut().out[rgbe[3]];
  bgr[0] = row[rgbe[2]];
  bgr[1] = row[rgbe[1]];
  bgr[2] = row[rgbe[0]];
}

Status flat(Reader& r, int64_t count, uint8_t* out) {
  uint8_t rgbe[4];
  for (int64_t i = 0; i < count; i++, out += 3) {
    if (!r.bytes(rgbe, 4)) return END_OF_DATA;
    convert(rgbe, out);
  }
  return OK;
}

}  // namespace

extern "C" {

int hdr_decode(const uint8_t* data, int64_t n, int64_t offset, int32_t width, int32_t height, uint8_t* out) {
  Reader r{data + (offset < n ? offset : n), data + n};
  if (width < 8 || width > 0x7fff) return flat(r, int64_t(width) * height, out);
  std::vector<uint8_t> line(size_t(width) * 4);
  for (int y = 0; y < height; y++) {
    uint8_t head[4];
    if (!r.bytes(head, 4)) return END_OF_DATA;
    if (head[0] != 2 || head[1] != 2 || (head[2] & 0x80)) {  // flat from here to the end
      convert(head, out);
      return flat(r, int64_t(width) * (height - y) - 1, out + 3);
    }
    if ((head[2] << 8 | head[3]) != width) return WRONG_WIDTH;
    uint8_t* ptr = line.data();
    for (int c = 0; c < 4; c++) {
      uint8_t* const ptr_end = line.data() + int64_t(c + 1) * width;
      while (ptr < ptr_end) {
        uint8_t code[2];
        if (!r.bytes(code, 2)) return END_OF_DATA;
        if (code[0] > 128) {
          const int count = code[0] - 128;
          if (count > ptr_end - ptr) return BAD_RUN;
          std::memset(ptr, code[1], count);
          ptr += count;
        } else {
          const int count = code[0];
          if (count == 0 || count > ptr_end - ptr) return BAD_RUN;
          *ptr++ = code[1];
          if (count > 1) {
            if (!r.bytes(ptr, count - 1)) return END_OF_DATA;
            ptr += count - 1;
          }
        }
      }
    }
    for (int x = 0; x < width; x++, out += 3) {
      const uint8_t rgbe[4] = {line[x], line[x + width], line[x + 2 * width], line[x + 3 * width]};
      convert(rgbe, out);
    }
  }
  return OK;
}

}  // extern "C"
