// BMP run-length decoding (BI_RLE8, BI_RLE4) as OpenCV 5.0's grfmt_bmp.cpp
// runs it under cv2.imdecode(buf, IMREAD_COLOR) (host code).
//
// The stream is a sequence of 16-bit codes (count, value):
//
//  * count > 0: an encoded run of `count` pixels, palette[value] for RLE8,
//    the two nibbles of `value` in turn for RLE4. A run that would pass the
//    end of its row fails the decode. An RLE8 run that ends exactly at the
//    end of its row moves to the next row (OpenCV fills it with FillUniColor)
//    and an end-of-line code right after it is then ignored; an RLE4 run
//    does not move on, and the end-of-line code after it does.
//  * 0, 0: end of line. The rest of the row takes palette entry 0.
//  * 0, 1: end of bitmap. RLE8: every pixel left takes palette entry 0.
//    RLE4: the same as end of line (cv2 5.0 adds no rows to the count).
//  * 0, 2, dx, dy: delta. The pixels skipped, counted in raster order and
//    running on over row ends, take palette entry 0. RLE4 skips dx pixels
//    only: dy is read and not used.
//  * 0, n > 2: an absolute run of n indices, padded to 16 bits. It fails the
//    decode when it would pass the end of its row.
//
// The decode ends, successfully, as soon as the last row is done, with or
// without an end-of-bitmap code. A code, delta or absolute run that needs
// bytes past the end of the data fails it ("Unexpected end of input
// stream"): OpenCV's memory stream cannot refill.
//
// C interface (ctypes):
//   int bmp_rle_decode(const uint8_t* data, int64_t n, int64_t offset,
//                      int32_t width, int32_t height, int32_t bits,
//                      const uint8_t* palette, uint8_t* out);
//     palette: 256 entries of 4 bytes (B, G, R, reserved), zero past the
//     file's colour table; out: height x width x 3 BGR, the stream's first
//     row first (the caller flips a bottom-up image).
//   Returns 0, 1 (the data ends before the image does) or 2 (a run passes
//   the end of its row).

#include <cstdint>
#include <cstring>

namespace {

enum Status { OK = 0, END_OF_DATA = 1, BAD_RUN = 2 };

struct EndOfData {};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  int byte() {
    if (p >= end) throw EndOfData();
    return *p++;
  }
  int word() {
    int lo = byte();
    return lo | (byte() << 8);
  }
  void bytes(uint8_t* dst, int64_t count) {
    if (end - p < count) throw EndOfData();
    std::memcpy(dst, p, count);
    p += count;
  }
};

inline void put(uint8_t* px, const uint8_t* clr) {
  px[0] = clr[0];
  px[1] = clr[1];
  px[2] = clr[2];
}

// OpenCV's FillUniColor: `count3` bytes of `clr` from `at`, running on into
// the next rows; moves to the next row whenever the current one is full.
int64_t fill_uni(uint8_t* out, int64_t at, int64_t& line_end, int64_t width3, int& y,
                 int height, int64_t count3, const uint8_t* clr) {
  do {
    int64_t end = at + count3;
    if (end > line_end) end = line_end;
    count3 -= end - at;
    for (; at < end; at += 3) put(out + at, clr);
    if (at >= line_end) {
      line_end += width3;
      at = line_end - width3;
      if (++y >= height) break;
    }
  } while (count3 > 0);
  return at;
}

Status rle8(Reader& r, int width, int height, const uint8_t* pal, uint8_t* out) {
  const int64_t width3 = int64_t(width) * 3;
  int64_t at = 0, line_end = width3;
  int y = 0, line_end_flag = 0;
  uint8_t src[256];
  for (;;) {
    int code = r.word();
    const int len = code & 255;
    code >>= 8;
    if (len != 0) {  // encoded run
      const int prev_y = y;
      if (at + int64_t(len) * 3 > line_end) return BAD_RUN;
      at = fill_uni(out, at, line_end, width3, y, height, int64_t(len) * 3, pal + 4 * code);
      line_end_flag = y - prev_y;
      if (y >= height) break;
    } else if (code > 2) {  // absolute run
      if (at + int64_t(code) * 3 > line_end) return BAD_RUN;
      r.bytes(src, (code + 1) & ~1);
      for (int i = 0; i < code; i++) put(out + at + 3 * i, pal + 4 * src[i]);
      at += int64_t(code) * 3;
      line_end_flag = 0;
    } else {  // end of line, end of bitmap or delta
      int64_t x_shift3 = line_end - at;
      int64_t y_shift = height - y;
      if (code || !line_end_flag || x_shift3 < width3) {
        if (code == 2) {
          x_shift3 = int64_t(r.byte()) * 3;
          y_shift = r.byte();
        }
        if (code != 0) x_shift3 += y_shift * width3;
        at = fill_uni(out, at, line_end, width3, y, height, x_shift3, pal);
        if (y >= height) break;
      }
      line_end_flag = 0;
    }
  }
  return OK;
}

Status rle4(Reader& r, int width, int height, const uint8_t* pal, uint8_t* out) {
  const int64_t width3 = int64_t(width) * 3;
  int64_t at = 0, line_end = width3;
  int y = 0;
  uint8_t src[256];
  for (;;) {
    int code = r.word();
    const int len = code & 255;
    code >>= 8;
    if (len != 0) {  // encoded run: the two nibbles in turn
      const uint8_t* clr[2] = {pal + 4 * (code >> 4), pal + 4 * (code & 15)};
      const int64_t end = at + int64_t(len) * 3;
      if (end > line_end) return BAD_RUN;
      int t = 0;
      do {
        put(out + at, clr[t]);
        t ^= 1;
      } while ((at += 3) < end);
    } else if (code > 2) {  // absolute run, high nibble first
      if (at + int64_t(code) * 3 > line_end) return BAD_RUN;
      r.bytes(src, (((code + 1) >> 1) + 1) & ~1);
      for (int i = 0; i < code; i++) {
        const int idx = (i & 1) ? src[i >> 1] & 15 : src[i >> 1] >> 4;
        put(out + at + 3 * i, pal + 4 * idx);
      }
      at += int64_t(code) * 3;
    } else {  // end of line, end of bitmap or delta: only the columns count
      int64_t x_shift3 = line_end - at;
      if (code == 2) {
        x_shift3 = int64_t(r.byte()) * 3;
        r.byte();  // dy, read and not used
      }
      at = fill_uni(out, at, line_end, width3, y, height, x_shift3, pal);
      if (y >= height) break;
    }
  }
  return OK;
}

}  // namespace

extern "C" {

int bmp_rle_decode(const uint8_t* data, int64_t n, int64_t offset, int32_t width, int32_t height,
                   int32_t bits, const uint8_t* palette, uint8_t* out) {
  Reader r{data + (offset < n ? offset : n), data + n};
  try {
    return bits == 8 ? rle8(r, width, height, palette, out) : rle4(r, width, height, palette, out);
  } catch (const EndOfData&) {
    return END_OF_DATA;
  }
}

}  // extern "C"
