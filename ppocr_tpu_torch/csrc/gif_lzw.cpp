// GIF image data (the LZW code size byte, then sub-blocks of LZW codes) as
// OpenCV 5.0's grfmt_gif.cpp reads the first frame under
// cv2.imdecode(buf, IMREAD_COLOR) (host code).
//
// Codes are read least significant bit first, one byte at a time: a byte is
// fetched only when fewer bits are left than the code size, and the codes
// those bits complete are decoded before the next byte. The minimum code
// size must be 2..11 (the first code size 3..12).
//
//  * clear: the table is emptied and the code size reset.
//  * end of information: the same, and the codes left in the bits already
//    fetched are dropped; reading goes on with the next byte, so codes after
//    it still count.
//  * a literal (below clear) or a table entry: the entry pending since the
//    last code gets its last byte (the first byte of this code's string;
//    a code equal to the pending entry is its own first byte doubled, the
//    KwKwK case), and this code's string starts the next pending entry. A
//    code past the pending entry fails the decode. The table stops growing
//    at 4096 entries; the code size grows by one when the pending entry
//    reaches 1 << size, up to 12.
//  * once the image's pixel count is reached, a code (other than clear and
//    end of information) only adds one to the count: it is not looked up
//    and the table does not grow. Reading a further byte with the count past
//    the image fails the decode, and so does a code whose string runs past
//    the end of the image before that.
//
// The sub-blocks run to a zero length byte; a byte past the end of the data
// fails the decode, and so does a pixel count short of the image at the end.
// Pixel values are bytes: a literal above 255 (code sizes past 9) keeps its
// low 8 bits.
//
// The screen is then filled with the background colour and the indices
// painted onto it: rows in the interlaced order (every 8th from 0, every
// 8th from 4, every 4th from 2, every 2nd from 1) when the frame is
// interlaced; a pixel of the transparent index keeps the background; an
// index outside the colour tables fails the decode.
//
// C interface (ctypes):
//   int gif_frame(const uint8_t* data, int64_t n, int64_t offset,
//                 int32_t width, int32_t height, int32_t interlaced,
//                 const uint8_t* colours, const uint8_t* known,
//                 int32_t transparent, const uint8_t* background,
//                 uint8_t* screen, int32_t screen_width,
//                 int32_t screen_height, int32_t left, int32_t top);
//     offset: the LZW minimum code size byte; colours: 256 BGR entries;
//     known: 256 flags, the entries the tables hold; transparent: the
//     transparent index or -1; background: one BGR colour; screen:
//     screen_height x screen_width x 3 BGR, the frame at (left, top)
//     inside it. The screen is written only on success.
//   Returns 0, 1 (the data ends first), 2 (a code size outside 2..11),
//   3 (a code past the table), 4 (a string past the end of the image),
//   5 (more codes than pixels), 6 (fewer pixels than the image) or 7 (an
//   index outside the colour tables).

#include <cstdint>
#include <vector>

namespace {

enum Status { OK = 0, END_OF_DATA = 1, BAD_CODE_SIZE = 2, BAD_CODE = 3, STRING_PAST_END = 4, TOO_MANY = 5,
              TOO_FEW = 6, UNKNOWN_INDEX = 7 };

constexpr int kTable = 4096;

Status lzw(const uint8_t* data, int64_t n, int64_t offset, int64_t pixels, uint8_t* out) {
  const uint8_t* p = data + (offset < n ? offset : n);
  const uint8_t* const end = data + n;
  if (p >= end) return END_OF_DATA;
  const int min_size = *p++;
  if (min_size < 2 || min_size > 11) return BAD_CODE_SIZE;
  const int clear = 1 << min_size, eoi = clear + 1;
  // entry k > eoi: the string of code prev[k] followed by last[k]; first[k]
  // is its first byte and len[k] its length. The pending entry (index
  // `size`) has prev, first and len but no last byte yet.
  std::vector<int> prev(kTable + 1), len(kTable + 1);
  std::vector<uint8_t> first(kTable + 1), last(kTable + 1);
  int size = eoi, code_size = min_size + 1;
  int64_t idx = 0;
  int left = 0;
  uint32_t bits = 0;
  if (p >= end) return END_OF_DATA;
  int block = *p++;
  while (block) {
    if (idx > pixels) return TOO_MANY;
    if (left < code_size) {
      if (p >= end) return END_OF_DATA;
      bits |= uint32_t(*p++) << left;
      block--;
      left += 8;
    }
    while (left >= code_size) {
      const int code = bits & ((1u << code_size) - 1);
      bits >>= code_size;
      left -= code_size;
      if (code == clear || code == eoi) {
        size = eoi;
        code_size = min_size + 1;
        if (code == clear) continue;
        break;
      }
      if (idx >= pixels) {  // past the image: counted only
        idx++;
        continue;
      }
      // this code's first byte and length
      int c_first, c_len;
      if (code < clear) {
        c_first = code & 255;
        c_len = 1;
      } else if (code < size || size >= kTable || (code == size && size > eoi)) {
        // a complete entry, or the pending one (KwKwK): its length already
        // counts the last byte, which is its own first byte
        c_first = first[code];
        c_len = len[code];
      } else {
        return BAD_CODE;
      }
      if (size < kTable) {  // the pending entry is complete; this code's string is the next one's prefix
        last[size] = uint8_t(c_first);
        size++;
        prev[size] = code;
        first[size] = uint8_t(c_first);
        len[size] = c_len + 1;
      }
      if (c_len > 1 && idx + c_len > pixels) return STRING_PAST_END;
      // write the string back to front
      int64_t at = idx + c_len - 1;
      int c = code;
      if (code >= clear) {
        for (; c > eoi; c = prev[c]) out[at--] = last[c];
      }
      out[at] = uint8_t(c & 255);
      idx += c_len;
      if (size == (1 << code_size) && code_size < 12) code_size++;
    }
    if (block == 0) {
      if (p >= end) return END_OF_DATA;
      block = *p++;
    }
  }
  return idx < pixels ? TOO_FEW : OK;
}

}  // namespace

extern "C" {

int gif_frame(const uint8_t* data, int64_t n, int64_t offset, int32_t width, int32_t height, int32_t interlaced,
              const uint8_t* colours, const uint8_t* known, int32_t transparent, const uint8_t* background,
              uint8_t* screen, int32_t screen_width, int32_t screen_height, int32_t left, int32_t top) {
  std::vector<uint8_t> idx(int64_t(width) * height);
  const Status status = lzw(data, n, offset, int64_t(width) * height, idx.data());
  if (status != OK) return status;
  for (const uint8_t v : idx)
    if (!known[v] && v != transparent) return UNKNOWN_INDEX;
  const int64_t pitch = int64_t(screen_width) * 3;
  for (int64_t i = 0; i < pitch * screen_height; i += 3) {
    screen[i] = background[0];
    screen[i + 1] = background[1];
    screen[i + 2] = background[2];
  }
  static const int kPasses[4][2] = {{0, 8}, {4, 8}, {2, 4}, {1, 2}};
  const uint8_t* src = idx.data();
  for (int pass = 0; pass < (interlaced ? 4 : 1); pass++) {
    const int y0 = interlaced ? kPasses[pass][0] : 0, dy = interlaced ? kPasses[pass][1] : 1;
    for (int y = y0; y < height; y += dy, src += width) {
      uint8_t* row = screen + (int64_t(top) + y) * pitch + int64_t(left) * 3;
      for (int x = 0; x < width; x++) {
        if (src[x] == transparent) continue;
        const uint8_t* c = colours + 3 * src[x];
        row[3 * x] = c[0];
        row[3 * x + 1] = c[1];
        row[3 * x + 2] = c[2];
      }
    }
  }
  return OK;
}

}  // extern "C"
