// JPEG decoder after libjpeg-turbo 3.1 as OpenCV 5.0's imdecode drives it
// (host code).
//
// Decodes what cv2.imdecode(buf, IMREAD_COLOR) decodes for 8-bit lossy
// JPEGs -- sequential and progressive Huffman (SOF0, SOF1, SOF2) and
// sequential and progressive arithmetic coding (SOF9, SOF10) -- and gives
// the same pixels:
//
//  * jdmarker.c's marker reader: bytes before a marker are skipped, RSTn
//    and TEM between segments are ignored, DNL is skipped, unknown APPn and
//    COM are skipped by their length; the header errors of jdmarker.c and
//    jdinput.c stop the decode;
//  * jdhuff.c's sequential decoder with its 64-bit bit buffer (fast path
//    and all), jdphuff.c's progressive passes (DC first / refine, AC first /
//    refine with EOB runs), jdarith.c's QM decoder with DAC conditioning;
//    a bad Huffman code decodes as 0, a run past coefficient 63 lands on
//    jpeg_natural_order's padding entry, restart markers are resynced as
//    jpeg_resync_to_restart does, and after a marker in the entropy data
//    the rest of the segment is zeros, all as libjpeg does with a warning;
//  * jdcoefct.c's block smoothing of a progressive image whose first AC
//    coefficients are not all known to full precision;
//  * the islow integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2) in
//    the 16-bit lanes of libjpeg-turbo's SIMD version, which cv2's build
//    runs;
//  * jdsample.c's upsampling: "fancy" triangle filters for h2v1, h1v2 and
//    h2v2 (h2v1 and h2v2 fall back to replication when the component is
//    at most 2 samples wide), replication for other integral ratios; rows
//    above the first and below the last repeat the edge row (jdmainct.c);
//  * jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK (SCALEBITS 16)
//    with range limiting, then OpenCV's CMYK -> BGR for four components;
//  * the colour space rule of jdapimin.c (JFIF -> YCbCr, Adobe transform
//    0 -> RGB / CMYK, 2 -> YCCK, component ids 'R','G','B' -> RGB, else
//    YCbCr); one component is grey, written as three equal channels.
//
// The end of the data decides, as it does for cv2: OpenCV's memory source
// cannot refill, so a read past the end of the buffer makes cv2.imdecode
// return None. A single-scan (sequential interleaved) image is refused when
// any of its MCUs, the Huffman decoder's look-ahead included (jdhuff.c
// jpeg_fill_bit_buffer fills to MIN_GET_BITS = 57 bits unless it meets a
// marker), needs a byte past the end; what follows the last MCU is never
// read. A multi-scan image (progressive, or components in separate scans)
// is refused unless EOI is reached: jpeg_start_decompress reads the whole
// file before any output.
//
// It also reports the EXIF orientation from the first APP1 segment before
// the first scan as OpenCV's ExifReader reads it; the caller applies it.
//
// A second entry decodes one strip or tile of a JPEG-compressed TIFF
// (compression 7) as libtiff 4.7's tif_jpeg.c drives libjpeg-turbo under
// OpenCV's TIFFReadRGBAStrip / TIFFReadRGBATile (see jpeg_tiff.h): the same
// Decoder, with libtiff's source and rules in place of OpenCV's:
//
//  * the source inserts a fake EOI whenever the data runs out
//    (std_fill_input_buffer), so a cut block decodes as far as it goes and
//    the rest of its scan is zeros; a skip past the end lands on a fresh
//    fake EOI (std_skip_input_data); APP1 is skipped, not saved;
//  * the quantization and Huffman tables persist from the JPEGTables tag
//    and from block to block (jpeg_abort keeps them), the standard Huffman
//    tables included once jinit_huff_decoder has installed them; OpenCV's
//    own rule for files without any DHT does not apply;
//  * JPEGPreDecode's checks of the frame against the strip or tile;
//  * no colour space from the JFIF or Adobe markers: contiguous YCbCr is
//    converted to RGB by libjpeg (JPEGCOLORMODE_RGB, fancy upsampling), any
//    other image gets its components as stored (JCS_UNKNOWN, null_convert),
//    interleaved, at libtiff's row pitch.
//
// Refused with a status code, as cv2 refuses them on the repo's cases:
// lossless and hierarchical frames, a precision other than 8 bits, 2 or
// more than 4 components, non-integral sampling ratios.
//
// C interface (ctypes):
//   int jpeg_header(const uint8_t* data, int64_t n, int32_t info[3]);
//       info = {width, height, exif orientation (1..8, 0 when absent)}
//   int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap,
//                   int32_t info[3]);
//       out: height x width x 3 BGR, row-major, before the orientation;
//       info as above
//   jpeg_tiff_tables, jpeg_tiff_block: see jpeg_tiff.h
// All return 0 on success or one of the Status codes below.

#include <climits>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "jpeg_tiff.h"

namespace {

enum Status {
  OK = 0,
  CORRUPT = 1,
  TRUNCATED = 2,
  NO_SCAN = 3,
  LOSSLESS = 5,
  HIERARCHICAL = 6,
  PRECISION = 7,
  COMPONENTS = 8,
  SAMPLING = 9,
  EMPTY = 10,
  TOO_LARGE = 11,
  NO_FRAME = 12,
  SMALL_BUFFER = 13,
  FRAME = 14,   // TIFF: a frame larger than its strip or tile
  TABLES = 15,  // TIFF: JPEGTables that are not a tables-only stream
};

struct Fail {
  int status;
};
[[noreturn]] void fail(int status) { throw Fail{status}; }

// jutils.c jpeg_natural_order: zigzag position -> natural index, with 16
// padding entries for runs that go past the end of a block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// -- Huffman tables ---------------------------------------------------------

struct HuffTable {
  bool defined = false;
  uint8_t bits[17];
  uint8_t vals[256];
};

// jstdhuff.c: the tables a file without DHT is decoded with (tables 0, 1)
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},       // DC 0
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},       // DC 1
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},    // AC 0
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};   // AC 1
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// jaricom.c jpeg_aritab (Table D.2): Qe << 16 | next MPS << 8 | switch << 7
// | next LPS; entry 113 is the fixed 0.5 estimate
#define V(qe, lps, mps, sw) ((int32_t(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int32_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

constexpr int kLookahead = 8;  // jdhuff.h HUFF_LOOKAHEAD

// jdhuff.c d_derived_tbl
struct Derived {
  int64_t maxcode[18];
  int64_t valoffset[18];
  int lookup[1 << kLookahead];  // (length << 8) | symbol; length 9: longer
  uint8_t vals[256];
};

// jstdhuff.c add_huff_table: the standard table tblno (0 or 1) where none
// was defined
void std_table(HuffTable* tables, bool dc, int tblno) {
  HuffTable& t = tables[tblno];
  if (t.defined) return;
  std::memcpy(t.bits, kStdBits[(dc ? 0 : 2) + tblno], 17);
  std::memset(t.vals, 0, sizeof t.vals);
  if (dc) {
    for (int i = 0; i < 12; i++) t.vals[i] = uint8_t(i);
  } else {
    std::memcpy(t.vals, kStdAcVals[tblno], 162);
  }
  t.defined = true;
}

// jdhuff.c jpeg_make_d_derived_tbl
void make_derived(const HuffTable* tables, bool dc, int tblno, Derived* derived) {
  if (tblno < 0 || tblno >= 4 || !tables[tblno].defined) fail(CORRUPT);
  const HuffTable& t = tables[tblno];
  Derived& d = derived[tblno];
  char size[257];
  unsigned code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l];
    if (p + i > 256) fail(CORRUPT);
    while (i--) size[p++] = char(l);
  }
  size[p] = 0;
  const int nsym = p;
  unsigned code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code_of[p++] = code;
      code++;
    }
    if (int64_t(code) >= (int64_t(1) << si)) fail(CORRUPT);  // no all-ones code
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      d.valoffset[l] = int64_t(p) - int64_t(code_of[p]);
      p += t.bits[l];
      d.maxcode[l] = code_of[p - 1];
    } else {
      d.maxcode[l] = -1;
    }
  }
  d.valoffset[17] = 0;
  d.maxcode[17] = 0xFFFFF;
  for (int i = 0; i < (1 << kLookahead); i++) d.lookup[i] = (kLookahead + 1) << kLookahead;
  p = 0;
  for (int l = 1; l <= kLookahead; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int look = int(code_of[p]) << (kLookahead - l);
      for (int c = 1 << (kLookahead - l); c > 0; c--) d.lookup[look++] = (l << kLookahead) | t.vals[p];
    }
  }
  if (dc)
    for (int i = 0; i < nsym; i++)
      if (t.vals[i] > 15) fail(CORRUPT);
  std::memcpy(d.vals, t.vals, 256);
}

inline int huff_extend(int x, int s) { return x < (1 << (s - 1)) ? x + int(unsigned(-1) << s) + 1 : x; }

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  static constexpr int SB = 16;
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
  }
};

// -- IDCT and sample range ---------------------------------------------------

// jdmaster.c prepare_range_limit_table's "simple" part:
// simple[x + 384] = clamp(x, 0, 255) for x in [-384, 640)
struct RangeLimit {
  uint8_t simple[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int x = i - 384;
      simple[i] = uint8_t(x < 0 ? 0 : x > 255 ? 255 : x);
    }
  }
};
const RangeLimit kRange;
const YccTables kYcc;

// The islow IDCT as libjpeg-turbo's SIMD builds compute it
// (jidctint-sse2.asm / jidctint-avx2.asm, the same arithmetic): jidctint.c's
// algorithm in 16-bit lanes. Dequantization keeps the low 16 bits of each
// product (pmullw), the sums in0 +- in4, in3 + in7 and in1 + in5 wrap at 16
// bits (paddw), the products and their sums are 32-bit (pmaddwd, paddd),
// each pass ends saturated to 16 bits (packssdw) and the output saturated
// to 8 bits (packsswb) and shifted by 128. When rows 1-7 of the block are
// all zero, pass 1 is in0 * q << 2 in 16 bits. On data a valid file can
// hold none of this overflows and the result is the C version's; on
// corrupt data it is what cv2 returns.
inline int32_t wrap16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
inline int32_t sat16(int32_t x) { return x > 32767 ? 32767 : x < -32768 ? -32768 : x; }

// one 8-point pass on 16-bit inputs; out before the descale. Each product
// and each sum of two products fits in 32 bits (pmaddwd); the sums after
// them wrap at 32 bits (paddd), done here in unsigned arithmetic
void idct_pass(const int32_t* in, uint32_t* out) {
  const int32_t z2 = in[2], z3 = in[6];
  const uint32_t tmp3 = uint32_t(z2 * 10703 + z3 * 4433);   // F_0_541 + F_0_765, F_0_541
  const uint32_t tmp2 = uint32_t(z2 * 4433 + z3 * -10704);  // F_0_541, F_0_541 - F_1_847
  const uint32_t tmp0 = uint32_t(wrap16(in[0] + in[4]) * 8192);
  const uint32_t tmp1 = uint32_t(wrap16(in[0] - in[4]) * 8192);
  const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int32_t o3 = wrap16(in[3] + in[7]), o4 = wrap16(in[1] + in[5]);
  const uint32_t z3p = uint32_t(o3 * -6436 + o4 * 9633);  // F_1_175 - F_1_961, F_1_175
  const uint32_t z4p = uint32_t(o3 * 9633 + o4 * 6437);   // F_1_175, F_1_175 - F_0_390
  const int32_t i1 = in[1], i3 = in[3], i5 = in[5], i7 = in[7];
  const uint32_t t0 = uint32_t(i7 * -4927 + i1 * -7373) + z3p;
  const uint32_t t3 = uint32_t(i7 * -7373 + i1 * 4926) + z4p;
  const uint32_t t1 = uint32_t(i5 * -4176 + i3 * -20995) + z4p;
  const uint32_t t2 = uint32_t(i5 * -20995 + i3 * 4177) + z3p;
  out[0] = tmp10 + t3;
  out[7] = tmp10 - t3;
  out[1] = tmp11 + t2;
  out[6] = tmp11 - t2;
  out[2] = tmp12 + t1;
  out[5] = tmp12 - t1;
  out[3] = tmp13 + t0;
  out[4] = tmp13 - t0;
}

// a pass's output after its rounding descale (arithmetic shift, as psrad)
inline int32_t descale(uint32_t x, int shift) { return int32_t(x + (1u << (shift - 1))) >> shift; }

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];  // pass 1's 16-bit results, row-major
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; k++) ac_zero = coef[k] == 0;
  int32_t in[8];
  uint32_t o[8];
  for (int c = 0; c < 8; c++) {
    if (ac_zero) {
      const int32_t dc = wrap16(wrap16(int32_t(coef[c]) * q[c]) * 4);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      continue;
    }
    bool col_zero = true;
    for (int r = 1; r < 8 && col_zero; r++) col_zero = coef[8 * r + c] == 0;
    if (col_zero) {  // the full pass with in[1..7] = 0: in[0] * 4, saturated
      const int32_t dc = sat16(wrap16(int32_t(coef[c]) * q[c]) * 4);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      continue;
    }
    for (int r = 0; r < 8; r++) in[r] = wrap16(int32_t(coef[8 * r + c]) * q[8 * r + c]);
    idct_pass(in, o);
    for (int r = 0; r < 8; r++) ws[8 * r + c] = sat16(descale(o[r], 11));
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* px = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      // the full pass with w[1..7] = 0: (w[0] + 16) >> 5, saturated
      const int32_t v = (w[0] + 16) >> 5;
      const uint8_t p = uint8_t((v > 127 ? 127 : v < -128 ? -128 : v) + 128);
      for (int c = 0; c < 8; c++) px[c] = p;
      continue;
    }
    idct_pass(w, o);
    for (int c = 0; c < 8; c++) {
      const int32_t v = sat16(descale(o[c], 18));
      px[c] = uint8_t((v > 127 ? 127 : v < -128 ? -128 : v) + 128);
    }
  }
}

// -- the decoder ---------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int wblocks = 0, hblocks = 0;  // width_in_blocks, height_in_blocks
  int bw = 0, bh = 0;            // the coefficient buffer, padded to whole MCUs
  int dw = 0, dh = 0;            // downsampled_width, downsampled_height
  int last_row_height = 1;
  bool latched = false;
  int16_t qt[64];  // the latched table, as libjpeg-turbo's SIMD builds keep it (short)
  std::vector<int16_t> coef;  // bh x bw blocks of 64, natural order
  std::vector<uint8_t> plane;  // bh * 8 rows of bw * 8 samples
  int16_t* block(int row, int col) { return coef.data() + (int64_t(row) * bw + col) * 64; }
};

constexpr int kMinGetBits = 57;  // jdhuff.h MIN_GET_BITS for a 64-bit bit buffer
constexpr int kFastBytesPerBlock = 512;  // jdhuff.c BUFSIZE: DCTSIZE2 * 8

enum MarkerResult { REACHED_SOS, REACHED_EOI, REACHED_SOF };

struct Decoder {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;  // the source's next byte

  // markers (jdmarker.c)
  int unread_marker = 0;
  bool saw_SOI = false, saw_SOF = false, in_headers = true;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int orientation = 0;
  bool app1_seen = false;
  int restart_interval = 0;
  int next_restart_num = 0;
  uint16_t qtab[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc_tbl[4], ac_tbl[4];
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];

  // frame
  int precision = 0, width = 0, height = 0, ncomp = 0;
  bool progressive = false, arith = false, lossless = false;
  std::vector<Component> comp;
  int hmax = 1, vmax = 1, total_imcu_rows = 0;
  bool multi_scan = false;
  std::vector<int> coef_bits;  // progressive: [2 * ncomp][64], this scan's and the one before
  int input_scan_number = 0;
  int last_good_imcu_row = 0;

  // scan
  int comps_in_scan = 0;
  Component* cur[4] = {nullptr, nullptr, nullptr, nullptr};
  int Ss = 0, Se = 0, Ah = 0, Al = 0;
  int blocks_in_mcu = 0;
  int mcus_per_row = 0;

  // entropy state (jdhuff.c / jdphuff.c)
  uint64_t get_buffer = 0;
  int bits_left = 0;
  bool insufficient = false;
  int restarts_to_go = 0;
  int last_dc[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  Derived dc_der[4], ac_der[4];
  const Derived* dc_cur[10];
  const Derived* ac_cur[10];
  int membership[10];

  // arithmetic decoding (jdarith.c)
  int64_t a_c = 0, a_a = 0;
  int a_ct = 0;
  int dc_context[4] = {0, 0, 0, 0};
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4];

  bool tiff = false;  // libtiff's source and rules (jpeg_tiff_block)

  Decoder(const uint8_t* data, int64_t size) : d(data), n(size) {
    fixed_bin[0] = 113;
    for (int i = 0; i < 16; i++) {
      arith_dc_L[i] = 0;
      arith_dc_U[i] = 1;
      arith_ac_K[i] = 5;
    }
  }

  // -- the source: it fails where OpenCV's would have to refill; libtiff's
  // inserts a fake EOI each time (tif_jpeg.c std_fill_input_buffer)
  int byte() {
    if (pos >= n) {
      if (!tiff) fail(TRUNCATED);
      return (pos++ - n) & 1 ? 0xD9 : 0xFF;
    }
    return d[pos++];
  }
  int two() {
    int a = byte();
    return (a << 8) | byte();
  }
  void skip(int64_t k) {
    if (!tiff) {
      pos = k > n - pos ? n : pos + k;  // OpenCV skip_input_data
      return;
    }
    // tif_jpeg.c std_skip_input_data: past what the buffer holds (the data,
    // or a fake EOI), a fresh fake EOI
    const int64_t left = pos < n ? n - pos : 2 - ((pos - n) & 1);
    pos += k > left ? left : k;
  }

  // jdmarker.c next_marker: skips anything up to FF xx, xx not 0 or FF
  void next_marker() {
    int c;
    for (;;) {
      c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker = c;
  }

  // OpenCV's ExifReader on the first APP1: a TIFF header 6 bytes in,
  // IFD0's entries, tag 0x0112's first 16-bit value
  void read_exif(int64_t at, int64_t len) {
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

  void get_sof(bool is_prog, bool is_lossless, bool is_arith) {
    if (saw_SOF) fail(CORRUPT);
    progressive = is_prog;
    lossless = is_lossless;
    arith = is_arith;
    int64_t length = two();
    precision = byte();
    height = two();
    width = two();
    ncomp = byte();
    length -= 8;
    if (height <= 0 || width <= 0 || ncomp <= 0) fail(EMPTY);
    if (length != ncomp * 3) fail(CORRUPT);
    comp.assign(ncomp, Component());
    for (Component& c : comp) {
      c.id = byte();
      int hv = byte();
      c.h = (hv >> 4) & 15;
      c.v = hv & 15;
      c.tq = byte();
    }
    saw_SOF = true;
  }

  void get_sos() {
    if (!saw_SOF) fail(NO_FRAME);
    int length = two();
    int ns = byte();
    if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail(CORRUPT);
    comps_in_scan = ns;
    for (int i = 0; i < 4; i++) cur[i] = nullptr;
    for (int i = 0; i < ns; i++) {
      int cc = byte();
      int c = byte();
      Component* found = nullptr;
      for (int ci = 0; ci < ncomp && ci < 4; ci++) {
        if (cc == comp[ci].id && !cur[ci]) {
          found = &comp[ci];
          break;
        }
      }
      if (!found) fail(CORRUPT);
      cur[i] = found;
      found->td = (c >> 4) & 15;
      found->ta = c & 15;
      for (int pi = 0; pi < i; pi++)
        if (cur[pi] == found) fail(CORRUPT);
    }
    Ss = byte();
    Se = byte();
    int c = byte();
    Ah = (c >> 4) & 15;
    Al = c & 15;
    next_restart_num = 0;
    input_scan_number++;
  }

  // start_pass of jdphuff.c / jdarith.c: the coefficients' known bits,
  // and the state before this scan for block smoothing
  void update_coef_bits() {
    for (int ci = 0; ci < comps_in_scan; ci++) {
      const size_t cindex = size_t(cur[ci] - comp.data());
      int* bits = &coef_bits[cindex * 64];
      int* prev = &coef_bits[(cindex + ncomp) * 64];
      for (int k = Ss < 1 ? Ss : 1; k <= (Se > 9 ? Se : 9); k++) prev[k] = input_scan_number > 1 ? bits[k] : 0;
      for (int k = Ss; k <= Se; k++) bits[k] = Al;
    }
  }

  void get_dht() {
    int64_t length = two() - 2;
    while (length > 16) {
      int index = byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) count += bits[i] = uint8_t(byte());
      length -= 17;
      if (count > 256 || count > length) fail(CORRUPT);
      uint8_t vals[256];
      std::memset(vals, 0, sizeof vals);
      for (int i = 0; i < count; i++) vals[i] = uint8_t(byte());
      length -= count;
      HuffTable* t;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) fail(CORRUPT);
        t = &ac_tbl[index];
      } else {
        if (index < 0 || index >= 4) fail(CORRUPT);
        t = &dc_tbl[index];
      }
      std::memcpy(t->bits, bits, 17);
      std::memcpy(t->vals, vals, 256);
      t->defined = true;
    }
    if (length != 0) fail(CORRUPT);
  }

  void get_dqt() {
    int64_t length = two() - 2;
    while (length > 0) {
      length--;
      int nq = byte();
      int prec = nq >> 4;
      nq &= 15;
      if (nq >= 4) fail(CORRUPT);
      for (int i = 0; i < 64; i++) qtab[nq][kNatural[i]] = uint16_t(prec ? two() : byte());
      qt_defined[nq] = true;
      length -= 64;
      if (prec) length -= 64;
    }
    if (length != 0) fail(CORRUPT);
  }

  void get_dac() {
    int64_t length = two() - 2;
    while (length > 0) {
      int index = byte();
      int val = byte();
      length -= 2;
      if (index < 0 || index >= 32) fail(CORRUPT);
      if (index >= 16) {
        arith_ac_K[index - 16] = uint8_t(val);
      } else {
        arith_dc_L[index] = uint8_t(val & 15);
        arith_dc_U[index] = uint8_t(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail(CORRUPT);
      }
    }
    if (length != 0) fail(CORRUPT);
  }

  // APP0 and APP14: the first 14 bytes are looked at, the rest skipped
  void get_interesting_appn(int m) {
    int64_t length = two() - 2;
    int numtoread = length >= 14 ? 14 : length > 0 ? int(length) : 0;
    uint8_t b[14];
    for (int i = 0; i < numtoread; i++) b[i] = uint8_t(byte());
    length -= numtoread;
    if (!in_headers) {
      // the colour space was chosen at the first scan
    } else if (m == 0xE0) {
      if (numtoread >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
    } else if (numtoread >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    if (length > 0) skip(length);
  }

  // APP1: saved whole (OpenCV asks libjpeg to keep it for its ExifReader)
  void save_app1() {
    int64_t length = two() - 2;
    if (length < 0) return;
    if (length > n - pos) fail(TRUNCATED);
    if (!app1_seen && in_headers) {
      app1_seen = true;
      read_exif(pos, length);
    }
    pos += length;
  }

  void skip_variable() {
    int64_t length = two() - 2;
    if (length > 0) skip(length);
  }

  // jdmarker.c read_markers: up to SOS or EOI (or SOF when asked)
  MarkerResult read_markers(bool stop_at_sof) {
    for (;;) {
      if (unread_marker == 0) {
        if (!saw_SOI) {
          int c = byte(), c2 = byte();
          if (c != 0xFF || c2 != 0xD8) fail(CORRUPT);
          unread_marker = c2;
        } else {
          next_marker();
        }
      }
      const int m = unread_marker;
      switch (m) {
        case 0xD8:
          if (saw_SOI) fail(CORRUPT);
          saw_SOI = true;
          break;
        case 0xC0:
        case 0xC1: get_sof(false, false, false); break;
        case 0xC2: get_sof(true, false, false); break;
        case 0xC3: get_sof(false, true, false); break;
        case 0xC9: get_sof(false, false, true); break;
        case 0xCA: get_sof(true, false, true); break;
        case 0xCB: get_sof(false, true, true); break;
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF: fail(HIERARCHICAL);
        case 0xC8: fail(CORRUPT);  // JPG, reserved
        case 0xDA:
          get_sos();
          unread_marker = 0;
          return REACHED_SOS;
        case 0xD9:
          unread_marker = 0;
          return REACHED_EOI;
        case 0xCC: get_dac(); break;
        case 0xC4: get_dht(); break;
        case 0xDB: get_dqt(); break;
        case 0xDD:
          if (two() != 4) fail(CORRUPT);
          restart_interval = two();
          break;
        case 0xE0:
        case 0xEE: get_interesting_appn(m); break;
        case 0xE1:
          if (tiff) skip_variable();  // libtiff saves no markers
          else save_app1();
          break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01:
          break;  // parameterless
        case 0xDC: skip_variable(); break;  // DNL
        default:
          if ((m >= 0xE2 && m <= 0xEF) || m == 0xFE) {
            skip_variable();
            break;
          }
          fail(CORRUPT);  // DHP, EXP, JPGn, RESn
      }
      unread_marker = 0;
      if (stop_at_sof && saw_SOF) return REACHED_SOF;
    }
  }

  // jdinput.c initial_setup, at the first SOS
  void initial_setup() {
    if (height > 65500 || width > 65500) fail(TOO_LARGE);
    if (lossless) fail(LOSSLESS);
    if (precision != 8) fail(PRECISION);
    if (ncomp > 10) fail(COMPONENTS);
    for (Component& c : comp) {
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) fail(SAMPLING);
      if (hmax < c.h) hmax = c.h;
      if (vmax < c.v) vmax = c.v;
    }
    for (Component& c : comp) {
      c.wblocks = int((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hblocks = int((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.wblocks + c.h - 1) / c.h * c.h;
      c.bh = (c.hblocks + c.v - 1) / c.v * c.v;
      int t = c.hblocks % c.v;
      c.last_row_height = t ? t : c.v;
    }
    total_imcu_rows = (height + 8 * vmax - 1) / (8 * vmax);
    multi_scan = comps_in_scan < ncomp || progressive;
  }

  // what jpeg_start_decompress checks for IMREAD_COLOR before the first
  // scan's data: a colour conversion to BGR (or CMYK for 4 components), an
  // upsampling method for each component, then the buffers
  void master_selection() {
    if (!tiff && ncomp != 1 && ncomp != 3 && ncomp != 4) fail(COMPONENTS);  // JCS_UNKNOWN takes any count
    for (Component& c : comp)
      if (hmax % c.h || vmax % c.v) fail(SAMPLING);
    if (!tiff && int64_t(width) * height > (int64_t(1) << 30)) fail(TOO_LARGE);  // OpenCV's own limit
    // OpenCV loads the standard Huffman tables when tables 0 and 1 are all
    // missing (Motion-JPEG frames); jinit_huff_decoder fills in any of them
    // for a sequential Huffman file; the progressive decoder does neither
    const bool none = !tiff && !dc_tbl[0].defined && !dc_tbl[1].defined && !ac_tbl[0].defined && !ac_tbl[1].defined;
    if (none || (!progressive && !arith)) {
      for (int t = 0; t < 2; t++) {
        std_table(dc_tbl, true, t);
        std_table(ac_tbl, false, t);
      }
    }
    for (Component& c : comp) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    if (progressive) coef_bits.assign(size_t(ncomp) * 2 * 64, -1);
  }

  // jdinput.c start_input_pass: per_scan_setup, latch_quant_tables, and
  // the entropy decoder's start_pass
  void start_input_pass() {
    if (comps_in_scan == 1) {
      Component* c = cur[0];
      mcus_per_row = c->wblocks;
      blocks_in_mcu = 1;
      membership[0] = 0;
    } else {
      mcus_per_row = (width + 8 * hmax - 1) / (8 * hmax);
      blocks_in_mcu = 0;
      for (int ci = 0; ci < comps_in_scan; ci++) {
        int k = cur[ci]->h * cur[ci]->v;
        if (blocks_in_mcu + k > 10) fail(CORRUPT);
        while (k-- > 0) membership[blocks_in_mcu++] = ci;
      }
    }
    for (int ci = 0; ci < comps_in_scan; ci++) {
      Component* c = cur[ci];
      if (c->latched) continue;
      if (c->tq < 0 || c->tq >= 4 || !qt_defined[c->tq]) fail(CORRUPT);
      for (int k = 0; k < 64; k++) c->qt[k] = int16_t(qtab[c->tq][k]);
      c->latched = true;
    }
    if (arith) start_pass_arith();
    else if (progressive) start_pass_phuff();
    else start_pass_huff();
  }

  // -- Huffman bit reading (jdhuff.c)

  // jpeg_fill_bit_buffer: to MIN_GET_BITS bits, or up to a marker; past a
  // marker, zeros when nbits are wanted that the buffer does not hold
  void fill(int nbits) {
    if (unread_marker == 0) {
      while (bits_left < kMinGetBits) {
        int c = byte();
        if (c == 0xFF) {
          do c = byte(); while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            goto no_more_bytes;
          }
        }
        get_buffer = (get_buffer << 8) | unsigned(c);
        bits_left += 8;
      }
      return;
    }
  no_more_bytes:
    if (nbits > bits_left) {
      insufficient = true;
      get_buffer <<= kMinGetBits - bits_left;
      bits_left = kMinGetBits;
    }
  }
  void check(int nbits) {
    if (bits_left < nbits) fill(nbits);
  }
  int get_bits(int k) {
    bits_left -= k;
    return int(get_buffer >> bits_left) & ((1 << k) - 1);
  }
  // HUFF_DECODE with jpeg_huff_decode behind it
  int huff_decode(const Derived& t) {
    int nb;
    if (bits_left < kLookahead) {
      fill(0);
      if (bits_left < kLookahead) {
        nb = 1;
        return huff_decode_slow(t, nb);
      }
    }
    int look = int(get_buffer >> (bits_left - kLookahead)) & ((1 << kLookahead) - 1);
    nb = t.lookup[look] >> kLookahead;
    if (nb <= kLookahead) {
      bits_left -= nb;
      return t.lookup[look] & 0xFF;
    }
    return huff_decode_slow(t, nb);
  }
  int huff_decode_slow(const Derived& t, int l) {
    check(l);
    int64_t code = get_bits(l);
    while (code > t.maxcode[l]) {
      code <<= 1;
      check(1);
      code |= get_bits(1);
      l++;
    }
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  // decode_mcu_fast's reads: 6 bytes whenever 16 bits or fewer are left; a
  // marker makes the MCU start over on the slow path. libjpeg-turbo reads
  // with no end check (BUFSIZE bytes per block remain); a block of stuffed
  // FF 00 bytes could outrun that, so the end also sends it to the slow path
  bool fast_marker = false;
  int64_t fast_pos = 0;
  void fast_fill() {
    if (bits_left > 16) return;
    for (int i = 0; i < 6; i++) {
      if (fast_pos >= n) {  // zeros, as after a marker; the MCU is redone
        fast_marker = true;
        get_buffer <<= 8;
        bits_left += 8;
        continue;
      }
      int c0 = d[fast_pos++];
      int c1 = fast_pos < n ? d[fast_pos] : 0;
      get_buffer = (get_buffer << 8) | unsigned(c0);
      bits_left += 8;
      if (c0 == 0xFF) {
        fast_pos++;
        if (c1 != 0) {
          fast_marker = true;
          fast_pos -= 2;
          get_buffer &= ~uint64_t(0xFF);
        }
      }
    }
  }
  int huff_decode_fast(const Derived& t) {
    fast_fill();
    int look = int(get_buffer >> (bits_left - kLookahead)) & ((1 << kLookahead) - 1);
    int s = t.lookup[look];
    int nb = s >> kLookahead;
    bits_left -= nb;
    s &= 0xFF;
    if (nb > kLookahead) {
      int64_t code = int64_t(get_buffer >> bits_left) & ((int64_t(1) << nb) - 1);
      while (code > t.maxcode[nb]) {
        code = (code << 1) | get_bits(1);
        nb++;
      }
      s = nb > 16 ? 0 : t.vals[(code + t.valoffset[nb]) & 0xFF];
    }
    return s;
  }

  // jdhuff.c decode_mcu_slow / decode_mcu_fast in one: FAST reads as the
  // fast path does and gives up (false) when it meets a marker, leaving
  // what it wrote in the blocks, as libjpeg-turbo does
  template <bool FAST>
  bool decode_mcu_huff(int16_t** blocks) {
    const uint64_t buf0 = get_buffer;
    const int left0 = bits_left;
    int dcs[4];
    std::memcpy(dcs, last_dc, sizeof dcs);
    if (FAST) {
      fast_marker = false;
      fast_pos = pos;
    }
    for (int b = 0; b < blocks_in_mcu; b++) {
      int16_t* block = blocks[b];
      int s = FAST ? huff_decode_fast(*dc_cur[b]) : huff_decode(*dc_cur[b]);
      if (s) {
        if (FAST) fast_fill();
        else check(s);
        s = huff_extend(get_bits(s), s);
      }
      int ci = membership[b];
      s = int(unsigned(s) + unsigned(dcs[ci]));
      dcs[ci] = s;
      block[0] = int16_t(s);
      const Derived& act = *ac_cur[b];
      for (int k = 1; k < 64; k++) {
        s = FAST ? huff_decode_fast(act) : huff_decode(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          if (FAST) fast_fill();
          else check(s);
          s = huff_extend(get_bits(s), s);
          block[kNatural[k]] = int16_t(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (FAST) {
      if (fast_marker) {
        get_buffer = buf0;
        bits_left = left0;
        return false;
      }
      pos = fast_pos;
    }
    std::memcpy(last_dc, dcs, sizeof dcs);
    return true;
  }

  void start_pass_huff() {
    // Ss, Se, Ah, Al other than 0, 63, 0, 0: a warning only
    for (int ci = 0; ci < comps_in_scan; ci++) {
      make_derived(dc_tbl, true, cur[ci]->td, dc_der);
      make_derived(ac_tbl, false, cur[ci]->ta, ac_der);
      last_dc[ci] = 0;
    }
    for (int b = 0; b < blocks_in_mcu; b++) {
      Component* c = cur[membership[b]];
      dc_cur[b] = c->td < 4 ? &dc_der[c->td] : nullptr;  // a scan reads only the tables it built
      ac_cur[b] = c->ta < 4 ? &ac_der[c->ta] : nullptr;
    }
    bits_left = 0;
    get_buffer = 0;
    insufficient = false;
    restarts_to_go = restart_interval;
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart
  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    if (unread_marker == 0xD0 + next_restart_num) {
      unread_marker = 0;
    } else {
      const int desired = next_restart_num;
      int marker = unread_marker;
      for (;;) {
        int action;
        if (marker < 0xC0) action = 2;
        else if (marker < 0xD0 || marker > 0xD7) action = 3;
        else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) action = 3;
        else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) {
          unread_marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
        marker = unread_marker;
      }
    }
    next_restart_num = (next_restart_num + 1) & 7;
  }

  // jdhuff.c / jdphuff.c process_restart
  void process_restart() {
    bits_left = 0;
    read_restart_marker();
    for (int ci = 0; ci < comps_in_scan; ci++) last_dc[ci] = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (unread_marker == 0) insufficient = false;
  }

  void decode_mcu_sequential(int16_t** blocks) {
    bool usefast = true;
    if (restart_interval) {
      if (restarts_to_go == 0) process_restart();
      usefast = false;
    }
    if (n - pos < int64_t(kFastBytesPerBlock) * blocks_in_mcu || unread_marker != 0) usefast = false;
    if (!insufficient) {
      if (!usefast || !decode_mcu_huff<true>(blocks)) decode_mcu_huff<false>(blocks);
    }
    if (restart_interval) restarts_to_go--;
  }

  // -- progressive Huffman (jdphuff.c)

  void start_pass_phuff() {
    const bool is_dc = Ss == 0;
    bool bad = false;
    if (is_dc) {
      if (Se != 0) bad = true;
    } else {
      if (Ss > Se || Se >= 64) bad = true;
      if (comps_in_scan != 1) bad = true;
    }
    if (Ah != 0 && Al != Ah - 1) bad = true;
    if (Al > 13) bad = true;
    if (bad) fail(CORRUPT);
    update_coef_bits();  // out-of-order progression: a warning only
    for (int ci = 0; ci < comps_in_scan; ci++) {
      Component* c = cur[ci];
      if (is_dc) {
        if (Ah == 0) make_derived(dc_tbl, true, c->td, dc_der);
      } else {
        make_derived(ac_tbl, false, c->ta, ac_der);
      }
      last_dc[ci] = 0;
    }
    for (int b = 0; b < blocks_in_mcu; b++) {
      Component* c = cur[membership[b]];
      dc_cur[b] = c->td < 4 ? &dc_der[c->td] : nullptr;  // a scan reads only the tables it built
      ac_cur[b] = c->ta < 4 ? &ac_der[c->ta] : nullptr;
    }
    bits_left = 0;
    get_buffer = 0;
    insufficient = false;
    eobrun = 0;
    restarts_to_go = restart_interval;
  }

  void decode_mcu_progressive(int16_t** blocks) {
    if (restart_interval && restarts_to_go == 0) process_restart();
    if (Ss == 0) {
      if (Ah == 0) dc_first(blocks);
      else dc_refine(blocks);
    } else {
      if (Ah == 0) ac_first(blocks[0]);
      else ac_refine(blocks[0]);
    }
    if (restart_interval) restarts_to_go--;
  }

  void dc_first(int16_t** blocks) {
    if (insufficient) return;
    for (int b = 0; b < blocks_in_mcu; b++) {
      int s = huff_decode(*dc_cur[b]);
      if (s) {
        check(s);
        s = huff_extend(get_bits(s), s);
      }
      int ci = membership[b];
      if ((last_dc[ci] >= 0 && s > INT_MAX - last_dc[ci]) ||
          (last_dc[ci] < 0 && s < INT_MIN - last_dc[ci]))
        fail(CORRUPT);
      s += last_dc[ci];
      last_dc[ci] = s;
      blocks[b][0] = int16_t(unsigned(s) << Al);
    }
  }

  void dc_refine(int16_t** blocks) {
    const int p1 = 1 << Al;
    for (int b = 0; b < blocks_in_mcu; b++) {
      check(1);
      if (get_bits(1)) blocks[b][0] = int16_t(blocks[b][0] | p1);
    }
  }

  void ac_first(int16_t* block) {
    if (insufficient) return;
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Derived& t = *ac_cur[0];
    for (int k = Ss; k <= Se; k++) {
      int s = huff_decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        check(s);
        s = huff_extend(get_bits(s), s);
        block[kNatural[k]] = int16_t(unsigned(s) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1u << r;
        if (r) {
          check(r);
          eobrun += get_bits(r);
        }
        eobrun--;
        break;
      }
    }
  }

  void ac_refine(int16_t* block) {
    if (insufficient) return;
    const int p1 = 1 << Al;
    const int m1 = int(unsigned(-1) << Al);
    const Derived& t = *ac_cur[0];
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int s = huff_decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          check(1);
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) {
            check(r);
            eobrun += get_bits(r);
          }
          break;
        }
        do {
          int16_t* coef = block + kNatural[k];
          if (*coef != 0) {
            check(1);
            if (get_bits(1) && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= Se);
        if (s) block[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          check(1);
          if (get_bits(1) && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
      eobrun--;
    }
  }

  // -- arithmetic decoding (jdarith.c)

  // jdarith.c get_byte: the data running out is an error there too
  // arith_decode: one binary decision in statistics bin st
  int arith_decode(uint8_t* st) {
    while (a_a < 0x8000) {
      if (--a_ct < 0) {
        int data = 0;
        if (unread_marker == 0) {
          data = byte();
          if (data == 0xFF) {
            do data = byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;  // zeros from here on, which is legal
              data = 0;
            }
          }
        }
        a_c = (a_c << 8) | data;
        if ((a_ct += 8) < 0)
          if (++a_ct == 0) a_a = 0x8000;  // the 2 initial bytes are in
      }
      a_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a_a - qe;
    a_a = temp;
    temp <<= a_ct;
    if (a_c >= temp) {
      a_c -= temp;
      if (a_a < qe) {
        a_a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a_a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_a < 0x8000) {
      if (a_a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void start_pass_arith() {
    if (progressive) {
      bool bad = false;
      if (Ss == 0) {
        if (Se != 0) bad = true;
      } else {
        if (Se < Ss || Se > 63) bad = true;
        if (comps_in_scan != 1) bad = true;
      }
      if (Ah != 0 && Ah - 1 != Al) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail(CORRUPT);
      update_coef_bits();  // out-of-order progression: a warning only
    }
    reset_arith();
  }

  void process_restart_arith() {
    read_restart_marker();
    reset_arith();
  }

  // the statistics bins of this scan's tables, its predictions, the coder
  void reset_arith() {
    for (int ci = 0; ci < comps_in_scan; ci++) {
      Component* c = cur[ci];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c->td], 0, sizeof dc_stats[0]);
        last_dc[ci] = 0;
        dc_context[ci] = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c->ta], 0, sizeof ac_stats[0]);
    }
    a_c = 0;
    a_a = 0;
    a_ct = -16;
    restarts_to_go = restart_interval;
  }

  // Figures F.19-F.24: a DC difference in the conditioning of component ci
  // (false: magnitude overflow, the rest of the segment is left alone)
  bool arith_dc_diff(int ci, int tbl, int* v_out) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (arith_decode(st) == 0) {
      dc_context[ci] = 0;
      *v_out = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          a_ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < int((1L << arith_dc_L[tbl]) >> 1)) dc_context[ci] = 0;
    else if (m > int((1L << arith_dc_U[tbl]) >> 1)) dc_context[ci] = 12 + sign * 4;
    else dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    *v_out = sign ? -v : v;
    return true;
  }

  // an AC value at k after its "nonzero" decision (false: overflow)
  bool arith_ac_value(int tbl, int k, uint8_t* st, int* v_out) {
    const int sign = arith_decode(fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m != 0) {
      if (arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            a_ct = -1;
            return false;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    *v_out = sign ? -v : v;
    return true;
  }

  void decode_mcu_arith(int16_t** blocks) {
    if (restart_interval) {
      if (restarts_to_go == 0) process_restart_arith();
      restarts_to_go--;
    }
    if (progressive && Ss == 0 && Ah != 0) {  // DC refine: the next bit
      const int p1 = 1 << Al;
      for (int b = 0; b < blocks_in_mcu; b++)
        if (arith_decode(fixed_bin)) blocks[b][0] = int16_t(blocks[b][0] | p1);
      return;
    }
    if (a_ct == -1) return;  // after an overflow, nothing until the next restart
    if (!progressive || Ss == 0) {  // sequential, or DC first
      for (int b = 0; b < blocks_in_mcu; b++) {
        const int ci = membership[b];
        Component* c = cur[ci];
        int v;
        if (!arith_dc_diff(ci, c->td, &v)) return;
        last_dc[ci] = (last_dc[ci] + v) & 0xffff;
        blocks[b][0] = int16_t(progressive ? int(unsigned(last_dc[ci]) << Al) : last_dc[ci]);
        if (progressive) continue;
        const int tbl = c->ta;
        for (int k = 1; k <= 63; k++) {
          uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
          if (arith_decode(st)) break;  // EOB
          while (arith_decode(st + 1) == 0) {
            st += 3;
            if (++k > 63) {
              a_ct = -1;
              return;
            }
          }
          if (!arith_ac_value(tbl, k, st, &v)) return;
          blocks[b][kNatural[k]] = int16_t(v);
        }
      }
      return;
    }
    int16_t* block = blocks[0];
    const int tbl = cur[0]->ta;
    if (Ah == 0) {  // AC first
      for (int k = Ss; k <= Se; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(st)) break;
        while (arith_decode(st + 1) == 0) {
          st += 3;
          if (++k > Se) {
            a_ct = -1;
            return;
          }
        }
        int v;
        if (!arith_ac_value(tbl, k, st, &v)) return;
        block[kNatural[k]] = int16_t(unsigned(v) << Al);
      }
      return;
    }
    // AC refine
    const int p1 = 1 << Al;
    const int m1 = int(unsigned(-1) << Al);
    int kex = Se;
    for (; kex > 0; kex--)
      if (block[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;
      for (;;) {
        int16_t* coef = block + kNatural[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = int16_t(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = int16_t(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) {
          a_ct = -1;
          return;
        }
      }
    }
  }

  // -- the scans

  // jdcoefct.c consume_data / decompress_onepass: every MCU of the scan
  void consume_scan() {
    int16_t* blocks[10];
    for (int row = 0; row < total_imcu_rows; row++) {
      int rows_per = 1;
      if (comps_in_scan == 1)
        rows_per = row < total_imcu_rows - 1 ? cur[0]->v : cur[0]->last_row_height;
      for (int yoff = 0; yoff < rows_per; yoff++) {
        for (int mx = 0; mx < mcus_per_row; mx++) {
          if (comps_in_scan == 1) {
            blocks[0] = cur[0]->block(row * cur[0]->v + yoff, mx);
          } else {
            int b = 0;
            for (int ci = 0; ci < comps_in_scan; ci++) {
              Component* c = cur[ci];
              for (int y = 0; y < c->v; y++)
                for (int x = 0; x < c->h; x++) blocks[b++] = c->block(row * c->v + y, mx * c->h + x);
            }
          }
          if (!insufficient) last_good_imcu_row = row;
          if (arith) decode_mcu_arith(blocks);
          else if (progressive) decode_mcu_progressive(blocks);
          else decode_mcu_sequential(blocks);
        }
      }
    }
  }

  // -- block smoothing (jdcoefct.c, libjpeg-turbo's 5x5 version): for a
  // progressive image whose first 9 AC coefficients are not all known to
  // full precision, those still zero are estimated from the DC values of
  // the block and its 24 neighbours

  static constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // Q00 .. Q30
  int bits_latch[2][10][10];  // [current, previous][component][coefficient]

  bool smoothing_ok() {
    if (!progressive) return false;
    bool useful = false;
    for (int ci = 0; ci < ncomp; ci++) {
      const Component& c = comp[ci];
      if (!c.latched) return false;
      for (int k : kSmoothPos)
        if (qtab_latched(c, k) == 0) return false;
      const int* bits = &coef_bits[size_t(ci) * 64];
      const int* prev = &coef_bits[size_t(ci + ncomp) * 64];
      if (bits[0] < 0) return false;
      bits_latch[0][ci][0] = bits[0];
      for (int k = 1; k < 10; k++) {
        bits_latch[1][ci][k] = input_scan_number > 1 ? prev[k] : -1;
        bits_latch[0][ci][k] = bits[k];
        if (bits[k] != 0) useful = true;
      }
    }
    return useful;
  }
  static int64_t qtab_latched(const Component& c, int k) { return uint16_t(c.qt[k]); }

  static int smooth_pred(int64_t q, int64_t num, int Al) {
    int pred;
    if (num >= 0) {
      pred = int(((q << 7) + num) / (q << 8));
      if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    } else {
      pred = int(((q << 7) - num) / (q << 8));
      if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      pred = -pred;
    }
    return pred;
  }

  void smooth_idct(int ci) {
    Component& c = comp[ci];
    const int stride = c.bw * 8;
    const int last_imcu_row = total_imcu_rows - 1;
    int64_t Q[10];
    for (int k = 0; k < 10; k++) Q[k] = qtab_latched(c, kSmoothPos[k]);
    int16_t ws[64];
    for (int row = 0; row < total_imcu_rows; row++) {
      int block_rows = c.v;
      if (row == last_imcu_row) {
        block_rows = c.hblocks % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int* bits = bits_latch[row > last_good_imcu_row ? 1 : 0][ci];
      const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                             bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                             bits[9] == -1;
      for (int br = 0; br < block_rows; br++) {
        // the neighbours are chosen by libjpeg's image_block_row, counted
        // with this iMCU row's block_rows (so at the last, short iMCU row,
        // and before it, not the block row's own index); the rows
        // themselves are the buffer's, dummy rows included
        const int r = row * c.v + br;
        const int image_block_row = row * block_rows + br;
        const int image_block_rows = block_rows * total_imcu_rows;
        const int r_prev = image_block_row > 0 ? r - 1 : r;
        const int r_pp = image_block_row > 1 ? r - 2 : r_prev;
        const int r_next = image_block_row < image_block_rows - 1 ? r + 1 : r;
        const int r_nn = image_block_row < image_block_rows - 2 ? r + 2 : r_next;
        const int rows[5] = {r_pp, r_prev, r, r_next, r_nn};
        auto dc_at = [&](int i, int col) { return int(c.block(rows[i], col)[0]); };
        int DC[5][5];  // DC[row][col], cols b-2 .. b+2
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) DC[i][j] = dc_at(i, 0);
        const int last_col = c.wblocks - 1;
        for (int b = 0; b <= last_col; b++) {
          std::memcpy(ws, c.block(r, b), sizeof ws);
          if (b == 0 && last_col > 0)
            for (int i = 0; i < 5; i++) DC[i][3] = DC[i][4] = dc_at(i, 1);
          if (b + 1 < last_col)
            for (int i = 0; i < 5; i++) DC[i][4] = dc_at(i, b + 2);
          // DC01..DC25 of jdcoefct.c, row by row
          const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2], DC04 = DC[0][3], DC05 = DC[0][4];
          const int DC06 = DC[1][0], DC07 = DC[1][1], DC08 = DC[1][2], DC09 = DC[1][3], DC10 = DC[1][4];
          const int DC11 = DC[2][0], DC12 = DC[2][1], DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4];
          const int DC16 = DC[3][0], DC17 = DC[3][1], DC18 = DC[3][2], DC19 = DC[3][3], DC20 = DC[3][4];
          const int DC21 = DC[4][0], DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3], DC25 = DC[4][4];
          const int64_t Q00 = Q[0];
          int Al;
          if ((Al = bits[1]) != 0 && ws[1] == 0) {
            int64_t num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                              3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                              3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                              DC24 + DC25)
                                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = int16_t(smooth_pred(Q[1], num, Al));
          }
          if ((Al = bits[2]) != 0 && ws[8] == 0) {
            int64_t num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                              38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                                              13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = int16_t(smooth_pred(Q[2], num, Al));
          }
          if ((Al = bits[3]) != 0 && ws[16] == 0) {
            int64_t num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                              5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
            ws[16] = int16_t(smooth_pred(Q[3], num, Al));
          }
          if ((Al = bits[4]) != 0 && ws[9] == 0) {
            int64_t num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                                              DC25)
                                           : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                              DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
            ws[9] = int16_t(smooth_pred(Q[4], num, Al));
          }
          if ((Al = bits[5]) != 0 && ws[2] == 0) {
            int64_t num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                              7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
            ws[2] = int16_t(smooth_pred(Q[5], num, Al));
          }
          if (change_dc) {
            if ((Al = bits[6]) != 0 && ws[3] == 0) {
              int64_t num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
              ws[3] = int16_t(smooth_pred(Q[6], num, Al));
            }
            if ((Al = bits[7]) != 0 && ws[10] == 0) {
              int64_t num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
              ws[10] = int16_t(smooth_pred(Q[7], num, Al));
            }
            if ((Al = bits[8]) != 0 && ws[17] == 0) {
              int64_t num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
              ws[17] = int16_t(smooth_pred(Q[8], num, Al));
            }
            if ((Al = bits[9]) != 0 && ws[24] == 0) {
              int64_t num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
              ws[24] = int16_t(smooth_pred(Q[9], num, Al));
            }
            int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                                 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            ws[0] = int16_t(smooth_pred(Q00, num, 0));
          }
          idct_islow(ws, c.qt, c.plane.data() + int64_t(r) * 8 * stride + b * 8, stride);
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 4; j++) DC[i][j] = DC[i][j + 1];
        }
      }
    }
  }

  // the header, every scan that cv2 reads, and the IDCT
  void run() {
    read_header();
    decode();
  }

  // jpeg_read_header(TRUE): the markers up to the first SOS
  void read_header() {
    if (read_markers(false) == REACHED_EOI) fail(saw_SOF ? NO_SCAN : NO_FRAME);
    in_headers = false;
    initial_setup();
  }

  // jpeg_start_decompress: every scan it reads, then the IDCT
  void decode() {
    master_selection();
    start_input_pass();
    consume_scan();
    if (multi_scan) {
      while (read_markers(false) == REACHED_SOS) {
        start_input_pass();
        consume_scan();
      }
    }
    const bool smooth = smoothing_ok();
    for (size_t ci = 0; ci < comp.size(); ci++) {
      Component& c = comp[ci];
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
      if (smooth) {
        smooth_idct(int(ci));
        continue;
      }
      int16_t zero_q[64];
      std::memset(zero_q, 0, sizeof zero_q);
      const int16_t* q = c.latched ? c.qt : zero_q;  // no scan: a zero multiplier table
      const int stride = c.bw * 8;
      for (int by = 0; by < c.hblocks; by++)
        for (int bx = 0; bx < c.wblocks; bx++)
          idct_islow(c.block(by, bx), q, c.plane.data() + int64_t(by) * 8 * stride + bx * 8, stride);
    }
  }

  bool rgb_space() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // one component at full size, width x height (jdsample.c)
  void upsample(const Component& c, uint8_t* out) const {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int W = width, H = height, dw = c.dw, dh = c.dh;
    const uint8_t* p = c.plane.data();
    const int st = c.bw * 8;
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; y++) std::memcpy(out + int64_t(y) * W, p + int64_t(y) * st, W);
    } else if (rh == 2 && rv == 1 && dw > 2) {
      std::vector<uint8_t> row(2 * size_t(dw));  // then W of them
      for (int y = 0; y < H; y++) {
        const uint8_t* in = p + int64_t(y) * st;
        uint8_t* o = row.data();
        o[0] = in[0];
        o[1] = uint8_t((3 * in[0] + in[1] + 2) >> 2);
        for (int i = 1; i < dw - 1; i++) {
          const int v3 = 3 * in[i];
          o[2 * i] = uint8_t((v3 + in[i - 1] + 1) >> 2);
          o[2 * i + 1] = uint8_t((v3 + in[i + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = uint8_t((3 * in[dw - 1] + in[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = in[dw - 1];
        std::memcpy(out + int64_t(y) * W, o, W);
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
      std::vector<uint8_t> row(2 * size_t(dw));  // then W of them
      for (int y = 0; y < H; y++) {
        int i = y >> 1;
        int j = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
        const uint8_t* a = p + int64_t(i) * st;
        const uint8_t* b = p + int64_t(j) * st;
        for (int k = 0; k < dw; k++) col[k] = 3 * a[k] + b[k];
        uint8_t* o = row.data();
        o[0] = uint8_t((col[0] * 4 + 8) >> 4);
        o[1] = uint8_t((col[0] * 3 + col[1] + 7) >> 4);
        for (int k = 1; k < dw - 1; k++) {
          const int c3 = col[k] * 3;
          o[2 * k] = uint8_t((c3 + col[k - 1] + 8) >> 4);
          o[2 * k + 1] = uint8_t((c3 + col[k + 1] + 7) >> 4);
        }
        o[2 * dw - 2] = uint8_t((col[dw - 1] * 3 + col[dw - 2] + 8) >> 4);
        o[2 * dw - 1] = uint8_t((col[dw - 1] * 4 + 7) >> 4);
        std::memcpy(out + int64_t(y) * W, o, W);
      }
    } else {  // replication (int_upsample, and h2v1 / h2v2 at dw <= 2)
      for (int y = 0; y < H; y++) {
        const uint8_t* in = p + int64_t(y / rv) * st;
        uint8_t* o = out + int64_t(y) * W;
        for (int x = 0; x < W; x++) o[x] = in[x / rh];
      }
    }
  }

  void write_bgr(uint8_t* out) const {
    const int64_t np = int64_t(width) * height;
    if (ncomp == 1) {
      std::vector<uint8_t> g(np);
      upsample(comp[0], g.data());
      for (int64_t i = 0; i < np; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> ch[4];
    for (int k = 0; k < ncomp; k++) {
      ch[k].resize(np);
      upsample(comp[k], ch[k].data());
    }
    if (ncomp == 3 && rgb_space()) {
      for (int64_t i = 0; i < np; i++) {
        out[3 * i] = ch[2][i];
        out[3 * i + 1] = ch[1][i];
        out[3 * i + 2] = ch[0][i];
      }
      return;
    }
    // jdcolor.c ycc_rgb_convert / ycck_cmyk_convert
    constexpr int SB = YccTables::SB;
    const int *cr_r = kYcc.cr_r, *cb_b = kYcc.cb_b;
    const int64_t *cr_g = kYcc.cr_g, *cb_g = kYcc.cb_g;
    const uint8_t* lim = kRange.simple + 384;
    if (ncomp == 3) {
      for (int64_t i = 0; i < np; i++) {
        int y = ch[0][i], cb = ch[1][i], cr = ch[2][i];
        out[3 * i + 2] = lim[y + cr_r[cr]];
        out[3 * i + 1] = lim[y + int((cb_g[cb] + cr_g[cr]) >> SB)];
        out[3 * i] = lim[y + cb_b[cb]];
      }
      return;
    }
    // four components: CMYK as stored (Adobe transform 0 or no Adobe
    // segment) or YCCK; then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
    const bool ycck = adobe && adobe_transform != 0;
    for (int64_t i = 0; i < np; i++) {
      int c0 = ch[0][i], c1 = ch[1][i], c2 = ch[2][i], k = ch[3][i];
      if (ycck) {
        int y = c0, cb = c1, cr = c2;
        c0 = lim[255 - (y + cr_r[cr])];
        c1 = lim[255 - (y + int((cb_g[cb] + cr_g[cr]) >> SB))];
        c2 = lim[255 - (y + cb_b[cb])];
      }
      out[3 * i + 2] = uint8_t(k - (((255 - c0) * k) >> 8));
      out[3 * i + 1] = uint8_t(k - (((255 - c1) * k) >> 8));
      out[3 * i] = uint8_t(k - (((255 - c2) * k) >> 8));
    }
  }

  // -- JPEG in TIFF

  // the tables libjpeg keeps between datastreams (jpeg_abort frees neither)
  void load_tables(const JpegTiffTables& t) {
    for (int i = 0; i < 4; i++) {
      qt_defined[i] = t.quant_defined[i] != 0;
      std::memcpy(qtab[i], t.quant[i], sizeof qtab[i]);
      for (int dc = 0; dc < 2; dc++) {
        HuffTable& h = (dc ? dc_tbl : ac_tbl)[i];
        const int k = (dc ? 0 : 4) + i;
        h.defined = t.huff_defined[k] != 0;
        std::memcpy(h.bits, t.huff_bits[k], 17);
        std::memcpy(h.vals, t.huff_vals[k], 256);
      }
    }
  }
  void save_tables(JpegTiffTables& t) const {
    for (int i = 0; i < 4; i++) {
      t.quant_defined[i] = qt_defined[i];
      std::memcpy(t.quant[i], qtab[i], sizeof qtab[i]);
      for (int dc = 0; dc < 2; dc++) {
        const HuffTable& h = (dc ? dc_tbl : ac_tbl)[i];
        const int k = (dc ? 0 : 4) + i;
        t.huff_defined[k] = h.defined;
        std::memcpy(t.huff_bits[k], h.bits, 17);
        std::memcpy(t.huff_vals[k], h.vals, 256);
      }
    }
  }

  // the first `rows` rows as libjpeg writes them into libtiff's buffer,
  // row_bytes apart: RGB (jdcolor.c ycc_rgb_convert) or the components as
  // stored (null_convert), interleaved
  void write_tiff(bool ycc_to_rgb, uint8_t* out, int64_t row_bytes, int rows) const {
    const int64_t np = int64_t(width) * height;
    std::vector<std::vector<uint8_t>> ch(ncomp);
    for (int k = 0; k < ncomp; k++) {
      ch[k].resize(np);
      upsample(comp[k], ch[k].data());
    }
    const uint8_t* lim = kRange.simple + 384;
    for (int y = 0; y < rows; y++) {
      uint8_t* o = out + y * row_bytes;
      const int64_t at = int64_t(y) * width;
      if (ycc_to_rgb) {
        const uint8_t *py = ch[0].data() + at, *pb = ch[1].data() + at, *pr = ch[2].data() + at;
        for (int x = 0; x < width; x++, o += 3) {
          const int yy = py[x], cb = pb[x], cr = pr[x];
          o[0] = lim[yy + kYcc.cr_r[cr]];
          o[1] = lim[yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> YccTables::SB)];
          o[2] = lim[yy + kYcc.cb_b[cb]];
        }
      } else {
        for (int x = 0; x < width; x++)
          for (int k = 0; k < ncomp; k++) *o++ = ch[k][at + x];
      }
    }
  }
};

int header(const uint8_t* data, int64_t n, int32_t* info) {
  Decoder dec(data, n);
  dec.read_markers(true);
  if (!dec.saw_SOF) return NO_FRAME;
  if (int64_t(dec.width) * dec.height > (int64_t(1) << 30)) return TOO_LARGE;
  info[0] = dec.width;
  info[1] = dec.height;
  info[2] = dec.orientation;
  return OK;
}

// A decoder on libtiff's source holding the image's tables, which it hands
// back however it ends: what a datastream defined stays defined
struct TiffDecoder : Decoder {
  JpegTiffTables* t;
  TiffDecoder(const uint8_t* data, int64_t n, JpegTiffTables* tables) : Decoder(data, n), t(tables) {
    tiff = true;
    load_tables(*t);
  }
  ~TiffDecoder() { save_tables(*t); }
};

// tif_jpeg.c JPEGSetupDecode: JPEGTables read as jpeg_read_header(FALSE)
// reads a tables-only datastream
int tiff_tables(const uint8_t* tables, int64_t n, JpegTiffTables* t) {
  TiffDecoder dec(tables, n, t);
  const MarkerResult r = dec.read_markers(false);
  return r == REACHED_EOI && !dec.saw_SOF ? OK : TABLES;  // at SOS: "Bogus JPEGTables field"
}

// JPEGPreDecode, then JPEGDecode's rows
int tiff_block(JpegTiffTables* t, const uint8_t* data, int64_t n, const JpegTiffBlock& b, uint8_t* out,
               int64_t row_bytes, int64_t rows) {
  TiffDecoder dec(data, n, t);
  dec.read_header();
  // JPEGPreDecode: a frame no larger than the strip or tile, except that
  // the last strip's may be taller at the same width; the component
  // count, the precision, the sampling factors
  const bool taller_last = b.last_strip && dec.width == b.segment_w && dec.height > b.segment_h;
  if (!taller_last && (dec.width > b.segment_w || dec.height > b.segment_h)) fail(FRAME);
  if (dec.ncomp != b.components) fail(COMPONENTS);
  if (dec.precision != b.precision) fail(PRECISION);
  if (dec.comp[0].h != b.h_sampling || dec.comp[0].v != b.v_sampling) fail(SAMPLING);
  for (int ci = 1; ci < dec.ncomp; ci++)
    if (dec.comp[ci].h != 1 || dec.comp[ci].v != 1) fail(SAMPLING);
  if (b.ycc_to_rgb && dec.ncomp != 3) fail(COMPONENTS);  // jdcolor.c: JCS_YCbCr has 3
  if (int64_t(dec.width) * dec.ncomp > row_bytes) fail(SMALL_BUFFER);
  dec.decode();
  // JPEGDecode: the rows the buffer holds, at most the frame's
  dec.write_tiff(b.ycc_to_rgb != 0, out, row_bytes, int(rows < dec.height ? rows : dec.height));
  return OK;
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, int64_t n, int32_t* info) {
  try {
    return header(data, n, info);
  } catch (const Fail& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return TOO_LARGE;
  }
}

int jpeg_tiff_tables(const uint8_t* tables, int64_t n, JpegTiffTables* t) {
  try {
    return t->status = tiff_tables(tables, n, t);
  } catch (const Fail& f) {
    return t->status = f.status;
  } catch (const std::bad_alloc&) {
    return t->status = TOO_LARGE;
  }
}

int jpeg_tiff_block(JpegTiffTables* t, const uint8_t* data, int64_t n, const JpegTiffBlock* b, uint8_t* out,
                    int64_t row_bytes, int64_t rows) {
  if (t->status) return t->status;  // JPEGSetupDecode fails for every block
  try {
    return tiff_block(t, data, n, *b, out, row_bytes, rows);
  } catch (const Fail& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return TOO_LARGE;
  }
}

int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* info) {
  try {
    Decoder dec(data, n);
    dec.run();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.orientation;
    if (cap < int64_t(dec.width) * dec.height * 3) return SMALL_BUFFER;
    dec.write_bgr(out);
    return OK;
  } catch (const Fail& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return TOO_LARGE;
  }
}

}  // extern "C"
