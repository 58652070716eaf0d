// The strips or tiles of a TIFF image as OpenCV 5.0's grfmt_tiff.cpp reads
// them under cv2.imdecode(buf, IMREAD_COLOR) and cv2.imread: block by block
// through libtiff 4.7's RGBA interface (TIFFReadRGBAStrip / TIFFReadRGBATile
// with stop_on_error 0), each block in a fresh RGBA image (host code). The
// directory, the tags and the colour tables are read in Python
// (utils/imcodec.py); this file does the per-byte work.
//
// For each block, in OpenCV's order (rows of blocks top to bottom, blocks left
// to right):
//
//  * fill: a byte count of 0, or a block that does not lie inside the data,
//    fails the whole decode (the block's buffer does not exist yet, so
//    libtiff's error stops the read). A byte count over 1 MiB is cut to ten
//    times the block size plus 4096 first. An uncompressed tile must fill
//    libtiff's raw buffer exactly: a file read through a memory map
//    (cv2.imread) holds the tile's byte count, one read through
//    cv2.imdecode's stream holds it rounded up to 1024 and never shrinks.
//  * decode into a zeroed buffer of the block's rows: uncompressed (too few
//    bytes leaves it zero), LZW as tif_lzw.c (codes MSB first with early
//    change; a stream whose first code is not a clear code, a code past the
//    table or a stream without EOI zeroes the rest; the old-style LSB-first
//    codes of a block whose data starts 00 x1 switch the whole file to that
//    decoder when they come first), PackBits as tif_packbits.c, deflate as
//    tif_zip.c (zlib's inflate with Z_PARTIAL_FLUSH; an error zeroes the
//    rest), the CCITT fax codecs as tif_fax3.c (see below: RLE, RLEW, G3 1D
//    and 2D, G4, which read FillOrder 2 themselves), JPEG as tif_jpeg.c
//    drives libjpeg (csrc/jpeg.cpp through jpeg_tiff.h: the JPEGTables tag
//    read once, the tables kept from block to block, JPEGPreDecode's checks
//    of the frame; contiguous YCbCr comes out as RGB, anything else as its
//    components; the data is never bit-reversed); a compression libtiff has
//    no codec for fails every block. A block that fails to decode keeps what
//    it got: libtiff goes on. A JPEG block its codec refuses fails as a fill
//    does (JPEGPreDecode runs in TIFFStartStrip).
//  * only when it decoded: the horizontal predictor (8 and 16 bits, after
//    the byte swap of a big-endian file) or the byte swap alone (JPEG has
//    neither).
//  * put: libtiff's contiguous or separate put routine for the photometric
//    interpretation, with its pointer steps (a clipped tile's skew included),
//    into BGR at the block's stored place; the rows of a block are mirrored
//    when the orientation flips horizontally (libtiff flips each block).
//
// In a planar (separate) image the first plane is filled as above; the other
// planes are read as TIFFReadEncodedStrip / TIFFReadTile read them, and their
// failures are ignored: a plane that cannot be filled is zero, and an
// uncompressed strip read from cv2.imdecode's stream takes the strip's bytes
// from its offset whatever its byte count says.
//
// C interface (ctypes): see tiff_decode below. Returns 0, or 1 (a block's
// data cannot be filled) or 2 (an uncompressed tile whose byte count is not
// the tile's size), or 3 (bad parameters), or 4 (the JPEG codec refuses the
// first plane's block).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#include "jpeg_tiff.h"

namespace {

enum Put : int32_t {
  PUT_GREY = 1,       // contiguous grey (MinIsBlack/MinIsWhite): map[] on the sample (16 bits: its high byte)
  PUT_PALETTE = 2,    // contiguous palette: pal[] on the index
  PUT_RGB8 = 3,       // contiguous RGB, 8 bits (associated alpha or none)
  PUT_RGBUA8 = 4,     // contiguous RGB + unassociated alpha, 8 bits: premultiplied
  PUT_RGB16 = 5,      // contiguous RGB, 16 bits
  PUT_RGBUA16 = 6,    // contiguous RGB + unassociated alpha, 16 bits
  PUT_CMYK8 = 7,      // contiguous CMYK, 8 bits
  PUT_SEP8 = 8,       // separate planes (RGB, or grey as RGB), 8 bits
  PUT_SEPUA8 = 9,     // separate planes + unassociated alpha, 8 bits
  PUT_SEP16 = 10,     // separate planes, 16 bits
  PUT_SEPUA16 = 11,   // separate planes + unassociated alpha, 16 bits
  PUT_SEPCMYK8 = 12,  // separate CMYK, 8 bits
  PUT_YCBCR = 13,     // contiguous YCbCr, 8 bits, blocks of ycc_hs x ycc_vs luma samples then Cb and Cr
  PUT_SEPYCBCR = 14,  // separate YCbCr planes, 8 bits, no subsampling
  PUT_CIELAB8 = 15,   // contiguous CIE L*a*b*, 8 bits (L unsigned, a and b signed)
  PUT_CIELAB16 = 16,  // contiguous CIE L*a*b*, 16 bits
};

enum Compression : int32_t {
  NONE = 1, CCITT_RLE = 2, CCITT_G3 = 3, CCITT_G4 = 4, LZW = 5, JPEG = 7, DEFLATE = 8, CCITT_RLEW = 32771,
  PACKBITS = 32773
};

}  // namespace

extern "C" {

// Everything the decode needs besides the data; filled by utils/imcodec.py.
struct TiffParams {
  int64_t width, height;      // the image
  int64_t block_w, block_h;   // the tile, or (width, rows per strip)
  int64_t blocks_across;      // tiles across (1 for strips)
  int64_t blocks_per_plane;   // strips or tiles of one plane
  int64_t nblocks;            // entries of offsets[] and counts[]
  int64_t row_bytes;          // bytes of one row of a block (scanline or tile row)
  int64_t block_bytes;        // TIFFStripSize or TIFFTileSize: the buffer of one block
  int32_t tiled, spp, bps, compression, predictor;
  int32_t swab;               // 16-bit samples stored big-endian
  int32_t bitrev;             // FillOrder 2: the raw bytes' bits reversed
  int32_t mapped;             // cv2.imread's memory map (else cv2.imdecode's stream)
  int32_t put, flip_h;
  int32_t planes;             // separate: the planes read (first, [second, third], [alpha or K])
  int32_t plane_index[4];     // separate: each read plane's sample index
  int32_t ycc_hs, ycc_vs;     // YCbCr: the subsampling
  int64_t sampling_row;       // YCbCr: bytes of one row of blocks (of ycc_vs image rows)
  float white[2];             // CIE L*a*b*: the white point's x and y
  int32_t group3_options;     // CCITT G3: T4Options (bit 0: rows may be 2D-coded)
  int32_t jpeg_ycc;           // JPEG, contiguous YCbCr: libjpeg converts to RGB (ycc_hs, ycc_vs: the sampling)
};

// zlib's z_stream on LP64
struct ZStream {
  const uint8_t* next_in;
  uint32_t avail_in;
  unsigned long total_in;
  uint8_t* next_out;
  uint32_t avail_out;
  unsigned long total_out;
  const char* msg;
  void* state;
  void* zalloc;
  void* zfree;
  void* opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
};

typedef int (*InflateInit2)(ZStream*, int, const char*, int);
typedef int (*Inflate)(ZStream*, int);
typedef int (*InflateEnd)(ZStream*);

}  // extern "C"

namespace {

// -- LZW (tif_lzw.c) ----------------------------------------------------------

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMax = 12;
constexpr int kCsize = (1 << kBitsMax) - 1 + 1024;

struct Entry {
  int next;  // -1: none
  uint8_t value, firstchar;
  uint16_t length;
};

struct Lzw {
  std::vector<Entry> tab;
  int mode = 0;  // the decoder chosen by the first block: 0 none yet, 1 new, 2 old-style (compat)
  Lzw() : tab(kCsize) {
    for (int i = 0; i < 256; i++) tab[i] = {-1, uint8_t(i), uint8_t(i), 1};
    for (int i = 256; i < kCsize; i++) tab[i] = {-1, 0, 0, 0};
  }
};

// Writes the first `occ` bytes (or all) of entry `code`'s string at `op`.
inline void write_string(const std::vector<Entry>& tab, int code, uint8_t* op, int64_t take) {
  int c = code;
  for (int64_t k = tab[code].length; k > take; k--) c = tab[c].next;
  for (int64_t i = take - 1; i >= 0; i--) {
    op[i] = tab[c].value;
    c = tab[c].next;
  }
}

// The new decoder (LZWDecode): returns 1, or 0 on an error (the rest zeroed
// where libtiff zeroes it).
int lzw_new(Lzw& z, const uint8_t* raw, int64_t rawcc, uint8_t* op, int64_t occ) {
  std::vector<Entry>& tab = z.tab;
  const uint64_t total_bits = uint64_t(rawcc) * 8;
  uint64_t bitpos = 0;
  uint32_t acc = 0;
  int accbits = 0;
  const uint8_t* bp = raw;
  int nbits = 9, free_ent = -1, maxcode = 510, oldcode = 0;
  auto next_code = [&](int& code) -> bool {  // MSB first; false when the bits run out
    if (bitpos + nbits > total_bits) return false;
    while (accbits < nbits) {
      acc = (acc << 8) | *bp++;
      accbits += 8;
    }
    accbits -= nbits;
    code = int((acc >> accbits) & ((1u << nbits) - 1));
    acc &= (1u << accbits) - 1;
    bitpos += nbits;
    return true;
  };
  auto grow = [&]() {
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 2;
      if (free_ent >= kCsize) free_ent = -1;  // only a clear or EOI may follow
    }
  };
  auto fail = [&]() {
    std::memset(op, 0, size_t(occ));
    return 0;
  };
  if (occ == 0) return 1;
  while (true) {
    int code;
    if (!next_code(code)) return fail();  // no EOI
    if (code >= kFirst) {
      uint8_t value;
      if (code >= free_ent) {
        if (code != free_ent) return fail();  // a code not yet in the table
        value = tab[oldcode].firstchar;
      } else {
        value = tab[code].firstchar;
      }
      tab[free_ent] = {oldcode, value, tab[oldcode].firstchar, uint16_t(tab[oldcode].length + 1)};
      grow();
      oldcode = code;
      const int64_t len = tab[code].length;
      if (len > occ) {  // the string's first bytes fill the block
        write_string(tab, code, op, occ);
        return 1;
      }
      write_string(tab, code, op, len);
      op += len;
      occ -= len;
      if (occ == 0) return 1;
    } else if (code < 256) {
      if (code > free_ent) return fail();  // no clear code yet, or a full table
      tab[free_ent] = {oldcode, uint8_t(code), tab[oldcode].firstchar, uint16_t(tab[oldcode].length + 1)};
      grow();
      oldcode = code;
      *op++ = uint8_t(code);
      if (--occ == 0) return 1;
    } else if (code == kEoi) {
      return 0;  // too few bytes: the rest stays zero
    } else {
      free_ent = kFirst;
      nbits = 9;
      maxcode = 510;
      do {
        if (!next_code(code)) return fail();
      } while (code == kClear);
      if (code == kEoi) return 0;
      if (code > kEoi) return fail();
      *op++ = uint8_t(code);
      oldcode = code;
      if (--occ == 0) return 1;
    }
  }
}

// The old-style decoder (LZWDecodeCompat): codes LSB first, the code width
// grows one code later; a stream that runs out ends as if by EOI.
int lzw_compat(Lzw& z, const uint8_t* raw, int64_t rawcc, uint8_t* op, int64_t occ) {
  std::vector<Entry>& tab = z.tab;
  const uint8_t* bp = raw;
  uint64_t bitsleft = uint64_t(rawcc) * 8;
  uint32_t nextdata = 0;
  int nextbits = 0, nbits = 9, free_ent = -1, maxcode = 510, oldcode = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < uint64_t(nbits)) return kEoi;
    nextdata |= uint32_t(*bp++) << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= uint32_t(*bp++) << nextbits;
      nextbits += 8;
    }
    const int code = int(nextdata & ((1u << nbits) - 1));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kCsize; i++) tab[i] = {-1, 0, 0, 0};
        nbits = 9;
        maxcode = 511;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 0;
      *op++ = uint8_t(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize) return 0;  // no clear code yet, or a full table
    Entry& e = tab[free_ent];
    e.next = oldcode;
    e.firstchar = tab[oldcode].firstchar;
    e.length = uint16_t(tab[oldcode].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 1;
    }
    oldcode = code;
    if (code >= 256) {
      const int64_t len = tab[code].length;
      if (len == 0) return 0;
      if (len > occ) {
        write_string(tab, code, op, occ);
        occ = 0;
        break;
      }
      write_string(tab, code, op, len);
      op += len;
      occ -= len;
    } else {
      *op++ = uint8_t(code);
      occ--;
    }
  }
  return occ > 0 ? 0 : 1;
}

int lzw_decode(Lzw& z, const uint8_t* raw, int64_t rawcc, uint8_t* op, int64_t occ) {
  if (rawcc >= 2 && raw[0] == 0 && (raw[1] & 1)) {
    if (z.mode == 0) z.mode = 2;
  } else if (z.mode == 0) {
    z.mode = 1;
  }
  return z.mode == 2 ? lzw_compat(z, raw, rawcc, op, occ) : lzw_new(z, raw, rawcc, op, occ);
}

// -- PackBits (tif_packbits.c) ------------------------------------------------

int packbits_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  while (cc > 0 && occ > 0) {
    int64_t n = int8_t(*bp++);
    cc--;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < n) n = occ;
      if (cc == 0) break;
      occ -= n;
      const uint8_t b = *bp++;
      cc--;
      std::memset(op, b, size_t(n));
      op += n;
    } else {
      if (occ < n + 1) n = occ - 1;
      if (cc < n + 1) break;
      n++;
      std::memcpy(op, bp, size_t(n));
      op += n;
      occ -= n;
      bp += n;
      cc -= n;
    }
  }
  return occ > 0 ? 0 : 1;
}

// -- deflate (tif_zip.c) ------------------------------------------------------

struct Zlib {
  InflateInit2 init;
  Inflate inflate;
  InflateEnd end;
  const char* version;
};

int zip_decode(const Zlib& zl, const uint8_t* raw, int64_t rawcc, uint8_t* op, int64_t occ) {
  ZStream s;
  std::memset(&s, 0, sizeof s);
  if (zl.init(&s, 15, zl.version, int(sizeof s)) != 0) return 0;
  s.next_in = raw;
  s.next_out = op;
  int ok = 1;
  do {
    const uint32_t in_before = rawcc <= 0xFFFFFFFFll ? uint32_t(rawcc) : 0xFFFFFFFFu;
    const uint32_t out_before = occ < 0xFFFFFFFFll ? uint32_t(occ) : 0xFFFFFFFFu;
    s.avail_in = in_before;
    s.avail_out = out_before;
    const int state = zl.inflate(&s, 1);  // Z_PARTIAL_FLUSH
    rawcc -= in_before - s.avail_in;
    occ -= out_before - s.avail_out;
    if (state == 1) break;  // Z_STREAM_END
    if (state != 0) {       // a data error or any other: the rest is zeroed
      std::memset(s.next_out, 0, size_t(occ));
      ok = 0;
      break;
    }
  } while (occ > 0);
  if (ok && occ != 0) {
    std::memset(s.next_out, 0, size_t(occ));
    ok = 0;
  }
  zl.end(&s);
  return ok;
}

// -- CCITT fax (tif_fax3.c, tif_fax3.h) ----------------------------------------
//
// Modified Huffman rows (CCITT RLE, byte-aligned; RLEW, 16-bit-aligned; G3 1D
// after an EOL), Modified READ rows (G3 2D: an EOL and a tag bit before each
// row says 1D or 2D) and MMR rows (G4: 2D only, no EOLs, the first row's
// reference white). The bits are read least significant first through a
// table that reverses each byte (FillOrder 1) or not (FillOrder 2); the raw
// bytes are never reversed. Each row's runs are painted into the zeroed
// block buffer (white clears, black sets bits, MSB first), and libtiff's
// control flow is kept: a code not in a table ends the row, which is then
// padded or cut to the width; the end of the data fills the row it was in
// and stops the block; a run array that overflows stops the block without
// filling the row. The run arrays live as long as the image, as libtiff's
// codec state does, so stale runs read past a reference row's end are the
// same ones.

enum FaxState : uint8_t { S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB,
                          S_MAKEUP, S_EOL };

struct FaxEntry {
  uint8_t state, width;
  uint32_t param;
};

struct FaxCode {
  const char* bits;  // the code as written in T.4, first bit first
  uint32_t param;
};

// T.4's tables 1-3: terminating codes 0-63, then make-up codes
const FaxCode kWhiteTerm[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5}, {"1110", 6}, {"1111", 7},
    {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13}, {"110100", 14},
    {"110101", 15}, {"101010", 16}, {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20},
    {"0010111", 21}, {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31}, {"00011011", 32},
    {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37}, {"00010111", 38},
    {"00101000", 39}, {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43}, {"00101101", 44},
    {"00000100", 45}, {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50},
    {"01010100", 51}, {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61}, {"00110011", 62},
    {"00110100", 63}};
const FaxCode kWhiteMakeUp[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320}, {"00110111", 384},
    {"01100100", 448}, {"01100101", 512}, {"01101000", 576}, {"01100111", 640}, {"011001100", 704},
    {"011001101", 768}, {"011010010", 832}, {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664},
    {"010011011", 1728}};
const FaxCode kBlackTerm[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6}, {"00011", 7},
    {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18},
    {"00001100111", 19}, {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32}, {"000001101011", 33},
    {"000011010010", 34}, {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47}, {"000001100100", 48},
    {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const FaxCode kBlackMakeUp[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256}, {"000000110011", 320},
    {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216}, {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};
const FaxCode kMakeUp[] = {  // white and black alike
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920}, {"000000010010", 1984},
    {"000000010011", 2048}, {"000000010100", 2112}, {"000000010101", 2176}, {"000000010110", 2240},
    {"000000010111", 2304}, {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
// the 2D modes; libtiff reads only the first 7 bits of the extension code
// (uncompressed mode) and 7 zeros as an EOL's start
const FaxCode kMain[] = {{"0001", 0}, {"001", 0}, {"1", 0}, {"011", 1}, {"000011", 2}, {"0000011", 3}, {"010", 1},
                         {"000010", 2}, {"0000010", 3}, {"0000001", 0}, {"0000000", 0}};
const uint8_t kMainState[] = {S_PASS, S_HORIZ, S_V0, S_VR, S_VR, S_VR, S_VL, S_VL, S_VL, S_EXT, S_EOL};

// mkg3states.c's FillTable: every index whose low bits (read first) are the code
template <size_t N>
void fill_table(FaxEntry* t, int size, const FaxCode (&codes)[N], uint8_t state, const uint8_t* states = nullptr) {
  for (size_t i = 0; i < N; i++) {
    const int width = int(std::strlen(codes[i].bits));
    int code = 0;
    for (int b = 0; b < width; b++) code |= (codes[i].bits[b] - '0') << b;
    for (int at = code; at < (1 << size); at += 1 << width)
      t[at] = {states ? states[i] : state, uint8_t(width), codes[i].param};
  }
}

struct FaxTables {
  FaxEntry main[128], white[4096], black[8192];
  uint8_t rev[256], same[256];
  FaxTables() {
    std::memset(main, 0, sizeof main);
    std::memset(white, 0, sizeof white);
    std::memset(black, 0, sizeof black);
    fill_table(main, 7, kMain, 0, kMainState);
    const FaxCode eol[] = {{"00000000000", 0}};  // 11 zeros: the EOL, its 1 left to the sync
    fill_table(white, 12, kWhiteMakeUp, S_MAKEUPW);
    fill_table(white, 12, kMakeUp, S_MAKEUP);
    fill_table(white, 12, kWhiteTerm, S_TERMW);
    fill_table(white, 12, eol, S_EOL);
    fill_table(black, 13, kBlackMakeUp, S_MAKEUPB);
    fill_table(black, 13, kMakeUp, S_MAKEUP);
    fill_table(black, 13, kBlackTerm, S_TERMB);
    fill_table(black, 13, eol, S_EOL);
    for (int b = 0; b < 256; b++) {
      same[b] = uint8_t(b);
      rev[b] = uint8_t(((b * 0x0802u & 0x22110u) | (b * 0x8020u & 0x88440u)) * 0x10101u >> 16);
    }
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

enum FaxKind { FAX_RLE, FAX_RLEW, FAX_G3_1D, FAX_G3_2D, FAX_G4 };

// libtiff's Fax3CodecState: the run arrays (Fax3SetupState sizes them once)
// and the G3 mode that a block without EOLs switches on for the rest of the
// image
struct FaxRuns {
  int64_t nruns = 0;
  std::vector<uint32_t> runs;
  bool no_eol = false;
  void setup(int64_t rowpixels, bool two_d) {
    nruns = (rowpixels + 1 + 31) / 32 * 32 * (two_d ? 2 : 1);
    runs.assign(size_t(2 * nruns + 2), 0);  // + the word _TIFFFax3fillruns may write past a full array
  }
};

// _TIFFFax3fillruns: white runs clear bits, black runs set them
void fax_fill(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int black = 0; black < 2; black++) {
      uint32_t run = runs[black];
      if (x + run > lastx || run > lastx) run = runs[black] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          *cp = black ? uint8_t(*cp | (0xff >> bx)) : uint8_t(*cp & (0xff << (8 - bx)));
          cp++;
          run -= 8 - bx;
        }
        const uint32_t n = run >> 3;
        std::memset(cp, black ? 0xff : 0, n);
        cp += n;
        run &= 7;
        if (run) *cp = black ? uint8_t(*cp | (0xff00 >> run)) : uint8_t(*cp & (0xff >> run));
      } else {
        *cp = black ? uint8_t(*cp | (masks[run] >> bx)) : uint8_t(*cp & ~(masks[run] >> bx));
      }
      x += runs[black];
    }
  }
}

// One block (Fax3PreDecode, then Fax3DecodeRLE, Fax3Decode1D, Fax3Decode2D or
// Fax4Decode on its rows). `align` is the parity of the raw data's address
// (RLEW skips a byte at an odd address).
class FaxDecoder {
 public:
  FaxDecoder(FaxKind kind, FaxRuns& r, const uint8_t* raw, int64_t rawcc, bool fill_order2, int64_t rowpixels,
             int64_t align)
      : kind_(kind), r_(r), cp_(raw), ep_(raw + rawcc), raw_(raw), align_(align),
        bitmap_(fill_order2 ? fax_tables().same : fax_tables().rev), lastx_(int32_t(rowpixels)) {}

  void decode(uint8_t* buf, int64_t occ, int64_t rowbytes) {
    const FaxTables& t = fax_tables();
    const bool two_d = kind_ == FAX_G3_2D || kind_ == FAX_G4;
    uint32_t* cur = r_.runs.data();
    uint32_t* ref = two_d ? cur + r_.nruns : nullptr;
    if (ref) {  // the first row's reference is white
      ref[0] = uint32_t(lastx_);
      ref[1] = 0;
    }
    for (; occ > 0; buf += rowbytes, occ -= rowbytes) {
      a0_ = 0;
      run_ = 0;
      pa_ = thisrun_ = cur;
      if ((kind_ == FAX_G3_1D || kind_ == FAX_G3_2D) && !r_.no_eol && sync_eol() == EOF_ROW) {
        // no EOL up to the end of the data: the block is read again from its
        // first byte into this row on, without EOLs, and so is every later
        // block
        r_.no_eol = true;
        cp_ = raw_;
        acc_ = 0;
        avail_ = 0;
        eolcnt_ = 0;
      }
      bool one_d = kind_ != FAX_G4;
      if (kind_ == FAX_G3_2D) {
        if (!need(1)) {  // NeedBits8(1, EOF2D)
          if (cleanup() == FAIL_ROW) return;
          fax_fill(buf, thisrun_, pa_, uint32_t(lastx_));
          return;
        }
        one_d = bits(1);
        clr(1);
      }
      if (ref) {
        pb_ = ref;
        b1_ = int32_t(*pb_++);
      }
      const Row row = one_d ? expand1d(t) : expand2d(t, ref);
      if (row == FAIL_ROW) return;
      if (row == EOF_ROW || (kind_ == FAX_G4 && eolcnt_)) {  // G4: an EOL starts the EOFB
        fax_fill(buf, thisrun_, pa_, uint32_t(lastx_));
        return;
      }
      fax_fill(buf, thisrun_, pa_, uint32_t(lastx_));
      if (kind_ == FAX_RLE) {
        clr(avail_ - (avail_ & ~7));
      } else if (kind_ == FAX_RLEW) {
        clr(avail_ - (avail_ & ~15));
        if (avail_ == 0 && ((cp_ - raw_) + align_) & 1) cp_++;
      }
      if (two_d) {  // the imaginary change for the reference (G3 skips it when the runs are full)
        if ((kind_ == FAX_G4 || pa_ < thisrun_ + r_.nruns) && !setvalue(0)) return;
        std::swap(cur, ref);
      }
    }
  }

 private:
  enum Row { OK_ROW, EOF_ROW, FAIL_ROW, UNEXPECTED_ROW };

  FaxKind kind_;
  FaxRuns& r_;
  const uint8_t *cp_, *ep_, *raw_;
  int64_t align_;
  const uint8_t* bitmap_;
  int32_t lastx_;
  uint32_t acc_ = 0;  // BitAcc: the next bits, the first in bit 0
  int avail_ = 0;     // BitsAvail
  int eolcnt_ = 0;    // EOLcnt
  int32_t a0_ = 0, run_ = 0, b1_ = 0;
  uint32_t *pa_ = nullptr, *thisrun_ = nullptr, *pb_ = nullptr;

  // NeedBits8 / NeedBits16: false at the end of the data with no bit left;
  // a partial code is padded with zeros
  bool need(int n) {
    if (avail_ >= n) return true;
    if (cp_ >= ep_) {
      if (avail_ == 0) return false;
      avail_ = n;
      return true;
    }
    while (avail_ < n) {
      if (cp_ >= ep_) {
        avail_ = n;
        break;
      }
      acc_ |= uint32_t(bitmap_[*cp_++]) << avail_;
      avail_ += 8;
    }
    return true;
  }
  uint32_t bits(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    avail_ -= n;
    acc_ >>= n;
  }
  const FaxEntry* lookup(const FaxEntry* tab, int width) {
    const FaxEntry* e = tab + bits(width);
    clr(e->width);
    return e;
  }
  // SETVALUE: false when the row's run array is full
  bool setvalue(uint32_t x) {
    if (pa_ >= thisrun_ + r_.nruns) return false;
    *pa_++ = uint32_t(run_) + x;
    a0_ = int32_t(uint32_t(a0_) + x);
    run_ = 0;
    return true;
  }
  void makeup(uint32_t x) {
    a0_ = int32_t(uint32_t(a0_) + x);
    run_ = int32_t(uint32_t(run_) + x);
  }

  // SYNC_EOL: past the next EOL (its 11 zeros were read already when
  // EOLcnt is set), its fill bits and its 1; EOF_ROW when the data ends
  // first
  Row sync_eol() {
    if (eolcnt_ == 0) {
      for (;;) {
        if (!need(11)) return EOF_ROW;
        if (bits(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need(8)) return EOF_ROW;
      if (bits(8)) break;
      clr(8);
    }
    while (bits(1) == 0) clr(1);
    clr(1);
    eolcnt_ = 0;
    return OK_ROW;
  }

  // CLEANUP_RUNS: the row padded or cut to the width
  Row cleanup() {
    if (run_ && !setvalue(0)) return FAIL_ROW;
    if (a0_ != lastx_) {
      while (a0_ > lastx_ && pa_ > thisrun_) a0_ = int32_t(uint32_t(a0_) - *--pa_);
      if (a0_ < lastx_) {
        if (a0_ < 0) a0_ = 0;
        if (((pa_ - thisrun_) & 1) && !setvalue(0)) return FAIL_ROW;
        if (!setvalue(uint32_t(lastx_ - a0_))) return FAIL_ROW;
      } else if (a0_ > lastx_) {
        if (!setvalue(uint32_t(lastx_)) || !setvalue(0)) return FAIL_ROW;
      }
    }
    return OK_ROW;
  }

  // EXPAND1D: white and black runs until the width is reached, an EOL or a
  // code not in the table
  Row expand1d(const FaxTables& t) {
    for (;;) {
      for (int black = 0; black < 2; black++) {
        for (;;) {
          if (!need(black ? 13 : 12)) {
            return cleanup() == FAIL_ROW ? FAIL_ROW : EOF_ROW;
          }
          const FaxEntry* e = lookup(black ? t.black : t.white, black ? 13 : 12);
          if (e->state == S_EOL) {
            eolcnt_ = 1;
            return cleanup();
          }
          if (e->state == (black ? S_TERMB : S_TERMW)) {
            if (!setvalue(e->param)) return FAIL_ROW;
            break;
          }
          if (e->state == (black ? S_MAKEUPB : S_MAKEUPW) || e->state == S_MAKEUP) {
            makeup(e->param);
            continue;
          }
          return cleanup();  // unexpected
        }
        if (a0_ >= lastx_) return cleanup();
      }
      if (pa_[-1] == 0 && pa_[-2] == 0) pa_ -= 2;
    }
  }

  // the two runs of a horizontal mode code, the colour of a0 first;
  // UNEXPECTED_ROW when a code is not in the table (the row then ends)
  Row horizontal(const FaxTables& t) {
    const bool black_first = (pa_ - thisrun_) & 1;
    for (int k = 0; k < 2; k++) {
      const bool black = black_first != (k == 1);
      for (;;) {
        if (!need(black ? 13 : 12)) return EOF_ROW;
        const FaxEntry* e = lookup(black ? t.black : t.white, black ? 13 : 12);
        if (e->state == (black ? S_TERMB : S_TERMW)) {
          if (!setvalue(e->param)) return FAIL_ROW;
          break;
        }
        if (e->state != (black ? S_MAKEUPB : S_MAKEUPW) && e->state != S_MAKEUP) return UNEXPECTED_ROW;
        makeup(e->param);
      }
    }
    return OK_ROW;
  }

  // CHECK_b1: false when the reference row's runs are exhausted
  bool check_b1(const uint32_t* ref) {
    if (pa_ != thisrun_) {
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref + r_.nruns) return false;
        b1_ = int32_t(uint32_t(b1_) + pb_[0] + pb_[1]);
        pb_ += 2;
      }
    }
    return true;
  }

  // EXPAND2D: mode codes against the reference row
  Row expand2d(const FaxTables& t, const uint32_t* ref) {
    auto eof = [&]() { return cleanup() == FAIL_ROW ? FAIL_ROW : EOF_ROW; };
    while (a0_ < lastx_) {
      if (pa_ >= thisrun_ + r_.nruns) return FAIL_ROW;
      if (!need(7)) return eof();
      const FaxEntry* e = lookup(t.main, 7);
      switch (e->state) {
        case S_PASS:
          if (!check_b1(ref) || pb_ + 1 >= ref + r_.nruns) return FAIL_ROW;
          b1_ = int32_t(uint32_t(b1_) + *pb_++);
          run_ = int32_t(uint32_t(run_) + uint32_t(b1_ - a0_));
          a0_ = b1_;
          b1_ = int32_t(uint32_t(b1_) + *pb_++);
          break;
        case S_HORIZ: {
          const Row row = horizontal(t);
          if (row == FAIL_ROW) return FAIL_ROW;
          if (row == EOF_ROW) return eof();
          if (row == UNEXPECTED_ROW) return cleanup();
          if (!check_b1(ref)) return FAIL_ROW;
          break;
        }
        case S_V0:
        case S_VR:
          if (!check_b1(ref)) return FAIL_ROW;
          if (!setvalue(uint32_t(b1_ - a0_) + (e->state == S_VR ? e->param : 0))) return FAIL_ROW;
          if (pb_ >= ref + r_.nruns) return FAIL_ROW;
          b1_ = int32_t(uint32_t(b1_) + *pb_++);
          break;
        case S_VL:
          if (!check_b1(ref)) return FAIL_ROW;
          if (b1_ < int32_t(uint32_t(a0_) + e->param)) return cleanup();  // unexpected
          if (!setvalue(uint32_t(b1_ - a0_) - e->param)) return FAIL_ROW;
          b1_ = int32_t(uint32_t(b1_) - *--pb_);
          break;
        case S_EXT:  // uncompressed mode, which libtiff does not decode
          *pa_++ = uint32_t(lastx_ - a0_);
          return cleanup();
        case S_EOL:
          *pa_++ = uint32_t(lastx_ - a0_);
          if (!need(4)) return eof();
          clr(4);
          eolcnt_ = 1;
          return cleanup();
        default:
          return cleanup();
      }
    }
    if (run_) {
      if (run_ + a0_ < lastx_) {
        if (!need(1)) return eof();
        if (!bits(1)) return cleanup();
        clr(1);
      }
      if (!setvalue(0)) return FAIL_ROW;
    }
    return cleanup();
  }
};

// -- the predictor and the byte swap ------------------------------------------

void swab16(uint8_t* p, int64_t n) {
  for (int64_t i = 0; i + 1 < n; i += 2) {
    const uint8_t t = p[i];
    p[i] = p[i + 1];
    p[i + 1] = t;
  }
}

void undo_predictor(uint8_t* buf, int64_t occ, int64_t row_bytes, int bps, int stride, bool swab) {
  for (int64_t at = 0; at + row_bytes <= occ; at += row_bytes) {
    uint8_t* row = buf + at;
    if (bps == 8) {
      for (int64_t i = stride; i < row_bytes; i++) row[i] = uint8_t(row[i] + row[i - stride]);
    } else {  // 16: native order first
      if (swab) swab16(row, row_bytes);
      uint16_t* w = reinterpret_cast<uint16_t*>(row);
      const int64_t wc = row_bytes / 2;
      for (int64_t i = stride; i < wc; i++) w[i] = uint16_t(w[i] + w[i - stride]);
    }
  }
}

// -- CIE L*a*b* (tif_color.c, the sRGB display of tif_getimage.c) -------------

struct Lab {
  static constexpr int kRange = 1500;
  float x0, y0, z0, step;
  float gun[kRange + 1];  // luminance step → 8-bit value, the same for the three guns
  explicit Lab(const float* white) {
    const float ref_y = 100.0F;  // refWhite from the white point, as initCIELabConversion
    x0 = white[0] / white[1] * ref_y;
    y0 = ref_y;
    z0 = (1.0F - white[0] - white[1]) / white[1] * ref_y;
    const double gamma = 1.0 / 2.4F;
    step = (100.0F - 1.0F) / kRange;
    for (int i = 0; i <= kRange; i++) gun[i] = 255u * float(std::pow(double(i) / kRange, gamma));
  }
  // TIFFCIELab16ToXYZ, then TIFFXYZToRGB
  void to_rgb(uint32_t l, int32_t a, int32_t b, uint8_t* rgb) const {
    const float L = float(l) * 100.0F / 65535.0F;
    float X, Y, Z, cby, tmp;
    if (L < 8.856F) {
      Y = (L * y0) / 903.292F;
      cby = 7.787F * (Y / y0) + 16.0F / 116.0F;
    } else {
      cby = (L + 16.0F) / 116.0F;
      Y = y0 * cby * cby * cby;
    }
    tmp = float(a) / 256.0F / 500.0F + cby;
    X = tmp < 0.2069F ? x0 * (tmp - 0.13793F) / 7.787F : x0 * tmp * tmp * tmp;
    tmp = cby - float(b) / 256.0F / 200.0F;
    Z = tmp < 0.2069F ? z0 * (tmp - 0.13793F) / 7.787F : z0 * tmp * tmp * tmp;
    static const float m[9] = {3.2410F, -1.5374F, -0.4986F, -0.9692F, 1.8760F, 0.0416F, 0.0556F, -0.2040F, 1.0570F};
    for (int c = 0; c < 3; c++) {
      float v = m[3 * c] * X + m[3 * c + 1] * Y + m[3 * c + 2] * Z;
      v = v > 1.0F ? v : 1.0F;
      v = v < 100.0F ? v : 100.0F;
      int i = int((v - 1.0F) / step);
      i = i < kRange ? i : kRange;
      const float g = gun[i];
      const uint32_t u = uint32_t(g > 0 ? g + 0.5 : g - 0.5);
      rgb[c] = uint8_t(u < 255u ? u : 255u);
    }
  }
};

// -- the put routines (tif_getimage.c) ----------------------------------------

// libtiff's UaToAa (unassociated alpha premultiplied) and Bitdepth16To8
struct Maps {
  uint8_t ua[256][256];
  uint8_t to8[65536];
  Maps() {
    for (int a = 0; a < 256; a++)
      for (int v = 0; v < 256; v++) ua[a][v] = uint8_t((v * a + 127) / 255);
    for (int n = 0; n < 65536; n++) to8[n] = uint8_t((n + 128) / 257);
  }
};

struct Tables {
  const uint8_t* map;  // [256] grey level of a sample (or of a 16-bit sample's high byte)
  const uint8_t* pal;  // [256 x 3] RGB of a palette index
  const int32_t* ycc;  // [5 x 256] libtiff's Y, Cr->R, Cb->B, Cr->G, Cb->G tables
  const Lab* lab;
  const uint8_t (*ua)[256];
  const uint8_t* to8;
  // grey or palette samples of 1, 2 or 4 bits: the BGR pixels of each byte
  std::vector<uint8_t> packed;  // [256 x 8 / bps x 3]
  Tables(const TiffParams& p, const uint8_t* m, const uint8_t* pl, const int32_t* y, const Lab* l)
      : map(m), pal(pl), ycc(y), lab(l) {
    static const Maps maps;
    ua = maps.ua;
    to8 = maps.to8;
    if ((p.put == PUT_GREY || p.put == PUT_PALETTE) && p.bps < 8) {
      const int per = 8 / p.bps, mask = (1 << p.bps) - 1;
      packed.resize(size_t(256 * per * 3));
      for (int b = 0; b < 256; b++) {
        for (int k = 0; k < per; k++) {
          const int v = (b >> (8 - p.bps * (k + 1))) & mask;
          uint8_t* q = &packed[size_t((b * per + k) * 3)];
          if (p.put == PUT_GREY) {
            q[0] = q[1] = q[2] = map[v];
          } else {
            q[0] = pal[3 * v + 2];
            q[1] = pal[3 * v + 1];
            q[2] = pal[3 * v];
          }
        }
      }
    }
  }
};

inline uint16_t u16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }

inline uint8_t clamp255(int32_t v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// TIFFYCbCrtoRGB on libtiff's tables
inline void ycbcr_to_rgb(const int32_t* t, int y, int cb, int cr, uint8_t* rgb) {
  const int32_t* ytab = t;
  const int32_t *cr_r = t + 256, *cb_b = t + 512, *cr_g = t + 768, *cb_g = t + 1024;
  rgb[0] = clamp255(ytab[y] + cr_r[cr]);
  rgb[1] = clamp255(ytab[y] + int32_t((cb_g[cb] + cr_g[cr]) >> 16));
  rgb[2] = clamp255(ytab[y] + cb_b[cb]);
}

// Where a block's pixels go: BGR rows of the output, mirrored when the
// orientation flips horizontally.
struct Dst {
  uint8_t* base;  // the block's first pixel in the output
  int64_t stride, cols;
  bool flip;
  uint8_t* at(int64_t y, int64_t x) const { return base + y * stride + 3 * (flip ? cols - 1 - x : x); }
};

// One block's `w` x `h` pixels from its buffer(s), with libtiff's steps:
// `skew` is the pixels of each buffer row past the `w` read (a clipped tile).
void put_block(const TiffParams& p, const Tables& t, const uint8_t* const* planes, int64_t w, int64_t h,
               int64_t skew, const Dst& dst) {
  const int spp = p.spp, bps = p.bps;
  int64_t y = 0, x = 0;
  auto emit = [&](uint8_t r, uint8_t g, uint8_t b) {
    uint8_t* q = dst.at(y, x++);
    q[0] = b;
    q[1] = g;
    q[2] = r;
  };
  if (p.put == PUT_YCBCR) {  // blocks: each pixel of a block takes its luma and the block's Cb and Cr
    const int hs = p.ycc_hs, vs = p.ycc_vs, size = hs * vs + 2;
    const int64_t across = (w + hs - 1) / hs;
    const uint8_t* pp = planes[0];
    uint8_t rgb[3];
    for (int64_t by = 0; by * vs < h; by++) {
      for (int64_t bx = 0; bx < across; bx++, pp += size) {
        for (int r = 0; r < vs && by * vs + r < h; r++) {
          for (int c = 0; c < hs && bx * hs + c < w; c++) {
            ycbcr_to_rgb(t.ycc, pp[r * hs + c], pp[hs * vs], pp[hs * vs + 1], rgb);
            uint8_t* q = dst.at(by * vs + r, bx * hs + c);
            q[0] = rgb[2];
            q[1] = rgb[1];
            q[2] = rgb[0];
          }
        }
      }
      pp += (skew / hs) * size;
    }
    return;
  }
  switch (p.put) {
    case PUT_GREY:
    case PUT_PALETTE: {
      const bool grey = p.put == PUT_GREY;
      auto one = [&](int v) {
        if (grey) {
          emit(t.map[v], t.map[v], t.map[v]);
        } else {
          emit(t.pal[3 * v], t.pal[3 * v + 1], t.pal[3 * v + 2]);
        }
      };
      const uint8_t* pp = planes[0];
      if (bps < 8) {  // a byte's pixels at once: the first ones of the last byte of a row
        const int per = 8 / bps;
        for (y = 0; y < h; y++) {
          for (x = 0; x < w; x += per) {
            const uint8_t* px = &t.packed[size_t(*pp++) * per * 3];
            const int64_t n = std::min<int64_t>(per, w - x);
            if (!dst.flip) {
              std::memcpy(dst.at(y, x), px, size_t(n * 3));
            } else {
              for (int64_t k = 0; k < n; k++) std::memcpy(dst.at(y, x + k), px + 3 * k, 3);
            }
          }
          pp += skew / per;
        }
      } else if (bps == 8) {
        for (y = 0; y < h; y++) {
          for (x = 0; x < w; pp += spp) one(*pp);
          pp += skew;
        }
      } else {  // 16-bit grey: the high byte
        for (y = 0; y < h; y++) {
          for (x = 0; x < w; pp += 2 * spp) one(u16(pp) >> 8);
          pp += skew;
        }
      }
      break;
    }
    case PUT_RGB8:
    case PUT_RGBUA8:
    case PUT_CMYK8: {
      const uint8_t* pp = planes[0];
      for (y = 0; y < h; y++) {
        for (x = 0; x < w; pp += spp) {
          if (p.put == PUT_RGB8) {
            emit(pp[0], pp[1], pp[2]);
          } else if (p.put == PUT_RGBUA8) {
            const uint8_t* m = t.ua[pp[3]];
            emit(m[pp[0]], m[pp[1]], m[pp[2]]);
          } else {
            const int k = 255 - pp[3];
            emit(uint8_t(k * (255 - pp[0]) / 255), uint8_t(k * (255 - pp[1]) / 255), uint8_t(k * (255 - pp[2]) / 255));
          }
        }
        pp += skew * spp;
      }
      break;
    }
    case PUT_CIELAB8:
    case PUT_CIELAB16: {
      const uint8_t* pp = planes[0];
      uint8_t rgb[3];
      for (y = 0; y < h; y++) {
        for (x = 0; x < w;) {
          if (p.put == PUT_CIELAB8) {
            t.lab->to_rgb(uint32_t(pp[0]) * 257, int32_t(int8_t(pp[1])) * 256, int32_t(int8_t(pp[2])) * 256, rgb);
            pp += 3;
          } else {
            t.lab->to_rgb(u16(pp), int16_t(u16(pp + 2)), int16_t(u16(pp + 4)), rgb);
            pp += 6;
          }
          emit(rgb[0], rgb[1], rgb[2]);
        }
        pp += skew * 3 * (p.put == PUT_CIELAB8 ? 1 : 2);
      }
      break;
    }
    case PUT_RGB16:
    case PUT_RGBUA16: {
      const uint8_t* pp = planes[0];
      for (y = 0; y < h; y++) {
        for (x = 0; x < w; pp += 2 * spp) {
          const uint8_t r = t.to8[u16(pp)], g = t.to8[u16(pp + 2)], b = t.to8[u16(pp + 4)];
          if (p.put == PUT_RGB16) {
            emit(r, g, b);
          } else {
            const uint8_t* m = t.ua[t.to8[u16(pp + 6)]];
            emit(m[r], m[g], m[b]);
          }
        }
        pp += 2 * skew * spp;
      }
      break;
    }
    default: {  // separate planes
      const int size = (p.put == PUT_SEP16 || p.put == PUT_SEPUA16) ? 2 : 1;
      const uint8_t *r = planes[0], *g = planes[1], *b = planes[2], *a = planes[3];
      for (y = 0; y < h; y++) {
        for (x = 0; x < w; r += size, g += size, b += size, a += size) {
          if (p.put == PUT_SEP8) {
            emit(*r, *g, *b);
          } else if (p.put == PUT_SEPUA8) {
            const uint8_t* m = t.ua[*a];
            emit(m[*r], m[*g], m[*b]);
          } else if (p.put == PUT_SEPCMYK8) {
            const int k = 255 - *a;
            emit(uint8_t(k * (255 - *r) / 255), uint8_t(k * (255 - *g) / 255), uint8_t(k * (255 - *b) / 255));
          } else if (p.put == PUT_SEPYCBCR) {
            uint8_t rgb[3];
            ycbcr_to_rgb(t.ycc, *r, *g, *b, rgb);
            emit(rgb[0], rgb[1], rgb[2]);
          } else if (p.put == PUT_SEP16) {
            emit(t.to8[u16(r)], t.to8[u16(g)], t.to8[u16(b)]);
          } else {
            const uint8_t* m = t.ua[t.to8[u16(a)]];
            emit(m[t.to8[u16(r)]], m[t.to8[u16(g)]], m[t.to8[u16(b)]]);
          }
        }
        r += skew * size;
        g += skew * size;
        b += skew * size;
        a += skew * size;
      }
      break;
    }
  }
}

// -- reading a block ----------------------------------------------------------

enum Status { OK = 0, FILL_FAILED = 1, BAD_TILE_SIZE = 2, BAD_PARAMS = 3, JPEG_FAILED = 4 };

struct Reader {
  const uint8_t* data;
  int64_t n;
  const TiffParams& p;
  const uint64_t* offsets;
  const uint64_t* counts;
  const Zlib& zl;
  Lzw lzw;
  FaxRuns fax;
  int64_t rawdatasize = 0;  // libtiff's raw buffer, for uncompressed tiles
  int64_t raw_offset = 0;   // the filled block's offset in the file
  std::vector<uint8_t> reversed;
  const uint8_t* jpeg_tables;  // the JPEGTables tag's bytes (JPEG), or null
  int64_t jpeg_tables_n;
  std::unique_ptr<JpegTiffTables> jpeg_state;  // null until JPEGSetupDecode has run
  int64_t segment_h = 0;       // the block's rows (a strip's, or the tile height)
  bool last_strip = false;     // a strip that ends the image

  Reader(const uint8_t* d, int64_t size, const TiffParams& params, const uint64_t* o, const uint64_t* c,
         const Zlib& z, const uint8_t* tables, int64_t ntables)
      : data(d), n(size), p(params), offsets(o), counts(c), zl(z), jpeg_tables(tables), jpeg_tables_n(ntables) {
    if (is_fax())
      fax.setup(p.block_w, p.compression == CCITT_G4 || (p.compression == CCITT_G3 && (p.group3_options & 1)));
  }

  bool is_fax() const {
    return p.compression == CCITT_RLE || p.compression == CCITT_G3 || p.compression == CCITT_G4 ||
           p.compression == CCITT_RLEW;
  }
  // the fax codecs read the bits in either order themselves, and TIFFInitJPEG
  // asks for none (TIFF_NOBITREV)
  bool no_bitrev() const { return is_fax() || p.compression == JPEG; }

  // tif_jpeg.c: JPEGSetupDecode reads JPEGTables once; JPEGPreDecode and
  // JPEGDecode read the block. false: the codec refused it
  bool jpeg(const uint8_t* raw, int64_t rawcc, uint8_t* buf, int64_t occ) {
    if (!jpeg_state) {
      jpeg_state.reset(new JpegTiffTables());
      if (jpeg_tables) jpeg_tiff_tables(jpeg_tables, jpeg_tables_n, jpeg_state.get());
    }
    const bool separate = p.planes != 0;
    const JpegTiffBlock b{int32_t(p.block_w), int32_t(segment_h), int32_t(last_strip), separate ? 1 : p.spp, p.bps,
                          p.jpeg_ycc ? p.ycc_hs : 1, p.jpeg_ycc ? p.ycc_vs : 1, p.jpeg_ycc};
    return jpeg_tiff_block(jpeg_state.get(), raw, rawcc, &b, buf, p.row_bytes, occ / p.row_bytes) == 0;
  }

  // TIFFFillStrip / TIFFFillTile: the block's raw bytes, or false
  bool fill(int64_t block, const uint8_t** raw, int64_t* rawcc) {
    if (block < 0 || block >= p.nblocks) return false;
    uint64_t count = counts[block];
    if (count == 0 || count > uint64_t(INT64_MAX)) return false;
    if (count > (1u << 20) && p.block_bytes != 0 && (count - 4096) / 10 > uint64_t(p.block_bytes))
      count = uint64_t(p.block_bytes) * 10 + 4096;
    const uint64_t off = offsets[block];
    if (count > uint64_t(n) || off > uint64_t(n) - count) return false;
    if (p.tiled) {  // the raw buffer libtiff holds the tile in
      if (p.mapped && (!p.bitrev || no_bitrev())) {
        rawdatasize = int64_t(count);
      } else {
        const int64_t rounded = int64_t((count + 1023) / 1024 * 1024);
        if (rounded > rawdatasize) rawdatasize = rounded;
      }
    }
    *raw = data + off;
    *rawcc = int64_t(count);
    raw_offset = int64_t(off);
    if (p.bitrev && !no_bitrev()) {
      reversed.assign(*raw, *raw + count);
      for (uint8_t& b : reversed) {
        b = uint8_t(((b * 0x0802u & 0x22110u) | (b * 0x8020u & 0x88440u)) * 0x10101u >> 16);
      }
      *raw = reversed.data();
    }
    return true;
  }

  // the codec on a filled block: 1 decoded, 0 failed, -1 refused before
  // decoding (JPEG: the fill fails)
  int decode(const uint8_t* raw, int64_t rawcc, uint8_t* buf, int64_t occ) {
    int ok;
    switch (p.compression) {
      case JPEG:
        return jpeg(raw, rawcc, buf, occ) ? 1 : -1;  // no predictor, no byte swap
      case NONE:
        if (rawcc < occ) return 0;
        std::memcpy(buf, raw, size_t(occ));
        ok = 1;
        break;
      case LZW:
        ok = lzw_decode(lzw, raw, rawcc, buf, occ);
        break;
      case PACKBITS:
        ok = packbits_decode(raw, rawcc, buf, occ);
        break;
      case DEFLATE:
        ok = zip_decode(zl, raw, rawcc, buf, occ);
        break;
      case CCITT_RLE:
      case CCITT_RLEW:
      case CCITT_G3:
      case CCITT_G4: {
        // RLEW aligns on the data's address: the file's offset when mapped,
        // the start of libtiff's own raw buffer when streamed
        const FaxKind kind = p.compression == CCITT_RLE    ? FAX_RLE
                             : p.compression == CCITT_RLEW ? FAX_RLEW
                             : p.compression == CCITT_G4   ? FAX_G4
                             : (p.group3_options & 1)      ? FAX_G3_2D
                                                           : FAX_G3_1D;
        FaxDecoder(kind, fax, raw, rawcc, p.bitrev != 0, p.block_w, p.mapped ? raw_offset : 0)
            .decode(buf, occ, p.row_bytes);
        return 1;  // the buffer holds what was decoded whatever the codec's answer
      }
      default:  // a compression libtiff knows no codec for: its decode fails
        return 0;
    }
    if (!ok) return 0;
    const bool predicted = p.predictor == 2 && (p.compression == LZW || p.compression == DEFLATE);
    const int stride = p.planes ? 1 : p.spp;
    if (predicted) {
      undo_predictor(buf, occ, p.row_bytes, p.bps, stride, p.swab && p.bps == 16);
    } else if (p.swab && p.bps == 16) {
      swab16(buf, occ);
    }
    return 1;
  }

  // the first plane (or the only one): a fill failure ends the decode
  Status first(int64_t block, uint8_t* buf, int64_t occ) {
    const uint8_t* raw;
    int64_t rawcc;
    if (!fill(block, &raw, &rawcc)) return FILL_FAILED;
    if (p.tiled && p.compression == NONE && rawdatasize != p.block_bytes) return BAD_TILE_SIZE;
    return decode(raw, rawcc, buf, occ) < 0 ? JPEG_FAILED : OK;
  }

  // another plane of a separate image: every failure is ignored
  void other(int64_t block, uint8_t* buf, int64_t occ) {
    if (!p.tiled && p.compression == NONE && !p.mapped) {  // read straight from the strip's offset
      if (block >= p.nblocks) return;
      const uint64_t off = offsets[block];
      if (off > uint64_t(n)) return;
      const int64_t got = std::min<int64_t>(occ, n - int64_t(off));
      std::memcpy(buf, data + off, size_t(got));
      if (got < occ) return;
      if (p.bitrev) {
        for (int64_t i = 0; i < occ; i++) {
          const uint8_t b = buf[i];
          buf[i] = uint8_t(((b * 0x0802u & 0x22110u) | (b * 0x8020u & 0x88440u)) * 0x10101u >> 16);
        }
      }
      if (p.swab && p.bps == 16) swab16(buf, occ);
      return;
    }
    const uint8_t* raw;
    int64_t rawcc;
    if (!fill(block, &raw, &rawcc) || decode(raw, rawcc, buf, occ) < 0) std::memset(buf, 0, size_t(occ));
  }
};

}  // namespace

extern "C" {

// data[n]: the file. offsets[], counts[]: p->nblocks strip or tile offsets and
// byte counts, after libtiff's directory fix-ups. map: [256] grey levels;
// pal: [256 x 3] palette RGB. ycc: [5 x 256] YCbCr tables (YCbCr only). zinit / zinflate / zend / zversion: zlib's
// inflateInit2_, inflate, inflateEnd and version string (deflate only). jpeg_tables[jpeg_tables_n]: the
// JPEGTables tag's bytes (JPEG; null when the tag is absent or libtiff drops it).
// out: height x width x 3 BGR, each block at its stored place. Written
// block by block: only meaningful on 0.
int tiff_decode(const uint8_t* data, int64_t n, const TiffParams* params, const uint64_t* offsets,
                const uint64_t* counts, const uint8_t* map, const uint8_t* pal, const int32_t* ycc, void* zinit,
                void* zinflate, void* zend, const char* zversion, const uint8_t* jpeg_tables, int64_t jpeg_tables_n,
                uint8_t* out) {
  const TiffParams& p = *params;
  if ((p.put == PUT_YCBCR || p.put == PUT_SEPYCBCR) && (!ycc || p.ycc_hs <= 0 || p.ycc_vs <= 0)) return BAD_PARAMS;
  if (p.width <= 0 || p.height <= 0 || p.block_w <= 0 || p.block_h <= 0 || p.row_bytes <= 0 || p.block_bytes <= 0 ||
      p.spp <= 0 || (p.bps != 1 && p.bps != 2 && p.bps != 4 && p.bps != 8 && p.bps != 16) || p.planes < 0 ||
      p.planes > 4 || (p.compression == DEFLATE && !zinit) || (p.jpeg_ycc && (p.ycc_hs <= 0 || p.ycc_vs <= 0)))
    return BAD_PARAMS;
  const Zlib zl{reinterpret_cast<InflateInit2>(zinit), reinterpret_cast<Inflate>(zinflate),
                reinterpret_cast<InflateEnd>(zend), zversion};
  const bool lab_put = p.put == PUT_CIELAB8 || p.put == PUT_CIELAB16;
  const std::unique_ptr<Lab> lab(lab_put ? new Lab(p.white) : nullptr);
  const Tables tables(p, map, pal, ycc, lab.get());
  Reader rd(data, n, p, offsets, counts, zl, jpeg_tables, jpeg_tables_n);
  const int64_t nplanes = p.planes ? p.planes : 1;
  std::vector<uint8_t> buf(size_t(p.block_bytes * nplanes));
  for (int64_t y = 0; y < p.height; y += p.block_h) {
    const int64_t rows = std::min(p.block_h, p.height - y);
    for (int64_t x = 0; x < p.width; x += p.block_w) {
      const int64_t cols = std::min(p.block_w, p.width - x);
      const int64_t block = (y / p.block_h) * p.blocks_across + x / p.block_w;
      // a strip's buffer holds its rows (of YCbCr, its rows rounded up to
      // whole blocks, read at the scanline size libtiff rounds down); a
      // tile's, the whole tile
      int64_t occ = p.tiled ? p.block_bytes : rows * p.row_bytes;
      if (p.put == PUT_YCBCR && !p.tiled)
        occ = std::min((rows + p.ycc_vs - 1) / p.ycc_vs * p.ycc_vs * p.row_bytes,
                       (rows + p.ycc_vs - 1) / p.ycc_vs * p.sampling_row);
      std::fill(buf.begin(), buf.end(), 0);
      rd.segment_h = p.tiled ? p.block_h : rows;
      rd.last_strip = !p.tiled && y + rows == p.height;
      const uint8_t* planes[4];
      if (p.planes == 0) {
        const Status s = rd.first(block, buf.data(), occ);
        if (s != OK) return s;
        planes[0] = planes[1] = planes[2] = planes[3] = buf.data();
      } else {
        for (int k = 0; k < p.planes; k++) {
          uint8_t* plane = buf.data() + k * p.block_bytes;
          const int64_t b = block + int64_t(p.plane_index[k]) * p.blocks_per_plane;
          if (k == 0) {
            const Status s = rd.first(b, plane, occ);
            if (s != OK) return s;
          } else {
            rd.other(b, plane, occ);
          }
        }
        // grey planes: one colour plane read as all three, the alpha after it
        const bool grey = p.planes == 1 || (p.planes == 2 && p.put != PUT_SEPCMYK8);
        planes[0] = buf.data();
        planes[1] = grey ? buf.data() : buf.data() + p.block_bytes;
        planes[2] = grey ? buf.data() : buf.data() + 2 * p.block_bytes;
        planes[3] = buf.data() + (p.planes - 1) * p.block_bytes;
      }
      put_block(p, tables, planes, cols, rows, p.block_w - cols,
                Dst{out + (y * p.width + x) * 3, p.width * 3, cols, p.flip_h != 0});
    }
  }
  return OK;
}

}  // extern "C"
