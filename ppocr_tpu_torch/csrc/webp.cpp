// A lossless WebP image (the VP8L bitstream) as libwebp decodes it under
// cv2.imdecode(buf, IMREAD_COLOR): OpenCV 5.0's bundled libwebp
// (src/dec/vp8l_dec.c, src/utils/huffman_utils.c, src/dsp/lossless.c),
// without its incremental mode (host code).
//
// The stream is read least significant bit first. Its header is the
// signature byte 0x2f, 14-bit width - 1 and height - 1, the alpha bit and a
// 3-bit version that must be 0. Then, at the top level only, up to four
// transforms (each kind at most once), the colour cache and the meta prefix
// codes; then the ARGB pixels, coded with prefix codes, backward references
// (LZ77) and colour cache hits. Sub-images (a transform's data, the meta
// prefix-code image) are coded the same way without transforms or meta
// codes. The transforms are undone in the reverse of their order.
//
// The data ends as the bit reader of a non-incremental WebPDecode ends it:
// a decode that needs a bit past the last byte fails (a stream shorter than
// 8 bytes reads as 64 bits, zero-padded); data past the last pixel is
// ignored.
//
// C interface (ctypes):
//   int vp8l_decode(const uint8_t* data, int64_t n, uint8_t* out,
//                   int32_t width, int32_t height);
//     out: height x width x 3 BGR, the alpha dropped; width and height must
//     be the header's. Written only on success.
//   Returns 0 or a Status code below.
//   int vp8l_decode_alpha(...): a lossy WebP's lossless alpha plane
//     (csrc/webp_alpha.h).

#include "webp_alpha.h"

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

namespace {

enum Status {
  OK = 0,
  BAD_HEADER = 1,       // signature, version
  END_OF_DATA = 2,      // a bit past the last byte
  TRANSFORM_TWICE = 3,  // a transform kind given again
  BAD_CACHE_BITS = 4,   // colour cache bits outside 1..11
  BAD_CODE = 5,         // a prefix code that is over-subscribed, incomplete or empty
  BAD_CODE_LENGTHS = 6, // max_symbol or a repeat past the alphabet
  BAD_COPY = 7,         // a backward reference before the first pixel or past the last
  NO_MEMORY = 8,
  BAD_ARGUMENT = 9,
};

struct Failure {
  Status status;
};

[[noreturn]] void fail(Status s) { throw Failure{s}; }

// vp8l_dec.c's alphabet sizes: green + length codes, red, blue, alpha, distance
constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, kNumLiteralCodes, kNumLiteralCodes,
                                  kNumLiteralCodes, kNumDistanceCodes};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kCodeLengthCodes = 19;
constexpr uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                            7,  8,  9, 10, 11, 12, 13, 14, 15};
constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;        // HUFFMAN_TABLE_BITS
constexpr int kLengthsRootBits = 7; // LENGTHS_TABLE_BITS
constexpr int kMaxCacheBits = 11;

// vp8l_dec.c kCodeToPlane: (dy << 4) | (8 - dx) of the 120 short distances
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b,
    0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

// vp8l_utils / bit_reader_utils.c: the VP8L bit reader. Bits past the data
// read as 0; `pos > end` is VP8LIsEndOfStream.
struct Bits {
  std::vector<uint8_t> buf;
  uint64_t pos = 0, end = 0;

  Bits(const uint8_t* d, int64_t n) {
    buf.assign(size_t(n) + 16, 0);
    if (n) std::memcpy(buf.data(), d, size_t(n));
    // VP8LInitBitReader loads min(n, 8) bytes into a 64-bit window: a
    // shorter stream still reads 64 bits before its end
    end = 8 * uint64_t(n < 8 ? 8 : n);
  }
  uint64_t peek() const {
    const uint64_t at = pos >> 3;
    if (at + 8 > buf.size()) {
      uint64_t v = 0;
      for (uint64_t k = 0; at + k < buf.size() && k < 8; k++) v |= uint64_t(buf[at + k]) << (8 * k);
      return v >> (pos & 7);
    }
    uint64_t v;
    std::memcpy(&v, buf.data() + at, 8);
    return v >> (pos & 7);
  }
  uint32_t read(int n) {  // n <= 24 (VP8L_MAX_NUM_BIT_READ)
    const uint32_t v = uint32_t(peek()) & ((1u << n) - 1);
    pos += n;
    return v;
  }
  bool eos() const { return pos > end; }
};

struct Code {  // huffman_utils.h HuffmanCode
  uint8_t bits;
  uint16_t value;
};

// huffman_utils.c GetNextKey: the next bit-reversed key of `len` bits
uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(Code* table, int step, int end, Code code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// huffman_utils.c BuildHuffmanTable: the table's size, or 0 for a code that
// is empty, over-subscribed or incomplete (one used symbol of any length
// makes a code that reads no bits). With `root` null it only checks.
int build_table(Code* root, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; s++) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(root ? n : 0);
  for (int s = 0; s < n; s++) {
    const int len = lengths[s];
    if (len > 0) {
      if (root) sorted[offset[len]] = uint16_t(s);
      offset[len]++;
    }
  }
  int total_size = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {  // one symbol: no bits
    if (root) replicate(root, 1, total_size, Code{0, sorted[0]});
    return total_size;
  }
  Code* table = root;
  uint32_t low = 0xffffffffu;
  const uint32_t mask = uint32_t(total_size) - 1;
  uint32_t key = 0;
  int num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << root_bits, symbol = 0;
  int len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, Code{uint8_t(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root) {
          root[low].bits = uint8_t(table_bits + root_bits);
          root[low].value = uint16_t((table - root) - low);
        }
      }
      if (root) replicate(&table[key >> root_bits], step, table_size, Code{uint8_t(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;  // incomplete
  return total_size;
}

// vp8l_dec.c ReadSymbol
inline int read_symbol(const Code* table, Bits& br) {
  uint64_t val = br.peek();
  table += val & ((1u << kRootBits) - 1);
  const int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br.pos += kRootBits;
    val = br.peek();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.pos += table->bits;
  return table->value;
}

// vp8l_dec.c GetCopyDistance (and GetCopyLength)
inline int copy_value(int symbol, Bits& br) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + int(br.read(extra_bits)) + 1;
}

// vp8l_dec.c PlaneCodeToDistance: a distance below 1 is 1
inline int plane_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Group {
  int table[5];  // offsets into Entropy::tables
};

// the prefix codes of one (sub-)image
struct Entropy {
  std::vector<Code> tables;
  std::vector<Group> groups;
  std::vector<uint32_t> meta;  // group index per block; empty: one group
  int meta_bits = 0, meta_xsize = 0;
  int cache_bits = 0;
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Decoder {
  Bits br;
  Transform transforms[4];
  int num_transforms = 0;
  uint32_t seen = 0;

  Decoder(const uint8_t* d, int64_t n) : br(d, n) {}

  // vp8l_dec.c ReadHuffmanCodeLengths
  void read_code_lengths(const int* code_length_code_lengths, int num_symbols, int* lengths) {
    Code table[1 << kLengthsRootBits];
    if (!build_table(table, kLengthsRootBits, code_length_code_lengths, kCodeLengthCodes)) fail(BAD_CODE);
    int max_symbol;
    if (br.read(1)) {  // use length
      const int length_nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(length_nbits));
      if (max_symbol > num_symbols) fail(BAD_CODE_LENGTHS);
    } else {
      max_symbol = num_symbols;
    }
    int symbol = 0, prev = 8;  // DEFAULT_CODE_LENGTH
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      if (br.eos()) fail(END_OF_DATA);
      const Code& p = table[br.peek() & ((1u << kLengthsRootBits) - 1)];
      br.pos += p.bits;
      const int code_len = p.value;
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len) prev = code_len;
      } else {  // 16: repeat the previous non-zero length 3..6 times; 17, 18: zeros 3..10, 11..138
        static constexpr int kExtraBits[3] = {2, 3, 7}, kOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = int(br.read(kExtraBits[slot])) + kOffsets[slot];
        if (symbol + repeat > num_symbols) fail(BAD_CODE_LENGTHS);
        const int length = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
  }

  // vp8l_dec.c ReadHuffmanCode: appends the table to `out` (if not null)
  // and returns its offset
  int read_code(int alphabet_size, std::vector<Code>* out) {
    std::vector<int> lengths(alphabet_size > 256 ? alphabet_size : 256, 0);
    if (br.read(1)) {  // simple: one or two symbols, the first of 1 or 8 bits
      const int num_symbols = int(br.read(1)) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (num_symbols == 2) lengths[br.read(8)] = 1;
    } else {
      int code_length_code_lengths[kCodeLengthCodes] = {0};
      const int num_codes = int(br.read(4)) + 4;
      for (int i = 0; i < num_codes; i++) code_length_code_lengths[kCodeLengthCodeOrder[i]] = int(br.read(3));
      read_code_lengths(code_length_code_lengths, alphabet_size, lengths.data());
    }
    if (br.eos()) fail(END_OF_DATA);
    const int size = build_table(nullptr, kRootBits, lengths.data(), alphabet_size);
    if (!size) fail(BAD_CODE);
    if (!out) return 0;
    const size_t at = out->size();
    out->resize(at + size_t(size));
    build_table(out->data() + at, kRootBits, lengths.data(), alphabet_size);
    return int(at);
  }

  // vp8l_dec.c ReadHuffmanCodes (and ReadHuffmanCodesHelper)
  void read_codes(int xsize, int ysize, bool allow_meta, Entropy& e) {
    int num_groups_max = 1;
    std::vector<int> mapping;
    if (allow_meta && br.read(1)) {
      const int bits = 2 + int(br.read(3));
      const int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
      e.meta = sub_image(hx, hy);
      e.meta_bits = bits;
      e.meta_xsize = hx;
      for (uint32_t& g : e.meta) {
        g = (g >> 8) & 0xffff;
        if (int(g) >= num_groups_max) num_groups_max = int(g) + 1;
      }
      // the indices no block uses: their codes are read and checked, not kept
      if (num_groups_max > 1000 || num_groups_max > int64_t(xsize) * ysize) {
        mapping.assign(size_t(num_groups_max), -1);
        int used = 0;
        for (uint32_t& g : e.meta) {
          if (mapping[g] < 0) mapping[g] = used++;
          g = uint32_t(mapping[g]);
        }
        e.groups.resize(size_t(used));
      }
    }
    if (br.eos()) fail(END_OF_DATA);
    if (mapping.empty()) e.groups.resize(size_t(num_groups_max));
    for (int i = 0; i < num_groups_max; i++) {
      const bool keep = mapping.empty() || mapping[i] >= 0;
      Group& g = e.groups[mapping.empty() ? i : (keep ? mapping[i] : 0)];
      for (int j = 0; j < 5; j++) {
        const int alphabet = kAlphabetSize[j] + (j == 0 && e.cache_bits > 0 ? 1 << e.cache_bits : 0);
        const int at = read_code(alphabet, keep ? &e.tables : nullptr);
        if (keep) g.table[j] = at;
      }
    }
  }

  // vp8l_dec.c DecodeImageData: the entropy-coded pixels of a width x
  // height image. `green_only`: alpha_dec.c's DecodeAlphaData, the 8-bit
  // path of an alpha plane, which fails only where the data ends before the
  // last pixel (DecodeImageData also where it ends with it).
  void decode_pixels(Entropy& e, int width, int height, uint32_t* data, bool green_only = false) {
    const int64_t total = int64_t(width) * height;
    const int len_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_size = e.cache_bits ? 1 << e.cache_bits : 0;
    const int cache_shift = 32 - e.cache_bits;
    std::vector<uint32_t> cache(size_t(cache_size), 0);
    const Code* base = e.tables.data();
    auto group_at = [&](int col, int row) -> const Group& {
      if (e.meta.empty()) return e.groups[0];
      return e.groups[e.meta[size_t(row >> e.meta_bits) * size_t(e.meta_xsize) + size_t(col >> e.meta_bits)]];
    };
    // every decoded pixel goes into the colour cache, in order
    // (VP8LColorCacheInsert: the hash 0x1e35a7bd * argb >> (32 - bits))
    auto insert = [&](uint32_t argb) {
      if (cache_size) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    };
    int64_t at = 0;
    int col = 0, row = 0;
    while (at < total) {
      if (br.eos()) fail(END_OF_DATA);
      const Group& g = group_at(col, row);
      const int code = read_symbol(base + g.table[GREEN], br);
      if (code < kNumLiteralCodes) {
        const int red = read_symbol(base + g.table[RED], br);
        const int blue = read_symbol(base + g.table[BLUE], br);
        const int alpha = read_symbol(base + g.table[ALPHA], br);
        if (br.eos() && !green_only) fail(END_OF_DATA);
        const uint32_t argb = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) | (uint32_t(code) << 8) | uint32_t(blue);
        data[at++] = argb;
        insert(argb);
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < len_limit) {  // backward reference
        const int length = copy_value(code - kNumLiteralCodes, br);
        const int dist_symbol = read_symbol(base + g.table[DIST], br);
        const int dist = plane_to_distance(width, copy_value(dist_symbol, br));
        if (br.eos() && !green_only) fail(END_OF_DATA);
        if (at < dist || total - at < length) fail(BAD_COPY);
        for (int k = 0; k < length; k++, at++) {
          data[at] = data[at - dist];
          insert(data[at]);
        }
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
      } else {  // colour cache (the code is below the alphabet's size)
        const uint32_t argb = cache[size_t(code - len_limit)];
        data[at++] = argb;
        insert(argb);
        if (++col >= width) {
          col = 0;
          ++row;
        }
      }
    }
    if (br.eos() && !green_only) fail(END_OF_DATA);
  }

  // vp8l_dec.c DecodeImageStream, after the transforms (which only the top
  // level has): the colour cache bits, then the prefix codes (meta codes at
  // the top level only)
  void read_entropy(int xsize, int ysize, bool top, Entropy& e) {
    if (br.read(1)) {
      e.cache_bits = int(br.read(4));
      if (e.cache_bits < 1 || e.cache_bits > kMaxCacheBits) fail(BAD_CACHE_BITS);
    }
    read_codes(xsize, ysize, top, e);
  }

  // a transform's data or the meta prefix-code image
  std::vector<uint32_t> sub_image(int xsize, int ysize) {
    Entropy e;
    read_entropy(xsize, ysize, false, e);
    std::vector<uint32_t> px(size_t(xsize) * size_t(ysize), 0);
    decode_pixels(e, xsize, ysize, px.data());
    return px;
  }

  // vp8l_dec.c ReadTransform (and ExpandColorMap)
  void read_transform(int* xsize, int ysize) {
    const int type = int(br.read(2));
    if (seen & (1u << type)) fail(TRANSFORM_TWICE);
    seen |= 1u << type;
    Transform& t = transforms[num_transforms++];
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    t.bits = 0;
    if (type == 0 || type == 1) {  // predictor, cross-colour: block bits 2..9
      t.bits = 2 + int(br.read(3));
      t.data = sub_image(subsample(t.xsize, t.bits), subsample(ysize, t.bits));
    } else if (type == 3) {  // colour indexing: 2, 4 or 16 colours pack 8, 4 or 2 pixels a byte
      const int num_colors = int(br.read(8)) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, bits);
      t.bits = bits;
      const std::vector<uint32_t> palette = sub_image(num_colors, 1);
      // delta-coded by byte; the entries past the palette are transparent
      // black, up to 1 << (8 >> bits)
      const int final_num = 1 << (8 >> bits);
      t.data.assign(size_t(final_num), 0);
      t.data[0] = palette[0];
      for (int i = 1; i < num_colors; i++) {
        uint32_t v = 0;
        for (int b = 0; b < 32; b += 8) v |= (((palette[i] >> b) + (t.data[i - 1] >> b)) & 0xff) << b;
        t.data[i] = v;
      }
    }
  }
};

// lossless.c: per-byte sums and the predictors
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int add_sub_full(int a, int b, int c) { return int(clip255(uint32_t(a + b - c))); }
inline int add_sub_half(int a, int b) { return int(clip255(uint32_t(a + (a - b) / 2))); }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

template <int kMode>
inline uint32_t predict(const uint32_t* out, const uint32_t* top) {
  const uint32_t L = out[-1], T = top[0], TL = top[-1], TR = top[1];
  switch (kMode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {  // Select(T, L, TL)
      int d = 0;
      for (int s = 0; s < 32; s += 8) d += sub3(int((T >> s) & 0xff), int((L >> s) & 0xff), int((TL >> s) & 0xff));
      return d <= 0 ? T : L;
    }
    case 12: {  // ClampedAddSubtractFull(L, T, TL)
      uint32_t v = 0;
      for (int s = 0; s < 32; s += 8)
        v |= uint32_t(add_sub_full(int((L >> s) & 0xff), int((T >> s) & 0xff), int((TL >> s) & 0xff))) << s;
      return v;
    }
    case 13: {  // ClampedAddSubtractHalf(L, T, TL)
      const uint32_t ave = average2(L, T);
      uint32_t v = 0;
      for (int s = 0; s < 32; s += 8) v |= uint32_t(add_sub_half(int((ave >> s) & 0xff), int((TL >> s) & 0xff))) << s;
      return v;
    }
    default:  // 0, and 14 and 15 (VP8LPredictorsAdd's padding entries are PredictorAdd0)
      return 0xff000000u;
  }
}

// lossless.c PredictorAdd<mode>_C: a run of pixels of one block
template <int kMode>
void predictor_add(const uint32_t* in, const uint32_t* top, int n, uint32_t* out) {
  for (int x = 0; x < n; x++) out[x] = add_pixels(in[x], predict<kMode>(out + x, top + x));
}

using PredictorAdd = void (*)(const uint32_t*, const uint32_t*, int, uint32_t*);
constexpr PredictorAdd kPredictorAdd[16] = {
    predictor_add<0>, predictor_add<1>, predictor_add<2>,  predictor_add<3>,  predictor_add<4>,  predictor_add<5>,
    predictor_add<6>, predictor_add<7>, predictor_add<8>,  predictor_add<9>,  predictor_add<10>, predictor_add<11>,
    predictor_add<12>, predictor_add<13>, predictor_add<0>, predictor_add<0>};

// The inverse transforms work in place on the image, which is sized for its
// full width: each pixel is read before it is written, and the predictors
// read only pixels already written.

// lossless.c PredictorInverseTransform_C: the top-left pixel predicts from
// black, the rest of row 0 from L, column 0 from T
void predictor_inverse(const Transform& t, uint32_t* px) {
  const int w = t.xsize;
  const int tile = 1 << t.bits;
  const int tiles_per_row = subsample(w, t.bits);
  px[0] = add_pixels(px[0], 0xff000000u);
  for (int x = 1; x < w; x++) px[x] = add_pixels(px[x], px[x - 1]);
  for (int y = 1; y < t.ysize; y++) {
    const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * size_t(tiles_per_row);
    uint32_t* row = px + size_t(y) * size_t(w);
    const uint32_t* top = row - w;
    row[0] = add_pixels(row[0], top[0]);
    for (int x = 1; x < w;) {
      const int x_end = (x & ~(tile - 1)) + tile < w ? (x & ~(tile - 1)) + tile : w;
      kPredictorAdd[(modes[x >> t.bits] >> 8) & 0xf](row + x, top + x, x_end - x, row + x);
      x = x_end;
    }
  }
}

// lossless.c VP8LTransformColorInverse_C: signed 8-bit products >> 5; blue
// takes the new red
inline int color_delta(int8_t pred, int8_t color) { return (int(pred) * color) >> 5; }

void cross_color_inverse(const Transform& t, uint32_t* px) {
  const int w = t.xsize;
  const int tile = 1 << t.bits;
  const int tiles_per_row = subsample(w, t.bits);
  for (int y = 0; y < t.ysize; y++) {
    const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * size_t(tiles_per_row);
    uint32_t* row = px + size_t(y) * size_t(w);
    for (int x0 = 0; x0 < w; x0 += tile) {
      const uint32_t code = codes[x0 >> t.bits];
      const int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff), r2b = int8_t((code >> 16) & 0xff);
      const int x_end = x0 + tile < w ? x0 + tile : w;
      for (int x = x0; x < x_end; x++) {
        const uint32_t argb = row[x];
        const int8_t green = int8_t(argb >> 8);
        int red = int((argb >> 16) & 0xff);
        int blue = int(argb & 0xff);
        red = (red + color_delta(g2r, green)) & 0xff;
        blue += color_delta(g2b, green);
        blue = (blue + color_delta(r2b, int8_t(red))) & 0xff;
        row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
      }
    }
  }
}

// lossless.c VP8LAddGreenToBlueAndRed_C
void add_green(int64_t n, uint32_t* px) {
  for (int64_t i = 0; i < n; i++) {
    const uint32_t argb = px[i];
    const uint32_t green = (argb >> 8) & 0xff;
    const uint32_t rb = (argb & 0x00ff00ffu) + ((green << 16) | green);
    px[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
}

// lossless.c ColorIndexInverseTransform_C: the index is the green byte,
// packed pixels from the low bits up. The rows widen, so they are unpacked
// from the last one up, each from a copy of its packed pixels: a row's
// output never reaches a packed row not yet read.
void color_index_inverse(const Transform& t, uint32_t* px) {
  const int w = t.xsize;
  const int packed_w = subsample(w, t.bits);
  const int bits_per_pixel = 8 >> t.bits;
  const int per_byte_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  const uint32_t* map = t.data.data();
  std::vector<uint32_t> packed_row(size_t(packed_w), 0);
  for (int y = t.ysize - 1; y >= 0; y--) {
    std::memcpy(packed_row.data(), px + size_t(y) * size_t(packed_w), size_t(packed_w) * sizeof(uint32_t));
    const uint32_t* src = packed_row.data();
    uint32_t* dst = px + size_t(y) * size_t(w);
    uint32_t packed = 0;
    for (int x = 0; x < w; x++) {
      if ((x & per_byte_mask) == 0) packed = (*src++ >> 8) & 0xff;
      dst[x] = map[packed & bit_mask];
      packed >>= bits_per_pixel;
    }
  }
}

void undo_transforms(const Decoder& dec, uint32_t* px) {
  for (int k = dec.num_transforms - 1; k >= 0; k--) {  // in the reverse of their order
    const Transform& t = dec.transforms[k];
    switch (t.type) {
      case 0: predictor_inverse(t, px); break;
      case 1: cross_color_inverse(t, px); break;
      case 2: add_green(int64_t(t.xsize) * t.ysize, px); break;
      default: color_index_inverse(t, px); break;
    }
  }
}

Status read_header(Bits& br, int* w, int* h, int* alpha) {
  if (br.read(8) != 0x2f) return BAD_HEADER;
  *w = int(br.read(14)) + 1;
  *h = int(br.read(14)) + 1;
  *alpha = int(br.read(1));
  if (br.read(3) != 0) return BAD_HEADER;
  return br.eos() ? END_OF_DATA : OK;
}

}  // namespace

extern "C" int vp8l_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t width, int32_t height) {
  if (n < 0) return BAD_ARGUMENT;
  try {
    Decoder dec(data, n);
    int w, h, a;
    const Status s = read_header(dec.br, &w, &h, &a);
    if (s) return s;
    if (w != width || h != height) return BAD_ARGUMENT;
    int xsize = w;  // colour indexing narrows the coded width
    while (dec.br.read(1)) dec.read_transform(&xsize, h);
    Entropy top;
    dec.read_entropy(xsize, h, true, top);
    const size_t full = size_t(w) * size_t(h);
    std::unique_ptr<uint32_t[]> buf(new uint32_t[full]);
    uint32_t* px = buf.get();
    dec.decode_pixels(top, xsize, h, px);
    undo_transforms(dec, px);
    for (size_t i = 0; i < full; i++) {
      const uint32_t argb = px[i];
      out[3 * i] = uint8_t(argb);
      out[3 * i + 1] = uint8_t(argb >> 8);
      out[3 * i + 2] = uint8_t(argb >> 16);
    }
    return OK;
  } catch (const Failure& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return NO_MEMORY;
  }
}

extern "C" int vp8l_decode_alpha(const uint8_t* data, int64_t n, int32_t width, int32_t height, uint8_t* out) {
  if (n < 0 || width <= 0 || height <= 0) return BAD_ARGUMENT;
  try {
    Decoder dec(data, n);
    int xsize = width;
    while (dec.br.read(1)) dec.read_transform(&xsize, height);
    Entropy top;
    dec.read_entropy(xsize, height, true, top);
    // vp8l_dec.c Is8bOptimizable, for the colour indexing transform alone
    bool green_only = dec.num_transforms == 1 && dec.transforms[0].type == 3 && top.cache_bits == 0;
    for (const Group& g : top.groups)
      for (int j : {RED, BLUE, ALPHA}) green_only = green_only && top.tables[size_t(g.table[j])].bits == 0;
    std::unique_ptr<uint32_t[]> buf(new uint32_t[size_t(width) * size_t(height)]);
    dec.decode_pixels(top, xsize, height, buf.get(), green_only);
    if (!out) return OK;
    undo_transforms(dec, buf.get());
    for (size_t i = 0; i < size_t(width) * size_t(height); i++) out[i] = uint8_t(buf[i] >> 8);
    return OK;
  } catch (const Failure& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return NO_MEMORY;
  }
}
