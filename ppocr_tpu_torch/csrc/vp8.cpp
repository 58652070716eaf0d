// A lossy WebP image (the VP8 key frame, with its ALPH chunk) as libwebp
// decodes it under cv2.imdecode(buf, IMREAD_COLOR): OpenCV 5.0's bundled
// libwebp (src/dec/vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c,
// io_dec.c, alpha_dec.c; src/utils/bit_reader*; src/dsp/dec.c,
// upsampling.c, yuv.h, filters.c), without its incremental mode and its
// threads, which change no pixel (host code).
//
// The frame is one key frame of 16x16 macroblocks: a frame tag, the start
// code and the 14-bit width and height, then partition 0 (segment and
// filter headers, quantisers, coefficient probabilities, the intra modes of
// every macroblock) and 1, 2, 4 or 8 partitions of coefficient tokens, each
// read by its own boolean decoder. Each macroblock is predicted (16x16 or
// 4x4 luma modes, 8x8 chroma modes) from its unfiltered neighbours and the
// inverse DCT/WHT of its dequantised coefficients added. The loop filter
// then runs over the whole frame, macroblock by macroblock in raster order
// (libwebp filters each row behind its reconstruction, which reads only
// unfiltered samples: the same order). The 4:2:0 planes become BGR by
// libwebp's fancy upsampler and its 14-bit YUV -> RGB; the whole frame is
// upsampled in one pass, which gives the bytes libwebp's batches of rows
// give (EmitFancyRGB carries the unfinished row from batch to batch).
//
// The data ends as the non-incremental decoder ends it: a boolean decoder
// that loads past its partition's last byte sets eof (bit_reader_utils.c
// VP8LoadFinalBytes), and eof in partition 0 after a row of intra modes or
// in a token partition after a macroblock fails the decode.
//
// The alpha plane (ALPH): a header byte (compression method 0 raw or 1
// lossless, filter 0..3, pre-processing 0..1, reserved bits 0), then the
// plane raw or as a VP8L image stream without its header, read as the green
// channel (csrc/webp.cpp), then unfiltered (horizontal, vertical,
// gradient). libwebp decodes it whenever the chunk is there, whatever the
// output mode: a bad ALPH chunk refuses the file. Its values never reach
// the BGR output.
//
// C interface (ctypes):
//   int vp8_decode(const uint8_t* data, int64_t n, const uint8_t* alpha,
//                  int64_t alpha_n, uint8_t* out, uint8_t* alpha_out,
//                  int32_t width, int32_t height);
//     data: the VP8 payload and whatever follows it in the data WebPDecode
//     was given (the last token partition runs to the end). alpha: the ALPH
//     chunk's payload, alpha_n its size, or alpha_n < 0 for none. out:
//     height x width x 3 BGR; alpha_out: height x width or null. Written
//     only on success. width and height must be the frame header's.
//   Returns 0 or a Status code below.

#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

#include "webp_alpha.h"

namespace {

enum Status {
  OK = 0,
  BAD_FRAME_HEADER = 1,   // not a key frame, profile > 3, not shown, start code
  SHORT_HEADER = 2,       // fewer than 10 bytes
  SHORT_PARTITION0 = 3,   // the first partition longer than the data
  BAD_SEGMENT_HEADER = 4, // eof in the segment header
  BAD_FILTER_HEADER = 5,  // eof in the filter header
  SHORT_PARTITIONS = 6,   // no room for the token partitions' sizes
  NO_LAST_PARTITION = 7,  // no byte left for the last token partition
  END_OF_PARTITION0 = 8,  // eof in a row of intra modes
  END_OF_TOKENS = 9,      // eof in a token partition
  BAD_ARGUMENT = 10,
  NO_MEMORY = 11,
  BAD_ALPHA_HEADER = 12,  // an ALPH chunk of one byte or less, a method, pre-processing or reserved bits out of range
  SHORT_ALPHA = 13,       // a raw plane shorter than width x height
  BAD_ALPHA_STREAM = 14,  // a lossless plane csrc/webp.cpp refuses
};

struct Failure {
  Status status;
};

[[noreturn]] void fail(Status s) { throw Failure{s}; }


// RFC 6386's tables as libwebp holds them: quant_dec.c kDcTable and kAcTable,
// tree_dec.c CoeffsUpdateProba, CoeffsProba0 and kBModesProba (indexed by
// the top and the left 4x4 mode, in libwebp's order of the modes)
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

constexpr uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

constexpr uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

constexpr uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// tree_dec.c kBands (a coefficient's band by its position; the 17th entry
// is read past the last coefficient), dec/common_dec.h kZigzag, and the
// extra bits' probabilities of the token categories 3..6
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// dec/common_dec.h: the intra modes; libwebp's order of the 4x4 modes
// (kBModesProba is indexed by it)
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  // the DC variants at the frame's top and left edges (CheckMode)
  DC_PRED_NOTOP = 4, DC_PRED_NOLEFT = 5, DC_PRED_NOTOPLEFT = 6,
};

// bit_reader_utils.h / bit_reader_inl_utils.h: the boolean decoder, with
// libwebp's load points (56 bits at once while 8 bytes remain, then byte
// by byte; the first load past the end sets eof and shifts in 8 zero bits)
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 254;  // the range minus 1, in [127, 254]
  int bits = -8;         // valid bits left
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* max = nullptr;  // the last position of a 56-bit load
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    range = 254;
    value = 0;
    bits = -8;
    eof = false;
    buf = start;
    end = start + size;
    max = size >= 8 ? start + size - 8 + 1 : start;
    load();
  }
  void load_final() {  // VP8LoadFinalBytes
    if (buf < end) {
      bits += 8;
      value = uint64_t(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  void load() {  // VP8LoadNewBytes
    if (buf < max) {
      uint64_t in;
      std::memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else {
      load_final();
    }
  }
  int get(int prob) {  // VP8GetBit
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {  // VP8GetSigned: a bit of probability 1/2, shifting once
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t value32 = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - value32) >> 31;  // -1 or 0
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value_of(int n) {  // VP8GetValue: n bits, the first the most significant
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get(0x80)) << n;
    return v;
  }
  int32_t signed_value_of(int n) {  // VP8GetSignedValue: magnitude, then sign
    const int v = int(value_of(n));
    return get(0x80) ? -v : v;
  }
};

struct Band {  // VP8BandProbas
  uint8_t p[3][11];
};

struct Quant {  // VP8QuantMatrix
  int y1[2], y2[2], uv[2];
};

struct MBData {  // VP8MBData: one macroblock's modes and coefficients
  int16_t coeffs[384];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct NonZero {  // VP8MB: the top or left non-zero contexts
  uint8_t nz, nz_dc;
};

struct FInfo {  // VP8FInfo
  uint8_t limit, ilevel, inner, hev_thresh;
};

struct TopSamples {  // VP8TopSamples: the unfiltered last row of the macroblock above
  uint8_t y[16], u[8], v[8];
};

// dsp/dec.c: prediction and reconstruction in libwebp's work buffer (rows
// of BPS bytes: luma 16x16 at Y_OFF under its top row, chroma 8x8 at U_OFF
// and V_OFF; the left column and top row are the neighbours' samples)
constexpr int BPS = 32;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
                           8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                           0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip_8b(int v) { return !(v & ~0xff) ? uint8_t(v) : v < 0 ? 0 : 255; }
inline void store(uint8_t* dst, int x, int y, int v) { dst[x + y * BPS] = clip_8b(dst[x + y * BPS] + (v >> 3)); }

// Transform_SSE2 (dsp/dec_sse2.c), the inverse DCT added to the prediction
// as the decoder runs it on x86-64: TransformOne_C's arithmetic in 16-bit
// lanes that wrap, the constants 35468 and 85627 (/ 2^16) as x + mulhi(x,
// k), then a saturating store. On the coefficients of a valid stream it
// gives TransformOne_C's pixels; where sums overflow int16 (damaged data)
// it gives the x86-64 build's, which are cv2's.
inline int16_t wrap16(int v) { return int16_t(v); }
inline int mulhi(int16_t x, int k) { return (int(x) * k) >> 16; }
inline int mul1(int16_t x) { return mulhi(x, 20091) + x; }   // x * 85627 >> 16
inline int mul2(int16_t x) { return mulhi(x, -30068) + x; }  // x * 35468 >> 16

void transform(const int16_t* in, uint8_t* dst) {
  int16_t tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = wrap16(a + d);
    tmp[4 * i + 1] = wrap16(b + c);
    tmp[4 * i + 2] = wrap16(b - c);
    tmp[4 * i + 3] = wrap16(a - d);
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass: row i
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    const int v[4] = {a + d, b + c, b - c, a - d};
    for (int x = 0; x < 4; ++x) dst[x + i * BPS] = clip_8b(dst[x + i * BPS] + (wrap16(v[x]) >> 3));
  }
}

// TransformAC3_C: in[0], in[1] and in[4] alone, in 32-bit arithmetic
void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = (in[4] * 35468) >> 16, d4 = ((in[4] * 20091) >> 16) + in[4];
  const int c1 = (in[1] * 35468) >> 16, d1 = ((in[1] * 20091) >> 16) + in[1];
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int v[4] = {rows[y] + d1, rows[y] + c1, rows[y] - c1, rows[y] - d1};
    for (int x = 0; x < 4; ++x) store(dst, x, y, v[x]);
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {  // TransformDC_C
  const int dc = in[0] + 4;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) store(dst, i, j, dc);
}

// TransformWHT_C: the second-order (Y2) transform, into the DC of the 16 blocks
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// frame_dec.c DoTransform / DoUVTransform, by the 2-bit codes of NzCodeBits
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform(src, dst); break;      // any coefficient
    case 2: transform_ac3(src, dst); break;  // in[0], in[1], in[4] only
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    for (int k = 0; k < 4; ++k) {
      uint8_t* d = dst + (k & 1) * 4 + (k >> 1) * 4 * BPS;
      if (bits & 0xaa) transform(src + 16 * k, d);
      else transform_dc(src + 16 * k, d);
    }
  }
}

// the predictors (dsp/dec.c)
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {  // TrueMotion: top + left - top-left, clipped
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip_8b(top[x] + left - tl);
    dst += BPS;
  }
}

void put(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size_t(size));
}

void predict16(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      put(dst, dc >> 5, 16);
      break;
    case TM_PRED: true_motion(dst, 16); break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_PRED_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      put(dst, dc >> 4, 16);
      break;
    case DC_PRED_NOLEFT:
      dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      put(dst, dc >> 4, 16);
      break;
    default: put(dst, 0x80, 16); break;  // no top, no left
  }
}

void predict8(int mode, uint8_t* dst) {  // chroma
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      put(dst, dc >> 4, 8);
      break;
    case TM_PRED: true_motion(dst, 8); break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_PRED_NOTOP:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      put(dst, dc >> 3, 8);
      break;
    case DC_PRED_NOLEFT:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      put(dst, dc >> 3, 8);
      break;
    default: put(dst, 0x80, 8); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      put(dst, int(dc >> 3), 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {  // smoothed along the top row, the top-right pixel included
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
  }
}

#undef DST

// frame_dec.c CheckMode: DC without top, left or both at the frame's edges
inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_PRED_NOTOPLEFT : DC_PRED_NOLEFT;
    return mb_y == 0 ? DC_PRED_NOTOP : DC_PRED;
  }
  return mode;
}

// the loop filters (dsp/dec.c), on a plane of `stride` bytes a row
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2
inline int abs0(int v) { return v < 0 ? -v : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip_8b(p0 + a2);
  p[0] = clip_8b(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip_8b(p1 + a3);
  p[-step] = clip_8b(p0 + a2);
  p[0] = clip_8b(q0 - a1);
  p[step] = clip_8b(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip_8b(p2 + a3);
  p[-2 * step] = clip_8b(p1 + a2);
  p[-step] = clip_8b(p0 + a1);
  p[0] = clip_8b(q0 - a1);
  p[step] = clip_8b(q1 - a2);
  p[2 * step] = clip_8b(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs0(p1 - p0) > thresh || abs0(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs0(p0 - q0) + abs0(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it && abs0(q3 - q2) <= it &&
         abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

// SimpleVFilter16 (hstride = stride, vstride = 1) and SimpleHFilter16
void simple_filter16(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
}

// FilterLoop26 (macroblock edges) and FilterLoop24 (inner edges)
template <bool kEdge>
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else if (kEdge) do_filter6(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

// dsp/yuv.h: 14-bit fixed point YUV -> RGB
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t clip8(int v) { return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[0] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  bgr[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[2] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
}

// upsampling.c UpsampleRgbLinePair (UPSAMPLE_FUNC, BGR): two output rows
// from their luma rows and the chroma rows above and below them, u and v
// packed in one word and averaged together
inline uint32_t load_uv(uint8_t u, uint8_t v) { return uint32_t(u) | (uint32_t(v) << 16); }

void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_bgr(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_bgr(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_bgr(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
      yuv_to_bgr(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_bgr(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
      yuv_to_bgr(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_bgr(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_bgr(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
    }
  }
}

struct Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;         // partition 0
  BoolReader parts[8];   // the token partitions
  int num_parts_minus_one = 0;
  // segment header (ResetSegmentHeader's defaults)
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_proba[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  Quant dqm[4];
  Band bands[4][8];
  const Band* bands_ptr[4][17];
  bool use_skip_proba = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];

  // vp8_dec.c VP8GetHeaders (the frame tag, the picture header, partition 0's headers)
  void headers(const uint8_t* buf, size_t size) {
    if (size < 4) fail(SHORT_HEADER);
    const uint32_t bits = buf[0] | (buf[1] << 8) | (uint32_t(buf[2]) << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (profile > 3 || !show || !key_frame) fail(BAD_FRAME_HEADER);
    buf += 3;
    size -= 3;
    if (size < 7) fail(SHORT_HEADER);
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail(BAD_FRAME_HEADER);
    width = ((buf[4] << 8) | buf[3]) & 0x3fff;  // the scale bits (the top two) are ignored
    height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (partition_length > size) fail(SHORT_PARTITION0);
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get(0x80);  // the colour space and clamping type, read and ignored
    br.get(0x80);
    segment_header();
    filter_header();
    partitions(buf, size);
    quant();
    br.get(0x80);  // update_proba, ignored
    proba();
  }

  // vp8_dec.c ParseSegmentHeader
  void segment_header() {
    use_segment = br.get(0x80);
    if (use_segment) {
      update_map = br.get(0x80);
      if (br.get(0x80)) {  // update data
        absolute_delta = br.get(0x80);
        for (int& q : quantizer) q = br.get(0x80) ? br.signed_value_of(7) : 0;
        for (int& f : filter_strength) f = br.get(0x80) ? br.signed_value_of(6) : 0;
      }
      if (update_map)
        for (uint8_t& p : segment_proba) p = br.get(0x80) ? uint8_t(br.value_of(8)) : 255;
    } else {
      update_map = false;
    }
    if (br.eof) fail(BAD_SEGMENT_HEADER);
  }

  // vp8_dec.c ParseFilterHeader: no filtering at all where the frame's level is 0
  void filter_header() {
    simple = br.get(0x80);
    level = int(br.value_of(6));
    sharpness = int(br.value_of(3));
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {  // update the deltas
      for (int& d : ref_lf_delta)
        if (br.get(0x80)) d = br.signed_value_of(6);
      for (int& d : mode_lf_delta)
        if (br.get(0x80)) d = br.signed_value_of(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail(BAD_FILTER_HEADER);
  }

  // vp8_dec.c ParsePartitions: sizes past the data are clipped; the last
  // partition takes what is left and must have a byte
  void partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    num_parts_minus_one = (1 << br.value_of(2)) - 1;
    const size_t last_part = size_t(num_parts_minus_one);
    if (size < 3 * last_part) fail(SHORT_PARTITIONS);
    const uint8_t* part_start = buf + last_part * 3;
    size_t size_left = size - last_part * 3;
    for (size_t p = 0; p < last_part; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (size_t(sz[2]) << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    if (part_start >= buf_end) fail(NO_LAST_PARTITION);
  }

  // quant_dec.c VP8ParseQuant
  void quant() {
    const int base_q0 = int(br.value_of(7));
    const int dqy1_dc = br.get(0x80) ? br.signed_value_of(4) : 0;
    const int dqy2_dc = br.get(0x80) ? br.signed_value_of(4) : 0;
    const int dqy2_ac = br.get(0x80) ? br.signed_value_of(4) : 0;
    const int dquv_dc = br.get(0x80) ? br.signed_value_of(4) : 0;
    const int dquv_ac = br.get(0x80) ? br.signed_value_of(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  // tree_dec.c VP8ParseProba
  void proba() {
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            bands[t][b].p[c][p] =
                br.get(kCoeffsUpdateProba[t][b][c][p]) ? uint8_t(br.value_of(8)) : kCoeffsProba0[t][b][c][p];
      for (int b = 0; b < 17; ++b) bands_ptr[t][b] = &bands[t][kBands[b]];
    }
    use_skip_proba = br.get(0x80);
    if (use_skip_proba) skip_p = int(br.value_of(8));
  }

  // frame_dec.c PrecomputeFilterStrengths
  void filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level = level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = uint8_t(ilevel);
          info.limit = uint8_t(2 * lvl + ilevel);
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;  // no filtering
          info.ilevel = info.hev_thresh = 0;
        }
        info.inner = uint8_t(i4x4);
      }
    }
  }

  // tree_dec.c ParseIntraMode, with the top and left 4x4 mode contexts
  void intra_mode(MBData& block, uint8_t* top, uint8_t* left) {
    if (update_map) {
      block.segment = !br.get(segment_proba[0]) ? uint8_t(br.get(segment_proba[1]))
                                                : uint8_t(br.get(segment_proba[2]) + 2);
    } else {
      block.segment = 0;
    }
    if (use_skip_proba) block.skip = uint8_t(br.get(skip_p));
    block.is_i4x4 = !br.get(145);
    if (!block.is_i4x4) {
      const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
      block.imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          ymode = !br.get(prob[0])   ? B_DC_PRED
                  : !br.get(prob[1]) ? B_TM_PRED
                  : !br.get(prob[2]) ? B_VE_PRED
                  : !br.get(prob[3])
                      ? (!br.get(prob[4]) ? B_HE_PRED : (!br.get(prob[5]) ? B_RD_PRED : B_VR_PRED))
                      : (!br.get(prob[6]) ? B_LD_PRED
                                          : (!br.get(prob[7]) ? B_VL_PRED : (!br.get(prob[8]) ? B_HD_PRED : B_HU_PRED)));
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    block.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
  }

  // vp8_dec.c GetLargeValue: a token's value past 2 (categories 1..6)
  static int large_value(BoolReader& t, const uint8_t* p) {
    int v;
    if (!t.get(p[3])) {
      v = !t.get(p[4]) ? 2 : 3 + t.get(p[5]);
    } else if (!t.get(p[6])) {
      if (!t.get(p[7])) {
        v = 5 + t.get(159);
      } else {
        v = 7 + 2 * t.get(165);
        v += t.get(145);
      }
    } else {
      const int bit1 = t.get(p[8]);
      const int bit0 = t.get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + t.get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // vp8_dec.c GetCoeffs: one block's tokens from position n on; returns
  // the position after the last non-zero coefficient. The dequantised
  // value is stored as int16_t, as libwebp stores it.
  static int coeffs(BoolReader& t, const Band* const* prob, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = prob[n]->p[ctx];
    for (; n < 16; ++n) {
      if (!t.get(p[0])) return n;  // end of block
      while (!t.get(p[1])) {       // zeros
        p = prob[++n]->p[0];
        if (n == 16) return 16;
      }
      const Band* next = prob[n + 1];
      int v;
      if (!t.get(p[2])) {
        v = 1;
        p = next->p[1];
      } else {
        v = large_value(t, p);
        p = next->p[2];
      }
      out[kZigzag[n]] = int16_t(t.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : uint32_t(dc_nz);
    return nz_coeffs;
  }

  // vp8_dec.c ParseResiduals: returns whether every block came out zero
  bool residuals(BoolReader& t, MBData& block, NonZero& mb, NonZero& left_mb) {
    const Quant& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof(block.coeffs));
    const Band* const* ac_proba;
    int first;
    if (!block.is_i4x4) {  // the Y2 block: the 16 luma DCs
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left_mb.nz_dc;
      const int nz = coeffs(t, bands_ptr[1], ctx, q.y2, 0, dc);
      mb.nz_dc = left_mb.nz_dc = uint8_t(nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      ac_proba = bands_ptr[0];
    } else {
      first = 0;
      ac_proba = bands_ptr[3];
    }
    uint8_t tnz = mb.nz & 0x0f;
    uint8_t lnz = left_mb.nz & 0x0f;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(t, ac_proba, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = uint8_t((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = uint8_t((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = uint8_t(mb.nz >> (4 + ch));
      lnz = uint8_t(left_mb.nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(t, bands_ptr[2], ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = uint8_t((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = uint8_t((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= uint32_t(tnz << 4) << ch;
      out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    mb.nz = uint8_t(out_t_nz);
    left_mb.nz = uint8_t(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }
};

// frame_dec.c ReconstructRow: one macroblock row into the frame's planes
// (unfiltered), through the work buffer
struct Reconstructor {
  const Decoder& dec;
  uint8_t* y_plane;
  uint8_t* u_plane;
  uint8_t* v_plane;
  int y_stride, uv_stride;
  std::vector<TopSamples> yuv_t;
  uint8_t yuv_b[YUV_SIZE];

  Reconstructor(const Decoder& d, uint8_t* y, uint8_t* u, uint8_t* v)
      : dec(d), y_plane(y), u_plane(u), v_plane(v), y_stride(16 * d.mb_w), uv_stride(8 * d.mb_w),
        yuv_t(size_t(d.mb_w)) {
    std::memset(yuv_b, 0, sizeof(yuv_b));
  }

  void row(int mb_y, const MBData* blocks) {
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;  // the frame's left edge
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {  // the frame's top edge, top-left and top-right included
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < dec.mb_w; ++mb_x) {
      const MBData& block = blocks[mb_x];
      if (mb_x > 0) {  // the previous macroblock's right columns become the left ones
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      TopSamples* const top_yuv = yuv_t.data() + mb_x;
      const int16_t* const coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_yuv[0].y, 16);
        std::memcpy(u_dst - BPS, top_yuv[0].u, 8);
        std::memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= dec.mb_w - 1) std::memset(top_right, top_yuv[0].y[15], 4);  // the row's last macroblock
          else std::memcpy(top_right, top_yuv[1].y, 4);
        }
        // the blocks below the first sub-row take the same top-right pixels
        for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + kScan[n];
          predict4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        predict16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        if (bits)
          for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
      }
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      predict8(uv_mode, u_dst);
      predict8(uv_mode, v_dst);
      do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < dec.mb_h - 1) {  // the unfiltered bottom row, for the next row's prediction
        std::memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        std::memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        std::memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      uint8_t* const y_out = y_plane + size_t(mb_y) * 16 * y_stride + mb_x * 16;
      uint8_t* const u_out = u_plane + size_t(mb_y) * 8 * uv_stride + mb_x * 8;
      uint8_t* const v_out = v_plane + size_t(mb_y) * 8 * uv_stride + mb_x * 8;
      for (int j = 0; j < 16; ++j) std::memcpy(y_out + size_t(j) * y_stride, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(u_out + size_t(j) * uv_stride, u_dst + j * BPS, 8);
        std::memcpy(v_out + size_t(j) * uv_stride, v_dst + j * BPS, 8);
      }
    }
  }
};

// frame_dec.c DoFilter: one macroblock's left edge, inner vertical edges,
// top edge and inner horizontal edges
void filter_mb(int filter_type, const FInfo& f, int mb_x, int mb_y, uint8_t* y_plane, uint8_t* u_plane,
               uint8_t* v_plane, int y_bps, int uv_bps) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* const y_dst = y_plane + size_t(mb_y) * 16 * y_bps + mb_x * 16;
  if (filter_type == 1) {  // simple: luma only
    if (mb_x > 0) simple_filter16(y_dst, 1, y_bps, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k, 1, y_bps, limit);
    if (mb_y > 0) simple_filter16(y_dst, y_bps, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; ++k) simple_filter16(y_dst + 4 * k * y_bps, y_bps, 1, limit);
    return;
  }
  uint8_t* const u_dst = u_plane + size_t(mb_y) * 8 * uv_bps + mb_x * 8;
  uint8_t* const v_dst = v_plane + size_t(mb_y) * 8 * uv_bps + mb_x * 8;
  const int ilevel = f.ilevel, hev_t = f.hev_thresh;
  if (mb_x > 0) {  // HFilter16, HFilter8
    filter_loop<true>(y_dst, 1, y_bps, 16, limit + 4, ilevel, hev_t);
    filter_loop<true>(u_dst, 1, uv_bps, 8, limit + 4, ilevel, hev_t);
    filter_loop<true>(v_dst, 1, uv_bps, 8, limit + 4, ilevel, hev_t);
  }
  if (f.inner) {  // HFilter16i, HFilter8i
    for (int k = 1; k <= 3; ++k) filter_loop<false>(y_dst + 4 * k, 1, y_bps, 16, limit, ilevel, hev_t);
    filter_loop<false>(u_dst + 4, 1, uv_bps, 8, limit, ilevel, hev_t);
    filter_loop<false>(v_dst + 4, 1, uv_bps, 8, limit, ilevel, hev_t);
  }
  if (mb_y > 0) {  // VFilter16, VFilter8
    filter_loop<true>(y_dst, y_bps, 1, 16, limit + 4, ilevel, hev_t);
    filter_loop<true>(u_dst, uv_bps, 1, 8, limit + 4, ilevel, hev_t);
    filter_loop<true>(v_dst, uv_bps, 1, 8, limit + 4, ilevel, hev_t);
  }
  if (f.inner) {  // VFilter16i, VFilter8i
    for (int k = 1; k <= 3; ++k) filter_loop<false>(y_dst + 4 * k * y_bps, y_bps, 1, 16, limit, ilevel, hev_t);
    filter_loop<false>(u_dst + 4 * uv_bps, uv_bps, 1, 8, limit, ilevel, hev_t);
    filter_loop<false>(v_dst + 4 * uv_bps, uv_bps, 1, 8, limit, ilevel, hev_t);
  }
}

// filters.c: the alpha plane's unfilters (row 0 runs from 0 along the row;
// a later row's first pixel predicts from the one above)
void unfilter(int filter, const uint8_t* prev, uint8_t* row, int width) {
  if (filter == 1 || prev == nullptr) {  // horizontal (and the first row of the others)
    if (filter == 0) return;
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      row[i] = uint8_t(pred + row[i]);
      pred = row[i];
    }
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) row[i] = uint8_t(prev[i] + row[i]);
  } else if (filter == 3) {  // gradient: left + top - top-left, clipped
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      left = uint8_t(row[i] + (((g & ~0xff) == 0) ? g : g < 0 ? 0 : 255));
      top_left = top;
      row[i] = left;
    }
  }
}

// alpha_dec.c ALPHInit and ALPHDecode: the ALPH chunk's plane
void decode_alpha(const uint8_t* data, int64_t n, int width, int height, uint8_t* out) {
  if (n <= 1) fail(BAD_ALPHA_HEADER);
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre_processing = (data[0] >> 4) & 3;
  if (method > 1 || pre_processing > 1 || (data[0] >> 6)) fail(BAD_ALPHA_HEADER);
  const size_t size = size_t(width) * size_t(height);
  std::vector<uint8_t> plane(out ? size : 0);
  if (method == 0) {
    if (uint64_t(n - 1) < size) fail(SHORT_ALPHA);
    if (out) std::memcpy(plane.data(), data + 1, size);
  } else if (vp8l_decode_alpha(data + 1, n - 1, width, height, out ? plane.data() : nullptr)) {
    fail(BAD_ALPHA_STREAM);
  }
  if (!out) return;  // the values: only where asked for (IMREAD_COLOR drops them)
  for (int y = 0; y < height; ++y)
    unfilter(filter, y ? plane.data() + size_t(y - 1) * width : nullptr, plane.data() + size_t(y) * width, width);
  std::memcpy(out, plane.data(), size);
}

int decode(const uint8_t* data, int64_t n, const uint8_t* alpha, int64_t alpha_n, uint8_t* out, uint8_t* alpha_out,
           int32_t width, int32_t height) {
  std::unique_ptr<Decoder> owned(new Decoder());
  Decoder& dec = *owned;
  dec.headers(data, size_t(n));
  if (dec.width != width || dec.height != height || width <= 0 || height <= 0) return BAD_ARGUMENT;
  dec.filter_strengths();
  const int mb_w = dec.mb_w, mb_h = dec.mb_h;
  const size_t y_stride = size_t(16) * mb_w, uv_stride = size_t(8) * mb_w;
  std::vector<uint8_t> y_plane(y_stride * 16 * mb_h), u_plane(uv_stride * 8 * mb_h), v_plane(uv_stride * 8 * mb_h);
  std::vector<FInfo> f_info(static_cast<size_t>(mb_w) * mb_h);
  std::vector<MBData> blocks(static_cast<size_t>(mb_w));
  std::vector<NonZero> top_nz(static_cast<size_t>(mb_w) + 1);  // [0]: the left macroblock's
  std::vector<uint8_t> intra_t(size_t(4) * mb_w, B_DC_PRED);
  uint8_t intra_l[4];
  std::unique_ptr<Reconstructor> rec(new Reconstructor(dec, y_plane.data(), u_plane.data(), v_plane.data()));
  // vp8_dec.c ParseFrame: a row of intra modes from partition 0, then the
  // row's tokens from partition mb_y & (n - 1), then its reconstruction
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& tokens = dec.parts[mb_y & dec.num_parts_minus_one];
    std::memset(intra_l, B_DC_PRED, 4);
    top_nz[0] = NonZero{0, 0};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      blocks[size_t(mb_x)].skip = 0;
      dec.intra_mode(blocks[size_t(mb_x)], intra_t.data() + 4 * mb_x, intra_l);
    }
    if (dec.br.eof) fail(END_OF_PARTITION0);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {  // VP8DecodeMB
      MBData& block = blocks[size_t(mb_x)];
      NonZero& left = top_nz[0];
      NonZero& mb = top_nz[size_t(mb_x) + 1];
      bool skip = dec.use_skip_proba ? block.skip : false;
      if (!skip) {
        skip = dec.residuals(tokens, block, mb, left);
      } else {
        left.nz = mb.nz = 0;
        if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        block.non_zero_y = block.non_zero_uv = 0;
      }
      if (dec.filter_type > 0) {
        FInfo& f = f_info[size_t(mb_y) * mb_w + mb_x];
        f = dec.fstrengths[block.segment][block.is_i4x4];
        f.inner |= uint8_t(!skip);
      }
      if (tokens.eof) fail(END_OF_TOKENS);
    }
    rec->row(mb_y, blocks.data());
  }
  if (dec.filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        filter_mb(dec.filter_type, f_info[size_t(mb_y) * mb_w + mb_x], mb_x, mb_y, y_plane.data(), u_plane.data(),
                  v_plane.data(), int(y_stride), int(uv_stride));
  if (alpha_n >= 0) decode_alpha(alpha, alpha_n, width, height, alpha_out);
  // io_dec.c EmitFancyRGB over the whole frame: row 0 and an even height's
  // last row take their own chroma row twice
  const size_t out_stride = size_t(width) * 3;
  const uint8_t* Y = y_plane.data();
  const uint8_t* U = u_plane.data();
  const uint8_t* V = v_plane.data();
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, width);
  int y = 1;
  for (; y + 1 < height; y += 2) {
    const size_t above = size_t((y - 1) >> 1) * uv_stride, below = size_t((y + 1) >> 1) * uv_stride;
    upsample_pair(Y + y * y_stride, Y + (y + 1) * y_stride, U + above, V + above, U + below, V + below,
                  out + y * out_stride, out + (y + 1) * out_stride, width);
  }
  if (y < height) {  // an even height's last row
    const size_t last = size_t((height - 1) >> 1) * uv_stride;
    upsample_pair(Y + y * y_stride, nullptr, U + last, V + last, U + last, V + last, out + y * out_stride, nullptr,
                  width);
  }
  return OK;
}

}  // namespace

extern "C" int vp8_decode(const uint8_t* data, int64_t n, const uint8_t* alpha, int64_t alpha_n, uint8_t* out,
                          uint8_t* alpha_out, int32_t width, int32_t height) {
  if (n < 0 || !out) return BAD_ARGUMENT;
  try {
    return decode(data, n, alpha, alpha_n, out, alpha_out, width, height);
  } catch (const Failure& f) {
    return f.status;
  } catch (const std::bad_alloc&) {
    return NO_MEMORY;
  }
}
