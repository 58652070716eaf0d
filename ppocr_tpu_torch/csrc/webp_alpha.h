// The lossless alpha plane of a lossy WebP, shared by csrc/vp8.cpp (which
// reads the ALPH chunk) and csrc/webp.cpp (which holds the VP8L decoder).

#pragma once

#include <cstdint>

// alpha_dec.c / vp8l_dec.c VP8LDecodeAlphaHeader and
// VP8LDecodeAlphaImageStream: a VP8L image stream without its 5-byte header
// (transforms, colour cache, prefix codes, pixels) for a width x height
// plane, its green channel written to `out` (height x width; nothing where
// `out` is null). A stream of the colour indexing transform alone, with no
// colour cache and one-symbol red, blue and alpha codes, is read by
// libwebp's 8-bit path, which lets the data end with the last pixel.
// Returns 0 or csrc/webp.cpp's Status code.
extern "C" int vp8l_decode_alpha(const uint8_t* data, int64_t n, int32_t width, int32_t height, uint8_t* out);
