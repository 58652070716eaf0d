// The JPEG-in-TIFF entry of csrc/jpeg.cpp, as csrc/tiff.cpp calls it: one
// strip or tile of a TIFF image of compression 7, decoded as libtiff 4.7's
// tif_jpeg.c drives libjpeg-turbo 3.1 under TIFFReadRGBAStrip /
// TIFFReadRGBATile. Both files are built into one library.
#pragma once

#include <cstdint>

extern "C" {

// What libjpeg keeps from one datastream to the next of an image (jpeg_abort
// frees neither): the tables of the JPEGTables tag and those the blocks
// define, which a later block may leave out. Zeroed before the first call.
struct JpegTiffTables {
  int32_t status;            // of reading JPEGTables: 0, or the failure of every block
  uint8_t quant_defined[4];
  uint16_t quant[4][64];     // natural order
  uint8_t huff_defined[8];   // DC tables 0-3, then AC tables 0-3
  uint8_t huff_bits[8][17];
  uint8_t huff_vals[8][256];
};

// What JPEGPreDecode holds a block's frame to, and how it is read out.
struct JpegTiffBlock {
  int32_t segment_w, segment_h;    // the strip (image width, its rows) or the tile
  int32_t last_strip;              // a strip that ends the image: its frame may be taller
  int32_t components;              // samples per pixel (contiguous) or 1 (separate)
  int32_t precision;               // BitsPerSample
  int32_t h_sampling, v_sampling;  // the first component's: YCbCrSubsampling under contiguous YCbCr, else 1, 1
  int32_t ycc_to_rgb;              // contiguous YCbCr: libjpeg converts to RGB (JPEGCOLORMODE_RGB);
                                   // else the components as stored (JCS_UNKNOWN)
};

// JPEGSetupDecode: reads a JPEGTables stream into t as a tables-only
// datastream. Returns 0, or a status that t keeps and every block returns.
int jpeg_tiff_tables(const uint8_t* tables, int64_t n, JpegTiffTables* t);

// JPEGPreDecode and JPEGDecode: decodes the block's stream (data[n]) and
// writes its first min(rows, frame height) rows, each of frame width x
// components bytes, row_bytes apart from out on. Returns 0, or a status: the
// block was refused before any row (libtiff's TIFFStartStrip fails) and out
// is untouched.
int jpeg_tiff_block(JpegTiffTables* t, const uint8_t* data, int64_t n, const JpegTiffBlock* b, uint8_t* out,
                    int64_t row_bytes, int64_t rows);

}  // extern "C"
