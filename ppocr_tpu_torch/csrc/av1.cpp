// AV1 still-picture decoder for coded-lossless 8-bit key frames, as libaom
// 3.14.1 decodes them (the copy in OpenCV 5.0, driven by libavif 1.4.2).
//
// The layers follow libaom's files, and so do the names in the comments:
//   * obu.c / obu_util.c: OBU headers and sizes, the sequence header, the
//     frame header and tile group OBUs, their trailing bits and padding
//     (aom_decode_frame_from_obus), and av1_dx_iface.c's peek at the stream
//     and its loop over the frames of one buffer;
//   * decodeframe.c: the uncompressed header (tile info, quantisation,
//     segmentation, delta q / lf, CodedLossless, loop filter, CDEF and
//     restoration parameters as far as they are read, film grain), the tile
//     buffers and the per-tile checks (overflow after each superblock, the
//     trailing bits after the symbol coder);
//   * entdec.c / daala reader: the symbol decoder, its tell() and overflow,
//     and the CDF adaptation (entropy.h update_cdf);
//   * decodemv.c / mvref_common.c: key-frame mode info, palette (with the
//     colour cache of the above and left blocks), filter intra, CFL alphas,
//     IntraBC with its reference-DV stack and its validity rules;
//   * decodetxb.c: the coefficients of TX_4X4 (the only transform size of a
//     lossless frame), 2-D class contexts, Golomb;
//   * reconintra.c / cfl.c / idct (iwht4x4): DC, the directional modes with
//     the edge filter and upsampling, smooth, Paeth, CFL, palette and filter
//     intra, then the inverse Walsh-Hadamard transform added with a clamp to
//     8 bits.
//
// The default CDFs and constant tables come from av1_tables.h, written from
// libaom 3.14.1's library by scripts/make_av1_tables_torch.py.
//
// What this decoder does not decode (a lossy frame, subsampled chroma, more
// than 8 bits, superres, film grain, a frame other than one shown key
// frame) gives status UNPORTED before any pixel is decoded.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

enum Status { OK = 0, HEADER_ERROR = 1, DECODE_ERROR = 2, UNPORTED = 3, BAD_CALL = 4 };

struct Error {
    int status;
    std::string msg;
};

[[noreturn]] void fail(int status, const std::string& msg) { throw Error{status, msg}; }

// -- constants ------------------------------------------------------------------

enum { OBU_SEQUENCE_HEADER = 1, OBU_TEMPORAL_DELIMITER = 2, OBU_FRAME_HEADER = 3, OBU_TILE_GROUP = 4,
       OBU_METADATA = 5, OBU_FRAME = 6, OBU_REDUNDANT_FRAME_HEADER = 7, OBU_TILE_LIST = 8, OBU_PADDING = 15 };
enum { KEY_FRAME = 0, INTER_FRAME = 1, INTRA_ONLY_FRAME = 2, SWITCH_FRAME = 3 };
enum { DC_PRED = 0, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED,
       SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
enum { PARTITION_NONE = 0, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
       PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { BLOCK_4X4 = 0, BLOCK_8X8 = 3, BLOCK_64X64 = 12, BLOCK_128X128 = 15, BLOCK_SIZES_ALL = 22 };

// block sizes in 4-sample units, in libaom's BLOCK_SIZE order
const int kBw4[BLOCK_SIZES_ALL] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const int kBh4[BLOCK_SIZES_ALL] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int kPaletteColorContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};
const int kIntrabcDelayPixels = 256, kIntrabcDelaySb64 = 4;

int log2i(int v) {
    int l = 0;
    while ((1 << (l + 1)) <= v) l++;
    return l;
}

int block_size(int w4, int h4) {
    for (int b = 0; b < BLOCK_SIZES_ALL; b++)
        if (kBw4[b] == w4 && kBh4[b] == h4) return b;
    return -1;
}

int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
uint8_t clip_pixel(int v) { return (uint8_t)clip3(0, 255, v); }
int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }
int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }

// -- bit reader of the headers (aom_read_bit_buffer): reading past the end is
// fatal where libaom gives the reader an error handler, else reads zeros ---------

struct BitReader {
    const uint8_t* p;
    size_t n;
    size_t bit = 0;
    bool strict = true;

    int bit1() {
        size_t byte = bit >> 3;
        if (byte >= n) {
            if (strict) fail(HEADER_ERROR, "truncated header");
            return 0;
        }
        int b = (p[byte] >> (7 - (bit & 7))) & 1;
        bit++;
        return b;
    }
    uint32_t f(int bits) {
        uint32_t v = 0;
        for (int i = 0; i < bits; i++) v = (v << 1) | (uint32_t)bit1();
        return v;
    }
    int su(int bits) {  // aom_rb_read_inv_signed_literal / su(1 + n)
        uint32_t v = f(bits);
        int sign_mask = 1 << (bits - 1);
        return (int)v - ((int)(v & sign_mask) << 1);
    }
    uint32_t uvlc() {
        int leading = 0;
        while (!bit1()) {
            leading++;
            if (leading >= 32) return UINT32_MAX;
        }
        if (leading >= 32) return UINT32_MAX;
        return f(leading) + ((1u << leading) - 1);
    }
    int ns(int n) {  // rb_read_uniform
        int l = 0;
        while ((1 << l) <= n) l++;  // get_unsigned_bits: msb + 1
        int m = (1 << l) - n;
        int v = (int)f(l - 1);
        if (v < m) return v;
        return (v << 1) - m + bit1();
    }
    size_t bytes_read() const { return (bit + 7) >> 3; }
};

// -- the sequence header ---------------------------------------------------------

struct SeqHeader {
    int profile = 0, still_picture = 0, reduced = 0;
    int timing_info_present = 0, equal_picture_interval = 0;
    int decoder_model_info_present = 0, buffer_delay_length = 0, buffer_removal_time_length = 0,
        frame_presentation_time_length = 0;
    int op_count = 1;
    int op_idc[32] = {0}, seq_level[32] = {0}, decoder_model_present[32] = {0};
    int width_bits = 0, height_bits = 0, max_width = 0, max_height = 0;
    int frame_id_numbers_present = 0, delta_frame_id_length = 0, frame_id_length = 0;
    int use_128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
    int enable_order_hint = 0, order_hint_bits = 0, force_screen_content_tools = 2, force_integer_mv = 2;
    int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
    int bit_depth = 8, mono = 0, cp = 2, tc = 2, mc = 2, color_range = 0, ss_x = 0, ss_y = 0;
    int separate_uv_delta_q = 0, film_grain_present = 0;
    int enable_interintra = 0, enable_masked = 0, enable_warped = 0, enable_dual = 0, enable_jnt = 0,
        enable_ref_frame_mvs = 0;
    int chroma_sample_position = 0;
};

bool valid_level(int idx) {
    // is_valid_seq_level_idx: 31, or a defined level below 8.0 (2.2, 2.3, 3.2,
    // 3.3, 4.2, 4.3 and the 7.x levels are not)
    if (idx == 31) return true;
    if (idx >= 20) return false;
    return idx != 2 && idx != 3 && idx != 6 && idx != 7 && idx != 10 && idx != 11;
}

void check_trailing_bits(BitReader& rb) {
    int k = 8 - (int)(rb.bit % 8);
    uint32_t t = rb.f(k);
    if (t != (1u << (k - 1))) fail(HEADER_ERROR, "bad trailing bits");
}

SeqHeader read_sequence_header(BitReader& rb) {
    SeqHeader s;
    s.profile = rb.f(3);
    if (s.profile > 2) fail(HEADER_ERROR, "unsupported profile");
    s.still_picture = rb.bit1();
    s.reduced = rb.bit1();
    if (!s.still_picture && s.reduced) fail(HEADER_ERROR, "a reduced still picture header on video");
    if (s.reduced) {
        s.seq_level[0] = rb.f(5);
        if (!valid_level(s.seq_level[0])) fail(HEADER_ERROR, "invalid seq_level_idx");
    } else {
        s.timing_info_present = rb.bit1();
        if (s.timing_info_present) {
            rb.f(32);
            rb.f(32);
            s.equal_picture_interval = rb.bit1();
            if (s.equal_picture_interval && rb.uvlc() == UINT32_MAX)
                fail(HEADER_ERROR, "num_ticks_per_picture_minus_1 of 2^32 - 1");
            s.decoder_model_info_present = rb.bit1();
            if (s.decoder_model_info_present) {
                s.buffer_delay_length = rb.f(5) + 1;
                rb.f(32);
                s.buffer_removal_time_length = rb.f(5) + 1;
                s.frame_presentation_time_length = rb.f(5) + 1;
            }
        }
        int display_model = rb.bit1();
        s.op_count = rb.f(5) + 1;
        for (int i = 0; i < s.op_count; i++) {
            s.op_idc[i] = rb.f(12);
            s.seq_level[i] = rb.f(5);
            if (!valid_level(s.seq_level[i])) fail(HEADER_ERROR, "invalid seq_level_idx");
            if (s.seq_level[i] > 7) rb.bit1();
            if (s.decoder_model_info_present) {
                s.decoder_model_present[i] = rb.bit1();
                if (s.decoder_model_present[i]) {
                    rb.f(s.buffer_delay_length);
                    rb.f(s.buffer_delay_length);
                    rb.bit1();
                }
            }
            if (display_model && rb.bit1() && rb.f(4) + 1 > 10)
                fail(HEADER_ERROR, "AV1 does not support more than 10 decoded frames delay");
        }
    }
    s.width_bits = rb.f(4) + 1;
    s.height_bits = rb.f(4) + 1;
    s.max_width = rb.f(s.width_bits) + 1;
    s.max_height = rb.f(s.height_bits) + 1;
    s.frame_id_numbers_present = s.reduced ? 0 : rb.bit1();
    if (s.frame_id_numbers_present) {
        s.delta_frame_id_length = rb.f(4) + 2;
        s.frame_id_length = rb.f(3) + s.delta_frame_id_length + 1;
        if (s.frame_id_length > 16) fail(HEADER_ERROR, "invalid frame_id_length");
    }
    s.use_128 = rb.bit1();
    s.enable_filter_intra = rb.bit1();
    s.enable_intra_edge_filter = rb.bit1();
    if (!s.reduced) {
        s.enable_interintra = rb.bit1();
        s.enable_masked = rb.bit1();
        s.enable_warped = rb.bit1();
        s.enable_dual = rb.bit1();
        s.enable_order_hint = rb.bit1();
        if (s.enable_order_hint) {
            s.enable_jnt = rb.bit1();
            s.enable_ref_frame_mvs = rb.bit1();
        }
        s.force_screen_content_tools = rb.bit1() ? 2 : rb.bit1();
        if (s.force_screen_content_tools > 0)
            s.force_integer_mv = rb.bit1() ? 2 : rb.bit1();
        else
            s.force_integer_mv = 2;
        if (s.enable_order_hint) s.order_hint_bits = rb.f(3) + 1;
    }
    s.enable_superres = rb.bit1();
    s.enable_cdef = rb.bit1();
    s.enable_restoration = rb.bit1();
    // color_config
    int high = rb.bit1();
    if (s.profile == 2 && high)
        s.bit_depth = rb.bit1() ? 12 : 10;
    else
        s.bit_depth = high ? 10 : 8;
    s.mono = s.profile != 1 ? rb.bit1() : 0;
    if (rb.bit1()) {
        s.cp = rb.f(8);
        s.tc = rb.f(8);
        s.mc = rb.f(8);
    }
    if (s.mono) {
        s.color_range = rb.bit1();
        s.ss_x = s.ss_y = 1;
    } else {
        if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
            s.ss_x = s.ss_y = 0;
            s.color_range = 1;
            if (!(s.profile == 1 || (s.profile == 2 && s.bit_depth == 12)))
                fail(HEADER_ERROR, "sRGB colorspace not compatible with specified profile");
        } else {
            s.color_range = rb.bit1();
            if (s.profile == 0) {
                s.ss_x = s.ss_y = 1;
            } else if (s.profile == 1) {
                s.ss_x = s.ss_y = 0;
            } else if (s.bit_depth == 12) {
                s.ss_x = rb.bit1();
                s.ss_y = s.ss_x ? rb.bit1() : 0;
            } else {
                s.ss_x = 1;
                s.ss_y = 0;
            }
            if (s.mc == 0 && (s.ss_x || s.ss_y))
                fail(HEADER_ERROR, "Identity CICP Matrix incompatible with non 4:4:4 color sampling");
            if (s.ss_x && s.ss_y) s.chroma_sample_position = rb.f(2);
        }
        s.separate_uv_delta_q = rb.bit1();
    }
    if (!s.mono && s.ss_x == 0 && s.ss_y == 1) fail(HEADER_ERROR, "4:4:0 subsampling");
    s.film_grain_present = rb.bit1();
    check_trailing_bits(rb);
    return s;
}

bool same_sequence(const SeqHeader& a, const SeqHeader& b) {
    // are_seq_headers_consistent: everything but the operating parameters
    return a.profile == b.profile && a.still_picture == b.still_picture && a.reduced == b.reduced &&
           a.max_width == b.max_width && a.max_height == b.max_height && a.width_bits == b.width_bits &&
           a.height_bits == b.height_bits && a.frame_id_numbers_present == b.frame_id_numbers_present &&
           a.use_128 == b.use_128 && a.enable_filter_intra == b.enable_filter_intra &&
           a.enable_intra_edge_filter == b.enable_intra_edge_filter && a.enable_order_hint == b.enable_order_hint &&
           a.order_hint_bits == b.order_hint_bits && a.force_screen_content_tools == b.force_screen_content_tools &&
           a.force_integer_mv == b.force_integer_mv && a.enable_superres == b.enable_superres &&
           a.enable_cdef == b.enable_cdef && a.enable_restoration == b.enable_restoration &&
           a.bit_depth == b.bit_depth && a.mono == b.mono && a.cp == b.cp && a.tc == b.tc && a.mc == b.mc &&
           a.color_range == b.color_range && a.ss_x == b.ss_x && a.ss_y == b.ss_y &&
           a.separate_uv_delta_q == b.separate_uv_delta_q && a.film_grain_present == b.film_grain_present;
}

// -- the frame header ----------------------------------------------------------------

struct FrameHeader {
    int show_existing = 0, frame_type = KEY_FRAME, show_frame = 1, showable = 0, error_resilient = 1;
    int disable_cdf_update = 0, allow_screen_content_tools = 0, force_integer_mv = 0;
    int width = 0, height = 0, upscaled_width = 0, superres_denom = 8;
    int allow_intrabc = 0, disable_frame_end_update_cdf = 1;
    int mi_cols = 0, mi_rows = 0;
    // tiles
    int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
    std::vector<int> mi_col_starts, mi_row_starts;
    int context_update_tile_id = 0, tile_size_bytes = 4;
    // quantisation and segmentation
    int base_q_idx = 0, dq_ydc = 0, dq_udc = 0, dq_uac = 0, dq_vdc = 0, dq_vac = 0, using_qmatrix = 0;
    int seg_enabled = 0, feature_enabled[8][8] = {{0}}, feature_data[8][8] = {{0}};
    int seg_id_pre_skip = 0, last_active_seg_id = 0;
    int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;
    int lossless[8] = {0};
    int coded_lossless = 0, all_lossless = 0;
    int reduced_tx_set = 0;
    int apply_grain = 0;
};

int qindex_of(const FrameHeader& fh, int seg) {
    if (fh.seg_enabled && fh.feature_enabled[seg][0]) return clip3(0, 255, fh.base_q_idx + fh.feature_data[seg][0]);
    return fh.base_q_idx;
}

int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
}

void read_delta_q(BitReader& rb, int& v) { v = rb.bit1() ? rb.su(7) : 0; }

void read_film_grain(BitReader& rb, const SeqHeader& s, FrameHeader& fh) {
    if (!s.film_grain_present || (!fh.show_frame && !fh.showable)) return;
    fh.apply_grain = rb.bit1();
    if (!fh.apply_grain) return;
    rb.f(16);  // grain_seed
    int update = fh.frame_type == INTER_FRAME ? rb.bit1() : 1;
    if (!update) {
        rb.f(3);  // film_grain_params_ref_idx: a key frame has no reference
        fail(HEADER_ERROR, "film grain parameters from a reference frame");
    }
    int num_y = rb.f(4);
    if (num_y > 14) fail(HEADER_ERROR, "Number of points for film grain luma scaling function exceeds the maximum value.");
    int prev = -1;
    for (int i = 0; i < num_y; i++) {
        int v = rb.f(8);
        rb.f(8);
        if (i && v <= prev) fail(HEADER_ERROR, "First coordinate of the scaling function points shall be increasing.");
        prev = v;
    }
    int from_luma = s.mono ? 0 : rb.bit1();
    int num_cb = 0, num_cr = 0;
    if (!(s.mono || from_luma || (s.ss_x == 1 && s.ss_y == 1 && num_y == 0))) {
        num_cb = rb.f(4);
        if (num_cb > 10) fail(HEADER_ERROR, "Number of points for film grain cb scaling function exceeds the maximum value.");
        prev = -1;
        for (int i = 0; i < num_cb; i++) {
            int v = rb.f(8);
            rb.f(8);
            if (i && v <= prev) fail(HEADER_ERROR, "First coordinate of the scaling function points shall be increasing.");
            prev = v;
        }
        num_cr = rb.f(4);
        if (num_cr > 10) fail(HEADER_ERROR, "Number of points for film grain cr scaling function exceeds the maximum value.");
        prev = -1;
        for (int i = 0; i < num_cr; i++) {
            int v = rb.f(8);
            rb.f(8);
            if (i && v <= prev) fail(HEADER_ERROR, "First coordinate of the scaling function points shall be increasing.");
            prev = v;
        }
        if (s.ss_x == 1 && s.ss_y == 1 && ((num_cb == 0 && num_cr != 0) || (num_cb != 0 && num_cr == 0)))
            fail(HEADER_ERROR, "In YCbCr 4:2:0, film grain shall be applied to both chroma components or neither.");
    }
    rb.f(2);  // grain_scaling_minus_8
    int lag = rb.f(2);
    int num_pos_luma = 2 * lag * (lag + 1);
    int num_pos_chroma = num_pos_luma;
    if (num_y) {
        num_pos_chroma = num_pos_luma + 1;
        for (int i = 0; i < num_pos_luma; i++) rb.f(8);
    }
    if (from_luma || num_cb)
        for (int i = 0; i < num_pos_chroma; i++) rb.f(8);
    if (from_luma || num_cr)
        for (int i = 0; i < num_pos_chroma; i++) rb.f(8);
    rb.f(2);  // ar_coeff_shift_minus_6
    rb.f(2);  // grain_scale_shift
    if (num_cb) rb.f(8 + 8 + 9);
    if (num_cr) rb.f(8 + 8 + 9);
    rb.bit1();  // overlap_flag
    rb.bit1();  // clip_to_restricted_range
}

// the uncompressed header of the first frame of a still picture (read_uncompressed_header)
FrameHeader read_frame_header(BitReader& rb, const SeqHeader& s, int temporal_id, int spatial_id) {
    FrameHeader fh;
    if (!s.reduced) {
        fh.show_existing = rb.bit1();
        if (fh.show_existing) {
            rb.f(3);
            fail(HEADER_ERROR, "Buffer does not contain a decoded frame");
        }
        fh.frame_type = rb.f(2);
        fh.show_frame = rb.bit1();
        if (s.still_picture && (fh.frame_type != KEY_FRAME || !fh.show_frame))
            fail(HEADER_ERROR, "Still pictures must be coded as shown keyframes");
        if (fh.show_frame && s.decoder_model_info_present && !s.equal_picture_interval)
            rb.f(s.frame_presentation_time_length);
        fh.showable = fh.show_frame ? fh.frame_type != KEY_FRAME : rb.bit1();
        fh.error_resilient =
            (fh.frame_type == SWITCH_FRAME || (fh.frame_type == KEY_FRAME && fh.show_frame)) ? 1 : rb.bit1();
    }
    if (fh.frame_type != KEY_FRAME || !fh.show_frame)
        fail(UNPORTED, "image sequences' first frame");  // a frame that needs or makes references
    fh.disable_cdf_update = rb.bit1();
    fh.allow_screen_content_tools = s.force_screen_content_tools == 2 ? rb.bit1() : s.force_screen_content_tools;
    if (fh.allow_screen_content_tools) fh.force_integer_mv = s.force_integer_mv == 2 ? rb.bit1() : s.force_integer_mv;
    fh.force_integer_mv = 1;  // FrameIsIntra
    if (s.frame_id_numbers_present) rb.f(s.frame_id_length);
    int frame_size_override = s.reduced ? 0 : rb.bit1();
    if (s.enable_order_hint) rb.f(s.order_hint_bits);
    // primary_ref_frame: PRIMARY_REF_NONE for an intra frame
    if (s.decoder_model_info_present) {
        if (rb.bit1()) {  // buffer_removal_time_present
            for (int op = 0; op < s.op_count; op++) {
                if (!s.decoder_model_present[op]) continue;
                int idc = s.op_idc[op];
                if (idc == 0 || (((idc >> temporal_id) & 1) && ((idc >> (spatial_id + 8)) & 1)))
                    rb.f(s.buffer_removal_time_length);
            }
        }
    }
    // refresh_frame_flags: all frames for a shown key frame
    // frame_size(), superres_params(), render_size()
    if (frame_size_override) {
        fh.width = rb.f(s.width_bits) + 1;
        fh.height = rb.f(s.height_bits) + 1;
        if (fh.width > s.max_width || fh.height > s.max_height)
            fail(HEADER_ERROR, "Frame dimensions are larger than the maximum values");
    } else {
        fh.width = s.max_width;
        fh.height = s.max_height;
    }
    fh.upscaled_width = fh.width;
    if (s.enable_superres && rb.bit1()) {
        fh.superres_denom = rb.f(3) + 9;
        fh.width = (fh.upscaled_width * 8 + fh.superres_denom / 2) / fh.superres_denom;
        int min_w = std::min(16, fh.upscaled_width);
        if (fh.width < min_w) fh.width = min_w;
    }
    if (rb.bit1()) {  // render_and_frame_size_different
        rb.f(16);
        rb.f(16);
    }
    fh.mi_cols = 2 * ((fh.width + 7) >> 3);
    fh.mi_rows = 2 * ((fh.height + 7) >> 3);
    if (fh.allow_screen_content_tools && fh.upscaled_width == fh.width) fh.allow_intrabc = rb.bit1();
    fh.disable_frame_end_update_cdf = (s.reduced || fh.disable_cdf_update) ? 1 : rb.bit1();
    // tile_info()
    int sb_shift = s.use_128 ? 5 : 4;
    int sb_cols = (fh.mi_cols + (1 << sb_shift) - 1) >> sb_shift;
    int sb_rows = (fh.mi_rows + (1 << sb_shift) - 1) >> sb_shift;
    int sb_size_log2 = sb_shift + 2;
    int max_tile_width_sb = 4096 >> sb_size_log2;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2);
    int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
    int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
    int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
    int min_log2_tiles = std::max(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    std::vector<int> col_sb, row_sb;
    if (rb.bit1()) {  // uniform_tile_spacing_flag
        fh.tile_cols_log2 = min_log2_tile_cols;
        while (fh.tile_cols_log2 < max_log2_tile_cols && rb.bit1()) fh.tile_cols_log2++;
        int w = (sb_cols + (1 << fh.tile_cols_log2) - 1) >> fh.tile_cols_log2;
        for (int start = 0; start < sb_cols; start += w) col_sb.push_back(start);
        col_sb.push_back(sb_cols);
        int min_log2_tile_rows = std::max(min_log2_tiles - fh.tile_cols_log2, 0);
        fh.tile_rows_log2 = min_log2_tile_rows;
        while (fh.tile_rows_log2 < max_log2_tile_rows && rb.bit1()) fh.tile_rows_log2++;
        int h = (sb_rows + (1 << fh.tile_rows_log2) - 1) >> fh.tile_rows_log2;
        for (int start = 0; start < sb_rows; start += h) row_sb.push_back(start);
        row_sb.push_back(sb_rows);
    } else {
        int widest = 1, start = 0, left = sb_cols;
        while (left > 0 && (int)col_sb.size() < 64) {
            int size = 1 + rb.ns(std::min(left, max_tile_width_sb));
            col_sb.push_back(start);
            start += size;
            left -= size;
            widest = std::max(widest, size);
        }
        col_sb.push_back(start + left);
        int area = sb_rows * sb_cols;
        if (min_log2_tiles) area >>= (min_log2_tiles + 1);
        int max_tile_height_sb = std::max(area / widest, 1);
        start = 0;
        left = sb_rows;
        while (left > 0 && (int)row_sb.size() < 64) {
            int size = 1 + rb.ns(std::min(left, max_tile_height_sb));
            row_sb.push_back(start);
            start += size;
            left -= size;
        }
        row_sb.push_back(start + left);
        fh.tile_cols_log2 = tile_log2(1, (int)col_sb.size() - 1);
        fh.tile_rows_log2 = tile_log2(1, (int)row_sb.size() - 1);
    }
    fh.tile_cols = (int)col_sb.size() - 1;
    fh.tile_rows = (int)row_sb.size() - 1;
    for (int v : col_sb) fh.mi_col_starts.push_back(std::min(v << sb_shift, fh.mi_cols));
    for (int v : row_sb) fh.mi_row_starts.push_back(std::min(v << sb_shift, fh.mi_rows));
    if (fh.tile_cols_log2 > 0 || fh.tile_rows_log2 > 0) {
        fh.context_update_tile_id = rb.f(fh.tile_cols_log2 + fh.tile_rows_log2);
        if (fh.context_update_tile_id >= fh.tile_cols * fh.tile_rows)
            fail(HEADER_ERROR, "Invalid context_update_tile_id");
        fh.tile_size_bytes = rb.f(2) + 1;
    }
    // quantization_params()
    int num_planes = s.mono ? 1 : 3;
    fh.base_q_idx = rb.f(8);
    read_delta_q(rb, fh.dq_ydc);
    if (num_planes > 1) {
        int diff_uv = s.separate_uv_delta_q ? rb.bit1() : 0;
        read_delta_q(rb, fh.dq_udc);
        read_delta_q(rb, fh.dq_uac);
        if (diff_uv) {
            read_delta_q(rb, fh.dq_vdc);
            read_delta_q(rb, fh.dq_vac);
        } else {
            fh.dq_vdc = fh.dq_udc;
            fh.dq_vac = fh.dq_uac;
        }
    }
    fh.using_qmatrix = rb.bit1();
    if (fh.using_qmatrix) {
        rb.f(4);
        rb.f(4);
        if (s.separate_uv_delta_q) rb.f(4);
    }
    // segmentation_params()
    fh.seg_enabled = rb.bit1();
    if (fh.seg_enabled) {
        for (int i = 0; i < 8; i++) {
            for (int j = 0; j < 8; j++) {
                int v = 0;
                fh.feature_enabled[i][j] = rb.bit1();
                if (fh.feature_enabled[i][j]) {
                    int bits = kSegFeatureBits[j], limit = kSegFeatureMax[j];
                    if (kSegFeatureSigned[j])
                        v = clip3(-limit, limit, rb.su(1 + bits));
                    else
                        v = clip3(0, limit, (int)rb.f(bits));
                }
                fh.feature_data[i][j] = v;
            }
        }
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++)
                if (fh.feature_enabled[i][j]) {
                    fh.last_active_seg_id = i;
                    if (j >= 5) fh.seg_id_pre_skip = 1;
                }
    }
    // delta_q_params(), delta_lf_params()
    fh.delta_q_res = 0;
    fh.delta_lf_res = 0;
    if (fh.base_q_idx > 0) fh.delta_q_present = rb.bit1();
    if (fh.delta_q_present) {
        fh.delta_q_res = rb.f(2);
        if (!fh.allow_intrabc) fh.delta_lf_present = rb.bit1();
        if (fh.delta_lf_present) {
            fh.delta_lf_res = rb.f(2);
            fh.delta_lf_multi = rb.bit1();
        }
    }
    fh.coded_lossless = 1;
    for (int seg = 0; seg < 8; seg++) {
        int q = qindex_of(fh, seg);
        fh.lossless[seg] = q == 0 && !fh.dq_ydc && !fh.dq_uac && !fh.dq_udc && !fh.dq_vac && !fh.dq_vdc;
        if (!fh.lossless[seg]) fh.coded_lossless = 0;
    }
    fh.all_lossless = fh.coded_lossless && fh.width == fh.upscaled_width;
    // loop_filter_params()
    if (!fh.coded_lossless && !fh.allow_intrabc) {
        int l0 = rb.f(6), l1 = rb.f(6);
        if (num_planes > 1 && (l0 || l1)) rb.f(12);
        rb.f(3);
        if (rb.bit1() && rb.bit1()) {
            for (int i = 0; i < 8; i++)
                if (rb.bit1()) rb.f(7);
            for (int i = 0; i < 2; i++)
                if (rb.bit1()) rb.f(7);
        }
    }
    // cdef_params()
    if (!fh.coded_lossless && !fh.allow_intrabc && s.enable_cdef) {
        rb.f(2);
        int bits = rb.f(2);
        for (int i = 0; i < (1 << bits); i++) rb.f(num_planes > 1 ? 12 : 6);
    }
    // lr_params()
    if (!fh.all_lossless && !fh.allow_intrabc && s.enable_restoration) {
        int uses_lr = 0, uses_chroma_lr = 0;
        for (int i = 0; i < num_planes; i++) {
            if (rb.f(2)) {
                uses_lr = 1;
                if (i > 0) uses_chroma_lr = 1;
            }
        }
        if (uses_lr) {
            if (s.use_128) {
                rb.bit1();
            } else if (rb.bit1()) {
                rb.bit1();
            }
            if (s.ss_x && s.ss_y && uses_chroma_lr) rb.bit1();
        }
    }
    // read_tx_mode()
    if (!fh.coded_lossless) rb.bit1();
    // frame_reference_mode(), skip_mode_params(), allow_warped_motion: none in an intra frame
    fh.reduced_tx_set = rb.bit1();
    read_film_grain(rb, s, fh);
    return fh;
}

// -- the symbol decoder (entdec.c, daala reader) -------------------------------------

struct SymbolDecoder {
    const uint8_t* buf;
    const uint8_t* bptr;
    const uint8_t* end;
    uint32_t dif;
    uint32_t rng;
    int cnt;
    int tell_offs;
    bool allow_update;

    void init(const uint8_t* data, size_t size, bool update) {
        buf = bptr = data;
        end = data + size;
        tell_offs = 10 - (32 - 8);
        dif = (1u << 31) - 1;
        rng = 0x8000;
        cnt = -15;
        allow_update = update;
        refill();
    }
    void refill() {
        int s = 32 - 9 - (cnt + 15);
        for (; s >= 0 && bptr < end; s -= 8, bptr++) {
            dif ^= (uint32_t)bptr[0] << s;
            cnt += 8;
        }
        if (bptr >= end) {
            tell_offs += 0x4000 - cnt;
            cnt = 0x4000;
        }
    }
    int normalize(uint32_t d_if, uint32_t r, int ret) {
        int d = 15 - log2i((int)r);  // 16 - OD_ILOG_NZ(rng)
        cnt -= d;
        dif = ((d_if + 1) << d) - 1;
        rng = r << d;
        if (cnt < 0) refill();
        return ret;
    }
    // od_ec_decode_cdf_q15 on libaom's inverted CDF row of n symbols
    int decode(const uint16_t* icdf, int n) {
        uint32_t r = rng, c = dif >> 16, u, v = r;
        int ret = -1;
        const int N = n - 1;
        do {
            u = v;
            ++ret;
            v = ((r >> 8) * (uint32_t)(icdf[ret] >> 6) >> 1);
            v += 4u * (uint32_t)(N - ret);
        } while (c < v && ret < n);  // a row's last value is 0: the loop ends there on a valid row
        r = u - v;
        return normalize(dif - (v << 16), r, ret);
    }
    int read_bool() {  // aom_read_bit: od_ec_decode_bool_q15 at f = 16384
        uint32_t r = rng;
        uint32_t v = ((r >> 8) * (16384u >> 6) >> 1) + 4;
        uint32_t vw = v << 16;
        int ret = 1;
        uint32_t r_new = v, d = dif;
        if (d >= vw) {
            r_new = r - v;
            d -= vw;
            ret = 0;
        }
        return normalize(d, r_new, ret);
    }
    int literal(int bits) {
        int v = 0;
        for (int i = 0; i < bits; i++) v = (v << 1) | read_bool();
        return v;
    }
    int symbol(uint16_t* cdf, int n) {
        int v = decode(cdf, n);
        if (allow_update) update(cdf, v, n);
        return v;
    }
    static void update(uint16_t* cdf, int val, int n) {
        static const int speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2};
        const int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + speed[n];
        int tmp = 32768;
        for (int i = 0; i < n - 1; ++i) {
            tmp = (i == val) ? 0 : tmp;
            if (tmp < cdf[i])
                cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
            else
                cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
        }
        cdf[n] += (cdf[n] < 32);
    }
    int tell() const { return (int)((bptr - buf) * 8 - cnt + tell_offs); }
    bool overflowed() const { return ((tell() + 7) >> 3) > (end - buf); }
    // check_trailing_bits_after_symbol_coder
    bool trailing_ok() const {
        if (overflowed()) return false;
        uint32_t nb_bits = (uint32_t)tell();
        uint32_t nb_bytes = (nb_bits + 7) >> 3;
        const uint8_t* p = buf + nb_bytes;
        uint8_t last = p[-1];
        uint8_t pattern = (uint8_t)(128 >> ((nb_bits - 1) & 7));
        if ((last & (2 * pattern - 1)) != pattern) return false;
        for (; p < end; p++)
            if (*p) return false;
        return true;
    }
};

// -- the CDFs of one tile ------------------------------------------------------------

struct Cdfs {
    uint16_t kf_y[5][5][14], uv_mode[2][13][15], partition[20][11], angle_delta[8][8], intrabc[3];
    uint16_t pal_y_size[7][8], pal_uv_size[7][8], pal_y_color[7][5][9], pal_uv_color[7][5][9];
    uint16_t pal_y_mode[7][3][3], pal_uv_mode[2][3], filter_intra[22][3], filter_intra_mode[6];
    uint16_t cfl_sign[9], cfl_alpha[6][17], skip[3][3], seg[3][9], delta_q[5], delta_lf_multi[4][5], delta_lf[5];
    uint16_t dv[143];  // nmv_context: joints, then two components
    uint16_t txb_skip[5][13][3], eob_extra[5][2][9][3], dc_sign[2][3][3], eob16[2][2][6];
    uint16_t base_eob[5][2][4][4], base[5][2][42][5], br[5][2][21][5];

    void init(int q_ctx) {
        using namespace av1tab;
        memcpy(kf_y, kf_y_mode_cdf, sizeof kf_y);
        memcpy(uv_mode, uv_mode_cdf, sizeof uv_mode);
        memcpy(partition, partition_cdf, sizeof partition);
        memcpy(angle_delta, angle_delta_cdf, sizeof angle_delta);
        memcpy(intrabc, intrabc_cdf, sizeof intrabc);
        memcpy(pal_y_size, palette_y_size_cdf, sizeof pal_y_size);
        memcpy(pal_uv_size, palette_uv_size_cdf, sizeof pal_uv_size);
        memcpy(pal_y_color, palette_y_color_index_cdf, sizeof pal_y_color);
        memcpy(pal_uv_color, palette_uv_color_index_cdf, sizeof pal_uv_color);
        memcpy(pal_y_mode, palette_y_mode_cdf, sizeof pal_y_mode);
        memcpy(pal_uv_mode, palette_uv_mode_cdf, sizeof pal_uv_mode);
        memcpy(filter_intra, filter_intra_cdfs, sizeof filter_intra);
        memcpy(filter_intra_mode, filter_intra_mode_cdf, sizeof filter_intra_mode);
        memcpy(cfl_sign, cfl_sign_cdf, sizeof cfl_sign);
        memcpy(cfl_alpha, cfl_alpha_cdf, sizeof cfl_alpha);
        memcpy(skip, skip_cdf, sizeof skip);
        memcpy(seg, spatial_pred_seg_cdf, sizeof seg);
        memcpy(delta_q, delta_q_lf_cdfs[0], sizeof delta_q);
        memcpy(delta_lf_multi, delta_q_lf_cdfs[1], sizeof delta_lf_multi);
        memcpy(delta_lf, delta_q_lf_cdfs[5], sizeof delta_lf);
        memcpy(dv, nmv_context, sizeof dv);
        memcpy(txb_skip, txb_skip_cdfs[q_ctx], sizeof txb_skip);
        memcpy(eob_extra, eob_extra_cdfs[q_ctx], sizeof eob_extra);
        memcpy(dc_sign, dc_sign_cdfs[q_ctx], sizeof dc_sign);
        memcpy(eob16, eob_multi16_cdfs[q_ctx], sizeof eob16);
        memcpy(base_eob, coeff_base_eob_cdfs[q_ctx], sizeof base_eob);
        memcpy(base, coeff_base_cdfs[q_ctx], sizeof base);
        memcpy(br, coeff_br_cdfs[q_ctx], sizeof br);
    }
};

// offsets in the nmv_context rows
const int kMvJoints = 0, kMvComp = 5, kMvCompSize = 69;
const int kMvClasses = 0, kMvClass0Fp = 12, kMvFp = 22, kMvSign = 27, kMvClass0Hp = 30, kMvHp = 33, kMvClass0 = 36,
          kMvBits = 39;

}  // namespace

namespace {

// -- the frame: blocks, contexts, prediction and reconstruction -----------------------

struct BlockInfo {
    int8_t bsize = 0, ymode = DC_PRED, uvmode = DC_PRED, skip = 0, seg_id = 0, intrabc = 0, partition = 0;
    int8_t pal_size[2] = {0, 0};
    uint8_t pal[3][8] = {{0}};
    int mv_row = 0, mv_col = 0;  // IntraBC's displacement in 1/8 samples
};

// tool counters of a decode (the coverage test reads them)
enum {
    ST_PARTITION = 0,        // 10 partition types
    ST_YMODE = 10,           // 13 luma modes
    ST_UVMODE = 23,          // 14 chroma modes (CFL last)
    ST_ANGLE_DELTA = 37,     // blocks with a non-zero angle delta
    ST_PALETTE_Y = 38,
    ST_PALETTE_UV = 39,
    ST_FILTER_INTRA = 40,
    ST_INTRABC = 41,
    ST_TILES = 42,
    ST_BLOCKS = 43,
    ST_PALETTE_CACHE = 44,   // palette colours taken from the cache
    ST_SEGMENTS = 45,        // blocks whose segment id was read
    ST_EDGE_UPSAMPLE = 46,   // directional predictions with an upsampled edge
    ST_EDGE_FILTER = 47,     // directional predictions with a filtered edge
    ST_GOLOMB = 48,
    ST_COUNT = 64
};

struct Frame {
    const SeqHeader& s;
    const FrameHeader& fh;
    int num_planes, mi_rows, mi_cols, stride, rows;
    std::vector<uint8_t> plane[3];
    std::vector<BlockInfo> blocks;
    std::vector<int32_t> grid;  // block index of each 4x4 unit, -1 before it is decoded
    std::vector<uint8_t> above_ctx[3], left_ctx[3];  // libaom's entropy contexts: cul_level | dc sign << 3
    int32_t* stats;

    // the tile
    int row_start = 0, row_end = 0, col_start = 0, col_end = 0;
    Cdfs cdf;
    SymbolDecoder sd;
    int current_q = 0;
    int delta_lf[4] = {0, 0, 0, 0};
    bool read_deltas = false;
    uint8_t decoded[3][35][35];  // BlockDecoded, indexed from -1

    // the block
    int mi_row = 0, mi_col = 0, bsize = 0, bw4 = 1, bh4 = 1;
    bool avail_u = false, avail_l = false;
    BlockInfo* b = nullptr;
    int angle_y = 0, angle_uv = 0, use_filter_intra = 0, filter_mode = 0, cfl_u = 0, cfl_v = 0;
    uint8_t map_y[64][64], map_uv[64][64];

    Frame(const SeqHeader& s_, const FrameHeader& fh_, int32_t* st) : s(s_), fh(fh_), stats(st) {
        num_planes = s.mono ? 1 : 3;
        mi_rows = fh.mi_rows;
        mi_cols = fh.mi_cols;
        stride = mi_cols * 4 + 160;  // a block may reach 124 samples past the last 4x4 unit
        rows = mi_rows * 4 + 160;
        for (int p = 0; p < num_planes; p++) {
            plane[p].assign((size_t)stride * rows, 0);
            above_ctx[p].assign(mi_cols + 64, 0);
            left_ctx[p].assign(mi_rows + 64, 0);
        }
        grid.assign((size_t)mi_rows * mi_cols, -1);
        blocks.reserve(1024);
    }

    uint8_t* px(int p, int y, int x) { return &plane[p][(size_t)y * stride + x]; }
    bool inside(int r, int c) const { return c >= col_start && c < col_end && r >= row_start && r < row_end; }
    const BlockInfo& at(int r, int c) const {
        int32_t idx = grid[(size_t)r * mi_cols + c];
        if (idx < 0) fail(DECODE_ERROR, "a neighbour that is not decoded");
        return blocks[idx];
    }

    // -- symbols ------------------------------------------------------------------------
    int sym(uint16_t* cdf_row, int n) { return sd.symbol(cdf_row, n); }
    int lit(int bits) { return sd.literal(bits); }
    int ns(int n) {  // NS(n)
        int w = log2i(n) + 1;
        int m = (1 << w) - n;
        int v = lit(w - 1);
        if (v < m) return v;
        return (v << 1) - m + lit(1);
    }

    // -- the tile -------------------------------------------------------------------------
    void decode_tile(int tile_row, int tile_col, const uint8_t* data, size_t size) {
        row_start = fh.mi_row_starts[tile_row];
        row_end = fh.mi_row_starts[tile_row + 1];
        col_start = fh.mi_col_starts[tile_col];
        col_end = fh.mi_col_starts[tile_col + 1];
        int q_ctx = fh.base_q_idx <= 20 ? 0 : fh.base_q_idx <= 60 ? 1 : fh.base_q_idx <= 120 ? 2 : 3;
        cdf.init(q_ctx);
        sd.init(data, size, !fh.disable_cdf_update);
        current_q = fh.base_q_idx;
        for (int p = 0; p < num_planes; p++)
            std::fill(above_ctx[p].begin() + col_start, above_ctx[p].begin() + std::min<size_t>(col_end + 32, above_ctx[p].size()), 0);
        std::fill(delta_lf, delta_lf + 4, 0);
        int sb4 = s.use_128 ? 32 : 16;
        int sb_size = s.use_128 ? BLOCK_128X128 : BLOCK_64X64;
        for (int r = row_start; r < row_end; r += sb4) {
            for (int p = 0; p < num_planes; p++)
                std::fill(left_ctx[p].begin() + r, left_ctx[p].begin() + std::min<size_t>(r + sb4 + 32, left_ctx[p].size()), 0);
            for (int c = col_start; c < col_end; c += sb4) {
                read_deltas = fh.delta_q_present;
                clear_block_decoded(r, c, sb4);
                decode_partition(r, c, sb_size);
                if (sd.overflowed()) fail(DECODE_ERROR, "Failed to decode tile data");
            }
        }
        if (!sd.trailing_ok()) fail(DECODE_ERROR, "Failed to decode tile data");
        stats[ST_TILES]++;
    }

    void clear_block_decoded(int r, int c, int sb4) {
        for (int p = 0; p < num_planes; p++) {
            int sub_x = p ? s.ss_x : 0, sub_y = p ? s.ss_y : 0;
            int sb_w4 = (col_end - c) >> sub_x, sb_h4 = (row_end - r) >> sub_y;
            for (int y = -1; y <= (sb4 >> sub_y); y++)
                for (int x = -1; x <= (sb4 >> sub_x); x++) {
                    uint8_t v;
                    if (y < 0 && x < sb_w4)
                        v = 1;
                    else if (x < 0 && y < sb_h4)
                        v = 1;
                    else
                        v = 0;
                    decoded[p][y + 1][x + 1] = v;
                }
            decoded[p][(sb4 >> sub_y) + 1][0] = 0;
        }
    }

    // -- partition ------------------------------------------------------------------------
    void decode_partition(int r, int c, int bs) {
        if (r >= mi_rows || c >= mi_cols) return;
        bool au = inside(r - 1, c), al = inside(r, c - 1);
        int n4 = kBw4[bs], half = n4 >> 1, quarter = half >> 1;
        bool has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
        int partition;
        if (bs == BLOCK_4X4) {
            partition = PARTITION_NONE;
        } else {
            int bsl = log2i(n4);
            int above = au && log2i(kBw4[at(r - 1, c).bsize]) < bsl;
            int left = al && log2i(kBh4[at(r, c - 1).bsize]) < bsl;
            uint16_t* cdf_row = cdf.partition[(bsl - 1) * 4 + left * 2 + above];
            int n = bsl == 1 ? 4 : (bsl == 5 ? 8 : 10);
            auto prob = [&](int e) { return (e > 0 ? cdf_row[e - 1] : 32768) - cdf_row[e]; };
            if (has_rows && has_cols) {
                partition = sym(cdf_row, n);
            } else if (has_cols) {  // split_or_horz
                int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                           prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B) + (bs != BLOCK_128X128 ? prob(PARTITION_VERT_4) : 0);
                uint16_t tmp[3] = {(uint16_t)(32768 - (32768 - psum)), 0, 0};
                partition = sd.decode(tmp, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
            } else if (has_rows) {  // split_or_vert
                int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) +
                           prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A) + (bs != BLOCK_128X128 ? prob(PARTITION_HORZ_4) : 0);
                uint16_t tmp[3] = {(uint16_t)psum, 0, 0};
                partition = sd.decode(tmp, 2) ? PARTITION_SPLIT : PARTITION_VERT;
            } else {
                partition = PARTITION_SPLIT;
            }
        }
        stats[ST_PARTITION + partition]++;
        int sub_h = block_size(n4, half ? half : 1), sub_v = block_size(half ? half : 1, n4);
        int split = block_size(std::max(half, 1), std::max(half, 1));
        switch (partition) {
            case PARTITION_NONE: decode_block(r, c, bs, partition); break;
            case PARTITION_HORZ:
                decode_block(r, c, sub_h, partition);
                if (has_rows) decode_block(r + half, c, sub_h, partition);
                break;
            case PARTITION_VERT:
                decode_block(r, c, sub_v, partition);
                if (has_cols) decode_block(r, c + half, sub_v, partition);
                break;
            case PARTITION_SPLIT:
                decode_partition(r, c, split);
                decode_partition(r, c + half, split);
                decode_partition(r + half, c, split);
                decode_partition(r + half, c + half, split);
                break;
            case PARTITION_HORZ_A:
                decode_block(r, c, split, partition);
                decode_block(r, c + half, split, partition);
                decode_block(r + half, c, sub_h, partition);
                break;
            case PARTITION_HORZ_B:
                decode_block(r, c, sub_h, partition);
                decode_block(r + half, c, split, partition);
                decode_block(r + half, c + half, split, partition);
                break;
            case PARTITION_VERT_A:
                decode_block(r, c, split, partition);
                decode_block(r + half, c, split, partition);
                decode_block(r, c + half, sub_v, partition);
                break;
            case PARTITION_VERT_B:
                decode_block(r, c, sub_v, partition);
                decode_block(r, c + half, split, partition);
                decode_block(r + half, c + half, split, partition);
                break;
            case PARTITION_HORZ_4: {
                int bs4 = block_size(n4, quarter);
                for (int i = 0; i < 4; i++)
                    if (i < 3 || r + quarter * 3 < mi_rows) decode_block(r + quarter * i, c, bs4, partition);
                break;
            }
            case PARTITION_VERT_4: {
                int bs4 = block_size(quarter, n4);
                for (int i = 0; i < 4; i++)
                    if (i < 3 || c + quarter * 3 < mi_cols) decode_block(r, c + quarter * i, bs4, partition);
                break;
            }
            default: fail(DECODE_ERROR, "invalid partition");
        }
    }

    // -- the block ------------------------------------------------------------------------
    void decode_block(int r, int c, int bs, int partition) {
        mi_row = r;
        mi_col = c;
        bsize = bs;
        bw4 = kBw4[bs];
        bh4 = kBh4[bs];
        avail_u = inside(r - 1, c);
        avail_l = inside(r, c - 1);
        blocks.emplace_back();
        int idx = (int)blocks.size() - 1;
        b = &blocks[idx];
        b->bsize = (int8_t)bs;
        b->partition = (int8_t)partition;
        int r_end = std::min(r + bh4, mi_rows), c_end = std::min(c + bw4, mi_cols);
        for (int y = r; y < r_end; y++)
            for (int x = c; x < c_end; x++) grid[(size_t)y * mi_cols + x] = idx;
        stats[ST_BLOCKS]++;
        mode_info();
        palette_tokens();
        if (b->skip) reset_block_context();
        if (b->intrabc) predict_intrabc();
        residual();
    }

    void reset_block_context() {
        for (int p = 0; p < num_planes; p++) {
            int sub_x = p ? s.ss_x : 0, sub_y = p ? s.ss_y : 0;
            for (int i = mi_col >> sub_x; i < ((mi_col + bw4) >> sub_x); i++) above_ctx[p][i] = 0;
            for (int i = mi_row >> sub_y; i < ((mi_row + bh4) >> sub_y); i++) left_ctx[p][i] = 0;
        }
    }

    void mode_info() {
        b->skip = 0;
        if (fh.seg_id_pre_skip) intra_segment_id();
        // read_skip
        if (fh.seg_id_pre_skip && fh.seg_enabled && fh.feature_enabled[b->seg_id][6]) {
            b->skip = 1;
        } else {
            int ctx = (avail_u ? at(mi_row - 1, mi_col).skip : 0) + (avail_l ? at(mi_row, mi_col - 1).skip : 0);
            b->skip = (int8_t)sym(cdf.skip[ctx], 2);
        }
        if (!fh.seg_id_pre_skip) intra_segment_id();
        read_delta_qindex();
        read_delta_lf();
        read_deltas = false;
        b->intrabc = fh.allow_intrabc ? (int8_t)sym(cdf.intrabc, 2) : 0;
        use_filter_intra = 0;
        angle_y = angle_uv = 0;
        if (b->intrabc) {
            stats[ST_INTRABC]++;
            b->ymode = DC_PRED;
            b->uvmode = DC_PRED;
            read_intrabc();
            return;
        }
        int above = kIntraModeContext[avail_u ? (int)at(mi_row - 1, mi_col).ymode : (int)DC_PRED];
        int left = kIntraModeContext[avail_l ? (int)at(mi_row, mi_col - 1).ymode : (int)DC_PRED];
        b->ymode = (int8_t)sym(cdf.kf_y[above][left], 13);
        stats[ST_YMODE + b->ymode]++;
        if (bsize >= BLOCK_8X8 && b->ymode >= V_PRED && b->ymode <= D67_PRED) {
            angle_y = sym(cdf.angle_delta[b->ymode - V_PRED], 7) - 3;
            if (angle_y) stats[ST_ANGLE_DELTA]++;
        }
        if (num_planes > 1) {
            // is_cfl_allowed: in a lossless block, where the 4:4:4 chroma block is 4x4
            int cfl_allowed = bsize == BLOCK_4X4;
            b->uvmode = (int8_t)sym(cdf.uv_mode[cfl_allowed][b->ymode], cfl_allowed ? 14 : 13);
            stats[ST_UVMODE + b->uvmode]++;
            if (b->uvmode == UV_CFL_PRED) read_cfl_alphas();
            if (bsize >= BLOCK_8X8 && b->uvmode >= V_PRED && b->uvmode <= D67_PRED) {
                angle_uv = sym(cdf.angle_delta[b->uvmode - V_PRED], 7) - 3;
                if (angle_uv) stats[ST_ANGLE_DELTA]++;
            }
        }
        if (bsize >= BLOCK_8X8 && bw4 <= 16 && bh4 <= 16 && fh.allow_screen_content_tools) palette_mode_info();
        if (s.enable_filter_intra && b->ymode == DC_PRED && b->pal_size[0] == 0 && std::max(bw4, bh4) <= 8) {
            use_filter_intra = sym(cdf.filter_intra[bsize], 2);
            if (use_filter_intra) {
                filter_mode = sym(cdf.filter_intra_mode, 5);
                stats[ST_FILTER_INTRA]++;
            }
        }
    }

    void intra_segment_id() {
        if (!fh.seg_enabled) {
            b->seg_id = 0;
            return;
        }
        int prev_ul = (avail_u && avail_l) ? at(mi_row - 1, mi_col - 1).seg_id : -1;
        int prev_u = avail_u ? at(mi_row - 1, mi_col).seg_id : -1;
        int prev_l = avail_l ? at(mi_row, mi_col - 1).seg_id : -1;
        int pred;
        if (prev_u == -1)
            pred = prev_l == -1 ? 0 : prev_l;
        else if (prev_l == -1)
            pred = prev_u;
        else
            pred = prev_ul == prev_u ? prev_u : prev_l;
        if (b->skip) {
            b->seg_id = (int8_t)pred;
            return;
        }
        int ctx;
        if (prev_ul < 0)
            ctx = 0;
        else if (prev_ul == prev_u && prev_ul == prev_l)
            ctx = 2;
        else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l)
            ctx = 1;
        else
            ctx = 0;
        int v = sym(cdf.seg[ctx], 8);
        int max = fh.last_active_seg_id + 1;
        // neg_deinterleave
        int id;
        if (!pred)
            id = v;
        else if (pred >= max - 1)
            id = max - v - 1;
        else if (2 * pred < max)
            id = v <= 2 * pred ? ((v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1)) : v;
        else
            id = v <= 2 * (max - pred - 1) ? ((v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1)) : max - (v + 1);
        b->seg_id = (int8_t)clip3(0, fh.last_active_seg_id, id);
        stats[ST_SEGMENTS]++;
    }

    void read_delta_qindex() {
        int sb_size = s.use_128 ? BLOCK_128X128 : BLOCK_64X64;
        if (bsize == sb_size && b->skip) return;
        if (!read_deltas) return;
        int abs = sym(cdf.delta_q, 4);
        if (abs == 3) {
            int rem = lit(3) + 1;
            abs = lit(rem) + (1 << rem) + 1;
        }
        if (abs) {
            int sign = lit(1);
            int reduced = sign ? -abs : abs;
            current_q = clip3(1, 255, current_q + (reduced << fh.delta_q_res));
        }
    }

    void read_delta_lf() {
        int sb_size = s.use_128 ? BLOCK_128X128 : BLOCK_64X64;
        if (bsize == sb_size && b->skip) return;
        if (!read_deltas || !fh.delta_lf_present) return;
        int count = fh.delta_lf_multi ? (s.mono ? 2 : 4) : 1;
        for (int i = 0; i < count; i++) {
            int abs = sym(fh.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf, 4);
            if (abs == 3) {
                int rem = lit(3) + 1;
                abs = lit(rem) + (1 << rem) + 1;
            }
            if (abs) {
                int sign = lit(1);
                int reduced = sign ? -abs : abs;
                delta_lf[i] = clip3(-63, 63, delta_lf[i] + (reduced << fh.delta_lf_res));
            }
        }
    }

    void read_cfl_alphas() {
        int signs = sym(cdf.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        cfl_u = cfl_v = 0;
        if (sign_u) {
            cfl_u = sym(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16) + 1;
            if (sign_u == 1) cfl_u = -cfl_u;
        }
        if (sign_v) {
            cfl_v = sym(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16) + 1;
            if (sign_v == 1) cfl_v = -cfl_v;
        }
    }

    // -- palette ----------------------------------------------------------------------------
    int palette_cache(int p, uint16_t* cache) {
        // av1_get_palette_cache: no above block across a 64-sample row boundary
        const BlockInfo* above = (avail_u && (mi_row % 16)) ? &at(mi_row - 1, mi_col) : nullptr;
        const BlockInfo* left = avail_l ? &at(mi_row, mi_col - 1) : nullptr;
        int an = above ? above->pal_size[p != 0] : 0, ln = left ? left->pal_size[p != 0] : 0;
        int ai = 0, li = 0, n = 0;
        while (an > 0 && ln > 0) {
            int va = above->pal[p][ai], vl = left->pal[p][li];
            if (vl < va) {
                if (n == 0 || vl != cache[n - 1]) cache[n++] = (uint16_t)vl;
                li++, ln--;
            } else {
                if (n == 0 || va != cache[n - 1]) cache[n++] = (uint16_t)va;
                ai++, an--;
                if (vl == va) li++, ln--;
            }
        }
        while (an-- > 0) {
            int v = above->pal[p][ai++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = (uint16_t)v;
        }
        while (ln-- > 0) {
            int v = left->pal[p][li++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = (uint16_t)v;
        }
        return n;
    }

    static int ceil_log2(int n) {
        if (n < 2) return 0;
        int i = 1, p = 2;
        while (p < n) i++, p <<= 1;
        return i;
    }

    // read_palette_colors_y / the U half of read_palette_colors_uv: cached colours
    // then new ones as deltas, merged in order
    void read_palette_colors(int p, int n) {
        uint16_t cache[16], cached[8];
        int n_cache = palette_cache(p, cache);
        int idx = 0;
        for (int i = 0; i < n_cache && idx < n; i++)
            if (lit(1)) cached[idx++] = cache[i];
        stats[ST_PALETTE_CACHE] += idx;
        int colors[8];
        if (idx < n) {
            int n_cached = idx, k = 0;
            colors[k++] = lit(8);
            idx++;
            if (idx < n) {
                int bits = 8 - 3 + lit(2);
                int range = (1 << 8) - colors[k - 1] - (p == 0 ? 1 : 0);
                for (; idx < n; idx++, k++) {
                    int delta = lit(bits) + (p == 0 ? 1 : 0);
                    colors[k] = clip3(0, 255, colors[k - 1] + delta);
                    range -= colors[k] - colors[k - 1];
                    bits = std::min(bits, ceil_log2(range));
                }
            }
            // merge_colors: the cached colours and the new ones, both ascending
            int i = 0, j = 0, o = 0;
            uint8_t* out = b->pal[p];
            while (i < n_cached && j < k) out[o++] = (uint8_t)(cached[i] <= colors[j] ? cached[i++] : colors[j++]);
            while (i < n_cached) out[o++] = (uint8_t)cached[i++];
            while (j < k) out[o++] = (uint8_t)colors[j++];
        } else {
            for (int i = 0; i < n; i++) b->pal[p][i] = (uint8_t)cached[i];
        }
    }

    void palette_mode_info() {
        int bsize_ctx = log2i(bw4) + log2i(bh4) - 2;
        if (b->ymode == DC_PRED) {
            int ctx = (avail_u && at(mi_row - 1, mi_col).pal_size[0] > 0) + (avail_l && at(mi_row, mi_col - 1).pal_size[0] > 0);
            if (sym(cdf.pal_y_mode[bsize_ctx][ctx], 2)) {
                b->pal_size[0] = (int8_t)(sym(cdf.pal_y_size[bsize_ctx], 7) + 2);
                read_palette_colors(0, b->pal_size[0]);
                stats[ST_PALETTE_Y]++;
            }
        }
        if (num_planes > 1 && b->uvmode == DC_PRED) {
            if (sym(cdf.pal_uv_mode[b->pal_size[0] > 0], 2)) {
                int n = sym(cdf.pal_uv_size[bsize_ctx], 7) + 2;
                b->pal_size[1] = (int8_t)n;
                read_palette_colors(1, n);
                if (lit(1)) {  // delta_encode_palette_colors_v
                    int bits = 8 - 4 + lit(2);
                    int prev = lit(8);
                    b->pal[2][0] = (uint8_t)prev;
                    for (int i = 1; i < n; i++) {
                        int delta = lit(bits);
                        if (delta && lit(1)) delta = -delta;
                        int val = prev + delta;
                        if (val < 0) val += 256;
                        if (val >= 256) val -= 256;
                        prev = clip3(0, 255, val);
                        b->pal[2][i] = (uint8_t)prev;
                    }
                } else {
                    for (int i = 0; i < n; i++) b->pal[2][i] = (uint8_t)lit(8);
                }
                stats[ST_PALETTE_UV]++;
            }
        }
    }

    void color_map(int n, uint8_t (*map)[64], int block_w, int block_h, int onscreen_w, int onscreen_h, int p) {
        map[0][0] = (uint8_t)ns(n);
        for (int i = 1; i < onscreen_h + onscreen_w - 1; i++) {
            for (int j = std::min(i, onscreen_w - 1); j >= std::max(0, i - onscreen_h + 1); j--) {
                int rr = i - j, cc = j;
                int scores[8] = {0}, order[8] = {0, 1, 2, 3, 4, 5, 6, 7};
                if (cc > 0) scores[map[rr][cc - 1]] += 2;
                if (rr > 0 && cc > 0) scores[map[rr - 1][cc - 1]] += 1;
                if (rr > 0) scores[map[rr - 1][cc]] += 2;
                for (int k = 0; k < 3; k++) {
                    int max_score = scores[k], max_idx = k;
                    for (int l = k + 1; l < n; l++)
                        if (scores[l] > max_score) max_score = scores[l], max_idx = l;
                    if (max_idx != k) {
                        max_score = scores[max_idx];
                        int max_order = order[max_idx];
                        for (int l = max_idx; l > k; l--) scores[l] = scores[l - 1], order[l] = order[l - 1];
                        scores[k] = max_score;
                        order[k] = max_order;
                    }
                }
                int hash = scores[0] * 1 + scores[1] * 2 + scores[2] * 2;
                int ctx = kPaletteColorContext[hash];
                uint16_t* row = p == 0 ? cdf.pal_y_color[n - 2][ctx] : cdf.pal_uv_color[n - 2][ctx];
                map[rr][cc] = (uint8_t)order[sym(row, n)];
            }
        }
        for (int i = 0; i < onscreen_h; i++)
            for (int j = onscreen_w; j < block_w; j++) map[i][j] = map[i][onscreen_w - 1];
        for (int i = onscreen_h; i < block_h; i++)
            for (int j = 0; j < block_w; j++) map[i][j] = map[onscreen_h - 1][j];
    }

    void palette_tokens() {
        int block_h = bh4 * 4, block_w = bw4 * 4;
        int on_h = std::min(block_h, (mi_rows - mi_row) * 4), on_w = std::min(block_w, (mi_cols - mi_col) * 4);
        if (b->pal_size[0]) color_map(b->pal_size[0], map_y, block_w, block_h, on_w, on_h, 0);
        if (b->pal_size[1]) {
            block_h >>= s.ss_y;
            block_w >>= s.ss_x;
            on_h >>= s.ss_y;
            on_w >>= s.ss_x;
            if (block_w < 4) block_w += 2, on_w += 2;
            if (block_h < 4) block_h += 2, on_h += 2;
            color_map(b->pal_size[1], map_uv, block_w, block_h, on_w, on_h, 1);
        }
    }

    // -- IntraBC: the reference-DV stack (mvref_common.c) and the DV ----------------------
    struct Cand {
        int row, col, weight;
    };
    Cand stack[8];
    int stack_n = 0;

    void add_candidate(const BlockInfo& cand, int weight) {
        if (!cand.intrabc) return;  // is_inter_block with ref_frame[0] == INTRA_FRAME
        for (int i = 0; i < stack_n; i++)
            if (stack[i].row == cand.mv_row && stack[i].col == cand.mv_col) {
                stack[i].weight += weight;
                return;
            }
        if (stack_n < 8) stack[stack_n++] = {cand.mv_row, cand.mv_col, weight};
    }

    void scan_row(int row_offset, int max_row_offset, int& processed_rows) {
        int end_mi = std::min(std::min(bw4, mi_cols - mi_col), 16);
        int col_offset = 0;
        if (std::abs(row_offset) > 1) {
            col_offset = 1;
            if ((mi_col & 1) && bw4 < 2) col_offset--;
        }
        int use_step_16 = bw4 >= 16;
        for (int i = 0; i < end_mi;) {
            const BlockInfo& cand = at(mi_row + row_offset, mi_col + col_offset + i);
            int n4_w = kBw4[cand.bsize];
            int len = std::min(bw4, n4_w);
            if (use_step_16)
                len = std::max(4, len);
            else if (std::abs(row_offset) > 1)
                len = std::max(len, 2);
            int weight = 2;
            if (bw4 >= 2 && bw4 <= n4_w) {
                int inc = std::min(-max_row_offset + row_offset + 1, (int)kBh4[cand.bsize]);
                weight = std::max(weight, inc);
                processed_rows = inc - row_offset - 1;
            }
            add_candidate(cand, len * weight);
            i += len;
        }
    }

    void scan_col(int col_offset, int max_col_offset, int& processed_cols) {
        int end_mi = std::min(std::min(bh4, mi_rows - mi_row), 16);
        int row_offset = 0;
        if (std::abs(col_offset) > 1) {
            row_offset = 1;
            if ((mi_row & 1) && bh4 < 2) row_offset--;
        }
        int use_step_16 = bh4 >= 16;
        for (int i = 0; i < end_mi;) {
            const BlockInfo& cand = at(mi_row + row_offset + i, mi_col + col_offset);
            int n4_h = kBh4[cand.bsize];
            int len = std::min(bh4, n4_h);
            if (use_step_16)
                len = std::max(4, len);
            else if (std::abs(col_offset) > 1)
                len = std::max(len, 2);
            int weight = 2;
            if (bh4 >= 2 && bh4 <= n4_h) {
                int inc = std::min(-max_col_offset + col_offset + 1, (int)kBw4[cand.bsize]);
                weight = std::max(weight, inc);
                processed_cols = inc - col_offset - 1;
            }
            add_candidate(cand, len * weight);
            i += len;
        }
    }

    void scan_point(int row_offset, int col_offset) {
        if (inside(mi_row + row_offset, mi_col + col_offset)) add_candidate(at(mi_row + row_offset, mi_col + col_offset), 4);
    }

    bool has_top_right() const {
        int bs = std::max(bw4, bh4);
        int sb_mi = s.use_128 ? 32 : 16;
        int mask_row = mi_row & (sb_mi - 1), mask_col = mi_col & (sb_mi - 1);
        if (bs > 16) return false;
        bool has_tr = !((mask_row & bs) && (mask_col & bs));
        while (bs < sb_mi) {
            if (mask_col & bs) {
                if ((mask_col & (2 * bs)) && (mask_row & (2 * bs))) {
                    has_tr = false;
                    break;
                }
            } else {
                break;
            }
            bs <<= 1;
        }
        // the last of a vertical category, the first of a horizontal one
        if (bw4 < bh4 && ((mi_col + bw4) & (bh4 - 1))) has_tr = true;
        if (bw4 > bh4 && (mi_row & (bw4 - 1))) has_tr = false;
        if (b->partition == PARTITION_VERT_A && bw4 == bh4 && (mask_row & bs)) has_tr = false;
        return has_tr;
    }

    void find_dv_stack() {
        stack_n = 0;
        int max_row_offset = 0, max_col_offset = 0;
        int row_adj = bh4 < 2 && (mi_row & 1), col_adj = bw4 < 2 && (mi_col & 1);
        int processed_rows = 0, processed_cols = 0;
        if (avail_u) {
            max_row_offset = -(3 << 1) + row_adj;
            if (bh4 < 2) max_row_offset = -(2 << 1) + row_adj;
            max_row_offset = clip3(row_start - mi_row, row_end - mi_row - 1, max_row_offset);
        }
        if (avail_l) {
            max_col_offset = -(3 << 1) + col_adj;
            if (bw4 < 2) max_col_offset = -(2 << 1) + col_adj;
            max_col_offset = clip3(col_start - mi_col, col_end - mi_col - 1, max_col_offset);
        }
        if (std::abs(max_row_offset) >= 1) scan_row(-1, max_row_offset, processed_rows);
        if (std::abs(max_col_offset) >= 1) scan_col(-1, max_col_offset, processed_cols);
        if (has_top_right()) scan_point(-1, bw4);
        int nearest = stack_n;
        for (int i = 0; i < nearest; i++) stack[i].weight += 640;  // REF_CAT_LEVEL
        scan_point(-1, -1);
        for (int idx = 2; idx <= 3; idx++) {
            int row_offset = -(idx << 1) + 1 + row_adj, col_offset = -(idx << 1) + 1 + col_adj;
            if (std::abs(row_offset) <= std::abs(max_row_offset) && std::abs(row_offset) > processed_rows)
                scan_row(row_offset, max_row_offset, processed_rows);
            if (std::abs(col_offset) <= std::abs(max_col_offset) && std::abs(col_offset) > processed_cols)
                scan_col(col_offset, max_col_offset, processed_cols);
        }
        auto sort_range = [&](int lo, int hi) {  // libaom's bubble sort by weight, stable
            int len = hi;
            while (len > lo) {
                int nr_len = lo;
                for (int i = lo + 1; i < len; i++)
                    if (stack[i - 1].weight < stack[i].weight) {
                        std::swap(stack[i - 1], stack[i]);
                        nr_len = i;
                    }
                len = nr_len;
            }
        };
        sort_range(0, nearest);
        sort_range(nearest, stack_n);
        // clamp_mv_ref
        for (int i = 0; i < stack_n; i++) {
            int bw = bw4 * 4, bh = bh4 * 4;
            int to_left = -(mi_col * 4 * 8), to_right = (mi_cols - bw4 - mi_col) * 4 * 8;
            int to_top = -(mi_row * 4 * 8), to_bottom = (mi_rows - bh4 - mi_row) * 4 * 8;
            stack[i].col = clip3(to_left - bw * 8 - 1024, to_right + bw * 8 + 1024, stack[i].col);
            stack[i].row = clip3(to_top - bh * 8 - 1024, to_bottom + bh * 8 + 1024, stack[i].row);
        }
    }

    int read_mv_component(const uint16_t* base_row) {
        uint16_t* comp = const_cast<uint16_t*>(base_row);
        int sign = sym(comp + kMvSign, 2);
        int cls = sym(comp + kMvClasses, 11);
        int mag, d;
        if (cls == 0) {
            d = sym(comp + kMvClass0, 2);
            mag = 0;
        } else {
            d = 0;
            for (int i = 0; i < cls; i++) d |= sym(comp + kMvBits + 3 * i, 2) << i;
            mag = 2 << (cls + 2);  // CLASS0_SIZE << (class + 2)
        }
        mag += ((d << 3) | (3 << 1) | 1) + 1;  // integer DVs: fr = 3, hp = 1
        return sign ? -mag : mag;
    }

    bool dv_valid(int dv_row, int dv_col) const {
        if ((dv_row & 7) || (dv_col & 7)) return false;
        int bw = bw4 * 4, bh = bh4 * 4;
        int src_top = mi_row * 4 * 8 + dv_row, tile_top = row_start * 4 * 8;
        if (src_top < tile_top) return false;
        int src_left = mi_col * 4 * 8 + dv_col, tile_left = col_start * 4 * 8;
        if (src_left < tile_left) return false;
        int src_bottom = (mi_row * 4 + bh) * 8 + dv_row, tile_bottom = row_end * 4 * 8;
        if (src_bottom > tile_bottom) return false;
        int src_right = (mi_col * 4 + bw) * 8 + dv_col, tile_right = col_end * 4 * 8;
        if (src_right > tile_right) return false;
        // sub-8x8 chroma: only with subsampled chroma, not decoded here
        int mib_log2 = s.use_128 ? 5 : 4;
        int sb_size = (1 << mib_log2) * 4;
        int active_sb_row = mi_row >> mib_log2;
        int active_sb64_col = (mi_col * 4) >> 6;
        int src_sb_row = ((src_bottom >> 3) - 1) / sb_size;
        int src_sb64_col = ((src_right >> 3) - 1) >> 6;
        int total_sb64_per_row = ((col_end - col_start - 1) >> 4) + 1;
        int active_sb64 = active_sb_row * total_sb64_per_row + active_sb64_col;
        int src_sb64 = src_sb_row * total_sb64_per_row + src_sb64_col;
        if (src_sb64 >= active_sb64 - kIntrabcDelaySb64) return false;
        int gradient = 1 + kIntrabcDelaySb64 + (sb_size > 64);
        int wf_offset = gradient * (active_sb_row - src_sb_row);
        if (src_sb_row > active_sb_row || src_sb64_col >= active_sb64_col - kIntrabcDelaySb64 + wf_offset) return false;
        return true;
    }

    void read_intrabc() {
        find_dv_stack();
        // av1_find_best_ref_mvs: the first two, lowered to even (no high precision)
        int ref[2][2] = {{0, 0}, {0, 0}};
        for (int i = 0; i < 2 && i < stack_n; i++) {
            ref[i][0] = stack[i].row;
            ref[i][1] = stack[i].col;
            for (int k = 0; k < 2; k++)
                if (ref[i][k] & 1) ref[i][k] += ref[i][k] > 0 ? -1 : 1;
        }
        int dv_row = ref[0][0], dv_col = ref[0][1];
        if (dv_row == 0 && dv_col == 0) dv_row = ref[1][0], dv_col = ref[1][1];
        if (dv_row == 0 && dv_col == 0) {  // av1_find_ref_dv
            int mib = s.use_128 ? 32 : 16;
            if (mi_row - mib < row_start) {
                dv_row = 0;
                dv_col = (-4 * mib - kIntrabcDelayPixels) * 8;
            } else {
                dv_row = -4 * mib * 8;
                dv_col = 0;
            }
        }
        bool valid = !(dv_col & 7) && !(dv_row & 7);
        dv_col = (dv_col >> 3) * 8;
        dv_row = (dv_row >> 3) * 8;
        // read_mv with the DV context, MV_SUBPEL_NONE
        int joint = sym(cdf.dv + kMvJoints, 4);
        int diff_row = 0, diff_col = 0;
        if (joint == 2 || joint == 3) diff_row = read_mv_component(cdf.dv + kMvComp);
        if (joint == 1 || joint == 3) diff_col = read_mv_component(cdf.dv + kMvComp + kMvCompSize);
        int mv_row = dv_row + diff_row, mv_col = dv_col + diff_col;
        mv_row = (mv_row >> 3) * 8;
        mv_col = (mv_col >> 3) * 8;
        b->mv_row = mv_row;
        b->mv_col = mv_col;
        bool mv_ok = mv_row > -(1 << 14) && mv_row < (1 << 14) && mv_col > -(1 << 14) && mv_col < (1 << 14);
        if (!(valid && mv_ok && dv_valid(mv_row, mv_col))) fail(DECODE_ERROR, "Failed to decode tile data (an invalid intrabc dv)");
    }

    void predict_intrabc() {
        int dy = b->mv_row >> 3, dx = b->mv_col >> 3;
        for (int p = 0; p < num_planes; p++) {
            int x0 = mi_col * 4, y0 = mi_row * 4, w = bw4 * 4, h = bh4 * 4;
            for (int i = 0; i < h; i++) memmove(px(p, y0 + i, x0), px(p, y0 + i + dy, x0 + dx), (size_t)w);
        }
    }

    // -- residual: 4x4 transform blocks, by 64x64 chunk and plane --------------------------
    void residual() {
        int width_chunks = std::max(1, bw4 >> 4), height_chunks = std::max(1, bh4 >> 4);
        for (int cy = 0; cy < height_chunks; cy++)
            for (int cx = 0; cx < width_chunks; cx++) {
                for (int p = 0; p < num_planes; p++) {
                    int sub_x = p ? s.ss_x : 0, sub_y = p ? s.ss_y : 0;
                    int num4w = bw4 >> sub_x, num4h = bh4 >> sub_y;  // 4:4:4 / 4:0:0
                    int base_x = (mi_col >> sub_x) * 4, base_y = (mi_row >> sub_y) * 4;
                    for (int y = 0; y < std::min(num4h, 16 >> sub_y); y++)
                        for (int x = 0; x < std::min(num4w, 16 >> sub_x); x++)
                            transform_block(p, base_x, base_y, x + ((cx << 4) >> sub_x), y + ((cy << 4) >> sub_y));
                }
            }
    }

    void transform_block(int p, int base_x, int base_y, int x, int y) {
        int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
        int sub_x = p ? s.ss_x : 0, sub_y = p ? s.ss_y : 0;
        int row = (start_y << sub_y) >> 2, col = (start_x << sub_x) >> 2;
        int sb_mask = s.use_128 ? 31 : 15;
        int sbr = row & sb_mask, sbc = col & sb_mask;
        int max_x = mi_cols * 4 - 1, max_y = mi_rows * 4 - 1;
        if (start_x >= (max_x >> sub_x) + 1 || start_y >= (max_y >> sub_y) + 1) return;
        if (!b->intrabc) {
            if (b->pal_size[p != 0]) {
                uint8_t (*map)[64] = p ? map_uv : map_y;
                for (int i = 0; i < 4; i++)
                    for (int j = 0; j < 4; j++) *px(p, start_y + i, start_x + j) = b->pal[p][map[y * 4 + i][x * 4 + j]];
            } else {
                bool is_cfl = p > 0 && b->uvmode == UV_CFL_PRED;
                int mode = p == 0 ? (int)b->ymode : (is_cfl ? (int)DC_PRED : (int)b->uvmode);
                bool have_left = avail_l || x > 0, have_above = avail_u || y > 0;
                bool have_ar = decoded[p][(sbr >> sub_y) - 1 + 1][(sbc >> sub_x) + 1 + 1];
                bool have_bl = decoded[p][(sbr >> sub_y) + 1 + 1][(sbc >> sub_x) - 1 + 1];
                predict_intra(p, start_x, start_y, have_left, have_above, have_ar, have_bl, mode);
                if (is_cfl) predict_cfl(p, start_x, start_y);
            }
        }
        if (!b->skip) {
            int32_t coef[16];
            int eob = coeffs(p, start_x, start_y, coef);
            if (eob > 0) reconstruct(p, start_x, start_y, coef, eob);
        }
        decoded[p][(sbr >> sub_y) + 1][(sbc >> sub_x) + 1] = 1;
    }

    // -- intra prediction (reconintra.c), on 4x4 blocks --------------------------------------
    bool is_smooth(int r, int c, int p) const {
        const BlockInfo& n = at(r, c);
        int mode;
        if (p == 0) {
            mode = n.ymode;
        } else {
            if (n.intrabc) return false;
            mode = n.uvmode;
        }
        return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
    }

    void predict_intra(int p, int x, int y, bool have_left, bool have_above, bool have_ar, bool have_bl, int mode) {
        const int w = 4, h = 4;
        int sub_x = p ? s.ss_x : 0, sub_y = p ? s.ss_y : 0;
        int max_x = ((mi_cols * 4) >> sub_x) - 1, max_y = ((mi_rows * 4) >> sub_y) - 1;
        int above_buf[48], left_buf[48];
        int* above = above_buf + 16;
        int* left = left_buf + 16;
        for (int i = 0; i < w + h; i++) {
            if (!have_above && have_left)
                above[i] = *px(p, y, x - 1);
            else if (!have_above && !have_left)
                above[i] = 127;
            else {
                int limit = std::min(max_x, x + (have_ar ? 2 * w : w) - 1);
                above[i] = *px(p, y - 1, std::min(limit, x + i));
            }
            if (!have_left && have_above)
                left[i] = *px(p, y - 1, x);
            else if (!have_left && !have_above)
                left[i] = 129;
            else {
                int limit = std::min(max_y, y + (have_bl ? 2 * h : h) - 1);
                left[i] = *px(p, std::min(limit, y + i), x - 1);
            }
        }
        if (have_above && have_left)
            above[-1] = *px(p, y - 1, x - 1);
        else if (have_above)
            above[-1] = *px(p, y - 1, x);
        else if (have_left)
            above[-1] = *px(p, y, x - 1);
        else
            above[-1] = 128;
        left[-1] = above[-1];
        int pred[4][4];
        if (p == 0 && use_filter_intra) {
            filter_intra(above, left, pred);
        } else if (mode >= V_PRED && mode <= D67_PRED) {
            directional(p, x, y, have_left, have_above, mode, above, left, pred, max_x, max_y);
        } else if (mode == SMOOTH_PRED) {
            const uint8_t* wts = av1tab::smooth_weights;  // the 4-sample weights come first
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int v = wts[i] * above[j] + (256 - wts[i]) * left[h - 1] + wts[j] * left[i] + (256 - wts[j]) * above[w - 1];
                    pred[i][j] = round2(v, 9);
                }
        } else if (mode == SMOOTH_V_PRED) {
            const uint8_t* wts = av1tab::smooth_weights;
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) pred[i][j] = round2(wts[i] * above[j] + (256 - wts[i]) * left[h - 1], 8);
        } else if (mode == SMOOTH_H_PRED) {
            const uint8_t* wts = av1tab::smooth_weights;
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) pred[i][j] = round2(wts[j] * left[i] + (256 - wts[j]) * above[w - 1], 8);
        } else if (mode == DC_PRED) {
            int avg;
            if (have_left && have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                for (int k = 0; k < h; k++) sum += left[k];
                avg = (sum + ((w + h) >> 1)) / (w + h);
            } else if (have_left) {
                int sum = 0;
                for (int k = 0; k < h; k++) sum += left[k];
                avg = clip3(0, 255, (sum + (h >> 1)) >> 2);
            } else if (have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                avg = clip3(0, 255, (sum + (w >> 1)) >> 2);
            } else {
                avg = 128;
            }
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) pred[i][j] = avg;
        } else {  // PAETH_PRED
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int base = above[j] + left[i] - above[-1];
                    int p_left = std::abs(base - left[i]), p_top = std::abs(base - above[j]),
                        p_top_left = std::abs(base - above[-1]);
                    if (p_left <= p_top && p_left <= p_top_left)
                        pred[i][j] = left[i];
                    else if (p_top <= p_top_left)
                        pred[i][j] = above[j];
                    else
                        pred[i][j] = above[-1];
                }
        }
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) *px(p, y + i, x + j) = (uint8_t)pred[i][j];
    }

    void filter_intra(const int* above, const int* left, int pred[4][4]) {
        // the recursive filter on 4x2 cells (w4 = 1, h2 = 2)
        for (int i2 = 0; i2 < 2; i2++) {
            int pv[7];
            for (int i = 0; i < 7; i++) {
                if (i < 5) {
                    if (i2 == 0)
                        pv[i] = above[i - 1];
                    else if (i == 0)
                        pv[i] = left[(i2 << 1) - 1];
                    else
                        pv[i] = pred[(i2 << 1) - 1][i - 1];
                } else {
                    pv[i] = left[(i2 << 1) + i - 5];
                }
            }
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 4; j++) {
                    int pr = 0;
                    for (int k = 0; k < 7; k++) pr += av1tab::filter_intra_taps[filter_mode][(i << 2) + j][k] * pv[k];
                    pred[(i2 << 1) + i][j] = clip3(0, 255, round2signed(pr, 4));
                }
        }
    }

    int filter_type(int p) const {
        bool above_smooth = false, left_smooth = false;
        if (avail_u) above_smooth = is_smooth(mi_row - 1, mi_col, p);
        if (avail_l) left_smooth = is_smooth(mi_row, mi_col - 1, p);
        return above_smooth || left_smooth;
    }

    static int edge_strength(int w, int h, int type, int delta) {
        int d = std::abs(delta), blk_wh = w + h, strength = 0;
        if (type == 0) {
            if (blk_wh <= 8) {
                if (d >= 56) strength = 1;
            } else if (blk_wh <= 12) {
                if (d >= 40) strength = 1;
            } else if (blk_wh <= 16) {
                if (d >= 40) strength = 1;
            } else if (blk_wh <= 24) {
                if (d >= 8) strength = 1;
                if (d >= 16) strength = 2;
                if (d >= 32) strength = 3;
            } else if (blk_wh <= 32) {
                if (d >= 1) strength = 1;
                if (d >= 4) strength = 2;
                if (d >= 32) strength = 3;
            } else {
                if (d >= 1) strength = 3;
            }
        } else {
            if (blk_wh <= 8) {
                if (d >= 40) strength = 1;
                if (d >= 64) strength = 2;
            } else if (blk_wh <= 16) {
                if (d >= 20) strength = 1;
                if (d >= 48) strength = 2;
            } else if (blk_wh <= 24) {
                if (d >= 4) strength = 3;
            } else {
                if (d >= 1) strength = 3;
            }
        }
        return strength;
    }

    static void edge_filter(int* buf, int sz, int strength) {  // buf[-1 .. sz - 2]
        if (!strength) return;
        int edge[80];
        for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
        for (int i = 1; i < sz; i++) {
            int sum = 0;
            for (int j = 0; j < 5; j++) {
                int k = clip3(0, sz - 1, i - 2 + j);
                sum += av1tab::intra_edge_kernel[strength - 1][j] * edge[k];
            }
            buf[i - 1] = (sum + 8) >> 4;
        }
    }

    static bool use_upsample(int w, int h, int type, int delta) {
        int d = std::abs(delta), blk_wh = w + h;
        if (d <= 0 || d >= 40) return false;
        return type ? blk_wh <= 8 : blk_wh <= 16;
    }

    static void upsample(int* buf, int num_px) {  // buf[-1 .. num_px - 1] → buf[-2 .. 2 num_px - 2]
        int dup[80];
        dup[0] = buf[-1];
        for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
        dup[num_px + 2] = buf[num_px - 1];
        buf[-2] = dup[0];
        const int8_t* k = av1tab::intra_edge_upsample_kernel;
        for (int i = 0; i < num_px; i++) {
            int sum = k[0] * dup[i] + k[1] * dup[i + 1] + k[2] * dup[i + 2] + k[3] * dup[i + 3];
            buf[2 * i - 1] = clip3(0, 255, round2(sum, 4));
            buf[2 * i] = dup[i + 2];
        }
    }

    void directional(int p, int x, int y, bool have_left, bool have_above, int mode, int* above, int* left,
                     int pred[4][4], int max_x, int max_y) {
        const int w = 4, h = 4;
        int angle = kModeToAngle[mode] + (p == 0 ? angle_y : angle_uv) * 3;
        int up_above = 0, up_left = 0;
        if (s.enable_intra_edge_filter) {
            if (angle != 90 && angle != 180) {
                if (angle > 90 && angle < 180 && (w + h) >= 24) {
                    int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                    above[-1] = left[-1] = v;
                }
                int type = filter_type(p);
                if (have_above) {
                    int strength = edge_strength(w, h, type, angle - 90);
                    int num_px = std::min(w, max_x - x + 1) + (angle < 90 ? h : 0) + 1;
                    if (strength) stats[ST_EDGE_FILTER]++;
                    edge_filter(above, num_px, strength);
                }
                if (have_left) {
                    int strength = edge_strength(w, h, type, angle - 180);
                    int num_px = std::min(h, max_y - y + 1) + (angle > 180 ? w : 0) + 1;
                    if (strength) stats[ST_EDGE_FILTER]++;
                    edge_filter(left, num_px, strength);
                }
            }
            int type = filter_type(p);
            up_above = use_upsample(w, h, type, angle - 90);
            if (up_above) upsample(above, w + (angle < 90 ? h : 0));
            up_left = use_upsample(w, h, type, angle - 180);
            if (up_left) upsample(left, h + (angle > 180 ? w : 0));
            if (up_above || up_left) stats[ST_EDGE_UPSAMPLE]++;
        }
        int dx = 0, dy = 0;
        if (angle < 90)
            dx = av1tab::dr_intra_derivative[angle];
        else if (angle > 90 && angle < 180)
            dx = av1tab::dr_intra_derivative[180 - angle];
        if (angle > 90 && angle < 180)
            dy = av1tab::dr_intra_derivative[angle - 90];
        else if (angle > 180)
            dy = av1tab::dr_intra_derivative[270 - angle];
        if (angle < 90) {  // av1_dr_prediction_z1_c
            const int max_base_x = (w + h - 1) << up_above;
            const int frac_bits = 6 - up_above, base_inc = 1 << up_above;
            int xx = dx;
            for (int r = 0; r < h; ++r, xx += dx) {
                int base = xx >> frac_bits, shift = ((xx << up_above) & 0x3F) >> 1;
                if (base >= max_base_x) {
                    for (int i = r; i < h; ++i)
                        for (int c = 0; c < w; c++) pred[i][c] = above[max_base_x];
                    break;
                }
                for (int c = 0; c < w; ++c, base += base_inc)
                    pred[r][c] = base < max_base_x ? round2(above[base] * (32 - shift) + above[base + 1] * shift, 5)
                                                   : above[max_base_x];
            }
        } else if (angle > 90 && angle < 180) {  // av1_dr_prediction_z2_c
            const int min_base_x = -(1 << up_above);
            const int frac_bits_x = 6 - up_above, frac_bits_y = 6 - up_left;
            for (int r = 0; r < h; ++r)
                for (int c = 0; c < w; ++c) {
                    int yy = r + 1, xx = (c << 6) - yy * dx;
                    int base_x = xx >> frac_bits_x;
                    if (base_x >= min_base_x) {
                        int shift = ((xx * (1 << up_above)) & 0x3F) >> 1;
                        pred[r][c] = round2(above[base_x] * (32 - shift) + above[base_x + 1] * shift, 5);
                    } else {
                        xx = c + 1;
                        yy = (r << 6) - xx * dy;
                        int base_y = yy >> frac_bits_y;
                        int shift = ((yy * (1 << up_left)) & 0x3F) >> 1;
                        pred[r][c] = round2(left[base_y] * (32 - shift) + left[base_y + 1] * shift, 5);
                    }
                }
        } else if (angle > 180) {  // av1_dr_prediction_z3_c
            const int max_base_y = (w + h - 1) << up_left;
            const int frac_bits = 6 - up_left, base_inc = 1 << up_left;
            int yy = dy;
            for (int c = 0; c < w; ++c, yy += dy) {
                int base = yy >> frac_bits, shift = ((yy << up_left) & 0x3F) >> 1;
                for (int r = 0; r < h; ++r, base += base_inc) {
                    if (base < max_base_y) {
                        pred[r][c] = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                    } else {
                        for (; r < h; ++r) pred[r][c] = left[max_base_y];
                        break;
                    }
                }
            }
        } else if (angle == 90) {
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) pred[r][c] = above[c];
        } else {
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) pred[r][c] = left[r];
        }
    }

    void predict_cfl(int p, int x, int y) {  // 4:4:4, a 4x4 block: its own luma
        int alpha = p == 1 ? cfl_u : cfl_v;
        int lq3[4][4], sum = 0;
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) {
                lq3[i][j] = *px(0, y + i, x + j) << 3;
                sum += lq3[i][j];
            }
        int avg = (sum + 8) >> 4;
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) {
                uint8_t* d = px(p, y + i, x + j);
                *d = clip_pixel(*d + round2signed(alpha * (lq3[i][j] - avg), 6));
            }
    }

    // -- coefficients (decodetxb.c) for TX_4X4, class 2-D -----------------------------------
    int coeffs(int p, int start_x, int start_y, int32_t* coef) {
        int x4 = start_x >> 2, y4 = start_y >> 2;
        int ptype = p > 0;
        uint8_t a = above_ctx[p][x4], l = left_ctx[p][y4];
        int skip_ctx;
        if (p == 0) {
            if (bsize == BLOCK_4X4) {
                skip_ctx = 0;
            } else {
                static const uint8_t skip_contexts[5][5] = {
                    {1, 2, 2, 2, 3}, {2, 4, 4, 4, 5}, {2, 4, 4, 4, 5}, {2, 4, 4, 4, 5}, {3, 5, 5, 5, 6}};
                int top = std::min(a & 7, 4), left = std::min(l & 7, 4);
                skip_ctx = skip_contexts[top][left];
            }
        } else {
            skip_ctx = (a != 0) + (l != 0) + (bsize != BLOCK_4X4 ? 10 : 7);
        }
        for (int i = 0; i < 16; i++) coef[i] = 0;
        int all_zero = sym(cdf.txb_skip[0][skip_ctx], 2);
        if (all_zero) {
            above_ctx[p][x4] = 0;
            left_ctx[p][y4] = 0;
            return 0;
        }
        const int16_t* scan = av1tab::default_scan_4x4;
        int eob_pt = sym(cdf.eob16[ptype][0], 5) + 1;
        int eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
        int eob_shift = eob_pt - 3;
        if (eob_shift >= 0) {
            if (sym(cdf.eob_extra[0][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
            for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
                eob_shift = std::max(0, eob_pt - 2) - 1 - i;
                if (lit(1)) eob += 1 << eob_shift;
            }
        }
        int level[6][6] = {{0}};  // [row][col] with two rows / columns of padding
        for (int c = eob - 1; c >= 0; c--) {
            int pos = scan[c], rr = pos >> 2, cc = pos & 3;
            int lv;
            if (c == eob - 1) {
                int ctx = c == 0 ? 0 : c <= 2 ? 1 : c <= 4 ? 2 : 3;
                lv = sym(cdf.base_eob[0][ptype][ctx], 3) + 1;
            } else {
                int mag = std::min(level[rr][cc + 1], 3) + std::min(level[rr + 1][cc], 3) +
                          std::min(level[rr + 1][cc + 1], 3) + std::min(level[rr][cc + 2], 3) + std::min(level[rr + 2][cc], 3);
                int ctx = std::min((mag + 1) >> 1, 4);
                static const int8_t offset[16] = {0, 1, 6, 6, 1, 6, 6, 21, 6, 6, 21, 21, 6, 21, 21, 21};
                ctx = pos == 0 ? 0 : ctx + offset[pos];
                lv = sym(cdf.base[0][ptype][ctx], 4);
            }
            if (lv > 2) {
                int mag = level[rr][cc + 1] + level[rr + 1][cc] + level[rr + 1][cc + 1];
                mag = std::min((mag + 1) >> 1, 6);
                int ctx = pos == 0 ? mag : (rr < 2 && cc < 2) ? mag + 7 : mag + 14;
                for (int idx = 0; idx < 4; idx++) {
                    int k = sym(cdf.br[0][ptype][ctx], 4);
                    lv += k;
                    if (k < 3) break;
                }
            }
            level[rr][cc] = lv;
        }
        int dc_ctx;
        {
            int sign_a = a >> 3, sign_l = l >> 3;
            int dc_sign = (sign_a == 1 ? -1 : sign_a == 2 ? 1 : 0) + (sign_l == 1 ? -1 : sign_l == 2 ? 1 : 0);
            dc_ctx = dc_sign < 0 ? 1 : dc_sign > 0 ? 2 : 0;
        }
        int cul = 0, dc_val = 0;
        for (int c = 0; c < eob; c++) {
            int pos = scan[c];
            int lv = level[pos >> 2][pos & 3];
            if (!lv) continue;
            int sign = c == 0 ? sym(cdf.dc_sign[ptype][dc_ctx], 2) : lit(1);
            if (lv >= 15) {  // read_golomb
                stats[ST_GOLOMB]++;
                int length = 0, i = 0;
                while (!i) {
                    i = lit(1);
                    if (++length > 20) fail(DECODE_ERROR, "Invalid length in read_golomb");
                }
                int xg = 1;
                for (int k = 0; k < length - 1; k++) xg = (xg << 1) + lit(1);
                lv += xg - 1;
            }
            if (c == 0) dc_val = sign ? -lv : lv;
            lv &= 0xFFFFF;
            cul += lv;
            // dequantised by 4 (qindex 0), masked to 24 bits, clamped to 8 + 7 bits
            int dq = (int)(((int64_t)lv * 4) & 0xFFFFFF);
            if (sign) dq = -dq;
            coef[pos] = clip3(-(1 << 15), (1 << 15) - 1, dq);
        }
        int ctx_byte = std::min(cul, 7);
        if (dc_val < 0)
            ctx_byte |= 1 << 3;
        else if (dc_val > 0)
            ctx_byte += 2 << 3;
        above_ctx[p][x4] = (uint8_t)ctx_byte;
        left_ctx[p][y4] = (uint8_t)ctx_byte;
        return eob;
    }

    // -- the inverse Walsh-Hadamard transform (aom_iwht4x4_16_add / _1_add) -------------------
    void reconstruct(int p, int x, int y, const int32_t* coef, int eob) {
        int32_t in[16];
        for (int i = 0; i < 16; i++) in[i] = coef[(i & 3) * 4 + (i >> 2)];
        int64_t out[16];
        if (eob > 1) {
            for (int i = 0; i < 4; i++) {
                const int32_t* ip = in + 4 * i;
                int64_t a1 = ip[0] >> 2, c1 = ip[1] >> 2, d1 = ip[2] >> 2, b1 = ip[3] >> 2;
                a1 += c1;
                d1 -= b1;
                int64_t e1 = (a1 - d1) >> 1;
                b1 = e1 - b1;
                c1 = e1 - c1;
                a1 -= b1;
                d1 += c1;
                out[4 * i + 0] = (int32_t)a1;
                out[4 * i + 1] = (int32_t)b1;
                out[4 * i + 2] = (int32_t)c1;
                out[4 * i + 3] = (int32_t)d1;
            }
            for (int i = 0; i < 4; i++) {
                int64_t a1 = out[i], c1 = out[4 + i], d1 = out[8 + i], b1 = out[12 + i];
                a1 += c1;
                d1 -= b1;
                int64_t e1 = (a1 - d1) >> 1;
                b1 = e1 - b1;
                c1 = e1 - c1;
                a1 -= b1;
                d1 += c1;
                uint8_t* d0 = px(p, y + 0, x + i);
                *d0 = clip_pixel(*d0 + (int)a1);
                uint8_t* dd1 = px(p, y + 1, x + i);
                *dd1 = clip_pixel(*dd1 + (int)b1);
                uint8_t* dd2 = px(p, y + 2, x + i);
                *dd2 = clip_pixel(*dd2 + (int)c1);
                uint8_t* dd3 = px(p, y + 3, x + i);
                *dd3 = clip_pixel(*dd3 + (int)d1);
            }
        } else {
            int64_t a1 = in[0] >> 2;
            int64_t e1 = a1 >> 1;
            a1 -= e1;
            int64_t tmp[4] = {(int32_t)a1, (int32_t)e1, (int32_t)e1, (int32_t)e1};
            for (int i = 0; i < 4; i++) {
                int64_t e = tmp[i] >> 1, a = tmp[i] - e;
                uint8_t* d0 = px(p, y + 0, x + i);
                *d0 = clip_pixel(*d0 + (int)a);
                for (int k = 1; k < 4; k++) {
                    uint8_t* d = px(p, y + k, x + i);
                    *d = clip_pixel(*d + (int)e);
                }
            }
        }
    }
};

}  // namespace

namespace {

// -- OBUs (obu.c, obu_util.c) and the stream (av1_dx_iface.c) -------------------------------

struct ObuHeader {
    int type = 0, has_ext = 0, temporal_id = 0, spatial_id = 0, size = 1;
};

// aom_read_obu_header_and_size: false on an error
bool read_obu_header_and_size(const uint8_t* d, size_t avail, ObuHeader& h, size_t& payload, size_t& bytes_read,
                              std::string& why) {
    if (avail < 1) return why = "an OBU header past the end", false;
    h = ObuHeader();
    if (d[0] & 0x80) return why = "the forbidden bit of an OBU header", false;
    h.type = (d[0] >> 3) & 15;
    h.has_ext = (d[0] >> 2) & 1;
    int has_size = (d[0] >> 1) & 1;
    if (!has_size) return why = "an OBU without a size field", false;
    if (h.has_ext) {
        if (avail == 1) return why = "an OBU extension past the end", false;
        h.size = 2;
        h.temporal_id = d[1] >> 5;
        h.spatial_id = (d[1] >> 3) & 3;
    }
    // aom_uleb_decode: at most 8 bytes, a value below 2^32
    uint64_t v = 0;
    size_t i = 0, left = avail - h.size;
    const uint8_t* p = d + h.size;
    for (; i < 8 && i < left; i++) {
        v |= (uint64_t)(p[i] & 0x7F) << (i * 7);
        if (!(p[i] >> 7)) break;
    }
    if (i == 8 || i == left) return why = "an OBU size past the end", false;
    if (v > UINT32_MAX) return why = "an OBU size of 2^32 or more", false;
    payload = (size_t)v;
    bytes_read = h.size + i + 1;
    return true;
}

int last_nonzero_byte(const uint8_t* d, size_t n) {
    while (n > 0) {
        if (d[n - 1]) return d[n - 1];
        n--;
    }
    return 0;
}

struct Decoder {
    int32_t* stats;
    bool decode_tiles;  // false: stop after the first frame header (av1_info)
    bool seq_ready = false, seq_changed = false;
    SeqHeader seq;
    int current_op = 0;
    FrameHeader fh;
    bool have_frame = false;
    Frame* frame = nullptr;
    int frames_done = 0, next_start_tile = 0;

    // decoder_peek_si_internal: a key frame after a sequence header, or the
    // stream is refused before it is decoded
    void peek(const uint8_t* data, size_t n) {
        ObuHeader h;
        size_t payload = 0, bytes_read = 0;
        std::string why;
        bool got_seq = false, found_key = false, intra_only = false;
        int reduced = 0;
        if (!read_obu_header_and_size(data, n, h, payload, bytes_read, why)) fail(HEADER_ERROR, why);
        if (h.type == OBU_TEMPORAL_DELIMITER) {
            if (n - bytes_read < payload) fail(HEADER_ERROR, "a temporal delimiter past the end");
            data += bytes_read + payload;
            n -= bytes_read + payload;
            if (!read_obu_header_and_size(data, n, h, payload, bytes_read, why)) fail(HEADER_ERROR, why);
        }
        while (true) {
            data += bytes_read;
            n -= bytes_read;
            if (n < payload) fail(HEADER_ERROR, "an OBU past the end");
            if (h.type == OBU_SEQUENCE_HEADER) {
                if (n < 2) fail(HEADER_ERROR, "a sequence header of less than 2 bytes");
                BitReader rb{data, n};
                rb.strict = false;
                rb.f(3);
                int still = rb.bit1();
                reduced = rb.bit1();
                if (!still && reduced) fail(HEADER_ERROR, "a reduced still picture header on video");
                if (reduced) {
                    rb.f(5);
                } else {
                    int timing = rb.bit1(), model = 0, delay_len = 0;
                    if (timing) {
                        rb.f(32);
                        rb.f(32);
                        if (rb.bit1() && rb.uvlc() == UINT32_MAX) fail(HEADER_ERROR, "num_ticks_per_picture_minus_1 of 2^32 - 1");
                        model = rb.bit1();
                        if (model) {
                            delay_len = rb.f(5) + 1;
                            rb.f(32);
                            rb.f(10);
                        }
                    }
                    int display = rb.bit1();
                    int count = rb.f(5) + 1;
                    for (int i = 0; i < count; i++) {
                        rb.f(12);
                        if (rb.f(5) > 7) rb.bit1();
                        if (model && rb.bit1()) {
                            rb.f(delay_len);
                            rb.f(delay_len);
                            rb.bit1();
                        }
                        if (display && rb.bit1()) rb.f(4);
                    }
                }
                got_seq = true;
            } else if (h.type == OBU_FRAME_HEADER || h.type == OBU_FRAME) {
                if (got_seq && reduced) {
                    found_key = true;
                    break;
                }
                if (n < 1) fail(HEADER_ERROR, "a frame header past the end");
                if (!(data[0] >> 7)) {
                    int type = (data[0] >> 5) & 3;
                    if (type == KEY_FRAME) {
                        found_key = true;
                        break;
                    }
                    if (type == INTRA_ONLY_FRAME) intra_only = true;
                }
            }
            data += payload;
            n -= payload;
            if (n == 0) break;
            if (!read_obu_header_and_size(data, n, h, payload, bytes_read, why)) fail(HEADER_ERROR, why);
        }
        if (!(got_seq && found_key) && !intra_only) fail(HEADER_ERROR, "no key frame after a sequence header");
    }

    bool in_operating_point(const ObuHeader& h) const {
        if (!current_op || !h.has_ext) return true;
        return ((current_op >> h.temporal_id) & 1) && ((current_op >> (h.spatial_id + 8)) & 1);
    }

    void check_frame_supported() {
        if (seq.bit_depth != 8) fail(UNPORTED, "10/12-bit samples");
        if (!seq.mono && (seq.ss_x || seq.ss_y)) fail(UNPORTED, "4:2:0 and 4:2:2 chroma");
        if (fh.width != fh.upscaled_width || fh.apply_grain) fail(UNPORTED, "superres and film grain");
        if (!fh.coded_lossless) fail(UNPORTED, "lossy frames (qindex > 0)");
    }

    size_t read_metadata(const uint8_t* d, size_t sz) {
        uint64_t type = 0;
        size_t len = 0;
        {
            size_t i = 0;
            for (; i < 8 && i < sz; i++) {
                type |= (uint64_t)(d[i] & 0x7F) << (i * 7);
                if (!(d[i] >> 7)) break;
            }
            if (i == 8 || i == sz || type > UINT32_MAX) fail(HEADER_ERROR, "a metadata type past the end");
            len = i + 1;
        }
        if (type == 0 || type >= 6) {
            if (last_nonzero_byte(d + len, sz - len) == 0) fail(HEADER_ERROR, "metadata without trailing bits");
            return sz;
        }
        if (type == 4) {  // ITU-T T.35
            const uint8_t* p = d + len;
            size_t n = sz - len;
            if (n == 0) fail(HEADER_ERROR, "itu_t_t35_country_code is missing");
            size_t cc = 1;
            if (p[0] == 0xFF) {
                if (n == 1) fail(HEADER_ERROR, "itu_t_t35_country_code_extension_byte is missing");
                cc++;
            }
            long end = (long)n - 1;
            while (end >= 0 && !p[end]) end--;
            if (end < (long)cc) fail(HEADER_ERROR, "No trailing bits found in ITU-T T.35 metadata OBU");
            if (p[end] != 0x80) fail(HEADER_ERROR, "the last nonzero byte of the ITU-T T.35 metadata is not 0x80");
            return sz;
        }
        if (type == 1 || type == 2) {  // HDR CLL (4 bytes), HDR MDCV (24 bytes)
            size_t need = type == 1 ? 4 : 24;
            if (sz - len < need) fail(HEADER_ERROR, "Incorrect HDR metadata payload size");
            size_t read = len + need;
            if (last_nonzero_byte(d + read, sz - read) != 0x80) fail(HEADER_ERROR, "HDR metadata without trailing bits");
            return sz;
        }
        BitReader rb{d + len, sz - len};
        if (type == 3) {  // scalability
            int mode = rb.f(8);
            if (mode == 14) {  // SCALABILITY_SS
                int layers = rb.f(2), dims = rb.bit1(), desc = rb.bit1(), group = rb.bit1();
                rb.f(3);
                if (dims)
                    for (int i = 0; i <= layers; i++) rb.f(32);
                if (desc)
                    for (int i = 0; i <= layers; i++) rb.f(8);
                if (group) {
                    int size = rb.f(8);
                    for (int i = 0; i < size; i++) {
                        rb.f(5);
                        int refs = rb.f(3);
                        for (int j = 0; j < refs; j++) rb.f(8);
                    }
                }
            }
        } else {  // timecode
            rb.f(5);
            int full = rb.bit1();
            rb.bit1();
            rb.bit1();
            rb.f(9);
            if (full) {
                rb.f(17);
            } else if (rb.bit1()) {
                rb.f(6);
                if (rb.bit1()) {
                    rb.f(6);
                    if (rb.bit1()) rb.f(5);
                }
            }
            int off = rb.f(5);
            if (off) rb.f(off);
        }
        check_trailing_bits(rb);
        return len + (rb.bit >> 3);
    }

    // decode_tiles for one tile group; the data runs to the end of the OBU
    void read_tile_group(BitReader& rb, const uint8_t* data, const uint8_t* end, bool obu_frame, bool& finished) {
        int num_tiles = fh.tile_cols * fh.tile_rows;
        size_t start_bit = rb.bit;
        int flag = num_tiles > 1 ? rb.bit1() : 0;
        int tg_start = 0, tg_end = num_tiles - 1;
        if (flag) {
            if (obu_frame) fail(HEADER_ERROR, "For OBU_FRAME type obu tile_start_and_end_present_flag must be 0");
            int bits = fh.tile_cols_log2 + fh.tile_rows_log2;
            tg_start = rb.f(bits);
            tg_end = rb.f(bits);
            if (tg_start != next_start_tile) fail(HEADER_ERROR, "tg_start must be equal to the next tile");
            if (tg_start > tg_end) fail(HEADER_ERROR, "tg_end must be greater than or equal to tg_start");
            if (tg_end >= num_tiles) fail(HEADER_ERROR, "tg_end must be less than NumTiles");
        }
        next_start_tile = tg_end == num_tiles - 1 ? 0 : tg_end + 1;
        size_t header_bytes = (rb.bit - start_bit + 7) >> 3;
        while (rb.bit & 7)
            if (rb.bit1()) fail(HEADER_ERROR, "non-zero alignment bits");
        const uint8_t* p = data + header_bytes;
        for (int t = tg_start; t <= tg_end; t++) {
            if (p >= end) fail(DECODE_ERROR, "Data ended before all tiles were read.");
            size_t size;
            if (t != tg_end) {
                if ((size_t)(end - p) < (size_t)fh.tile_size_bytes) fail(DECODE_ERROR, "Not enough data to read tile size");
                size = 0;
                for (int k = 0; k < fh.tile_size_bytes; k++) size |= (size_t)p[k] << (8 * k);
                size += 1;
                p += fh.tile_size_bytes;
                if (size > (size_t)(end - p)) fail(DECODE_ERROR, "Truncated packet or corrupt tile size");
            } else {
                size = end - p;
            }
            if (size == 0) fail(DECODE_ERROR, "Truncated packet or corrupt tile length");
            if (decode_tiles) frame->decode_tile(t / fh.tile_cols, t % fh.tile_cols, p, size);
            p += size;
        }
        finished = tg_end == num_tiles - 1;
    }

    // aom_decode_frame_from_obus: returns the bytes consumed; sets ``finished``
    size_t decode_frame_from_obus(const uint8_t* data, size_t n, bool& finished) {
        const uint8_t* start = data;
        const uint8_t* data_end = data + n;
        bool seen_frame_header = false;
        size_t frame_header_size = 0;
        const uint8_t* frame_header = nullptr;
        finished = false;
        next_start_tile = 0;
        while (!finished) {
            size_t avail = data_end - data;
            if (avail == 0 && !seen_frame_header) break;
            ObuHeader h;
            size_t payload = 0, bytes_read = 0;
            std::string why;
            if (!read_obu_header_and_size(data, avail, h, payload, bytes_read, why)) fail(HEADER_ERROR, why);
            data += bytes_read;
            if ((size_t)(data_end - data) < payload) fail(HEADER_ERROR, "an OBU past the end of the data");
            if (h.type != OBU_TEMPORAL_DELIMITER && h.type != OBU_SEQUENCE_HEADER && !in_operating_point(h)) {
                data += payload;
                continue;
            }
            BitReader rb{data, payload};
            size_t decoded = 0, payload_offset = 0;
            bool tile_group = false;
            switch (h.type) {
                case OBU_TEMPORAL_DELIMITER:
                    if (seen_frame_header) fail(HEADER_ERROR, "a temporal delimiter inside a frame");
                    break;
                case OBU_SEQUENCE_HEADER: {
                    SeqHeader s = read_sequence_header(rb);
                    if (seq_ready && !same_sequence(seq, s)) seq_changed = true;
                    if (seq_changed && seen_frame_header) fail(HEADER_ERROR, "a new sequence header inside a frame");
                    seq = s;
                    seq_ready = true;
                    current_op = seq.op_idc[0];
                    decoded = rb.bytes_read();
                    break;
                }
                case OBU_FRAME_HEADER:
                case OBU_REDUNDANT_FRAME_HEADER:
                case OBU_FRAME:
                    if (h.type == OBU_REDUNDANT_FRAME_HEADER) {
                        if (!seen_frame_header) {
                            data += payload;
                            continue;
                        }
                    } else if (seen_frame_header) {
                        fail(HEADER_ERROR, "a second frame header inside a frame");
                    }
                    if (!seen_frame_header) {
                        if (!seq_ready) fail(HEADER_ERROR, "No sequence header");
                        if (frames_done) fail(UNPORTED, "image sequences' first frame");  // a second frame
                        if (seq_changed) seq_changed = false;  // a key frame starts the new sequence
                        fh = read_frame_header(rb, seq, h.temporal_id, h.spatial_id);
                        if (h.type != OBU_FRAME) check_trailing_bits(rb);
                        frame_header_size = rb.bytes_read();
                        frame_header = data;
                        seen_frame_header = true;
                        check_frame_supported();
                        have_frame = true;
                        if (!decode_tiles) return data - start;
                        frame = new Frame(seq, fh, stats);
                    } else {
                        if (frame_header_size > payload || memcmp(data, frame_header, frame_header_size))
                            fail(HEADER_ERROR, "a redundant frame header that differs");
                        rb.bit = 8 * frame_header_size;
                    }
                    decoded = frame_header_size;
                    if (h.type != OBU_FRAME) break;
                    payload_offset = frame_header_size;
                    while (rb.bit & 7)
                        if (rb.bit1()) fail(HEADER_ERROR, "non-zero alignment bits");
                    tile_group = true;
                    break;
                case OBU_TILE_GROUP:
                    if (!seen_frame_header) fail(HEADER_ERROR, "a tile group before its frame header");
                    tile_group = true;
                    break;
                case OBU_METADATA:
                    decoded = read_metadata(data, payload);
                    break;
                case OBU_TILE_LIST:
                    fail(HEADER_ERROR, "a tile list OBU");
                case OBU_PADDING:
                    if (payload > 0 && last_nonzero_byte(data, payload) != 0x80) fail(HEADER_ERROR, "padding without trailing bits");
                    decoded = payload;
                    break;
                default:
                    if (payload > 0 && last_nonzero_byte(data, payload) == 0) fail(HEADER_ERROR, "a reserved OBU of zeros");
                    decoded = payload;
                    break;
            }
            if (tile_group) {
                if (payload_offset > payload) fail(HEADER_ERROR, "a tile group past the end of its OBU");
                BitReader trb{data + payload_offset, payload - payload_offset};
                read_tile_group(trb, data + payload_offset, data + payload, h.type == OBU_FRAME, finished);
                decoded = payload;
                if (finished) frames_done++;
            }
            if (decoded > payload) fail(HEADER_ERROR, "an OBU read past its size");
            for (size_t i = decoded; i < payload; i++)
                if (data[i]) fail(HEADER_ERROR, "non-zero padding after an OBU");
            data += payload;
        }
        return data - start;
    }

    // decoder_decode: frames one after another, zero bytes between them
    void run(const uint8_t* data, size_t n) {
        if (n == 0) fail(BAD_CALL, "no data");
        peek(data, n);
        size_t pos = 0;
        while (pos < n) {
            bool finished = false;
            pos += decode_frame_from_obus(data + pos, n - pos, finished);
            if (!decode_tiles && have_frame) return;
            while (pos < n && data[pos] == 0) pos++;
        }
        if (!frames_done) fail(DECODE_ERROR, "no frame decoded");
    }

    ~Decoder() { delete frame; }
};

void set_msg(char* msg, int len, const std::string& s) {
    if (msg && len > 0) {
        snprintf(msg, (size_t)len, "%s", s.c_str());
    }
}

}  // namespace

extern "C" {

// The stream's sequence and first frame headers: info = [width, height,
// bit_depth, mono, ss_x, ss_y, color_primaries, transfer, matrix,
// color_range, profile, still_picture, reduced header, base_q_idx, tiles,
// allow_intrabc, allow_screen_content_tools, use_128x128]. Returns a Status;
// UNPORTED names what is not decoded.
int av1_info(const uint8_t* data, int64_t n, int32_t* info, char* msg, int msg_len) {
    int32_t stats[ST_COUNT] = {0};
    Decoder d;
    d.stats = stats;
    d.decode_tiles = false;
    try {
        d.run(data, (size_t)n);
        if (!d.have_frame) fail(DECODE_ERROR, "no frame header");
    } catch (const Error& e) {
        set_msg(msg, msg_len, e.msg);
        return e.status;
    } catch (const std::bad_alloc&) {
        set_msg(msg, msg_len, "out of memory");
        return DECODE_ERROR;
    }
    const SeqHeader& s = d.seq;
    const FrameHeader& f = d.fh;
    int32_t v[18] = {f.upscaled_width, f.height, s.bit_depth, s.mono, s.ss_x, s.ss_y, s.cp, s.tc, s.mc,
                     s.color_range, s.profile, s.still_picture, s.reduced, f.base_q_idx, f.tile_cols * f.tile_rows,
                     f.allow_intrabc, f.allow_screen_content_tools, s.use_128};
    memcpy(info, v, sizeof v);
    return OK;
}

// Decode the stream into ``out``: the planes (1 or 3) of width x height 8-bit
// samples, Y then U then V. ``stats``: ST_COUNT tool counters. Returns a Status.
int av1_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, int32_t* stats, char* msg,
               int msg_len) {
    Decoder d;
    d.stats = stats;
    d.decode_tiles = true;
    try {
        d.run(data, (size_t)n);
        const Frame& fr = *d.frame;
        int w = d.fh.upscaled_width, h = d.fh.height;
        if ((int64_t)fr.num_planes * w * h != out_size) fail(BAD_CALL, "an output of another size");
        for (int p = 0; p < fr.num_planes; p++)
            for (int y = 0; y < h; y++) memcpy(out + ((size_t)p * h + y) * w, &fr.plane[p][(size_t)y * fr.stride], (size_t)w);
    } catch (const Error& e) {
        set_msg(msg, msg_len, e.msg);
        return e.status;
    } catch (const std::bad_alloc&) {
        set_msg(msg, msg_len, "out of memory");
        return DECODE_ERROR;
    }
    return OK;
}

}  // extern "C"
