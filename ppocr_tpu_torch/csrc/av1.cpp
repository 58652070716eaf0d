// AV1 still-picture decoder for 8-bit key frames (4:4:4, 4:2:2, 4:2:0 and
// monochrome), lossless or lossy, deblocked, CDEF-filtered and restored, as libaom
// 3.14.1 decodes them (the copy in OpenCV 5.0, driven by libavif 1.4.2).
//
// The layers follow libaom's files, and so do the names in the comments:
//   * obu.c / obu_util.c: OBU headers and sizes, the sequence header, the
//     frame header and tile group OBUs, their trailing bits and padding
//     (aom_decode_frame_from_obus), and av1_dx_iface.c's peek at the stream
//     and its loop over the frames of one buffer;
//   * decodeframe.c: the uncompressed header (tile info, quantisation with
//     its matrix levels, segmentation, delta q / lf, CodedLossless, the loop
//     filter, CDEF and restoration parameters, tx mode, film grain), the
//     tile buffers and the per-tile checks (overflow after each superblock,
//     the trailing bits after the symbol coder), the transform blocks of a
//     block by 64x64 chunk and plane, and an IntraBC block's var-tx tree
//     (decode_reconstruct_tx);
//   * entdec.c / daala reader: the symbol decoder, its tell() and overflow,
//     and the CDF adaptation (entropy.h update_cdf);
//   * decodemv.c / mvref_common.c: key-frame mode info (chroma only in a
//     block that carries it, is_chroma_reference: the last of a 2x2, 2x1 or
//     1x2 group of luma blocks under 8 samples in a subsampled plane, whose
//     chroma block covers the group), palette (with the
//     colour cache of the above and left blocks), filter intra, CFL alphas,
//     IntraBC with its reference-DV stack and its validity rules, the
//     transform size (read_selected_tx_size, read_tx_size_vartx) and type
//     (av1_read_tx_type);
//   * decodetxb.c: the coefficients of every transform size, their
//     contexts in the three classes, Golomb, and the dequantisation with
//     quantiser matrices;
//   * reconintra.c / cfl.c: DC, the directional modes with the edge filter
//     and upsampling, smooth, Paeth, CFL (the luma subsampled 4:2:0 or 4:2:2
//     as cfl_luma_subsampling_*_lbd, sub-8x8 luma stored for the group's
//     chroma block), palette and filter intra at the transform size, with the
//     neighbours' availability in the plane's own units;
//   * reconinter.c: IntraBC, whose integer luma displacement is a half-sample
//     one in a subsampled plane, predicted by the 2-tap bilinear filter
//     (av1_convolve_2d_sr_intrabc), the chroma block of a group from the
//     displacement of the block that carries it;
//   * av1_inv_txfm1d.c / av1_inv_txfm2d.c and the lowbd x86 transforms
//     libaom dispatches (av1_inv_txfm_avx2.c / _ssse3.c): every inverse
//     transform; idct (iwht4x4) for lossless blocks. The result is added
//     with a clamp to 8 bits;
//   * av1_loopfilter.c / aom_dsp/loopfilter.c: the deblocking filter once
//     the frame's tiles are decoded (av1_loop_filter_frame_init's levels
//     with delta lf, the segment's ALT_LF features and the intra reference
//     delta, update_sharpness's limits; set_lpf_parameters' edges and
//     lengths; the 4, 6, 8 and 14-tap filters), every vertical edge of a
//     plane before its horizontal ones;
//   * cdef.c / cdef_block.c: CDEF on the deblocked frame (read_cdef's index
//     per 64x64 unit, cdef_find_dir, adjust_strength, the primary and
//     secondary taps of cdef_filter_8_*, CDEF_VERY_LARGE past the 8-sample
//     grid of the frame);
//   * restoration.c / decodeframe.c: loop restoration (the unit coefficients
//     read at each superblock, loop_restoration_read_sb_coeffs; the stripe
//     boundaries saved before CDEF; av1_loop_restoration_filter_frame's
//     units and 64-row stripes; the Wiener filter of
//     av1_wiener_convolve_add_src and the self-guided filter of
//     av1_apply_selfguided_restoration);
//   * resize.c / superres_scale.c / restoration.c: superres
//     (av1_calculate_scaled_superres_size; av1_superres_upscale after CDEF,
//     av1_upscale_normative_rows by tile column with the 8-tap filter of
//     av1_convolve_horiz_rs; the stripe boundaries upscaled in
//     save_deblock_boundary_lines; the units of the upscaled frame and
//     av1_loop_restoration_corners_in_sb's scaled columns);
//   * grain_synthesis.c / av1_dx_iface.c: film grain on the frame as it is
//     output (av1_add_film_grain: the luma extended to even sizes;
//     add_film_grain_run's templates, AR filter, scaling functions, random
//     offsets per 32-row stripe and overlap).
//
// The default CDFs and constant tables come from av1_tables.h, written from
// libaom 3.14.1's library by scripts/make_av1_tables_torch.py.
//
// What this decoder does not decode (more than 8 bits, a frame other than one
// shown key frame) gives status UNPORTED before any pixel is decoded.

#include <algorithm>
#include <array>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

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

int log2i(int v) { return v > 0 ? 31 - __builtin_clz((unsigned)v) : 0; }

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

// film grain's parameters in the layout of libaom's aom_film_grain_t
// (grain_params.h), which av1_film_grain takes as it is
struct FilmGrain {
    int apply_grain = 0, update_parameters = 0;
    int scaling_points_y[14][2] = {{0}};
    int num_y_points = 0;
    int scaling_points_cb[10][2] = {{0}};
    int num_cb_points = 0;
    int scaling_points_cr[10][2] = {{0}};
    int num_cr_points = 0;
    int scaling_shift = 0, ar_coeff_lag = 0;
    int ar_coeffs_y[24] = {0}, ar_coeffs_cb[25] = {0}, ar_coeffs_cr[25] = {0};
    int ar_coeff_shift = 0;
    int cb_mult = 0, cb_luma_mult = 0, cb_offset = 0, cr_mult = 0, cr_luma_mult = 0, cr_offset = 0;
    int overlap_flag = 0, clip_to_restricted_range = 0;
    unsigned bit_depth = 0;
    int chroma_scaling_from_luma = 0, grain_scale_shift = 0;
    uint16_t random_seed = 0;
};
static_assert(sizeof(FilmGrain) == 648, "aom_film_grain_t's layout");

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
    int qm_level[3] = {15, 15, 15};  // qm_y, qm_u, qm_v (15: flat)
    int seg_enabled = 0, feature_enabled[8][8] = {{0}}, feature_data[8][8] = {{0}};
    int seg_id_pre_skip = 0, last_active_seg_id = 0;
    int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;
    int lossless[8] = {0};
    int coded_lossless = 0, all_lossless = 0;
    int reduced_tx_set = 0, tx_mode_select = 0;
    FilmGrain grain;
    int grain_bit = 0, header_bits = 0;  // where film_grain_params starts and the header ends, in bits
    // the in-loop filters: deblocking (levels y vertical, y horizontal, u,
    // v; the deltas of av1_set_default_ref_deltas unless updated), CDEF
    // (strengths as coded: primary * 4 + secondary) and restoration
    int loop_filter_level[4] = {0, 0, 0, 0};
    int lf_sharpness = 0, lf_delta_enabled = 0;
    int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
    int cdef_damping = 3, cdef_bits = 0, cdef_y_strengths[8] = {0}, cdef_uv_strengths[8] = {0};
    // loop restoration by plane: libaom's RestorationType (decode_restoration_mode
    // remaps lr_type as coded) and the unit's side in samples of the plane
    int lr_type[3] = {0, 0, 0};
    int lr_unit_size[3] = {256, 256, 256};
    int lr_unit_shift = 0, lr_uv_shift = 0;  // as coded
};

// libaom's RestorationType
enum { RESTORE_NONE = 0, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

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

// av1_read_film_grain_params: the parameters into libaom's aom_film_grain_t
// (a frame without them holds zeros)
void read_film_grain(BitReader& rb, const SeqHeader& s, FrameHeader& fh) {
    FilmGrain& g = fh.grain;
    if (!s.film_grain_present || (!fh.show_frame && !fh.showable)) return;
    g.apply_grain = rb.bit1();
    if (!g.apply_grain) return;
    g.random_seed = (uint16_t)rb.f(16);
    g.update_parameters = fh.frame_type == INTER_FRAME ? rb.bit1() : 1;
    g.bit_depth = (unsigned)s.bit_depth;
    if (!g.update_parameters) {
        rb.f(3);  // film_grain_params_ref_idx: a key frame has no reference
        fail(HEADER_ERROR, "film grain parameters from a reference frame");
    }
    auto points = [&](int (*pts)[2], int n) {
        for (int i = 0; i < n; i++) {
            pts[i][0] = rb.f(8);
            if (i && pts[i - 1][0] >= pts[i][0])
                fail(HEADER_ERROR, "First coordinate of the scaling function points shall be increasing.");
            pts[i][1] = rb.f(8);
        }
    };
    g.num_y_points = rb.f(4);
    if (g.num_y_points > 14) fail(HEADER_ERROR, "Number of points for film grain luma scaling function exceeds the maximum value.");
    points(g.scaling_points_y, g.num_y_points);
    g.chroma_scaling_from_luma = s.mono ? 0 : rb.bit1();
    if (!(s.mono || g.chroma_scaling_from_luma || (s.ss_x == 1 && s.ss_y == 1 && g.num_y_points == 0))) {
        g.num_cb_points = rb.f(4);
        if (g.num_cb_points > 10) fail(HEADER_ERROR, "Number of points for film grain cb scaling function exceeds the maximum value.");
        points(g.scaling_points_cb, g.num_cb_points);
        g.num_cr_points = rb.f(4);
        if (g.num_cr_points > 10) fail(HEADER_ERROR, "Number of points for film grain cr scaling function exceeds the maximum value.");
        points(g.scaling_points_cr, g.num_cr_points);
        if (s.ss_x == 1 && s.ss_y == 1 && ((g.num_cb_points == 0) != (g.num_cr_points == 0)))
            fail(HEADER_ERROR, "In YCbCr 4:2:0, film grain shall be applied to both chroma components or neither.");
    }
    g.scaling_shift = rb.f(2) + 8;
    g.ar_coeff_lag = rb.f(2);
    const int num_pos_luma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1);
    const int num_pos_chroma = num_pos_luma + (g.num_y_points > 0);
    if (g.num_y_points)
        for (int i = 0; i < num_pos_luma; i++) g.ar_coeffs_y[i] = (int)rb.f(8) - 128;
    if (g.num_cb_points || g.chroma_scaling_from_luma)
        for (int i = 0; i < num_pos_chroma; i++) g.ar_coeffs_cb[i] = (int)rb.f(8) - 128;
    if (g.num_cr_points || g.chroma_scaling_from_luma)
        for (int i = 0; i < num_pos_chroma; i++) g.ar_coeffs_cr[i] = (int)rb.f(8) - 128;
    g.ar_coeff_shift = rb.f(2) + 6;
    g.grain_scale_shift = rb.f(2);
    if (g.num_cb_points) {
        g.cb_mult = rb.f(8);
        g.cb_luma_mult = rb.f(8);
        g.cb_offset = rb.f(9);
    }
    if (g.num_cr_points) {
        g.cr_mult = rb.f(8);
        g.cr_luma_mult = rb.f(8);
        g.cr_offset = rb.f(9);
    }
    g.overlap_flag = rb.bit1();
    g.clip_to_restricted_range = rb.bit1();
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
    int min_inner_width = 0;  // av1_calculate_tile_cols: the narrowest tile column but the last, in 4x4 units
    if (rb.bit1()) {  // uniform_tile_spacing_flag
        fh.tile_cols_log2 = min_log2_tile_cols;
        while (fh.tile_cols_log2 < max_log2_tile_cols && rb.bit1()) fh.tile_cols_log2++;
        int w = (sb_cols + (1 << fh.tile_cols_log2) - 1) >> fh.tile_cols_log2;
        for (int start = 0; start < sb_cols; start += w) col_sb.push_back(start);
        col_sb.push_back(sb_cols);
        min_inner_width = std::min(w << sb_shift, fh.mi_cols);
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
        int narrowest = 65536;
        for (size_t i = 0; i + 2 < col_sb.size(); i++) narrowest = std::min(narrowest, col_sb[i + 1] - col_sb[i]);
        min_inner_width = narrowest << sb_shift;
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
    // av1_is_min_tile_width_satisfied: an inner tile column of 64 samples,
    // 128 before an upscale
    if (fh.tile_cols > 1 && min_inner_width * 4 < (64 << (fh.width != fh.upscaled_width)))
        fail(HEADER_ERROR, "Minimum tile width requirement not satisfied");
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
        fh.qm_level[0] = rb.f(4);
        fh.qm_level[1] = rb.f(4);
        fh.qm_level[2] = s.separate_uv_delta_q ? (int)rb.f(4) : fh.qm_level[1];
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
        fh.loop_filter_level[0] = l0;
        fh.loop_filter_level[1] = l1;
        if (num_planes > 1 && (l0 || l1)) {
            fh.loop_filter_level[2] = rb.f(6);
            fh.loop_filter_level[3] = rb.f(6);
        }
        fh.lf_sharpness = rb.f(3);
        fh.lf_delta_enabled = rb.bit1();
        if (fh.lf_delta_enabled && rb.bit1()) {  // loop_filter_delta_update
            for (int i = 0; i < 8; i++)
                if (rb.bit1()) fh.lf_ref_deltas[i] = rb.su(7);
            for (int i = 0; i < 2; i++)
                if (rb.bit1()) fh.lf_mode_deltas[i] = rb.su(7);
        }
    }
    // cdef_params()
    if (!fh.coded_lossless && !fh.allow_intrabc && s.enable_cdef) {
        fh.cdef_damping = rb.f(2) + 3;
        fh.cdef_bits = rb.f(2);
        for (int i = 0; i < (1 << fh.cdef_bits); i++) {
            fh.cdef_y_strengths[i] = rb.f(6);
            if (num_planes > 1) fh.cdef_uv_strengths[i] = rb.f(6);
        }
    }
    // lr_params()
    // lr_params() (decode_restoration_mode): lr_type 0-3 is NONE, SWITCHABLE,
    // WIENER, SGRPROJ; the luma unit is the superblock's side, doubled by
    // lr_unit_shift (a 64x64 superblock reads a second bit past a first 1);
    // the chroma unit is luma's >> lr_uv_shift, read in 4:2:0 only
    if (!fh.all_lossless && !fh.allow_intrabc && s.enable_restoration) {
        static const int kRemap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
        int uses_lr = 0, uses_chroma_lr = 0;
        for (int i = 0; i < num_planes; i++) {
            fh.lr_type[i] = kRemap[rb.f(2)];
            if (fh.lr_type[i]) {
                uses_lr = 1;
                if (i > 0) uses_chroma_lr = 1;
            }
        }
        if (uses_lr) {
            int size = s.use_128 ? 128 : 64;
            if (s.use_128) {
                fh.lr_unit_shift = rb.bit1();
                size <<= fh.lr_unit_shift;
            } else {
                fh.lr_unit_shift = rb.bit1();
                if (fh.lr_unit_shift) fh.lr_unit_shift += rb.bit1();
                size <<= fh.lr_unit_shift;
            }
            if (s.ss_x && s.ss_y && uses_chroma_lr) fh.lr_uv_shift = rb.bit1();
            fh.lr_unit_size[0] = size;
            fh.lr_unit_size[1] = fh.lr_unit_size[2] = size >> fh.lr_uv_shift;
        }
    }
    // read_tx_mode()
    if (!fh.coded_lossless) fh.tx_mode_select = rb.bit1();
    // frame_reference_mode(), skip_mode_params(), allow_warped_motion: none in an intra frame
    fh.reduced_tx_set = rb.bit1();
    fh.grain_bit = (int)rb.bit;
    read_film_grain(rb, s, fh);
    fh.header_bits = (int)rb.bit;
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
    uint16_t eob32[2][2][7], eob64[2][2][8], eob128[2][2][9], eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
    uint16_t tx_size[4][3][4], txfm_partition[21][3], intra_ext_tx[3][4][13][17], inter_ext_tx[4][4][17];
    uint16_t switchable_restore[4], wiener_restore[3], sgrproj_restore[3];

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
        memcpy(eob32, eob_multi32_cdfs[q_ctx], sizeof eob32);
        memcpy(eob64, eob_multi64_cdfs[q_ctx], sizeof eob64);
        memcpy(eob128, eob_multi128_cdfs[q_ctx], sizeof eob128);
        memcpy(eob256, eob_multi256_cdfs[q_ctx], sizeof eob256);
        memcpy(eob512, eob_multi512_cdfs[q_ctx], sizeof eob512);
        memcpy(eob1024, eob_multi1024_cdfs[q_ctx], sizeof eob1024);
        memcpy(tx_size, tx_size_cdf, sizeof tx_size);
        memcpy(txfm_partition, txfm_partition_cdf, sizeof txfm_partition);
        memcpy(intra_ext_tx, intra_ext_tx_cdf, sizeof intra_ext_tx);
        memcpy(inter_ext_tx, inter_ext_tx_cdf, sizeof inter_ext_tx);
        memcpy(switchable_restore, switchable_restore_cdf, sizeof switchable_restore);
        memcpy(wiener_restore, wiener_restore_cdf, sizeof wiener_restore);
        memcpy(sgrproj_restore, sgrproj_restore_cdf, sizeof sgrproj_restore);
    }
};

// -- the inverse transforms (av1_inv_txfm1d.c, av1_inv_txfm2d.c) ----------------------------

enum { TX_4X4 = 0, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16,
       TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16, TX_SIZES_ALL };
enum { DCT_DCT = 0, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST,
       FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, TX_TYPES };
enum { TX1D_DCT = 0, TX1D_ADST, TX1D_FLIPADST, TX1D_IDTX };  // vtx_tab / htx_tab
enum { TX_CLASS_2D = 0, TX_CLASS_HORIZ, TX_CLASS_VERT };
const int kTxW[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const int kTxH[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const int kInvCosBit = 12, kNewSqrt2 = 5793, kNewInvSqrt2 = 2896;

int tx_class(int type) {
    if (type == V_DCT || type == V_ADST || type == V_FLIPADST) return TX_CLASS_VERT;
    if (type == H_DCT || type == H_ADST || type == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
}

// av1_get_adjusted_tx_size: a side of 64 codes and dequantises as 32
int adjusted_tx_size(int t) {
    switch (t) {
        case TX_64X64: case TX_32X64: case TX_64X32: return TX_32X32;
        case TX_16X64: return TX_16X32;
        case TX_64X16: return TX_32X16;
        default: return t;
    }
}

int32_t clamp_bits(int64_t v, int bits) {  // clamp_value
    const int64_t hi = (1LL << (bits - 1)) - 1, lo = -(1LL << (bits - 1));
    return (int32_t)(v < lo ? lo : (v > hi ? hi : v));
}
int32_t round_shift(int64_t v, int bits) { return bits ? (int32_t)((v + (1LL << (bits - 1))) >> bits) : (int32_t)v; }
// the x86 path libaom dispatches computes in 16-bit lanes that saturate
// every rotation, negation and identity output
int32_t half_btf(int w0, int32_t in0, int w1, int32_t in1) {
    return clamp_bits(round_shift((int64_t)w0 * in0 + (int64_t)w1 * in1, kInvCosBit), 16);
}

// The 1-D inverse DCT of n = 2^k points in libaom's butterfly order, written
// by recursion: the even half is the DCT of n/2 points, the odd half a chain
// of rotations and add/sub stages; every add/sub is clamped to ``r`` bits.
// ``t`` holds the bit-reversed input.
void idct_rotate_first(int32_t* o, int m, int n) {  // the odd half's first rotations
    const int16_t* c = av1tab::cospi;
    const int s = 64 / n;
    for (int k = 0; k < m / 2; k++) {
        int coef = 0;  // the coefficient index at odd position k: brev over log2(n) bits of m + k
        for (int v = m + k, bits = n; bits > 1; bits >>= 1, v >>= 1) coef = (coef << 1) | (v & 1);
        int32_t a = o[k], b = o[m - 1 - k];
        o[k] = half_btf(c[64 - s * coef], a, -c[s * coef], b);
        o[m - 1 - k] = half_btf(c[s * coef], a, c[64 - s * coef], b);
    }
}

void idct_addsub(int32_t* o, int m, int block, int r) {
    for (int q = 0; q * block < m; q++)
        for (int i = 0; i < block / 2; i++) {
            int lo = q * block + i, hi = q * block + block - 1 - i;
            int32_t a = o[lo], b = o[hi];
            if (q & 1) {
                o[lo] = clamp_bits((int64_t)b - a, r);
                o[hi] = clamp_bits((int64_t)a + b, r);
            } else {
                o[lo] = clamp_bits((int64_t)a + b, r);
                o[hi] = clamp_bits((int64_t)a - b, r);
            }
        }
}

void idct_rotate_groups(int32_t* o, int m, int g) {  // after the add/sub stage of blocks of g
    const int16_t* c = av1tab::cospi;
    int kk = m / (4 * g), lk = 0;
    while ((1 << lk) < kk) lk++;
    for (int j = 0; j < kk; j++) {
        int rev = 0;
        for (int v = j, b = 0; b < lk; b++, v >>= 1) rev = (rev << 1) | (v & 1);
        int th = (16 / kk) * (1 + 4 * rev);
        for (int e = j * 2 * g + g / 2; e < j * 2 * g + g; e++) {  // the second quarter
            int32_t a = o[e], b = o[m - 1 - e];
            o[e] = half_btf(-c[th], a, c[64 - th], b);
            o[m - 1 - e] = half_btf(c[64 - th], a, c[th], b);
        }
        for (int e = j * 2 * g + g; e < j * 2 * g + g + g / 2; e++) {  // the third quarter
            int32_t a = o[e], b = o[m - 1 - e];
            o[e] = half_btf(-c[64 - th], a, -c[th], b);
            o[m - 1 - e] = half_btf(-c[th], a, c[64 - th], b);
        }
    }
}

void idct_rec(int32_t* t, int n, int r) {
    const int16_t* c = av1tab::cospi;
    if (n == 2) {
        int32_t a = t[0], b = t[1];
        t[0] = half_btf(c[32], a, c[32], b);
        t[1] = half_btf(c[32], a, -c[32], b);
        return;
    }
    const int m = n / 2;
    idct_rec(t, m, r);
    int32_t* o = t + m;
    idct_rotate_first(o, m, n);
    if (m > 2) {
        for (int block = 2; block <= m / 2; block *= 2) {
            idct_addsub(o, m, block, r);
            if (block < m / 2) {
                idct_rotate_groups(o, m, block);
            } else {
                for (int e = m / 4; e < m / 2; e++) {
                    int32_t a = o[e], b = o[m - 1 - e];
                    o[e] = half_btf(-c[32], a, c[32], b);
                    o[m - 1 - e] = half_btf(c[32], a, c[32], b);
                }
            }
        }
    }
    for (int i = 0; i < m; i++) {
        int32_t e = t[i], odd = o[m - 1 - i];
        t[i] = clamp_bits((int64_t)e + odd, r);
        t[n - 1 - i] = clamp_bits((int64_t)e - odd, r);
    }
}

void idct(const int32_t* in, int32_t* out, int n, int r) {
    int lg = 0;
    while ((1 << lg) < n) lg++;
    for (int i = 0; i < n; i++) {
        int rev = 0;
        for (int v = i, b = 0; b < lg; b++, v >>= 1) rev = (rev << 1) | (v & 1);
        out[i] = in[rev];
    }
    idct_rec(out, n, r);
}

void iadst4(const int32_t* in, int32_t* out) {
    const int16_t* sp = av1tab::sinpi;
    int64_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
    if (!(x0 | x1 | x2 | x3)) {
        out[0] = out[1] = out[2] = out[3] = 0;
        return;
    }
    int64_t s0 = sp[1] * x0, s1 = sp[2] * x0, s2 = sp[3] * x1, s3 = sp[4] * x2, s4 = sp[1] * x2, s5 = sp[2] * x3,
            s6 = sp[4] * x3;
    // libaom computes these in 32 bits; for inputs of 16 bits they fit
    int64_t s7 = (x0 - x2) + x3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = sp[3] * s7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    int64_t y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = s0 + s1;
    y3 = y3 - s3;
    const int64_t y[4] = {y0, y1, y2, y3};
    for (int i = 0; i < 4; i++) {
        out[i] = round_shift(y[i], kInvCosBit);
        out[i] = clamp_bits(out[i], 16);
    }
}

// av1_iadst8 / av1_iadst16: the input permuted, rotations of pairs, then for
// blocks of n, n/2, ... 4: add/sub between the block's halves and rotations
// in its second half (by 8/56 and 40/24, then 16/48, then 32), the output
// permuted with alternate signs
void iadst_n(const int32_t* in, int32_t* out, int n, int r) {
    const int16_t* c = av1tab::cospi;
    static const int ang4[2][2] = {{16, 48}, {48, 16}};
    static const int ang8[4][2] = {{8, 56}, {40, 24}, {56, 8}, {24, 40}};
    int32_t b[16];
    for (int k = 0; k < n / 2; k++) {
        b[2 * k] = in[n - 1 - 2 * k];
        b[2 * k + 1] = in[2 * k];
    }
    for (int k = 0; k < n / 2; k++) {
        const int th = (32 / n) * (1 + 4 * k);
        const int32_t x = b[2 * k], y = b[2 * k + 1];
        b[2 * k] = half_btf(c[th], x, c[64 - th], y);
        b[2 * k + 1] = half_btf(c[64 - th], x, -c[th], y);
    }
    for (int half = n / 2; half >= 2; half /= 2) {
        for (int base = 0; base < n; base += 2 * half)
            for (int i = 0; i < half; i++) {
                const int32_t x = b[base + i], y = b[base + half + i];
                b[base + i] = clamp_bits((int64_t)x + y, r);
                b[base + half + i] = clamp_bits((int64_t)x - y, r);
            }
        for (int base = 0; base < n; base += 2 * half) {
            int32_t* v = b + base + half;
            for (int p = 0; p < half / 2; p++) {
                const int32_t x = v[2 * p], y = v[2 * p + 1];
                if (half == 2) {
                    v[0] = half_btf(c[32], x, c[32], y);
                    v[1] = half_btf(c[32], x, -c[32], y);
                    continue;
                }
                const int* ang = half == 4 ? ang4[p] : ang8[p];
                if (p < half / 4) {
                    v[2 * p] = half_btf(c[ang[0]], x, c[ang[1]], y);
                    v[2 * p + 1] = half_btf(c[ang[1]], x, -c[ang[0]], y);
                } else {
                    v[2 * p] = half_btf(-c[ang[0]], x, c[ang[1]], y);
                    v[2 * p + 1] = half_btf(c[ang[1]], x, c[ang[0]], y);
                }
            }
        }
    }
    static const int8_t perm8[8] = {0, 4, 6, 2, 3, 7, 5, 1};
    static const int8_t perm16[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    const int8_t* perm = n == 8 ? perm8 : perm16;
    for (int i = 0; i < n; i++) {
        out[i] = (i & 1) ? -b[perm[i]] : b[perm[i]];
        out[i] = clamp_bits(out[i], 16);
    }
}

int32_t identity_scale(int32_t v, int n) {  // av1_iidentity{4,8,16,32}_c
    if (n == 4) return round_shift((int64_t)kNewSqrt2 * v, 12);
    if (n == 8) return (int32_t)((int64_t)v * 2);
    if (n == 16) return round_shift((int64_t)kNewSqrt2 * 2 * v, 12);
    return (int32_t)((int64_t)v * 4);
}

void iidentity(const int32_t* in, int32_t* out, int n) {
    for (int i = 0; i < n; i++) out[i] = clamp_bits(identity_scale(in[i], n), 16);
}

void inv_txfm1d(int kind, const int32_t* in, int32_t* out, int n, int r) {
    if (kind == TX1D_DCT) idct(in, out, n, r);
    else if (kind == TX1D_IDTX) iidentity(in, out, n);
    else if (n == 4) iadst4(in, out);
    else iadst_n(in, out, n, r);
}

// av1_inv_txfm2d_add_c with bd = 8: ``coef`` in libaom's layout (column by
// column, tx_size_high[adjusted] values each; a 64-sample side holds its
// first 32 coefficients), added to ``dst`` with a clip to 8 bits.
// The arithmetic is that of the path libaom dispatches on x86
// (av1_lowbd_inv_txfm2d_add_ssse3 / _avx2, which agree): the same stages in
// 16-bit lanes that saturate, where an identity row transform and the row
// shift are one rounding. libaom's C path parts from it only where a value
// leaves 16 bits, which damaged coefficients reach.
void inverse_transform_add(const int32_t* coef, int tx_size, int tx_type, uint8_t* dst, int stride) {
    const int w = kTxW[tx_size], h = kTxH[tx_size];
    const int cw = std::min(w, 32), ch = std::min(h, 32);
    const int8_t* shift = av1tab::inv_txfm_shift[tx_size];
    int lw = 0, lh = 0;
    while ((1 << lw) < w) lw++;
    while ((1 << lh) < h) lh++;
    const bool rect2 = std::abs(lw - lh) == 1;
    const int vtx = av1tab::vtx_tab[tx_type], htx = av1tab::htx_tab[tx_type];
    const bool ud_flip = vtx == TX1D_FLIPADST, lr_flip = htx == TX1D_FLIPADST;
    static thread_local int32_t buf[64 * 64];
    int32_t tin[64], tout[64];
    for (int r = 0; r < h; r++) {
        for (int c = 0; c < w; c++) {
            int32_t v = (r < ch && c < cw) ? coef[c * ch + r] : 0;
            if (rect2) v = round_shift((int64_t)v * kNewInvSqrt2, 12);
            tin[c] = clamp_bits(v, 16);  // bd + 8
        }
        if (htx == TX1D_IDTX) {  // the identity row and its shift: one rounding, then 16 bits
            for (int c = 0; c < w; c++)
                buf[r * w + c] = clamp_bits(round_shift(identity_scale(tin[c], w), -shift[0]), 16);
        } else {
            inv_txfm1d(htx, tin, buf + r * w, w, 16);
            for (int c = 0; c < w; c++) buf[r * w + c] = round_shift(buf[r * w + c], -shift[0]);
        }
    }
    for (int c = 0; c < w; c++) {
        for (int r = 0; r < h; r++) tin[r] = clamp_bits(buf[r * w + (lr_flip ? w - 1 - c : c)], 16);
        inv_txfm1d(vtx, tin, tout, h, 16);
        for (int r = 0; r < h; r++) {
            int32_t v = round_shift(tout[ud_flip ? h - 1 - r : r], -shift[1]);
            uint8_t* d = dst + (size_t)r * stride + c;
            *d = clip_pixel((int)std::max<int64_t>(-1024, std::min<int64_t>(1024, (int64_t)*d + v)));
        }
    }
}

// offsets in the nmv_context rows
const int kMvJoints = 0, kMvComp = 5, kMvCompSize = 69;
const int kMvClasses = 0, kMvClass0Fp = 12, kMvFp = 22, kMvSign = 27, kMvClass0Hp = 30, kMvHp = 33, kMvClass0 = 36,
          kMvBits = 39;

}  // namespace

namespace {

// -- the in-loop filters: deblocking (aom_dsp/loopfilter.c) and CDEF (cdef_block.c) -------------

int8_t signed_char_clamp(int t) { return (int8_t)clip3(-128, 127, t); }

// filter4: the 4-tap filter of the two samples each side
void lpf_filter4(int8_t mask, uint8_t thresh, uint8_t* op1, uint8_t* op0, uint8_t* oq0, uint8_t* oq1) {
    const int8_t ps1 = (int8_t)(*op1 ^ 0x80), ps0 = (int8_t)(*op0 ^ 0x80);
    const int8_t qs0 = (int8_t)(*oq0 ^ 0x80), qs1 = (int8_t)(*oq1 ^ 0x80);
    const int8_t hev = (int8_t)(-((std::abs(*op1 - *op0) > thresh) | (std::abs(*oq1 - *oq0) > thresh)));
    int8_t filter = (int8_t)(signed_char_clamp(ps1 - qs1) & hev);
    filter = (int8_t)(signed_char_clamp(filter + 3 * (qs0 - ps0)) & mask);
    const int8_t filter1 = (int8_t)(signed_char_clamp(filter + 4) >> 3);
    const int8_t filter2 = (int8_t)(signed_char_clamp(filter + 3) >> 3);
    *oq0 = (uint8_t)(signed_char_clamp(qs0 - filter1) ^ 0x80);
    *op0 = (uint8_t)(signed_char_clamp(ps0 + filter2) ^ 0x80);
    filter = (int8_t)(((filter1 + 1) >> 1) & ~hev);
    *oq1 = (uint8_t)(signed_char_clamp(qs1 - filter) ^ 0x80);
    *op1 = (uint8_t)(signed_char_clamp(ps1 + filter) ^ 0x80);
}

// aom_lpf_{vertical,horizontal}_{4,6,8,14}_c: ``length`` taps on a 4-sample
// segment, ``s`` at the first sample past the edge, ``step`` across it (1
// for a vertical edge, the stride for a horizontal one), ``along`` from one
// line to the next; blimit, limit and thresh are a level's loop_filter_thresh
void lpf_segment(uint8_t* s, ptrdiff_t step, ptrdiff_t along, int length, int blimit, int limit, int thresh) {
    for (int i = 0; i < 4; i++, s += along) {
        uint8_t* q[7];
        uint8_t* p[7];
        const int n = length == 14 ? 7 : length == 8 ? 4 : length == 6 ? 3 : 2;
        for (int k = 0; k < n; k++) q[k] = s + k * step, p[k] = s - (k + 1) * step;
        auto d = [](const uint8_t* a, const uint8_t* b) { return std::abs((int)*a - (int)*b); };
        // filter_mask2 / filter_mask3_chroma / filter_mask: every neighbour
        // step within limit, the edge within blimit
        bool over = d(p[1], p[0]) > limit || d(q[1], q[0]) > limit || d(p[0], q[0]) * 2 + d(p[1], q[1]) / 2 > blimit;
        for (int k = 2; k < std::min(n, 4); k++) over = over || d(p[k], p[k - 1]) > limit || d(q[k], q[k - 1]) > limit;
        const int8_t mask = over ? 0 : -1;
        if (length == 4) {
            lpf_filter4(mask, (uint8_t)thresh, p[1], p[0], q[0], q[1]);
            continue;
        }
        // flat_mask3_chroma / flat_mask4 at 1, and flat2 over p4..p6, q4..q6
        bool flat = true;
        for (int k = 1; k < std::min(n, 4); k++) flat = flat && d(p[k], p[0]) <= 1 && d(q[k], q[0]) <= 1;
        bool flat2 = length == 14;
        for (int k = 4; k < n; k++) flat2 = flat2 && d(p[k], p[0]) <= 1 && d(q[k], q[0]) <= 1;
        if (!mask || !flat) {
            lpf_filter4(mask, (uint8_t)thresh, p[1], p[0], q[0], q[1]);
            continue;
        }
        if (length == 6) {  // filter6: [1, 2, 2, 2, 1]
            const int p2 = *p[2], p1 = *p[1], p0 = *p[0], q0 = *q[0], q1 = *q[1], q2 = *q[2];
            *p[1] = (uint8_t)round2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3);
            *p[0] = (uint8_t)round2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3);
            *q[0] = (uint8_t)round2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3);
            *q[1] = (uint8_t)round2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3);
        } else if (length == 8 || !flat2) {  // filter8: [1, 1, 1, 2, 1, 1, 1]
            const int p3 = *p[3], p2 = *p[2], p1 = *p[1], p0 = *p[0], q0 = *q[0], q1 = *q[1], q2 = *q[2], q3 = *q[3];
            *p[2] = (uint8_t)round2(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0, 3);
            *p[1] = (uint8_t)round2(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1, 3);
            *p[0] = (uint8_t)round2(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2, 3);
            *q[0] = (uint8_t)round2(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3, 3);
            *q[1] = (uint8_t)round2(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3, 3);
            *q[2] = (uint8_t)round2(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3, 3);
        } else {  // filter14: [1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1] over a window sliding from p6 to q6
            int v[14];
            for (int k = 0; k < 7; k++) v[6 - k] = *p[k], v[7 + k] = *q[k];
            for (int k = 1; k <= 12; k++) {  // the outputs p5 .. q5 at v[k]
                int sum = 0;
                for (int t = k - 6; t <= k + 6; t++) sum += v[clip3(0, 13, t)] * ((t >= k - 1 && t <= k + 1) ? 2 : 1);
                uint8_t* at = k < 7 ? p[6 - k] : q[k - 7];
                *at = (uint8_t)round2(sum, 4);
            }
        }
    }
}

// CDEF on 16-bit samples (cdef_block.c): a sample outside the frame is
// CDEF_VERY_LARGE, which no constraint takes and no maximum counts
const int kCdefVeryLarge = 30000;
const int kCdefPriTaps[2][2] = {{4, 2}, {3, 3}}, kCdefSecTaps[2] = {2, 1};
// cdef_directions_padded: direction d at [d + 2], the taps at 1 and 2 samples
const int kCdefDirections[12][2][2] = {  // {row, col} of each tap
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}},  {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}},
    {{0, 1}, {0, 2}},   {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}},  {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}};

// cdef_find_dir_c: the direction of an 8x8 block and its directional
// contrast (the variance luma's primary strength is adjusted by)
int cdef_find_dir(const uint16_t* img, int stride, int32_t* var) {
    int32_t cost[8] = {0};
    int partial[8][15] = {{0}};
    static const int div_table[] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
            const int x = img[i * stride + j] - 128;
            partial[0][i + j] += x;
            partial[1][i + j / 2] += x;
            partial[2][i] += x;
            partial[3][3 + i - j / 2] += x;
            partial[4][7 + i - j] += x;
            partial[5][3 - i / 2 + j] += x;
            partial[6][j] += x;
            partial[7][i / 2 + j] += x;
        }
    for (int i = 0; i < 8; i++) {
        cost[2] += partial[2][i] * partial[2][i];
        cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= div_table[8];
    cost[6] *= div_table[8];
    for (int i = 0; i < 7; i++) {
        cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * div_table[i + 1];
        cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * div_table[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * div_table[8];
    cost[4] += partial[4][7] * partial[4][7] * div_table[8];
    for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
        cost[i] *= div_table[8];
        for (int j = 0; j < 3; j++)
            cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * div_table[2 * j + 2];
    }
    int32_t best_cost = 0;
    int best_dir = 0;
    for (int i = 0; i < 8; i++)
        if (cost[i] > best_cost) {
            best_cost = cost[i];
            best_dir = i;
        }
    *var = (best_cost - cost[(best_dir + 4) & 7]) >> 10;
    return best_dir;
}

// constrain: the difference, shrunk as it grows past the strength (shift:
// the damping less the strength's log2, at least 0)
inline int cdef_constrain(int diff, int threshold, int shift) {
    const int mag = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> shift)));
    return diff < 0 ? -mag : mag;
}

// cdef_filter_8_{0,1,2,3}: one block of bw x bh from ``in`` (16-bit, the
// block's first sample; neighbours two samples away) into ``dst``; the
// primary taps along ``dir``, the secondary ones 45 degrees off, the result
// clipped to the taps' range where both run
void cdef_filter_scalar(uint8_t* dst, int dstride, const uint16_t* in, int istride, int pri, int sec, int dir,
                        int pri_damping, int sec_damping, int bw, int bh) {
    const bool primary = pri != 0, secondary = sec != 0, clip = primary && secondary;
    const int pri_shift = primary ? std::max(0, pri_damping - log2i(pri)) : 0;
    const int sec_shift = secondary ? std::max(0, sec_damping - log2i(sec)) : 0;
    const int* pri_taps = kCdefPriTaps[pri & 1];
    auto offset = [&](int d, int k) { return kCdefDirections[d][k][0] * istride + kCdefDirections[d][k][1]; };
    const int po[2] = {offset(dir + 2, 0), offset(dir + 2, 1)};
    const int so[2][2] = {{offset(dir + 4, 0), offset(dir, 0)}, {offset(dir + 4, 1), offset(dir, 1)}};
    for (int i = 0; i < bh; i++)
        for (int j = 0; j < bw; j++) {
            const uint16_t* at = in + i * istride + j;
            const int x = at[0];
            int sum = 0, mx = x, mn = x;
            auto tap = [&](int v, int taps, int strength, int shift) {
                sum += taps * cdef_constrain(v - x, strength, shift);
                if (clip) {
                    if (v != kCdefVeryLarge) mx = std::max(v, mx);
                    mn = std::min(v, mn);
                }
            };
            for (int k = 0; k < 2; k++) {
                if (primary) {
                    tap(at[po[k]], pri_taps[k], pri, pri_shift);
                    tap(at[-po[k]], pri_taps[k], pri, pri_shift);
                }
                if (secondary)
                    for (int o : so[k]) {
                        tap(at[o], kCdefSecTaps[k], sec, sec_shift);
                        tap(at[-o], kCdefSecTaps[k], sec, sec_shift);
                    }
            }
            int y = x + ((8 + sum - (sum < 0)) >> 4);
            if (clip) y = clip3(mn, mx, y);
            dst[i * dstride + j] = (uint8_t)y;
        }
}

#if defined(__SSE2__)
// the same arithmetic on a row of 8 samples in 16-bit lanes (every value and
// difference, CDEF_VERY_LARGE's included, fits them): every luma block, the
// bulk of CDEF's work
void cdef_filter_rows8(uint8_t* dst, int dstride, const uint16_t* in, int istride, int pri, int sec, int dir,
                       int pri_damping, int sec_damping, int bh) {
    const bool primary = pri != 0, secondary = sec != 0, clip = primary && secondary;
    const __m128i zero = _mm_setzero_si128(), very_large = _mm_set1_epi16(kCdefVeryLarge);
    const __m128i pri_v = _mm_set1_epi16((int16_t)pri), sec_v = _mm_set1_epi16((int16_t)sec);
    const __m128i pri_shift = _mm_cvtsi32_si128(primary ? std::max(0, pri_damping - log2i(pri)) : 0);
    const __m128i sec_shift = _mm_cvtsi32_si128(secondary ? std::max(0, sec_damping - log2i(sec)) : 0);
    const __m128i pt[2] = {_mm_set1_epi16((int16_t)kCdefPriTaps[pri & 1][0]), _mm_set1_epi16((int16_t)kCdefPriTaps[pri & 1][1])};
    const __m128i st[2] = {_mm_set1_epi16((int16_t)kCdefSecTaps[0]), _mm_set1_epi16((int16_t)kCdefSecTaps[1])};
    auto offset = [&](int d, int k) { return kCdefDirections[d][k][0] * istride + kCdefDirections[d][k][1]; };
    const int po[2] = {offset(dir + 2, 0), offset(dir + 2, 1)};
    const int so[2][2] = {{offset(dir + 4, 0), offset(dir, 0)}, {offset(dir + 4, 1), offset(dir, 1)}};
    for (int i = 0; i < bh; i++) {
        const uint16_t* row = in + i * istride;
        const __m128i x = _mm_loadu_si128((const __m128i*)row);
        __m128i sum = zero, mx = x, mn = x;
        auto tap = [&](int o, __m128i taps, __m128i strength, __m128i shift) {
            const __m128i v = _mm_loadu_si128((const __m128i*)(row + o));
            const __m128i diff = _mm_sub_epi16(v, x);
            const __m128i ad = _mm_max_epi16(diff, _mm_sub_epi16(zero, diff));
            const __m128i room = _mm_max_epi16(zero, _mm_sub_epi16(strength, _mm_sra_epi16(ad, shift)));
            const __m128i neg = _mm_cmplt_epi16(diff, zero);
            const __m128i c = _mm_sub_epi16(_mm_xor_si128(_mm_min_epi16(ad, room), neg), neg);
            sum = _mm_add_epi16(sum, _mm_mullo_epi16(c, taps));
            if (clip) {
                const __m128i large = _mm_cmpeq_epi16(v, very_large);
                mx = _mm_max_epi16(mx, _mm_or_si128(_mm_and_si128(large, x), _mm_andnot_si128(large, v)));
                mn = _mm_min_epi16(mn, v);
            }
        };
        for (int k = 0; k < 2; k++) {
            if (primary) {
                tap(po[k], pt[k], pri_v, pri_shift);
                tap(-po[k], pt[k], pri_v, pri_shift);
            }
            if (secondary)
                for (int o : so[k]) {
                    tap(o, st[k], sec_v, sec_shift);
                    tap(-o, st[k], sec_v, sec_shift);
                }
        }
        const __m128i rounded = _mm_add_epi16(_mm_add_epi16(sum, _mm_set1_epi16(8)), _mm_cmplt_epi16(sum, zero));
        __m128i y = _mm_add_epi16(x, _mm_srai_epi16(rounded, 4));
        if (clip) y = _mm_min_epi16(_mm_max_epi16(y, mn), mx);
        _mm_storel_epi64((__m128i*)(dst + i * dstride), _mm_packus_epi16(y, y));
    }
}
#endif

void cdef_filter_block(uint8_t* dst, int dstride, const uint16_t* in, int istride, int pri, int sec, int dir,
                       int pri_damping, int sec_damping, int bw, int bh) {
#if defined(__SSE2__)
    if (bw == 8) return cdef_filter_rows8(dst, dstride, in, istride, pri, sec, dir, pri_damping, sec_damping, bh);
#endif
    cdef_filter_scalar(dst, dstride, in, istride, pri, sec, dir, pri_damping, sec_damping, bw, bh);
}

// adjust_strength: luma's primary strength scaled by the block's variance
int cdef_adjust_strength(int strength, int32_t var) {
    const int i = (var >> 6) ? std::min(log2i(var >> 6), 12) : 0;
    return var ? (strength * (4 + i) + 8) >> 4 : 0;
}

// -- loop restoration's filters (restoration.c), on one processing unit ------------------
// ``src`` is the unit's first sample; the three rows above and below it and
// the three columns left and right of it are readable.

// av1_wiener_convolve_add_src_c at WIENER_ROUND0_BITS 3 (8 bits): the
// horizontal pass over the unit's rows and three more on each side adds the
// centre sample << 7 (the centre tap's implicit 128) and 1 << 14, rounds by 3
// bits and clamps to [0, 8191]; the vertical pass adds the centre << 7 less
// 1 << 18 and rounds by 11 bits to 8 bits. ``hf`` / ``vf``: the 7 taps as
// libaom's WienerInfo holds them (the centre without its 128).
void wiener_filter(const uint8_t* src, ptrdiff_t sstride, uint8_t* dst, ptrdiff_t dstride, int w, int h,
                   const int16_t* hf, const int16_t* vf) {
    std::vector<uint16_t> tmp((size_t)(h + 6) * w);
    for (int y = -3; y < h + 3; y++) {
        const uint8_t* s = src + y * sstride;
        uint16_t* t = &tmp[(size_t)(y + 3) * w];
        for (int x = 0; x < w; x++) {
            int sum = (s[x] << 7) + (1 << 14);
            for (int k = 0; k < 7; k++) sum += hf[k] * s[x + k - 3];
            t[x] = (uint16_t)clip3(0, 8191, round2(sum, 3));
        }
    }
    for (int y = 0; y < h; y++) {
        const uint16_t* t = &tmp[(size_t)(y + 3) * w];
        for (int x = 0; x < w; x++) {
            int sum = (t[x] << 7) - (1 << 18);
            for (int k = 0; k < 7; k++) sum += vf[k] * t[x + (k - 3) * w];
            dst[y * dstride + x] = clip_pixel(round2(sum, 11));
        }
    }
}

// calculate_intermediate_result of av1_selfguided_restoration_c: the box
// sums of radius r (B) and of the squares (A) at rows -1..h (every row, or
// every other one from -1 in the fast pass) and columns -1..w, turned into
// the blend factor A = av1_x_by_xplus1[z] and the scaled mean B, in uint32
// arithmetic as libaom's. ``a`` / ``b``: (h + 2) rows of w + 2.
void sgr_intermediate(const uint8_t* src, ptrdiff_t stride, int w, int h, int r, uint32_t s, bool fast,
                      int32_t* a, int32_t* b) {
    const int n = (2 * r + 1) * (2 * r + 1), bw = w + 2;
    std::vector<int32_t> col_sum(w + 2 + 2 * r), col_sq(w + 2 + 2 * r);
    for (int i = -1; i < h + 1; i += fast ? 2 : 1) {
        for (int j = -1 - r; j < w + 1 + r; j++) {
            int32_t sum = 0, sq = 0;
            for (int d = -r; d <= r; d++) {
                const int v = src[(i + d) * stride + j];
                sum += v;
                sq += v * v;
            }
            col_sum[j + 1 + r] = sum;
            col_sq[j + 1 + r] = sq;
        }
        for (int j = -1; j < w + 1; j++) {
            uint32_t bs = 0, as = 0;
            for (int d = -r; d <= r; d++) {
                bs += (uint32_t)col_sum[j + d + 1 + r];
                as += (uint32_t)col_sq[j + d + 1 + r];
            }
            const uint32_t p = (as * n < bs * bs) ? 0 : as * n - bs * bs;
            const uint32_t z = (p * s + (1u << 19)) >> 20;  // SGRPROJ_MTABLE_BITS
            const int32_t A = av1tab::x_by_xplus1[std::min<uint32_t>(z, 255)];
            const size_t k = (size_t)(i + 1) * bw + (j + 1);
            a[k] = A;
            b[k] = (int32_t)(((uint32_t)(256 - A) * bs * (uint32_t)av1tab::one_by_x[n - 1] + (1u << 11)) >> 12);
        }
    }
}

// selfguided_restoration_fast_internal (r = 2, A and B on alternate rows
// from the unit's row -1: an even row weighs the rows above and below it 6
// and 5, an odd one its own row) and selfguided_restoration_internal (r = 1,
// 4 on the cross and 3 on the diagonals): the filtered samples << 4
void sgr_filter(const uint8_t* src, ptrdiff_t stride, int w, int h, int r, uint32_t s, bool fast, int32_t* flt) {
    const int bw = w + 2;
    std::vector<int32_t> A((size_t)(h + 2) * bw), B((size_t)(h + 2) * bw);
    sgr_intermediate(src, stride, w, h, r, s, fast, A.data(), B.data());
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            const size_t k = (size_t)(i + 1) * bw + (j + 1);
            const int32_t* a = &A[k];
            const int32_t* b = &B[k];
            int32_t av, bv, shift;
            if (fast && !(i & 1)) {
                av = (a[-bw] + a[bw]) * 6 + (a[-1 - bw] + a[-1 + bw] + a[1 - bw] + a[1 + bw]) * 5;
                bv = (b[-bw] + b[bw]) * 6 + (b[-1 - bw] + b[-1 + bw] + b[1 - bw] + b[1 + bw]) * 5;
                shift = 9;
            } else if (fast) {
                av = a[0] * 6 + (a[-1] + a[1]) * 5;
                bv = b[0] * 6 + (b[-1] + b[1]) * 5;
                shift = 8;
            } else {
                av = (a[0] + a[-1] + a[1] + a[-bw] + a[bw]) * 4 + (a[-1 - bw] + a[-1 + bw] + a[1 - bw] + a[1 + bw]) * 3;
                bv = (b[0] + b[-1] + b[1] + b[-bw] + b[bw]) * 4 + (b[-1 - bw] + b[-1 + bw] + b[1 - bw] + b[1 + bw]) * 3;
                shift = 9;
            }
            flt[(size_t)i * w + j] = round2(av * src[i * stride + j] + bv, shift);
        }
}

// av1_apply_selfguided_restoration_c: the two passes of the set ``ep`` (a
// radius of 0 skips its pass), blended with the source by av1_decode_xq's
// weights, rounded by 11 bits, cut to 16 bits and clamped to 8
void selfguided_filter(const uint8_t* src, ptrdiff_t stride, int w, int h, int ep, const int* xqd, uint8_t* dst,
                       ptrdiff_t dstride) {
    const int32_t* params = av1tab::sgr_params[ep];
    const int r0 = params[0], r1 = params[1];
    std::vector<int32_t> flt0((size_t)w * h), flt1((size_t)w * h);
    if (r0) sgr_filter(src, stride, w, h, r0, (uint32_t)params[2], true, flt0.data());
    if (r1) sgr_filter(src, stride, w, h, r1, (uint32_t)params[3], false, flt1.data());
    int xq0, xq1;
    if (!r0) {
        xq0 = 0;
        xq1 = 128 - xqd[1];
    } else if (!r1) {
        xq0 = xqd[0];
        xq1 = 0;
    } else {
        xq0 = xqd[0];
        xq1 = 128 - xqd[0] - xqd[1];
    }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            const size_t k = (size_t)i * w + j;
            const int32_t u = src[i * stride + j] << 4;
            int32_t v = u << 7;
            if (r0) v += xq0 * (flt0[k] - u);
            if (r1) v += xq1 * (flt1[k] - u);
            dst[i * dstride + j] = clip_pixel((int16_t)round2(v, 11));
        }
}

// -- the frame: blocks, contexts, prediction and reconstruction -----------------------

struct BlockInfo {
    int8_t bsize = 0, ymode = DC_PRED, uvmode = DC_PRED, skip = 0, seg_id = 0, intrabc = 0, partition = 0;
    int8_t tx_size = 0;                 // mbmi->tx_size: the luma transform the deblocking filter reads
    int8_t delta_lf[4] = {0, 0, 0, 0};  // the tile's running delta_lf[] after the block's mode info
    int8_t pal_size[2] = {0, 0};
    uint8_t pal[3][8] = {{0}};
    int mv_row = 0, mv_col = 0;  // IntraBC's displacement in 1/8 samples
};

// -- film grain (grain_synthesis.c), on the output frame -------------------------------------------
// libaom's add_film_grain_run with its static state in one object: the
// grain templates (a 73x82 luma block and chroma blocks by subsampling,
// generated from gaussian_sequence and the AR filter from the seed),
// then the frame in 32x32 luma blocks (16 rows of 2-sample pairs), each
// taking its template at a random offset drawn per 32-row stripe; with
// overlap the two grain columns and rows at a block's left and top edges
// are blended with the neighbour's. Chroma is noised before luma, from
// the luma samples without grain.

struct GrainSynthesis {
    const FilmGrain& p;
    uint16_t random_register = 0;
    int grain_min = -128, grain_max = 127;
    int scaling_lut_y[256] = {0}, scaling_lut_cb[256] = {0}, scaling_lut_cr[256] = {0};

    explicit GrainSynthesis(const FilmGrain& params) : p(params) {}

    int get_random_number(int bits) {
        const uint16_t bit =
            ((random_register >> 0) ^ (random_register >> 1) ^ (random_register >> 3) ^ (random_register >> 12)) & 1;
        random_register = (uint16_t)((random_register >> 1) | (bit << 15));
        return (random_register >> (16 - bits)) & ((1 << bits) - 1);
    }

    // the seed of the stripe of 32 luma rows at luma_line; 7 << 5 and 11 << 5
    // give the Cb and Cr templates' seeds (the seed ^ 0xb524, ^ 0x49d8)
    void init_random_generator(int luma_line, uint16_t seed) {
        random_register = seed;
        const int luma_num = luma_line >> 5;
        random_register ^= (uint16_t)(((luma_num * 37 + 178) & 255) << 8);
        random_register ^= (uint16_t)((luma_num * 173 + 105) & 255);
    }

    int clamp(int v, int lo, int hi) const { return v < lo ? lo : (v > hi ? hi : v); }

    int gauss(int shift) {
        return (av1tab::gaussian_sequence[get_random_number(11)] + ((1 << shift) >> 1)) >> shift;
    }

    static void init_scaling_function(const int (*points)[2], int num, int* lut) {
        if (num == 0) return;
        for (int i = 0; i < points[0][0]; i++) lut[i] = points[0][1];
        for (int point = 0; point < num - 1; point++) {
            const int delta_y = points[point + 1][1] - points[point][1];
            const int delta_x = points[point + 1][0] - points[point][0];
            const int64_t delta = (int64_t)delta_y * ((65536 + (delta_x >> 1)) / delta_x);
            for (int x = 0; x < delta_x; x++) lut[points[point][0] + x] = points[point][1] + (int)((x * delta + 32768) >> 16);
        }
        for (int i = points[num - 1][0]; i < 256; i++) lut[i] = points[num - 1][1];
    }

    // the AR filter's neighbours of a sample: (row, col, from luma)
    void pred_positions(std::vector<std::array<int, 3>>& luma, std::vector<std::array<int, 3>>& chroma) const {
        const int lag = p.ar_coeff_lag;
        for (int row = -lag; row < 0; row++)
            for (int col = -lag; col < lag + 1; col++) {
                luma.push_back({row, col, 0});
                chroma.push_back({row, col, 0});
            }
        for (int col = -lag; col < 0; col++) {
            luma.push_back({0, col, 0});
            chroma.push_back({0, col, 0});
        }
        if (p.num_y_points > 0) chroma.push_back({0, 0, 1});
    }

    void generate_luma_grain_block(const std::vector<std::array<int, 3>>& pos, int* block, int size_y, int size_x,
                                   int stride, int left_pad, int top_pad, int right_pad, int bottom_pad) {
        if (p.num_y_points == 0) {
            std::fill(block, block + (size_t)size_y * stride, 0);
            return;
        }
        const int shift = 12 - (int)p.bit_depth + p.grain_scale_shift;
        const int rounding = 1 << (p.ar_coeff_shift - 1);
        for (int i = 0; i < size_y; i++)
            for (int j = 0; j < size_x; j++) block[i * stride + j] = gauss(shift);
        for (int i = top_pad; i < size_y - bottom_pad; i++)
            for (int j = left_pad; j < size_x - right_pad; j++) {
                int wsum = 0;
                for (size_t k = 0; k < pos.size(); k++)
                    wsum += p.ar_coeffs_y[k] * block[(i + pos[k][0]) * stride + j + pos[k][1]];
                block[i * stride + j] = clamp(block[i * stride + j] + ((wsum + rounding) >> p.ar_coeff_shift), grain_min,
                                              grain_max);
            }
    }

    void generate_chroma_grain_blocks(const std::vector<std::array<int, 3>>& pos, const int* luma_block, int* cb,
                                      int* cr, int luma_stride, int size_y, int size_x, int stride, int left_pad,
                                      int top_pad, int right_pad, int bottom_pad, int ss_y, int ss_x) {
        const int shift = 12 - (int)p.bit_depth + p.grain_scale_shift;
        const int rounding = 1 << (p.ar_coeff_shift - 1);
        const bool do_cb = p.num_cb_points || p.chroma_scaling_from_luma;
        const bool do_cr = p.num_cr_points || p.chroma_scaling_from_luma;
        const size_t n = (size_t)size_y * stride;
        if (do_cb) {
            init_random_generator(7 << 5, p.random_seed);
            for (int i = 0; i < size_y; i++)
                for (int j = 0; j < size_x; j++) cb[i * stride + j] = gauss(shift);
        } else {
            std::fill(cb, cb + n, 0);
        }
        if (do_cr) {
            init_random_generator(11 << 5, p.random_seed);
            for (int i = 0; i < size_y; i++)
                for (int j = 0; j < size_x; j++) cr[i * stride + j] = gauss(shift);
        } else {
            std::fill(cr, cr + n, 0);
        }
        for (int i = top_pad; i < size_y - bottom_pad; i++)
            for (int j = left_pad; j < size_x - right_pad; j++) {
                int wsum_cb = 0, wsum_cr = 0;
                for (size_t k = 0; k < pos.size(); k++) {
                    if (pos[k][2] == 0) {
                        wsum_cb += p.ar_coeffs_cb[k] * cb[(i + pos[k][0]) * stride + j + pos[k][1]];
                        wsum_cr += p.ar_coeffs_cr[k] * cr[(i + pos[k][0]) * stride + j + pos[k][1]];
                    } else {
                        int av_luma = 0;
                        const int ly = ((i - top_pad) << ss_y) + top_pad, lx = ((j - left_pad) << ss_x) + left_pad;
                        for (int k2 = ly; k2 < ly + ss_y + 1; k2++)
                            for (int l = lx; l < lx + ss_x + 1; l++) av_luma += luma_block[k2 * luma_stride + l];
                        av_luma = (av_luma + ((1 << (ss_y + ss_x)) >> 1)) >> (ss_y + ss_x);
                        wsum_cb += p.ar_coeffs_cb[k] * av_luma;
                        wsum_cr += p.ar_coeffs_cr[k] * av_luma;
                    }
                }
                if (do_cb)
                    cb[i * stride + j] = clamp(cb[i * stride + j] + ((wsum_cb + rounding) >> p.ar_coeff_shift), grain_min,
                                               grain_max);
                if (do_cr)
                    cr[i * stride + j] = clamp(cr[i * stride + j] + ((wsum_cr + rounding) >> p.ar_coeff_shift), grain_min,
                                               grain_max);
            }
    }

    // add_noise_to_block: chroma first (from the luma without grain), then luma
    void add_noise_to_block(uint8_t* luma, uint8_t* cb, uint8_t* cr, int luma_stride, int chroma_stride,
                            const int* luma_grain, const int* cb_grain, const int* cr_grain, int luma_grain_stride,
                            int chroma_grain_stride, int half_luma_height, int half_luma_width, int ss_y, int ss_x,
                            int mc_identity) {
        int cb_mult = p.cb_mult - 128, cb_luma_mult = p.cb_luma_mult - 128, cb_offset = p.cb_offset - 256;
        int cr_mult = p.cr_mult - 128, cr_luma_mult = p.cr_luma_mult - 128, cr_offset = p.cr_offset - 256;
        const int rounding = 1 << (p.scaling_shift - 1);
        const bool apply_y = p.num_y_points > 0;
        const bool apply_cb = p.num_cb_points > 0 || p.chroma_scaling_from_luma;
        const bool apply_cr = p.num_cr_points > 0 || p.chroma_scaling_from_luma;
        if (p.chroma_scaling_from_luma) {
            cb_mult = cr_mult = 0;
            cb_luma_mult = cr_luma_mult = 64;
            cb_offset = cr_offset = 0;
        }
        int min_luma = 0, max_luma = 255, min_chroma = 0, max_chroma = 255;
        if (p.clip_to_restricted_range) {
            min_luma = min_chroma = 16;
            max_luma = 235;
            max_chroma = mc_identity ? 235 : 240;  // chroma keeps luma's range under the identity matrix
        }
        for (int i = 0; i < (half_luma_height << (1 - ss_y)); i++)
            for (int j = 0; j < (half_luma_width << (1 - ss_x)); j++) {
                const uint8_t* l = &luma[(i << ss_y) * luma_stride + (j << ss_x)];
                const int average_luma = ss_x ? (l[0] + l[1] + 1) >> 1 : l[0];
                if (apply_cb) {
                    uint8_t& c = cb[i * chroma_stride + j];
                    const int idx = clamp(((average_luma * cb_luma_mult + cb_mult * c) >> 6) + cb_offset, 0, 255);
                    c = (uint8_t)clamp(c + ((scaling_lut_cb[idx] * cb_grain[i * chroma_grain_stride + j] + rounding) >>
                                            p.scaling_shift),
                                       min_chroma, max_chroma);
                }
                if (apply_cr) {
                    uint8_t& c = cr[i * chroma_stride + j];
                    const int idx = clamp(((average_luma * cr_luma_mult + cr_mult * c) >> 6) + cr_offset, 0, 255);
                    c = (uint8_t)clamp(c + ((scaling_lut_cr[idx] * cr_grain[i * chroma_grain_stride + j] + rounding) >>
                                            p.scaling_shift),
                                       min_chroma, max_chroma);
                }
            }
        if (apply_y)
            for (int i = 0; i < (half_luma_height << 1); i++)
                for (int j = 0; j < (half_luma_width << 1); j++) {
                    uint8_t& v = luma[i * luma_stride + j];
                    v = (uint8_t)clamp(
                        v + ((scaling_lut_y[v] * luma_grain[i * luma_grain_stride + j] + rounding) >> p.scaling_shift),
                        min_luma, max_luma);
                }
    }

    // ver_boundary_overlap / hor_boundary_overlap: 1 or 2 columns (rows) blended
    void ver_overlap(const int* left, int left_stride, const int* right, int right_stride, int* dst, int dst_stride,
                     int width, int height) {
        for (; height > 0; height--) {
            if (width == 1) {
                *dst = clamp((*left * 23 + *right * 22 + 16) >> 5, grain_min, grain_max);
            } else if (width == 2) {
                const int a = clamp((27 * left[0] + 17 * right[0] + 16) >> 5, grain_min, grain_max);
                const int b = clamp((17 * left[1] + 27 * right[1] + 16) >> 5, grain_min, grain_max);
                dst[0] = a;
                dst[1] = b;
            }
            left += left_stride;
            right += right_stride;
            dst += dst_stride;
        }
    }

    void hor_overlap(const int* top, int top_stride, const int* bottom, int bottom_stride, int* dst, int dst_stride,
                     int width, int height) {
        for (; width > 0; width--) {
            if (height == 1) {
                *dst = clamp((*top * 23 + *bottom * 22 + 16) >> 5, grain_min, grain_max);
            } else if (height == 2) {
                const int a = clamp((27 * top[0] + 17 * bottom[0] + 16) >> 5, grain_min, grain_max);
                const int b = clamp((17 * top[top_stride] + 27 * bottom[bottom_stride] + 16) >> 5, grain_min, grain_max);
                dst[0] = a;
                dst[dst_stride] = b;
            }
            top++;
            bottom++;
            dst++;
        }
    }

    static void copy_area(const int* src, int src_stride, int* dst, int dst_stride, int width, int height) {
        for (; height > 0; height--) {
            if (width > 0) memcpy(dst, src, sizeof(int) * (size_t)width);
            src += src_stride;
            dst += dst_stride;
        }
    }

    // add_film_grain_run on even ``width`` x ``height`` luma and the chroma
    // planes of its subsampling
    void run(uint8_t* luma, uint8_t* cb, uint8_t* cr, int height, int width, int luma_stride, int chroma_stride,
             int ss_y, int ss_x, int mc_identity) {
        random_register = p.random_seed;
        const int left_pad = 3, right_pad = 3, top_pad = 3, bottom_pad = 0, ar_padding = 3;
        const int luma_sub_y = 32, luma_sub_x = 32;
        const int chroma_sub_y = luma_sub_y >> ss_y, chroma_sub_x = luma_sub_x >> ss_x;
        const int luma_block_size_y = top_pad + 2 * ar_padding + luma_sub_y * 2 + bottom_pad;
        const int luma_block_size_x = left_pad + 2 * ar_padding + luma_sub_x * 2 + 2 * ar_padding + right_pad;
        const int chroma_block_size_y = top_pad + (2 >> ss_y) * ar_padding + chroma_sub_y * 2 + bottom_pad;
        const int chroma_block_size_x =
            left_pad + (2 >> ss_x) * ar_padding + chroma_sub_x * 2 + (2 >> ss_x) * ar_padding + right_pad;
        const int luma_grain_stride = luma_block_size_x, chroma_grain_stride = chroma_block_size_x;
        const int overlap = p.overlap_flag;
        const int grain_center = 128 << (p.bit_depth - 8);
        grain_min = -grain_center;
        grain_max = grain_center - 1;

        std::vector<std::array<int, 3>> pos_luma, pos_chroma;
        pred_positions(pos_luma, pos_chroma);
        std::vector<int> y_line((size_t)luma_stride * 2), cb_line((size_t)chroma_stride * (2 >> ss_y)),
            cr_line((size_t)chroma_stride * (2 >> ss_y));
        std::vector<int> y_col((size_t)(luma_sub_y + 2) * 2),
            cb_col((size_t)((luma_sub_y + 2) >> ss_y) * (2 - ss_x)), cr_col(cb_col.size());
        std::vector<int> luma_grain((size_t)luma_block_size_y * luma_block_size_x),
            cb_grain((size_t)chroma_block_size_y * chroma_block_size_x), cr_grain(cb_grain.size());
        generate_luma_grain_block(pos_luma, luma_grain.data(), luma_block_size_y, luma_block_size_x, luma_grain_stride,
                                  left_pad, top_pad, right_pad, bottom_pad);
        generate_chroma_grain_blocks(pos_chroma, luma_grain.data(), cb_grain.data(), cr_grain.data(), luma_grain_stride,
                                     chroma_block_size_y, chroma_block_size_x, chroma_grain_stride, left_pad, top_pad,
                                     right_pad, bottom_pad, ss_y, ss_x);
        init_scaling_function(p.scaling_points_y, p.num_y_points, scaling_lut_y);
        if (p.chroma_scaling_from_luma) {
            memcpy(scaling_lut_cb, scaling_lut_y, sizeof scaling_lut_y);
            memcpy(scaling_lut_cr, scaling_lut_y, sizeof scaling_lut_y);
        } else {
            init_scaling_function(p.scaling_points_cb, p.num_cb_points, scaling_lut_cb);
            init_scaling_function(p.scaling_points_cr, p.num_cr_points, scaling_lut_cr);
        }
        int* const yl = y_line.data();
        int* const cbl = cb_line.data();
        int* const crl = cr_line.data();
        int* const yc = y_col.data();
        int* const cbc = cb_col.data();
        int* const crc = cr_col.data();
        const int cw = 2 >> ss_x, ch = 2 >> ss_y;  // the overlap's width and height in a chroma plane
        for (int y = 0; y < height / 2; y += luma_sub_y >> 1) {
            init_random_generator(y * 2, p.random_seed);
            for (int x = 0; x < width / 2; x += luma_sub_x >> 1) {
                int offset_y = get_random_number(8);
                const int offset_x = (offset_y >> 4) & 15;
                offset_y &= 15;
                const int luma_offset_y = top_pad + 2 * ar_padding + (offset_y << 1);
                const int luma_offset_x = left_pad + 2 * ar_padding + (offset_x << 1);
                const int chroma_offset_y = top_pad + (2 >> ss_y) * ar_padding + offset_y * (2 >> ss_y);
                const int chroma_offset_x = left_pad + (2 >> ss_x) * ar_padding + offset_x * (2 >> ss_x);
                const int* lg = &luma_grain[(size_t)luma_offset_y * luma_grain_stride + luma_offset_x];
                const int* cbg = &cb_grain[(size_t)chroma_offset_y * chroma_grain_stride + chroma_offset_x];
                const int* crg = &cr_grain[(size_t)chroma_offset_y * chroma_grain_stride + chroma_offset_x];
                if (overlap && x) {
                    ver_overlap(yc, 2, lg, luma_grain_stride, yc, 2, 2, std::min(luma_sub_y + 2, height - (y << 1)));
                    const int rows = std::min(chroma_sub_y + ch, (height - (y << 1)) >> ss_y);
                    ver_overlap(cbc, cw, cbg, chroma_grain_stride, cbc, cw, cw, rows);
                    ver_overlap(crc, cw, crg, chroma_grain_stride, crc, cw, cw, rows);
                    const int i = y ? 1 : 0;
                    add_noise_to_block(luma + ((y + i) << 1) * luma_stride + (x << 1),
                                       cb + ((y + i) << (1 - ss_y)) * chroma_stride + (x << (1 - ss_x)),
                                       cr + ((y + i) << (1 - ss_y)) * chroma_stride + (x << (1 - ss_x)), luma_stride,
                                       chroma_stride, yc + i * 4, cbc + i * (2 - ss_y) * (2 - ss_x),
                                       crc + i * (2 - ss_y) * (2 - ss_x), 2, 2 - ss_x,
                                       std::min(luma_sub_y >> 1, height / 2 - y) - i, 1, ss_y, ss_x, mc_identity);
                }
                if (overlap && y) {
                    if (x) {
                        hor_overlap(yl + (x << 1), luma_stride, yc, 2, yl + (x << 1), luma_stride, 2, 2);
                        hor_overlap(cbl + x * cw, chroma_stride, cbc, cw, cbl + x * cw, chroma_stride, cw, ch);
                        hor_overlap(crl + x * cw, chroma_stride, crc, cw, crl + x * cw, chroma_stride, cw, ch);
                    }
                    const int lx = (x ? x + 1 : 0) << 1, cx = (x ? x + 1 : 0) << (1 - ss_x);
                    hor_overlap(yl + lx, luma_stride, lg + (x ? 2 : 0), luma_grain_stride, yl + lx, luma_stride,
                                std::min(luma_sub_x - ((x ? 1 : 0) << 1), width - lx), 2);
                    const int cols = std::min(chroma_sub_x - ((x ? 1 : 0) << (1 - ss_x)), (width - lx) >> ss_x);
                    const int skip = (x ? 1 : 0) << (1 - ss_x);
                    hor_overlap(cbl + cx, chroma_stride, cbg + skip, chroma_grain_stride, cbl + cx, chroma_stride, cols, ch);
                    hor_overlap(crl + cx, chroma_stride, crg + skip, chroma_grain_stride, crl + cx, chroma_stride, cols, ch);
                    add_noise_to_block(luma + (y << 1) * luma_stride + (x << 1),
                                       cb + (y << (1 - ss_y)) * chroma_stride + (x << (1 - ss_x)),
                                       cr + (y << (1 - ss_y)) * chroma_stride + (x << (1 - ss_x)), luma_stride,
                                       chroma_stride, yl + (x << 1), cbl + (x << (1 - ss_x)), crl + (x << (1 - ss_x)),
                                       luma_stride, chroma_stride, 1, std::min(luma_sub_x >> 1, width / 2 - x), ss_y,
                                       ss_x, mc_identity);
                }
                const int i = overlap && y ? 1 : 0, j = overlap && x ? 1 : 0;
                add_noise_to_block(luma + ((y + i) << 1) * luma_stride + ((x + j) << 1),
                                   cb + ((y + i) << (1 - ss_y)) * chroma_stride + ((x + j) << (1 - ss_x)),
                                   cr + ((y + i) << (1 - ss_y)) * chroma_stride + ((x + j) << (1 - ss_x)), luma_stride,
                                   chroma_stride, lg + (i << 1) * luma_grain_stride + (j << 1),
                                   cbg + (i << (1 - ss_y)) * chroma_grain_stride + (j << (1 - ss_x)),
                                   crg + (i << (1 - ss_y)) * chroma_grain_stride + (j << (1 - ss_x)), luma_grain_stride,
                                   chroma_grain_stride, std::min(luma_sub_y >> 1, height / 2 - y) - i,
                                   std::min(luma_sub_x >> 1, width / 2 - x) - j, ss_y, ss_x, mc_identity);
                if (overlap) {
                    if (x) {
                        copy_area(yc + (luma_sub_y << 1), 2, yl + (x << 1), luma_stride, 2, 2);
                        copy_area(cbc + (chroma_sub_y << (1 - ss_x)), cw, cbl + (x << (1 - ss_x)), chroma_stride, cw, ch);
                        copy_area(crc + (chroma_sub_y << (1 - ss_x)), cw, crl + (x << (1 - ss_x)), chroma_stride, cw, ch);
                    }
                    const int lx = (x ? x + 1 : 0) << 1, cx = (x ? x + 1 : 0) << (1 - ss_x);
                    copy_area(lg + luma_sub_y * luma_grain_stride + (x ? 2 : 0), luma_grain_stride, yl + lx, luma_stride,
                              std::min(luma_sub_x, width - (x << 1)) - (x ? 2 : 0), 2);
                    const int cols = std::min(chroma_sub_x, (width - (x << 1)) >> ss_x) - (x ? cw : 0);
                    copy_area(cbg + chroma_sub_y * chroma_grain_stride + (x ? cw : 0), chroma_grain_stride, cbl + cx,
                              chroma_stride, cols, ch);
                    copy_area(crg + chroma_sub_y * chroma_grain_stride + (x ? cw : 0), chroma_grain_stride, crl + cx,
                              chroma_stride, cols, ch);
                    copy_area(lg + luma_sub_x, luma_grain_stride, yc, 2, 2, std::min(luma_sub_y + 2, height - (y << 1)));
                    const int rows = std::min(chroma_sub_y + ch, (height - (y << 1)) >> ss_y);
                    copy_area(cbg + chroma_sub_x, chroma_grain_stride, cbc, cw, cw, rows);
                    copy_area(crg + chroma_sub_x, chroma_grain_stride, crc, cw, cw, rows);
                }
            }
        }
    }
};

// -- superres's upscaling filter (resize.c) ---------------------------------------------------------

const int kRsBits = 14;  // RS_SCALE_SUBPEL_BITS: positions in 1/16384 sample

// av1_get_upscale_convolve_step
int32_t superres_step(int in_length, int out_length) {
    return ((in_length << kRsBits) + out_length / 2) / out_length;
}

// get_upscale_convolve_x0: the first output sample's position, centred
int32_t superres_x0(int in_length, int out_length, int32_t step) {
    const int err = out_length * step - (in_length << kRsBits);
    const int32_t x0 = (-((out_length - in_length) << (kRsBits - 1)) + out_length / 2) / out_length + 128 - err / 2;
    return (int32_t)((uint32_t)x0 & ((1u << kRsBits) - 1));
}

// av1_convolve_horiz_rs_c on one row: ``w`` samples from ``src`` (the
// sample before the first the filter centres on), the 8 taps of one of 64
// phases at each position
void convolve_horiz_rs(const uint8_t* src, uint8_t* dst, int w, int32_t x0_qn, int32_t x_step_qn) {
    src -= 3;
    int32_t x_qn = x0_qn;
    for (int x = 0; x < w; x++) {
        const uint8_t* sx = &src[x_qn >> kRsBits];
        const int16_t* f = av1tab::resize_filter_normative[(x_qn & ((1 << kRsBits) - 1)) >> 8];
        int sum = 0;
        for (int k = 0; k < 8; k++) sum += sx[k] * f[k];
        dst[x] = clip_pixel(round2(sum, 7));
        x_qn += x_step_qn;
    }
}

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
    ST_TX_SIZE = 49,         // 19 transform sizes, by libaom's TX_SIZE
    ST_TX_TYPE = 68,         // 16 transform types (of blocks with coefficients)
    ST_QM = 84,              // transform blocks dequantised through a quantiser matrix
    ST_DELTA_Q = 85,         // non-zero delta q read
    ST_VARTX_SPLIT = 86,     // var-tx split flags set
    ST_RESIDUAL = 87,        // transform blocks with coefficients
    ST_SUB8X8_CHROMA = 88,   // chroma blocks that cover a group of luma blocks under 8 samples
    ST_CHROMA_SUBPEL_DV = 89,  // IntraBC chroma blocks predicted at a half-sample displacement
    ST_CFL_SUBSAMPLED = 90,  // CFL predictions from subsampled luma
    ST_UV_TX_SIZE = 91,      // 19 transform sizes of the chroma planes
    ST_LF_EDGES = 110,       // deblocked 4-sample edge segments by plane and filter length (4, 6, 8, 14)
    ST_CDEF_Y = 122,         // luma 8x8 blocks CDEF filters
    ST_CDEF_UV = 123,        // chroma blocks CDEF filters
    ST_CDEF_SKIP = 124,      // 8x8 blocks of a filtered 64x64 unit whose 4x4 units all skip
    ST_CDEF_UNSET = 125,     // 64x64 units without a cdef_idx (every block skips)
    ST_CDEF_BITS = 126,      // frames with cdef_bits > 0
    ST_LR_UNITS = 127,       // restoration units by plane and type (NONE, WIENER, SGRPROJ)
    ST_LR_STRIPES = 136,     // processing stripes filtered
    ST_LR_SGR_SETS = 137,    // self-guided units by parameter set (16)
    ST_LR_UNIT_SIZES = 153,  // planes restored by unit size (32, 64, 128, 256)
    ST_LR_UV_SHIFT = 157,    // frames with lr_uv_shift 1
    ST_LR_BOUNDARY = 158,    // stripe edges (top, bottom) that read the deblocked rows saved before CDEF
    ST_SUPERRES = 160,       // frames upscaled, by denominator (9-16)
    ST_SUPERRES_LR_ROWS = 168,  // loop restoration's saved rows upscaled from the deblocked frame
    ST_GRAIN = 169,          // frames with film grain, by the planes it noises (Y, Cb, Cr)
    ST_GRAIN_AR_LAG = 172,   // frames with film grain by AR lag (0-3)
    ST_GRAIN_OVERLAP = 176,  // frames with film grain blended across block edges
    ST_GRAIN_FROM_LUMA = 177,  // frames whose chroma scaling is luma's
    ST_GRAIN_CLIP = 178,     // frames with film grain clipped to the restricted range
    ST_GRAIN_ODD = 179,      // frames with film grain of an odd width or height (extended to even)
    ST_COUNT = 180
};

struct Frame {
    const SeqHeader& s;
    const FrameHeader& fh;
    int num_planes, mi_rows, mi_cols, stride, rows;
    std::vector<uint8_t> plane[3];
    std::vector<BlockInfo> blocks;
    std::vector<int32_t> grid;  // block index of each 4x4 unit, -1 before it is decoded
    std::vector<uint8_t> above_ctx[3], left_ctx[3];  // libaom's entropy contexts: cul_level | dc sign << 3
    std::vector<uint8_t> above_txfm;                 // the txfm contexts: transform widths above
    uint8_t left_txfm[32];                           // and heights to the left, in the superblock
    std::vector<uint8_t> tx_type_map;                // the luma transform type at each 4x4 unit
    std::vector<int8_t> cdef_idx;                    // each 64x64 unit's CDEF strength index, -1 unread
    int cdef_cols = 0;
    // loop restoration: each plane's units (av1_alloc_restoration_struct) and
    // the coefficients the tile read last in each plane, the next unit's
    // reference (xd->wiener_info, xd->sgrproj_info)
    struct LrUnit {
        int type = RESTORE_NONE;
        int16_t vfilter[7] = {0}, hfilter[7] = {0};
        int ep = 0, xqd[2] = {0, 0};
    };
    std::vector<LrUnit> lr_units[3];
    int lr_hunits[3] = {0, 0, 0}, lr_vunits[3] = {0, 0, 0};
    LrUnit lr_ref[3];
    std::vector<uint8_t> lr_above[3], lr_below[3];  // each stripe's two rows of context above and below
    int32_t* stats;
    int sb_mask;

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
    bool has_chroma = false, avail_u_c = false, avail_l_c = false;  // is_chroma_reference, chroma_up/left_available
    BlockInfo* b = nullptr;
    int angle_y = 0, angle_uv = 0, use_filter_intra = 0, filter_mode = 0, cfl_u = 0, cfl_v = 0;
    uint8_t map_y[64][64], map_uv[64][64];
    int tx_size = TX_4X4, max_blocks_w = 1, max_blocks_h = 1;  // the luma transform; the block's 4x4 units in the frame
    uint8_t vartx[32][32];                                    // the luma transform size at each 4x4 unit
    int dequant[3][2] = {{0, 0}, {0, 0}, {0, 0}}, qm_level[3] = {15, 15, 15};
    int cur_tx_type = DCT_DCT;
    int32_t coef[32 * 32];
    uint8_t levels[36 * 36];
    uint16_t cfl_q3[32][32];
    int cfl_w = 0, cfl_h = 0;

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
        tx_type_map.assign((size_t)mi_rows * mi_cols, DCT_DCT);
        above_txfm.assign(mi_cols + 64, 64);
        cdef_cols = (mi_cols + 15) >> 4;
        cdef_idx.assign((size_t)cdef_cols * ((mi_rows + 15) >> 4), -1);
        sb_mask = s.use_128 ? 31 : 15;
        blocks.reserve(1024);
        for (int p = 0; p < num_planes; p++) {
            if (!fh.lr_type[p]) continue;
            lr_hunits[p] = lr_count_units(fh.lr_unit_size[p], plane_w(p));
            lr_vunits[p] = lr_count_units(fh.lr_unit_size[p], plane_h(p));
            lr_units[p].assign((size_t)lr_hunits[p] * lr_vunits[p], LrUnit());
        }
    }

    // the plane's visible samples after superres (av1_whole_frame_rect)
    int plane_w(int p) const { return (fh.upscaled_width + sub_x(p)) >> sub_x(p); }
    int plane_h(int p) const { return (fh.height + sub_y(p)) >> sub_y(p); }
    // av1_lr_count_units: the last unit is up to 1.5 units long
    static int lr_count_units(int unit, int size) { return std::max((size + (unit >> 1)) / unit, 1); }

    uint8_t* px(int p, int y, int x) { return &plane[p][(size_t)y * stride + x]; }
    int sub_x(int p) const { return p ? s.ss_x : 0; }
    int sub_y(int p) const { return p ? s.ss_y : 0; }
    // get_plane_block_size: the block's size in plane p (BLOCK_INVALID, 255, where it has none)
    int plane_bsize(int p) const { return av1tab::ss_size_lookup[bsize][sub_x(p)][sub_y(p)]; }
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
            std::fill(above_ctx[p].begin() + (col_start >> sub_x(p)),
                      above_ctx[p].begin() + std::min<size_t>(col_end + 32, above_ctx[p].size()), 0);
        std::fill(above_txfm.begin() + col_start, above_txfm.begin() + std::min<size_t>(col_end + 32, above_txfm.size()), 64);
        std::fill(delta_lf, delta_lf + 4, 0);
        lr_reset();
        int sb4 = s.use_128 ? 32 : 16;
        int sb_size = s.use_128 ? BLOCK_128X128 : BLOCK_64X64;
        for (int r = row_start; r < row_end; r += sb4) {
            for (int p = 0; p < num_planes; p++)
                std::fill(left_ctx[p].begin() + (r >> sub_y(p)),
                          left_ctx[p].begin() + std::min<size_t>(r + sb4 + 32, left_ctx[p].size()), 0);
            std::fill(left_txfm, left_txfm + 32, 64);
            for (int c = col_start; c < col_end; c += sb4) {
                read_deltas = fh.delta_q_present;
                clear_block_decoded(r, c, sb4);
                read_lr(r, c, sb4);
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
        // the partition's subsize must have a size in the subsampled planes (4:2:2 has no tall ones)
        int subsize = partition == PARTITION_NONE ? bs
                      : partition == PARTITION_SPLIT ? split
                      : partition == PARTITION_HORZ_4 ? block_size(n4, quarter)
                      : partition == PARTITION_VERT_4 ? block_size(quarter, n4)
                      : (partition == PARTITION_HORZ || partition == PARTITION_HORZ_A || partition == PARTITION_HORZ_B) ? sub_h
                                                                                                                      : sub_v;
        if (av1tab::ss_size_lookup[subsize][s.ss_x][s.ss_y] == 255)
            fail(DECODE_ERROR, "Block size invalid with this subsampling mode");
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
        // is_chroma_reference: a block under 8 samples on a subsampled side
        // carries the chroma of its group only as the group's last
        has_chroma = num_planes > 1 && !(s.ss_y && bh4 == 1 && !(r & 1)) && !(s.ss_x && bw4 == 1 && !(c & 1));
        avail_u_c = has_chroma && (s.ss_y && bh4 == 1 ? inside(r - 2, c) : avail_u);
        avail_l_c = has_chroma && (s.ss_x && bw4 == 1 ? inside(r, c - 2) : avail_l);
        if (has_chroma && ((s.ss_y && bh4 == 1) || (s.ss_x && bw4 == 1))) stats[ST_SUB8X8_CHROMA]++;
        blocks.emplace_back();
        int idx = (int)blocks.size() - 1;
        b = &blocks[idx];
        b->bsize = (int8_t)bs;
        b->partition = (int8_t)partition;
        int r_end = std::min(r + bh4, mi_rows), c_end = std::min(c + bw4, mi_cols);
        for (int y = r; y < r_end; y++)
            for (int x = c; x < c_end; x++) grid[(size_t)y * mi_cols + x] = idx;
        stats[ST_BLOCKS]++;
        max_blocks_w = std::min(bw4, mi_cols - c);
        max_blocks_h = std::min(bh4, mi_rows - r);
        mode_info();
        palette_tokens();
        read_block_tx_size();
        set_dequant();
        if (b->skip) reset_block_context();
        if (b->intrabc) predict_intrabc();
        residual();
        // cfl_store_inter_block_visit: an IntraBC block without chroma keeps
        // its luma for the CFL of its group's chroma block
        if (b->intrabc && num_planes > 1 && !has_chroma)
            cfl_store(mi_col * 4, mi_row * 4, 0, 0, std::min(bw4, mi_cols - mi_col) * 4, std::min(bh4, mi_rows - mi_row) * 4);
    }

    void reset_block_context() {
        for (int p = 0; p < (has_chroma ? num_planes : 1); p++) {
            for (int i = mi_col >> sub_x(p); i < ((mi_col + bw4) >> sub_x(p)); i++) above_ctx[p][i] = 0;
            for (int i = mi_row >> sub_y(p); i < ((mi_row + bh4) >> sub_y(p)); i++) left_ctx[p][i] = 0;
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
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        for (int i = 0; i < 4; i++) b->delta_lf[i] = (int8_t)delta_lf[i];
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
        if (has_chroma) {
            // is_cfl_allowed: a block of at most 32x32, or a lossless one whose chroma block is 4x4
            int cfl_allowed = fh.lossless[b->seg_id] ? plane_bsize(1) == BLOCK_4X4 : (bw4 <= 8 && bh4 <= 8);
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

    // read_cdef: the 64x64 unit's strength index, a cdef_bits literal at its
    // first block that does not skip (every unit a block of 128 covers)
    // -- loop restoration's coefficients (decodeframe.c) ----------------------------------

    // av1_reset_loop_restoration: each tile's references start from the
    // middle of each tap's and weight's range
    void lr_reset() {
        static const int16_t kWiener[7] = {3, -7, 15, -22, 15, -7, 3};
        for (int p = 0; p < 3; p++) {
            memcpy(lr_ref[p].vfilter, kWiener, sizeof kWiener);
            memcpy(lr_ref[p].hfilter, kWiener, sizeof kWiener);
            lr_ref[p].xqd[0] = -32;
            lr_ref[p].xqd[1] = 31;
        }
    }

    // aom_read_primitive_subexpfin / refsubexpfin (binary_codes_reader.c):
    // a value of [0, n) coded beside ``ref``
    int subexpfin(int n, int k) {
        for (int i = 0, mk = 0;; i++) {
            const int b = i ? k + i - 1 : k, a = 1 << b;
            if (n <= mk + 3 * a) return (n - mk <= 1 ? 0 : ns(n - mk)) + mk;
            if (!lit(1)) return lit(b) + mk;
            mk += a;
        }
    }
    static int inv_recenter_nonneg(int r, int v) {
        if (v > (r << 1)) return v;
        return (v & 1) ? r - ((v + 1) >> 1) : (v >> 1) + r;
    }
    int refsubexpfin(int lo, int hi, int k, int ref) {  // a value of [lo, hi]
        const int n = hi - lo + 1, r = ref - lo, v = subexpfin(n, k);
        return lo + ((r << 1) <= n ? inv_recenter_nonneg(r, v) : n - 1 - inv_recenter_nonneg(n - 1 - r, v));
    }

    // read_wiener_filter: taps 0-2 of each direction (chroma's 5-tap filter
    // has no tap 0), mirrored, the centre making the sum 0
    void read_wiener(int p, LrUnit& u) {
        LrUnit& ref = lr_ref[p];
        for (int dir = 0; dir < 2; dir++) {
            int16_t* f = dir ? u.hfilter : u.vfilter;
            const int16_t* rf = dir ? ref.hfilter : ref.vfilter;
            f[0] = (int16_t)(p ? 0 : refsubexpfin(-5, 10, 1, rf[0]));
            f[1] = (int16_t)refsubexpfin(-23, 8, 2, rf[1]);
            f[2] = (int16_t)refsubexpfin(-17, 46, 3, rf[2]);
            f[6] = f[0];
            f[5] = f[1];
            f[4] = f[2];
            f[3] = (int16_t)(-2 * (f[0] + f[1] + f[2]));
        }
        memcpy(ref.vfilter, u.vfilter, sizeof u.vfilter);
        memcpy(ref.hfilter, u.hfilter, sizeof u.hfilter);
    }

    // read_sgrproj_filter: the set, then the weights its radii use (a set
    // without its first pass codes the second weight; one without its second
    // derives that weight from the first)
    void read_sgrproj(int p, LrUnit& u) {
        LrUnit& ref = lr_ref[p];
        u.ep = lit(4);
        const int32_t* params = av1tab::sgr_params[u.ep];
        if (!params[0]) {
            u.xqd[0] = 0;
            u.xqd[1] = refsubexpfin(-32, 95, 4, ref.xqd[1]);
        } else if (!params[1]) {
            u.xqd[0] = refsubexpfin(-96, 31, 4, ref.xqd[0]);
            u.xqd[1] = clip3(-32, 95, 128 - u.xqd[0]);
        } else {
            u.xqd[0] = refsubexpfin(-96, 31, 4, ref.xqd[0]);
            u.xqd[1] = refsubexpfin(-32, 95, 4, ref.xqd[1]);
        }
        ref.ep = u.ep;
        memcpy(ref.xqd, u.xqd, sizeof u.xqd);
        stats[ST_LR_SGR_SETS + u.ep]++;
    }

    // decode_partition's first step at a superblock: the coefficients of each
    // unit whose top-left corner lies in it (av1_loop_restoration_corners_in_sb,
    // which scales a column by the superres denominator over 8), plane by
    // plane, row by row
    void read_lr(int r, int c, int sb4) {
        const bool scaled = fh.width != fh.upscaled_width;
        for (int p = 0; p < num_planes; p++) {
            const int type = fh.lr_type[p];
            if (!type) continue;
            const int size = fh.lr_unit_size[p], my = 4 >> sub_y(p);
            const int mx = scaled ? (4 >> sub_x(p)) * fh.superres_denom : 4 >> sub_x(p), dx = scaled ? size * 8 : size;
            const int rcol0 = (c * mx + dx - 1) / dx, rrow0 = (r * my + size - 1) / size;
            const int rcol1 = std::min(((c + sb4) * mx + dx - 1) / dx, lr_hunits[p]);
            const int rrow1 = std::min(((r + sb4) * my + size - 1) / size, lr_vunits[p]);
            for (int rr = rrow0; rr < rrow1; rr++)
                for (int rc = rcol0; rc < rcol1; rc++) {
                    LrUnit& u = lr_units[p][(size_t)rr * lr_hunits[p] + rc];
                    if (type == RESTORE_SWITCHABLE)
                        u.type = sym(cdf.switchable_restore, 3);
                    else if (type == RESTORE_WIENER)
                        u.type = sym(cdf.wiener_restore, 2) ? RESTORE_WIENER : RESTORE_NONE;
                    else
                        u.type = sym(cdf.sgrproj_restore, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
                    if (u.type == RESTORE_WIENER) read_wiener(p, u);
                    if (u.type == RESTORE_SGRPROJ) read_sgrproj(p, u);
                    stats[ST_LR_UNITS + p * 3 + u.type]++;
                }
        }
    }

    void read_cdef() {
        if (b->skip || fh.coded_lossless || !s.enable_cdef || fh.allow_intrabc) return;
        const int r = mi_row & ~15, c = mi_col & ~15;
        int8_t& idx = cdef_idx[(size_t)(r >> 4) * cdef_cols + (c >> 4)];
        if (idx != -1) return;
        const int v = lit(fh.cdef_bits);
        for (int y = r; y < std::min(r + bh4, mi_rows); y += 16)
            for (int x = c; x < std::min(c + bw4, mi_cols); x += 16) cdef_idx[(size_t)(y >> 4) * cdef_cols + (x >> 4)] = (int8_t)v;
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
            current_q = clip3(1, 255, current_q + reduced * (1 << fh.delta_q_res));
            stats[ST_DELTA_Q]++;
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
                delta_lf[i] = clip3(-63, 63, delta_lf[i] + reduced * (1 << fh.delta_lf_res));
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
        if (has_chroma && b->uvmode == DC_PRED) {
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
        // a sub-8x8 block's chroma reaches 4 luma samples left or up of it
        if (has_chroma) {
            if (bw < 8 && s.ss_x && src_left < tile_left + 4 * 8) return false;
            if (bh < 8 && s.ss_y && src_top < tile_top + 4 * 8) return false;
        }
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

    // the prediction of each plane's block from the current frame: the
    // luma displacement halved in a subsampled plane, whose half samples
    // av1_convolve_2d_sr_intrabc averages ((a + b + 1) >> 1 across or
    // down, (a + b + c + d + 2) >> 2 both ways)
    void predict_intrabc() {
        for (int p = 0; p < (has_chroma ? num_planes : 1); p++) {
            const int pbs = plane_bsize(p);
            const int x0 = (mi_col >> sub_x(p)) * 4, y0 = (mi_row >> sub_y(p)) * 4, w = kBw4[pbs] * 4, h = kBh4[pbs] * 4;
            const int dx16 = (2 * b->mv_col) >> sub_x(p), dy16 = (2 * b->mv_row) >> sub_y(p);  // 1/16 samples
            const int dx = dx16 >> 4, dy = dy16 >> 4, fx = dx16 & 15, fy = dy16 & 15;
            if (fx || fy) stats[ST_CHROMA_SUBPEL_DV]++;
            for (int i = 0; i < h; i++) {
                uint8_t* d = px(p, y0 + i, x0);
                const uint8_t* a = px(p, y0 + i + dy, x0 + dx);
                const uint8_t* c = px(p, y0 + i + dy + 1, x0 + dx);
                if (!fx && !fy) {
                    memmove(d, a, (size_t)w);
                } else if (!fy) {
                    for (int j = 0; j < w; j++) d[j] = (uint8_t)((a[j] + a[j + 1] + 1) >> 1);
                } else if (!fx) {
                    for (int j = 0; j < w; j++) d[j] = (uint8_t)((a[j] + c[j] + 1) >> 1);
                } else {
                    for (int j = 0; j < w; j++) d[j] = (uint8_t)((a[j] + a[j + 1] + c[j] + c[j + 1] + 2) >> 2);
                }
            }
        }
    }

    // -- the transform size (decodemv.c / decodeframe.c) ----------------------------------------
    static int sqr_tx_size_of(int side) {  // get_sqr_tx_size
        return side >= 64 ? TX_64X64 : side == 32 ? TX_32X32 : side == 16 ? TX_16X16 : side == 8 ? TX_8X8 : TX_4X4;
    }

    int max_rect_tx() const { return av1tab::max_txsize_rect_lookup[bsize]; }

    // read_selected_tx_size: a depth below the largest rectangle, its
    // context from the txfm contexts above and left (a block size where the
    // neighbour is an IntraBC block)
    int read_selected_tx_size() {
        const int max_tx = max_rect_tx();
        int depth_max = 0, cat = 0;
        for (int t = max_tx; t != TX_4X4; t = av1tab::sub_tx_size_map[t]) {
            if (depth_max < 2) depth_max++;
            cat++;
        }
        cat -= 1;
        const int max_w = kTxW[max_tx], max_h = kTxH[max_tx];
        int above = above_txfm[mi_col] >= max_w, left = left_txfm[mi_row & 31] >= max_h;
        if (avail_u && at(mi_row - 1, mi_col).intrabc) above = kBw4[at(mi_row - 1, mi_col).bsize] * 4 >= max_w;
        if (avail_l && at(mi_row, mi_col - 1).intrabc) left = kBh4[at(mi_row, mi_col - 1).bsize] * 4 >= max_h;
        int ctx = avail_u && avail_l ? above + left : avail_u ? above : avail_l ? left : 0;
        int depth = sym(cdf.tx_size[cat][ctx], depth_max + 1);
        int t = max_tx;
        for (int d = 0; d < depth; d++) t = av1tab::sub_tx_size_map[t];
        return t;
    }

    void set_txfm_ctx(int tx_w, int tx_h) {  // set_txfm_ctxs
        for (int i = 0; i < bw4; i++) above_txfm[mi_col + i] = (uint8_t)tx_w;
        for (int i = 0; i < bh4; i++) left_txfm[(mi_row & 31) + i] = (uint8_t)tx_h;
    }

    // read_tx_size_vartx: the split flags of an IntraBC block's transform
    // tree, at most two levels below the largest rectangle
    void read_vartx(int t, int depth, int row, int col) {
        if (row >= max_blocks_h || col >= max_blocks_w) return;
        const int w4 = kTxW[t] >> 2, h4 = kTxH[t] >> 2;
        auto leaf = [&](int size, int update_as) {
            for (int y = row; y < std::min(row + (kTxH[update_as] >> 2), 32); y++)
                for (int x = col; x < std::min(col + (kTxW[update_as] >> 2), 32); x++) vartx[y][x] = (uint8_t)size;
            tx_size = size;
            for (int i = 0; i < (kTxW[update_as] >> 2); i++) above_txfm[mi_col + col + i] = (uint8_t)kTxW[size];
            for (int i = 0; i < (kTxH[update_as] >> 2); i++) left_txfm[((mi_row + row) & 31) + i] = (uint8_t)kTxH[size];
        };
        if (depth == 2) {
            leaf(t, t);
            return;
        }
        // txfm_partition_context
        int above = above_txfm[mi_col + col] < kTxW[t], left = left_txfm[(mi_row + row) & 31] < kTxH[t];
        int max_sqr = sqr_tx_size_of(std::max(bw4, bh4) * 4);
        int category = (av1tab::txsize_sqr_up_map[t] != max_sqr && max_sqr > TX_8X8) + (TX_64X64 - max_sqr) * 2;
        int ctx = category * 3 + above + left;
        if (sym(cdf.txfm_partition[ctx], 2)) {
            stats[ST_VARTX_SPLIT]++;
            const int sub = av1tab::sub_tx_size_map[t];
            if (sub == TX_4X4) {
                leaf(sub, t);
                return;
            }
            const int sw4 = kTxW[sub] >> 2, sh4 = kTxH[sub] >> 2;
            for (int y = 0; y < h4; y += sh4)
                for (int x = 0; x < w4; x += sw4) read_vartx(sub, depth + 1, row + y, col + x);
        } else {
            leaf(t, t);
        }
    }

    // the transform size syntax of parse_decode_block
    void read_block_tx_size() {
        const bool lossless = fh.lossless[b->seg_id], select = fh.tx_mode_select;
        if (b->intrabc && select && bsize > BLOCK_4X4 && !b->skip && !lossless) {
            const int max_tx = max_rect_tx();
            const int w4 = kTxW[max_tx] >> 2, h4 = kTxH[max_tx] >> 2;
            for (int y = 0; y < bh4; y += h4)
                for (int x = 0; x < bw4; x += w4) read_vartx(max_tx, 0, y, x);
            return;
        }
        if (lossless) {
            tx_size = TX_4X4;
        } else if (bsize > BLOCK_4X4 && select && (!b->intrabc || !b->skip)) {
            tx_size = read_selected_tx_size();
        } else {
            tx_size = max_rect_tx();  // tx_size_from_tx_mode (TX_MODE_LARGEST, or an IntraBC block that skips)
        }
        for (int y = 0; y < bh4; y++)
            for (int x = 0; x < bw4; x++) vartx[y][x] = (uint8_t)tx_size;
        b->tx_size = (int8_t)tx_size;
        if (b->skip && b->intrabc)
            set_txfm_ctx(bw4 * 4, bh4 * 4);
        else
            set_txfm_ctx(kTxW[tx_size], kTxH[tx_size]);
    }

    // the block's quantisers: its qindex (the superblock's delta and the
    // segment's), the 8-bit dc / ac lookups with the plane's deltas, and the
    // quantiser matrix level where one applies
    void set_dequant() {
        const int seg = b->seg_id;
        int q = fh.delta_q_present ? current_q : fh.base_q_idx;
        if (fh.seg_enabled && fh.feature_enabled[seg][0]) q = clip3(0, 255, q + fh.feature_data[seg][0]);
        const int dc_delta[3] = {fh.dq_ydc, fh.dq_udc, fh.dq_vdc}, ac_delta[3] = {0, fh.dq_uac, fh.dq_vac};
        for (int p = 0; p < num_planes; p++) {
            dequant[p][0] = av1tab::dc_qlookup[clip3(0, 255, q + dc_delta[p])];
            dequant[p][1] = av1tab::ac_qlookup[clip3(0, 255, q + ac_delta[p])];
            qm_level[p] = (fh.using_qmatrix && !fh.lossless[seg]) ? fh.qm_level[p] : 15;
        }
    }

    // -- residual: transform blocks by 64x64 chunk and plane (decode_token_recon_block) ---------
    int plane_tx_size(int p) const {  // av1_get_tx_size: chroma takes the largest size of its block, capped at 32
        if (fh.lossless[b->seg_id]) return TX_4X4;
        if (p == 0) return tx_size;
        return adjusted_tx_size(av1tab::max_txsize_rect_lookup[plane_bsize(p)]);
    }

    // by 64x64 luma chunk, each plane's transform blocks in the chunk's part
    // of the plane's block (x, y in the plane's 4-sample units)
    void residual() {
        const int width_chunks = std::max(1, bw4 >> 4), height_chunks = std::max(1, bh4 >> 4);
        const bool lossless = fh.lossless[b->seg_id];
        for (int cy = 0; cy < height_chunks; cy++)
            for (int cx = 0; cx < width_chunks; cx++)
                for (int p = 0; p < (has_chroma ? num_planes : 1); p++) {
                    if (b->intrabc && !lossless && !b->skip && p == 0) {
                        const int t = max_rect_tx();
                        const int w4 = kTxW[t] >> 2, h4 = kTxH[t] >> 2;
                        for (int y = cy * 16; y < std::min(bh4, cy * 16 + 16); y += h4)
                            for (int x = cx * 16; x < std::min(bw4, cx * 16 + 16); x += w4) transform_tree(t, x, y);
                        continue;
                    }
                    const int t = plane_tx_size(p), pbs = plane_bsize(p);
                    const int step_x = kTxW[t] >> 2, step_y = kTxH[t] >> 2;
                    const int ox = (cx * 16) >> sub_x(p), oy = (cy * 16) >> sub_y(p);
                    const int nw = std::min<int>(kBw4[pbs], 16 >> sub_x(p)), nh = std::min<int>(kBh4[pbs], 16 >> sub_y(p));
                    for (int y = 0; y < nh; y += step_y)
                        for (int x = 0; x < nw; x += step_x) transform_block(p, t, x + ox, y + oy);
                }
    }

    // decode_reconstruct_tx: an IntraBC block's luma down its var-tx tree
    void transform_tree(int t, int x, int y) {
        if (y >= max_blocks_h || x >= max_blocks_w) return;
        if (t == vartx[y][x]) {
            transform_block(0, t, x, y);
            return;
        }
        const int sub = av1tab::sub_tx_size_map[t];
        const int sw4 = kTxW[sub] >> 2, sh4 = kTxH[sub] >> 2;
        const int row_end = std::min(kTxH[t] >> 2, max_blocks_h - y), col_end = std::min(kTxW[t] >> 2, max_blocks_w - x);
        for (int r = 0; r < row_end; r += sh4)
            for (int c = 0; c < col_end; c += sw4) transform_tree(sub, x + c, y + r);
    }

    // one transform block of plane p at (x4, y4), in the plane's 4-sample
    // units from the block's origin in the plane (a group's origin for the
    // chroma of a sub-8x8 block)
    void transform_block(int p, int t, int x4, int y4) {
        const int sx = sub_x(p), sy = sub_y(p);
        const int start_x = (mi_col >> sx) * 4 + x4 * 4, start_y = (mi_row >> sy) * 4 + y4 * 4;
        if (start_x >= ((mi_cols * 4) >> sx) || start_y >= ((mi_rows * 4) >> sy)) return;
        const int w = kTxW[t], h = kTxH[t], step_x = w >> 2, step_y = h >> 2;
        const int sbr = (((start_y << sy) >> 2) & sb_mask) >> sy, sbc = (((start_x << sx) >> 2) & sb_mask) >> sx;
        stats[ST_TX_SIZE + t]++;
        if (p) stats[ST_UV_TX_SIZE + t]++;
        if (!b->intrabc) {
            if (b->pal_size[p != 0]) {
                uint8_t (*map)[64] = p ? map_uv : map_y;
                for (int i = 0; i < h; i++)
                    for (int j = 0; j < w; j++) *px(p, start_y + i, start_x + j) = b->pal[p][map[y4 * 4 + i][x4 * 4 + j]];
            } else {
                const bool is_cfl = p > 0 && b->uvmode == UV_CFL_PRED;
                const int mode = p == 0 ? (int)b->ymode : (is_cfl ? (int)DC_PRED : (int)b->uvmode);
                const bool have_left = (p ? avail_l_c : avail_l) || x4 > 0, have_above = (p ? avail_u_c : avail_u) || y4 > 0;
                const bool have_ar = decoded[p][sbr - 1 + 1][sbc + step_x + 1];
                const bool have_bl = decoded[p][sbr + step_y + 1][sbc - 1 + 1];
                predict_intra(p, start_x, start_y, t, have_left, have_above, have_ar, have_bl, mode);
                if (is_cfl) predict_cfl(p, start_x, start_y, w, h);
            }
        }
        if (!b->skip) {
            int eob = coeffs(p, t, x4, y4);
            if (eob > 0) {
                stats[ST_RESIDUAL]++;
                if (fh.lossless[b->seg_id])
                    reconstruct_wht(p, start_x, start_y, eob);
                else
                    inverse_transform_add(coef, t, cur_tx_type, px(p, start_y, start_x), stride);
            }
        }
        // store_cfl_required: a block without chroma always keeps its luma, one with it where it predicts by CFL
        if (p == 0 && num_planes > 1 && !b->intrabc && (!has_chroma || b->uvmode == UV_CFL_PRED))
            cfl_store(start_x, start_y, x4, y4, w, h);
        for (int i = 0; i < step_y; i++)
            for (int j = 0; j < step_x; j++) decoded[p][sbr + i + 1][sbc + j + 1] = 1;
    }

    // -- intra prediction (reconintra.c), at the transform size ---------------------------------
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

    void predict_intra(int p, int x, int y, int t, bool have_left, bool have_above, bool have_ar, bool have_bl,
                       int mode) {
        const int w = kTxW[t], h = kTxH[t];
        int pred[64][64];
        int sub_x = p ? s.ss_x : 0, sub_y = p ? s.ss_y : 0;
        int max_x = ((mi_cols * 4) >> sub_x) - 1, max_y = ((mi_rows * 4) >> sub_y) - 1;
        int above_buf[160], left_buf[160];
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
        if (p == 0 && use_filter_intra) {
            filter_intra(above, left, w, h, pred);
        } else if (mode >= V_PRED && mode <= D67_PRED) {
            directional(p, x, y, w, h, have_left, have_above, mode, above, left, max_x, max_y, pred);
        } else if (mode == SMOOTH_PRED) {
            const uint8_t* wh = av1tab::smooth_weights + h - 4;
            const uint8_t* ww = av1tab::smooth_weights + w - 4;
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int v = wh[i] * above[j] + (256 - wh[i]) * left[h - 1] + ww[j] * left[i] + (256 - ww[j]) * above[w - 1];
                    pred[i][j] = round2(v, 9);
                }
        } else if (mode == SMOOTH_V_PRED) {
            const uint8_t* wh = av1tab::smooth_weights + h - 4;
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) pred[i][j] = round2(wh[i] * above[j] + (256 - wh[i]) * left[h - 1], 8);
        } else if (mode == SMOOTH_H_PRED) {
            const uint8_t* ww = av1tab::smooth_weights + w - 4;
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) pred[i][j] = round2(ww[j] * left[i] + (256 - ww[j]) * above[w - 1], 8);
        } else if (mode == DC_PRED) {
            int avg;
            if (have_left && have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                for (int k = 0; k < h; k++) sum += left[k];
                if (w == h) {
                    avg = (sum + w) >> (log2i(w) + 1);
                } else {  // dc_predictor_rect: a multiply and shift for 1:2 and 1:4
                    int shift1 = log2i(std::min(w, h));
                    int mult = (std::max(w, h) == 2 * std::min(w, h)) ? 0x5556 : 0x3334;
                    avg = (((sum + ((w + h) >> 1)) >> shift1) * mult) >> 16;
                }
            } else if (have_left) {
                int sum = 0;
                for (int k = 0; k < h; k++) sum += left[k];
                avg = (sum + (h >> 1)) >> log2i(h);
            } else if (have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                avg = (sum + (w >> 1)) >> log2i(w);
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

    // av1_filter_intra_predictor_c: the recursive filter on 4x2 cells
    void filter_intra(const int* above, const int* left, int w, int h, int (*pred)[64]) {
        int buf[33][33];
        for (int r = 0; r < h; r++) buf[r + 1][0] = left[r];
        for (int c = 0; c <= w; c++) buf[0][c] = above[c - 1];
        for (int r = 1; r < h + 1; r += 2)
            for (int c = 1; c < w + 1; c += 4) {
                const int pv[7] = {buf[r - 1][c - 1], buf[r - 1][c], buf[r - 1][c + 1], buf[r - 1][c + 2],
                                   buf[r - 1][c + 3], buf[r][c - 1], buf[r + 1][c - 1]};
                for (int k = 0; k < 8; k++) {
                    int pr = 0;
                    for (int t = 0; t < 7; t++) pr += av1tab::filter_intra_taps[filter_mode][k][t] * pv[t];
                    buf[r + (k >> 2)][c + (k & 3)] = clip3(0, 255, round2signed(pr, 4));
                }
            }
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) pred[r][c] = buf[r + 1][c + 1];
    }

    // get_intra_edge_filter_type: the above and left blocks, for chroma the
    // ones that carry the chroma above and left of the block's chroma
    // (xd->chroma_above_mbmi / chroma_left_mbmi)
    int filter_type(int p) const {
        bool above_smooth = false, left_smooth = false;
        if (p ? avail_u_c : avail_u) {
            int r = mi_row - 1, c = mi_col;
            if (p && s.ss_x && !(mi_col & 1)) c++;
            if (p && s.ss_y && (mi_row & 1)) r--;
            above_smooth = is_smooth(r, c, p);
        }
        if (p ? avail_l_c : avail_l) {
            int r = mi_row, c = mi_col - 1;
            if (p && s.ss_x && (mi_col & 1)) c--;
            if (p && s.ss_y && !(mi_row & 1)) r++;
            left_smooth = is_smooth(r, c, p);
        }
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
        int edge[160];
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
        int dup[40];
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

    void directional(int p, int x, int y, int w, int h, bool have_left, bool have_above, int mode, int* above,
                     int* left, int max_x, int max_y, int (*pred)[64]) {
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

    // -- chroma from luma (cfl.c): the reconstructed luma, subsampled ----------------------------
    // cfl_store_tx / cfl_store_block: the w x h luma at (x, y), the
    // transform's (col4, row4) in the block moved one unit right / down for
    // the second block of a sub-8x8 group (sub8x8_adjust_offset), averaged
    // over 2x2 (4:2:0) or 2x1 (4:2:2) samples, in 1/8 units
    void cfl_store(int x, int y, int col4, int row4, int w, int h) {
        const int sx = s.ss_x, sy = s.ss_y;
        if (bw4 == 1 || bh4 == 1) {
            if ((mi_row & 1) && sy) row4++;
            if ((mi_col & 1) && sx) col4++;
        }
        const int row = row4 << (2 - sy), col = col4 << (2 - sx), sh = h >> sy, sw = w >> sx;
        if (col4 == 0 && row4 == 0) {
            cfl_w = sw;
            cfl_h = sh;
        } else {
            cfl_w = std::max(col + sw, cfl_w);
            cfl_h = std::max(row + sh, cfl_h);
        }
        for (int i = 0; i < sh; i++)
            for (int j = 0; j < sw; j++) {
                const uint8_t* l = px(0, y + (i << sy), x + (j << sx));
                int v;
                if (sx && sy)
                    v = (l[0] + l[1] + l[stride] + l[stride + 1]) << 1;
                else if (sx)
                    v = (l[0] + l[1]) << 2;
                else
                    v = l[0] << 3;
                cfl_q3[row + i][col + j] = (uint16_t)v;
            }
    }

    void predict_cfl(int p, int x, int y, int w, int h) {
        // cfl_pad: the columns and rows past what the luma wrote repeat its last
        if (w > cfl_w) {
            for (int i = 0; i < cfl_h; i++)
                for (int j = cfl_w; j < w; j++) cfl_q3[i][j] = cfl_q3[i][cfl_w - 1];
            cfl_w = w;
        }
        if (h > cfl_h) {
            for (int i = cfl_h; i < h; i++)
                for (int j = 0; j < w; j++) cfl_q3[i][j] = cfl_q3[cfl_h - 1][j];
            cfl_h = h;
        }
        const int alpha = p == 1 ? cfl_u : cfl_v;
        if (s.ss_x || s.ss_y) stats[ST_CFL_SUBSAMPLED]++;
        const int num_pel_log2 = log2i(w) + log2i(h);
        int sum = 1 << (num_pel_log2 - 1);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) sum += cfl_q3[i][j];
        const int avg = sum >> num_pel_log2;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                uint8_t* d = px(p, y + i, x + j);
                *d = clip_pixel(*d + round2signed(alpha * (cfl_q3[i][j] - avg), 6));
            }
    }

    // -- coefficients (decodetxb.c) ----------------------------------------------------------------
    // the transform type (av1_read_tx_type for luma, av1_get_tx_type)
    int read_tx_type(int t, int x4, int y4) {
        const int seg = b->seg_id;
        uint8_t& slot = tx_type_map[(size_t)(mi_row + y4) * mi_cols + (mi_col + x4)];
        slot = DCT_DCT;
        const bool inter = b->intrabc;
        const int set_type = ext_tx_set_type(t, inter);
        if (!(fh.seg_enabled && fh.feature_enabled[seg][6]) && qindex_of(fh, seg) != 0 &&
            av1tab::num_ext_tx_set[set_type] > 1) {
            const int eset = av1tab::ext_tx_set_index[inter][set_type];
            const int sq = av1tab::txsize_sqr_map[t];
            int symbol;
            if (inter) {
                symbol = sym(cdf.inter_ext_tx[eset][sq], av1tab::num_ext_tx_set[set_type]);
            } else {
                const int mode = use_filter_intra ? av1tab::fimode_to_intradir[filter_mode] : b->ymode;
                symbol = sym(cdf.intra_ext_tx[eset][sq][mode], av1tab::num_ext_tx_set[set_type]);
            }
            slot = av1tab::ext_tx_inv[set_type][symbol];
        }
        return slot;
    }

    int ext_tx_set_type(int t, bool inter) const {  // av1_get_ext_tx_set_type
        const int up = av1tab::txsize_sqr_up_map[t];
        if (up > TX_32X32) return 0;  // EXT_TX_SET_DCTONLY
        if (up == TX_32X32) return inter ? 1 : 0;  // EXT_TX_SET_DCT_IDTX
        if (fh.reduced_tx_set) return inter ? 1 : 2;  // EXT_TX_SET_DTT4_IDTX
        return av1tab::ext_tx_set_lookup[inter][av1tab::txsize_sqr_map[t] == TX_16X16];
    }

    // x4, y4: the transform's position in the plane's 4-sample units from
    // the block's origin in the plane; an IntraBC block's chroma takes the
    // luma type at the luma position they scale to
    int get_tx_type(int p, int t, int x4, int y4) {
        if (fh.lossless[b->seg_id] || av1tab::txsize_sqr_up_map[t] > TX_32X32) return DCT_DCT;
        const int luma = tx_type_map[(size_t)(mi_row + (y4 << sub_y(p))) * mi_cols + (mi_col + (x4 << sub_x(p)))];
        if (p == 0) return luma;
        int type = b->intrabc ? luma : av1tab::intra_mode_to_tx_type[b->uvmode == UV_CFL_PRED ? (int)DC_PRED : (int)b->uvmode];
        if (!av1tab::ext_tx_used[ext_tx_set_type(t, b->intrabc)][type]) type = DCT_DCT;
        return type;
    }

    // av1_read_coeffs_txb with get_txb_ctx and av1_set_entropy_contexts:
    // fills ``coef`` (dequantised, libaom's layout) and ``cur_tx_type``;
    // returns the eob
    int coeffs(int p, int t, int x4, int y4) {
        const int ax = (mi_col >> sub_x(p)) + x4, ly = (mi_row >> sub_y(p)) + y4;  // the plane's 4-sample units
        const int pbs = plane_bsize(p);
        const int w4 = kTxW[t] >> 2, h4 = kTxH[t] >> 2;
        const int ptype = p > 0;
        const uint8_t* a = &above_ctx[p][ax];
        const uint8_t* l = &left_ctx[p][ly];
        // get_txb_ctx
        int dc_sum = 0;
        for (int k = 0; k < w4; k++) dc_sum += (a[k] >> 3) == 1 ? -1 : (a[k] >> 3) == 2 ? 1 : 0;
        for (int k = 0; k < h4; k++) dc_sum += (l[k] >> 3) == 1 ? -1 : (l[k] >> 3) == 2 ? 1 : 0;
        const int dc_ctx = dc_sum < 0 ? 1 : dc_sum > 0 ? 2 : 0;
        int skip_ctx;
        if (p == 0) {
            if (bw4 == w4 && bh4 == h4) {
                skip_ctx = 0;
            } else {
                static const uint8_t skip_contexts[5][5] = {
                    {1, 2, 2, 2, 3}, {2, 4, 4, 4, 5}, {2, 4, 4, 4, 5}, {2, 4, 4, 4, 5}, {3, 5, 5, 5, 6}};
                int top = 0, left = 0;
                for (int k = 0; k < w4; k++) top |= a[k];
                for (int k = 0; k < h4; k++) left |= l[k];
                skip_ctx = skip_contexts[std::min(top & 7, 4)][std::min(left & 7, 4)];
            }
        } else {
            int above_ec = 0, left_ec = 0;
            for (int k = 0; k < w4; k++) above_ec |= a[k] != 0;
            for (int k = 0; k < h4; k++) left_ec |= l[k] != 0;
            skip_ctx = above_ec + left_ec + (kBw4[pbs] * kBh4[pbs] > w4 * h4 ? 10 : 7);
        }
        const int txs_ctx = (av1tab::txsize_sqr_map[t] + av1tab::txsize_sqr_up_map[t] + 1) >> 1;
        const int adj = adjusted_tx_size(t);
        const int cw = kTxW[adj], ch = kTxH[adj];
        int bhl = log2i(ch);
        int all_zero = sym(cdf.txb_skip[txs_ctx][skip_ctx], 2);
        int cul = 0, dc_val = 0, eob = 0;
        if (all_zero) {
            if (p == 0) tx_type_map[(size_t)ly * mi_cols + ax] = DCT_DCT;
        } else {
            if (p == 0) read_tx_type(t, x4, y4);
            cur_tx_type = get_tx_type(p, t, x4, y4);
            stats[ST_TX_TYPE + cur_tx_type]++;
            const int cls = tx_class(cur_tx_type);
            const int scan_kind = cls == TX_CLASS_2D ? 0 : cls == TX_CLASS_VERT ? 1 : 2;
            const int16_t* scan = av1tab::scan_data + av1tab::scan_start[t][scan_kind];
            const int8_t* nz_offset = av1tab::nz_map_ctx_offset_data + av1tab::nz_map_ctx_offset_start[t];
            // the eob
            const int eob_ctx = cls == TX_CLASS_2D ? 0 : 1;
            int eob_pt;
            switch (log2i(cw * ch) - 4) {
                case 0: eob_pt = sym(cdf.eob16[ptype][eob_ctx], 5) + 1; break;
                case 1: eob_pt = sym(cdf.eob32[ptype][eob_ctx], 6) + 1; break;
                case 2: eob_pt = sym(cdf.eob64[ptype][eob_ctx], 7) + 1; break;
                case 3: eob_pt = sym(cdf.eob128[ptype][eob_ctx], 8) + 1; break;
                case 4: eob_pt = sym(cdf.eob256[ptype][eob_ctx], 9) + 1; break;
                case 5: eob_pt = sym(cdf.eob512[ptype][eob_ctx], 10) + 1; break;
                default: eob_pt = sym(cdf.eob1024[ptype][eob_ctx], 11) + 1; break;
            }
            const int offset_bits = av1tab::eob_offset_bits[eob_pt];
            int eob_extra = 0;
            if (offset_bits > 0) {
                if (sym(cdf.eob_extra[txs_ctx][ptype][eob_pt - 3], 2)) eob_extra += 1 << (offset_bits - 1);
                for (int i = 1; i < offset_bits; i++)
                    if (lit(1)) eob_extra += 1 << (offset_bits - 1 - i);
            }
            eob = av1tab::eob_group_start[eob_pt];
            if (eob > 2) eob += eob_extra;
            // the levels, in reverse scan order, on a padded column-major grid
            const int stride_l = ch + 4;
            memset(levels, 0, sizeof(uint8_t) * (size_t)stride_l * (cw + 4));
            auto lv_at = [&](int pos) -> uint8_t& { return levels[(pos >> bhl) * stride_l + (pos & (ch - 1))]; };
            const int br_txs = std::min(txs_ctx, 3);
            for (int c = eob - 1; c >= 0; c--) {
                const int pos = scan[c];
                const int col = pos >> bhl, row = pos & (ch - 1);
                const uint8_t* lv = &levels[col * stride_l + row];
                int level;
                if (c == eob - 1) {
                    const int area = cw * ch;
                    const int ctx = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
                    level = sym(cdf.base_eob[txs_ctx][ptype][ctx], 3) + 1;
                } else {
                    int ctx;
                    if (cls == TX_CLASS_2D && pos == 0) {
                        ctx = 0;
                    } else {
                        int mag = std::min<int>(lv[stride_l], 3) + std::min<int>(lv[1], 3);
                        if (cls == TX_CLASS_2D)
                            mag += std::min<int>(lv[stride_l + 1], 3) + std::min<int>(lv[2 * stride_l], 3) +
                                   std::min<int>(lv[2], 3);
                        else if (cls == TX_CLASS_VERT)
                            mag += std::min<int>(lv[2], 3) + std::min<int>(lv[3], 3) + std::min<int>(lv[4], 3);
                        else
                            mag += std::min<int>(lv[2 * stride_l], 3) + std::min<int>(lv[3 * stride_l], 3) +
                                   std::min<int>(lv[4 * stride_l], 3);
                        ctx = std::min((mag + 1) >> 1, 4);
                        if (cls == TX_CLASS_2D)
                            ctx += nz_offset[pos];
                        else
                            ctx += av1tab::nz_map_ctx_offset_1d[cls == TX_CLASS_HORIZ ? col : row];
                    }
                    level = sym(cdf.base[txs_ctx][ptype][ctx], 4);
                }
                if (level > 2) {
                    int br_ctx;
                    if (c == eob - 1) {  // get_br_ctx_eob
                        br_ctx = pos == 0 ? 0
                                 : ((cls == TX_CLASS_2D && row < 2 && col < 2) || (cls == TX_CLASS_HORIZ && col == 0) ||
                                    (cls == TX_CLASS_VERT && row == 0))
                                     ? 7
                                     : 14;
                    } else {  // get_br_ctx
                        int mag = lv[1] + lv[stride_l];
                        bool near;
                        if (cls == TX_CLASS_2D) {
                            mag += lv[stride_l + 1];
                            near = row < 2 && col < 2;
                        } else if (cls == TX_CLASS_HORIZ) {
                            mag += lv[2 * stride_l];
                            near = col == 0;
                        } else {
                            mag += lv[2];
                            near = row == 0;
                        }
                        mag = std::min((mag + 1) >> 1, 6);
                        br_ctx = pos == 0 ? mag : near ? mag + 7 : mag + 14;
                    }
                    for (int idx = 0; idx < 4; idx++) {
                        const int k = sym(cdf.br[br_txs][ptype][br_ctx], 4);
                        level += k;
                        if (k < 3) break;
                    }
                }
                lv_at(pos) = (uint8_t)level;
            }
            // signs, Golomb remainders and dequantisation, in scan order
            const int tx_area = kTxW[t] * kTxH[t];
            const int scale = (tx_area > 256) + (tx_area > 1024);
            const uint8_t* qm = nullptr;
            if (qm_level[p] < 15 && cur_tx_type < IDTX) {
                qm = &av1tab::iwt_matrix[qm_level[p]][p > 0][av1tab::qm_start[t]];
                stats[ST_QM]++;
            }
            std::fill(coef, coef + cw * ch, 0);
            for (int c = 0; c < eob; c++) {
                const int pos = scan[c];
                int level = lv_at(pos);
                if (!level) continue;
                const int sign = c == 0 ? sym(cdf.dc_sign[ptype][dc_ctx], 2) : lit(1);
                if (level >= 15) {  // read_golomb
                    stats[ST_GOLOMB]++;
                    int length = 0, i = 0;
                    while (!i) {
                        i = lit(1);
                        if (++length > 20) fail(DECODE_ERROR, "Invalid length in read_golomb");
                    }
                    int xg = 1;
                    for (int k = 0; k < length - 1; k++) xg = (xg << 1) + lit(1);
                    level += xg - 1;
                }
                if (c == 0) dc_val = sign ? -level : level;
                level &= 0xFFFFF;
                cul += level;
                int dqv = dequant[p][pos != 0];
                if (qm) dqv = (qm[pos] * dqv + 16) >> 5;
                int dq = (int)(((int64_t)level * dqv) & 0xFFFFFF);
                dq >>= scale;
                if (sign) dq = -dq;
                coef[pos] = clip3(-(1 << 15), (1 << 15) - 1, dq);
            }
        }
        int ctx_byte = std::min(cul, 7);
        if (dc_val < 0)
            ctx_byte |= 1 << 3;
        else if (dc_val > 0)
            ctx_byte += 2 << 3;
        // av1_set_entropy_contexts: past the frame's last 4x4 column or row
        // (max_block_wide / max_block_high of the plane's block), 0
        int pw = kBw4[pbs] * 4, ph = kBh4[pbs] * 4;
        if (mi_col + bw4 > mi_cols) pw += ((mi_cols - bw4 - mi_col) * 32) >> (3 + sub_x(p));
        if (mi_row + bh4 > mi_rows) ph += ((mi_rows - bh4 - mi_row) * 32) >> (3 + sub_y(p));
        const int blocks_w = pw >> 2, blocks_h = ph >> 2;
        for (int k = 0; k < w4; k++) above_ctx[p][ax + k] = (uint8_t)(x4 + k < blocks_w ? ctx_byte : 0);
        for (int k = 0; k < h4; k++) left_ctx[p][ly + k] = (uint8_t)(y4 + k < blocks_h ? ctx_byte : 0);
        return eob;
    }

    // -- the inverse Walsh-Hadamard transform of a lossless block (aom_iwht4x4_16_add / _1_add) --
    void reconstruct_wht(int p, int x, int y, int eob) {
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
    // -- the in-loop filters, on the whole frame once its tiles are decoded ---------------------

    // av1_get_filter_level: the block's level for plane p and an edge
    // direction (0 vertical, 1 horizontal): the frame's, with the block's
    // delta_lf, the segment's ALT_LF feature and the intra reference delta
    int filter_level(const BlockInfo& bi, int p, int dir) const {
        int lvl = p == 0 ? fh.loop_filter_level[dir] : fh.loop_filter_level[p + 1];
        if (fh.delta_lf_present) lvl = clip3(0, 63, lvl + bi.delta_lf[fh.delta_lf_multi ? (p == 0 ? dir : p + 1) : 0]);
        const int feature = p == 0 ? 1 + dir : p + 2;  // SEG_LVL_ALT_LF_Y_V, _Y_H, _U, _V
        if (fh.seg_enabled && fh.feature_enabled[bi.seg_id][feature])
            lvl = clip3(0, 63, lvl + fh.feature_data[bi.seg_id][feature]);
        if (fh.lf_delta_enabled) lvl = clip3(0, 63, lvl + fh.lf_ref_deltas[0] * (1 << (lvl >> 5)));  // INTRA_FRAME
        return lvl;
    }

    // get_transform_size: the luma transform, the largest of the chroma
    // block (capped at 32), 4x4 in a lossless segment
    int lf_tx_size(const BlockInfo& bi, int p) const {
        if (fh.lossless[bi.seg_id]) return TX_4X4;
        if (p == 0) return bi.tx_size;
        return adjusted_tx_size(av1tab::max_txsize_rect_lookup[av1tab::ss_size_lookup[bi.bsize][s.ss_x][s.ss_y]]);
    }

    // av1_filter_block_plane_vert / _horz with set_lpf_parameters: walk
    // each 4-sample row (column) of the plane from transform edge to
    // transform edge; an edge inside the plane's visible samples but not on
    // its first column (row) is filtered at the length both sides' transforms
    // allow (4 / 8 / 14 in luma, 4 / 6 in chroma) and the current block's
    // level, or the previous one's where the current is 0. A chroma position
    // reads the block of the odd 4x4 unit, the one that carries the chroma of
    // a group under 8 samples. Intra blocks never spare an edge for skip (an
    // IntraBC frame runs no filter). The filters read and write the decoded
    // samples past the visible ones up to the 8-sample grid.
    void deblock_plane(int p, int dir) {
        const int ssx = sub_x(p), ssy = sub_y(p);
        const int pw = (fh.width + ssx) >> ssx, ph = (fh.height + ssy) >> ssy;
        const int units_x = (mi_cols + ssx) >> ssx, units_y = (mi_rows + ssy) >> ssy;
        const int lines = dir == 0 ? units_y : units_x, span = dir == 0 ? units_x : units_y;
        for (int line = 0; line < lines; line++)
            for (int u = 0; u < span;) {
                const int x = (dir == 0 ? u : line) * 4, y = (dir == 0 ? line : u) * 4;
                int ts = TX_4X4, length = 0, level = 0;
                if (x < pw && y < ph) {
                    const int mr = ssy | ((y << ssy) >> 2), mc = ssx | ((x << ssx) >> 2);
                    const BlockInfo& cur = at(mr, mc);
                    ts = lf_tx_size(cur, p);
                    const int coord = dir == 0 ? x : y, size = dir == 0 ? kTxW[ts] : kTxH[ts];
                    if (!(coord & (size - 1)) && coord) {
                        const BlockInfo& prev = dir == 0 ? at(mr, mc - (1 << ssx)) : at(mr - (1 << ssy), mc);
                        const int pv_ts = lf_tx_size(prev, p);
                        const int cur_level = filter_level(cur, p, dir), pv_level = filter_level(prev, p, dir);
                        if (cur_level || pv_level) {
                            const int dim = std::min(log2i(dir == 0 ? kTxW[ts] : kTxH[ts]), log2i(dir == 0 ? kTxW[pv_ts] : kTxH[pv_ts])) - 2;
                            static const int kLumaLength[5] = {4, 8, 14, 14, 14};
                            length = p ? (dim == 0 ? 4 : 6) : kLumaLength[dim];
                            level = cur_level ? cur_level : pv_level;
                        }
                    }
                }
                if (length) {
                    // update_sharpness and av1_loop_filter_init: the level's limits
                    int limit = level >> ((fh.lf_sharpness > 0) + (fh.lf_sharpness > 4));
                    if (fh.lf_sharpness > 0) limit = std::min(limit, 9 - fh.lf_sharpness);
                    limit = std::max(limit, 1);
                    const ptrdiff_t step = dir == 0 ? 1 : stride, along = dir == 0 ? stride : 1;
                    lpf_segment(px(p, y, x), step, along, length, 2 * (level + 2) + limit, limit, level >> 4);
                    stats[ST_LF_EDGES + p * 4 + (length == 4 ? 0 : length == 6 ? 1 : length == 8 ? 2 : 3)]++;
                }
                u += (dir == 0 ? kTxW[ts] : kTxH[ts]) >> 2;
            }
    }

    // av1_loop_filter_frame: no plane unless a luma level is set; each plane
    // whose level is set, every vertical edge before any horizontal one
    void deblock() {
        if (!fh.loop_filter_level[0] && !fh.loop_filter_level[1]) return;
        for (int p = 0; p < num_planes; p++) {
            if (p && !fh.loop_filter_level[p + 1]) continue;
            deblock_plane(p, 0);
            deblock_plane(p, 1);
        }
    }

    // av1_cdef_frame: by 64x64 unit of its cdef_idx (none where it is
    // unset), the unit's 8x8 blocks with a 4x4 unit that does not skip;
    // luma's direction and variance from the deblocked samples, chroma taking
    // luma's direction (remapped in 4:2:2); every tap reads the deblocked
    // frame, CDEF_VERY_LARGE outside the 8-sample grid of the frame
    void cdef() {
        if (!fh.cdef_bits && !fh.cdef_y_strengths[0] && !fh.cdef_uv_strengths[0]) return;
        if (fh.cdef_bits) stats[ST_CDEF_BITS]++;
        const int B = 2;  // the taps' reach
        std::vector<uint16_t> src[3];
        int sw[3] = {0, 0, 0};
        for (int p = 0; p < num_planes; p++) {
            const int w = (mi_cols * 4) >> sub_x(p), h = (mi_rows * 4) >> sub_y(p);
            sw[p] = w + 2 * B;
            src[p].assign((size_t)sw[p] * (h + 2 * B), kCdefVeryLarge);
            for (int y = 0; y < h; y++) {
                const uint8_t* row = px(p, y, 0);
                std::copy(row, row + w, &src[p][(size_t)(y + B) * sw[p] + B]);
            }
        }
        static const int kConv422[8] = {7, 0, 2, 4, 5, 6, 6, 6}, kConv440[8] = {1, 2, 2, 2, 3, 4, 6, 0};
        for (int fr = 0; fr < (mi_rows + 15) >> 4; fr++)
            for (int fc = 0; fc < cdef_cols; fc++) {
                const int idx = cdef_idx[(size_t)fr * cdef_cols + fc];
                if (idx < 0) {
                    stats[ST_CDEF_UNSET]++;
                    continue;
                }
                int level[2], sec[2];
                for (int t = 0; t < 2; t++) {
                    const int strength = t ? fh.cdef_uv_strengths[idx] : fh.cdef_y_strengths[idx];
                    level[t] = strength >> 2;
                    sec[t] = (strength & 3) + ((strength & 3) == 3);
                }
                if (!level[0] && !sec[0] && !level[1] && !sec[1]) continue;
                for (int r = fr * 16; r < std::min(fr * 16 + 16, mi_rows); r += 2)
                    for (int c = fc * 16; c < std::min(fc * 16 + 16, mi_cols); c += 2) {
                        if (at(r, c).skip && at(r, c + 1).skip && at(r + 1, c).skip && at(r + 1, c + 1).skip) {
                            stats[ST_CDEF_SKIP]++;
                            continue;
                        }
                        int32_t var = 0;
                        const int dir = cdef_find_dir(&src[0][(size_t)(r * 4 + B) * sw[0] + c * 4 + B], sw[0], &var);
                        for (int p = 0; p < num_planes; p++) {
                            const int t = p ? 1 : 0;
                            if (p && !level[t] && !sec[t]) continue;
                            const int ssx = sub_x(p), ssy = sub_y(p);
                            const int pri = p ? level[t] : cdef_adjust_strength(level[t], var);
                            int d = dir;
                            if (p && ssx != ssy) d = (ssx ? kConv422 : kConv440)[dir];
                            const int x0 = (c * 4) >> ssx, y0 = (r * 4) >> ssy;
                            cdef_filter_block(px(p, y0, x0), stride, &src[p][(size_t)(y0 + B) * sw[p] + x0 + B], sw[p], pri,
                                              sec[t], level[t] ? d : 0, fh.cdef_damping - (p > 0), fh.cdef_damping - (p > 0),
                                              8 >> ssx, 8 >> ssy);
                            stats[p ? ST_CDEF_UV : ST_CDEF_Y]++;
                        }
                    }
            }
    }

    // -- loop restoration (restoration.c), on the frame after CDEF ------------------------------
    // Its frame is each plane's visible samples, 3 of them replicated past
    // every edge (av1_extend_frame, RESTORATION_BORDER), not the 8-sample grid.
    // A unit is filtered in processing stripes of 64 rows (>> ss_y), the first
    // of the plane 8 (>> ss_y) rows shorter; a stripe reads, in place of the
    // rows past its top and bottom, two rows of the deblocked frame saved
    // before CDEF (the nearer one twice), except at the top of the plane and
    // the bottom, where it reads the extended frame.

    static constexpr int kLrBorder = 3;  // RESTORATION_BORDER: the samples a filter reads past a unit

    bool lr_on() const { return fh.lr_type[0] || fh.lr_type[1] || fh.lr_type[2]; }

    // save_tile_row_boundary_lines with save_deblock_boundary_lines: for each
    // stripe but the first the two rows above it, and for each but the last
    // the two rows below it (the first twice where it is the plane's last
    // row), each upscaled where superres is on and extended past its ends. libaom saves the frame's first and
    // last rows again after CDEF (save_cdef_boundary_lines) for stripes that
    // never read them: a stripe at the plane's top or bottom reads the
    // extended frame instead.
    void lr_save_boundaries() {
        for (int p = 0; p < num_planes; p++) {
            if (!fh.lr_type[p]) continue;
            const int pw = plane_w(p), ph = plane_h(p), lw = pw + 2 * kLrBorder;
            const int sh = 64 >> sub_y(p), off = 8 >> sub_y(p);
            int stripes = 0;
            while (std::max(0, stripes * sh - off) < ph) stripes++;
            lr_above[p].assign((size_t)stripes * 2 * lw, 0);
            lr_below[p].assign((size_t)stripes * 2 * lw, 0);
            auto save = [&](int y, uint8_t* line) {
                if (fh.width != fh.upscaled_width) {
                    upscale_row(p, px(p, y, 0), line + kLrBorder);
                    stats[ST_SUPERRES_LR_ROWS]++;
                } else {
                    memcpy(line + kLrBorder, px(p, y, 0), (size_t)pw);
                }
                memset(line, line[kLrBorder], kLrBorder);
                memset(line + kLrBorder + pw, line[kLrBorder + pw - 1], kLrBorder);
            };
            for (int st = 0; st < stripes; st++) {
                const int y0 = std::max(0, st * sh - off), y1 = std::min((st + 1) * sh - off, ph);
                uint8_t* above = &lr_above[p][(size_t)st * 2 * lw];
                uint8_t* below = &lr_below[p][(size_t)st * 2 * lw];
                if (st > 0) {
                    save(y0 - 2, above);
                    save(y0 - 1, above + lw);
                }
                if (y1 < ph) {
                    save(y1, below);
                    save(ph - y1 >= 2 ? y1 + 1 : y1, below + lw);
                }
            }
        }
    }

    // av1_loop_restoration_filter_frame: each plane whose type is not NONE,
    // unit by unit (av1_foreach_rest_unit_in_plane: units of the unit size,
    // the last of a row or column up to 1.5 units long, each unit's rows
    // moved up by the stripe offset but the plane's first and last), each
    // unit stripe by stripe (av1_loop_restoration_filter_unit), into a copy
    // of the plane that then replaces it
    void restore() {
        for (int p = 0; p < num_planes; p++) {
            if (!fh.lr_type[p]) continue;
            const int ssx = sub_x(p), ssy = sub_y(p), pw = plane_w(p), ph = plane_h(p);
            const int size = fh.lr_unit_size[p], ext = size * 3 / 2, off = 8 >> ssy, sh = 64 >> ssy;
            stats[ST_LR_UNIT_SIZES + (size == 32 ? 0 : size == 64 ? 1 : size == 128 ? 2 : 3)]++;
            // av1_extend_frame
            const int B = kLrBorder, es = pw + 2 * B;
            std::vector<uint8_t> src((size_t)es * (ph + 2 * B));
            for (int y = -B; y < ph + B; y++) {
                uint8_t* row = &src[(size_t)(y + B) * es];
                memcpy(row + B, px(p, clip3(0, ph - 1, y), 0), (size_t)pw);
                memset(row, row[B], B);
                memset(row + B + pw, row[B + pw - 1], B);
            }
            std::vector<uint8_t> dst((size_t)pw * ph);
            for (int y = 0; y < ph; y++) memcpy(&dst[(size_t)y * pw], px(p, y, 0), (size_t)pw);
            const int lw = pw + 2 * kLrBorder;
            std::vector<uint8_t> win;
            for (int y0 = 0, row = 0; y0 < ph; row++) {
                const int uh = ph - y0 < ext ? ph - y0 : size;
                const int vs = std::max(0, y0 - off), ve = y0 + uh < ph ? y0 + uh - off : ph;
                for (int x0 = 0, col = 0; x0 < pw; col++) {
                    const int uw = pw - x0 < ext ? pw - x0 : size;
                    const LrUnit& u = lr_units[p][(size_t)row * lr_hunits[p] + col];
                    for (int ys = vs; u.type && ys < ve;) {
                        const int fs = (ys + off) / sh;
                        const int nominal = sh - (ys == 0 ? off : 0), h = std::min(nominal, ve - ys);
                        const bool copy_above = ys != 0, copy_below = ys + nominal < ph;
                        // the stripe with B rows and columns around it
                        const int ww = uw + 2 * B;
                        win.resize((size_t)ww * (h + 2 * B));
                        for (int r = -B; r < h + B; r++) {
                            const uint8_t* from;
                            if (r < 0 && copy_above)
                                from = &lr_above[p][((size_t)fs * 2 + std::max(r + 2, 0)) * lw + x0];
                            else if (r >= h && copy_below)
                                from = &lr_below[p][((size_t)fs * 2 + std::min(r - h, 1)) * lw + x0];
                            else
                                from = &src[(size_t)(ys + r + B) * es + x0];
                            memcpy(&win[(size_t)(r + B) * ww], from, (size_t)ww);
                        }
                        stats[ST_LR_STRIPES]++;
                        stats[ST_LR_BOUNDARY] += copy_above + copy_below;
                        const uint8_t* w0 = &win[(size_t)B * ww + B];
                        uint8_t* d0 = &dst[(size_t)ys * pw + x0];
                        // wiener_filter_stripe / sgrproj_filter_stripe: by
                        // processing unit of 64 columns (>> ss_x)
                        for (int j = 0; j < uw; j += 64 >> ssx) {
                            const int w = std::min(64 >> ssx, uw - j);
                            if (u.type == RESTORE_WIENER)
                                wiener_filter(w0 + j, ww, d0 + j, pw, w, h, u.hfilter, u.vfilter);
                            else
                                selfguided_filter(w0 + j, ww, w, h, u.ep, u.xqd, d0 + j, pw);
                        }
                        ys += h;
                    }
                    x0 += uw;
                }
                y0 += uh;
            }
            for (int y = 0; y < ph; y++) memcpy(px(p, y, 0), &dst[(size_t)y * pw], (size_t)pw);
        }
        if (fh.lr_uv_shift) stats[ST_LR_UV_SHIFT]++;
    }

    // -- superres (resize.c): after CDEF, before loop restoration -------------------------------------
    // av1_upscale_normative_rows of one row of plane p: the row as decoded up
    // to the 8-sample grid (av1_superres_upscale's copy keeps the samples
    // past the visible ones), its first and last samples replicated past
    // the frame's edges (upscale_normative_rect pads only there: a tile
    // column reads its neighbours' samples), each tile column upscaled on
    // its own with the phase carried from the one before
    void upscale_row(int p, const uint8_t* in, uint8_t* out) const {
        const int ssx = sub_x(p), down_w = (fh.width + ssx) >> ssx, up_w = (fh.upscaled_width + ssx) >> ssx;
        const int in_w = (mi_cols * 4) >> ssx, pad = 8;
        const int32_t step = superres_step(down_w, up_w);
        int32_t x0 = superres_x0(down_w, up_w, step);
        std::vector<uint8_t> row((size_t)in_w + 2 * pad);
        uint8_t* e = row.data();
        memcpy(e + pad, in, (size_t)in_w);
        memset(e, in[0], pad);
        memset(e + pad + in_w, in[in_w - 1], pad);
        for (int j = 0; j < fh.tile_cols; j++) {
            const int dx0 = fh.mi_col_starts[j] << (2 - ssx), dx1 = fh.mi_col_starts[j + 1] << (2 - ssx);
            const int ux0 = dx0 * fh.superres_denom / 8;
            const int ux1 = j == fh.tile_cols - 1 ? up_w : dx1 * fh.superres_denom / 8;
            convolve_horiz_rs(e + pad + dx0 - 1, out + ux0, ux1 - ux0, x0, step);
            x0 += (ux1 - ux0) * step - ((dx1 - dx0) << kRsBits);
        }
    }

    // av1_superres_upscale: each plane's visible rows into a frame of the
    // upscaled width
    void superres() {
        const int up_stride = ((fh.upscaled_width + 7) & ~7) + 160;
        for (int p = 0; p < num_planes; p++) {
            std::vector<uint8_t> up((size_t)up_stride * rows, 0);
            for (int y = 0; y < plane_h(p); y++) upscale_row(p, px(p, y, 0), &up[(size_t)y * up_stride]);
            plane[p].swap(up);
        }
        stride = up_stride;
        stats[ST_SUPERRES + fh.superres_denom - 9]++;
    }

    // -- film grain (av1_add_film_grain), on the frame as it is output ---------------------------------
    // the luma of an odd width or height extended to even (extend_even), the
    // chroma of the even size, the noise of add_film_grain_run; a
    // monochrome frame is libaom's 4:2:0 image without chroma
    void film_grain() {
        const FilmGrain& g = fh.grain;
        if (!g.apply_grain) return;
        const int w = fh.upscaled_width, h = fh.height, we = w + (w & 1), he = h + (h & 1);
        if (w & 1)
            for (int y = 0; y < h; y++) *px(0, y, w) = *px(0, y, w - 1);
        if (h & 1) memcpy(px(0, h, 0), px(0, h - 1, 0), (size_t)we);
        const int ssx = s.mono ? 1 : s.ss_x, ssy = s.mono ? 1 : s.ss_y;
        std::vector<uint8_t> grey;
        uint8_t *cb, *cr;
        if (s.mono) {
            grey.assign((size_t)stride * rows, 128);
            cb = cr = grey.data();
        } else {
            cb = px(1, 0, 0);
            cr = px(2, 0, 0);
        }
        GrainSynthesis(g).run(px(0, 0, 0), cb, cr, he, we, stride, stride, ssy, ssx, s.mc == 0);
        stats[ST_GRAIN] += g.num_y_points > 0;
        stats[ST_GRAIN + 1] += g.num_cb_points > 0 || g.chroma_scaling_from_luma;
        stats[ST_GRAIN + 2] += g.num_cr_points > 0 || g.chroma_scaling_from_luma;
        stats[ST_GRAIN_AR_LAG + g.ar_coeff_lag]++;
        stats[ST_GRAIN_OVERLAP] += g.overlap_flag;
        stats[ST_GRAIN_FROM_LUMA] += g.chroma_scaling_from_luma;
        stats[ST_GRAIN_CLIP] += g.clip_to_restricted_range;
        stats[ST_GRAIN_ODD] += (w | h) & 1;
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

double now_ms() {
    return std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now().time_since_epoch()).count();
}

struct Decoder {
    int32_t* stats;
    double stage_ms[6] = {0, 0, 0, 0, 0, 0};  // wall ms of the tiles, deblocking, CDEF, LR, superres, film grain
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
            if (decode_tiles) {
                const double t0 = now_ms();
                frame->decode_tile(t / fh.tile_cols, t % fh.tile_cols, p, size);
                stage_ms[0] += now_ms() - t0;
            }
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
                        // libaom 3.14 fails the frame on one before any frame header
                        if (!seen_frame_header) fail(HEADER_ERROR, "a redundant frame header before the frame header");
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
                if (finished) {
                    // av1_decode_tg_tiles_and_wrapup: the in-loop filters once the
                    // last tile is decoded; loop restoration's stripe boundaries are
                    // saved from the deblocked frame before CDEF (without CDEF libaom
                    // takes its "optimized" path, which reads the same rows); superres
                    // upscales the frame CDEF leaves, loop restoration filters the
                    // upscaled one; film grain is added to the frame as
                    // decoder_get_frame outputs it
                    const double t0 = now_ms();
                    frame->deblock();
                    const double t1 = now_ms();
                    if (frame->lr_on()) frame->lr_save_boundaries();
                    const double t2 = now_ms();
                    frame->cdef();
                    const double t3 = now_ms();
                    if (fh.width != fh.upscaled_width) frame->superres();
                    const double t4 = now_ms();
                    if (frame->lr_on()) frame->restore();
                    const double t5 = now_ms();
                    frame->film_grain();
                    const double t6 = now_ms();
                    stage_ms[1] += t1 - t0;
                    stage_ms[2] += t3 - t2;
                    stage_ms[3] += (t2 - t1) + (t5 - t4);
                    if (fh.width != fh.upscaled_width) stage_ms[4] += t4 - t3;
                    if (fh.grain.apply_grain) stage_ms[5] += t6 - t5;
                    frames_done++;
                }
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

// The stream's sequence and first frame headers: info = [width (after
// superres), height, bit_depth, mono, ss_x, ss_y, color_primaries,
// transfer, matrix, color_range, profile, still_picture, reduced header,
// base_q_idx, tiles, allow_intrabc, allow_screen_content_tools,
// use_128x128, the bit of the frame header where film_grain_params starts,
// the frame header's bits]. Returns a Status; UNPORTED names what is not
// decoded.
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
    int32_t v[20] = {f.upscaled_width, f.height, s.bit_depth, s.mono, s.ss_x, s.ss_y, s.cp, s.tc, s.mc,
                     s.color_range, s.profile, s.still_picture, s.reduced, f.base_q_idx, f.tile_cols * f.tile_rows,
                     f.allow_intrabc, f.allow_screen_content_tools, s.use_128, f.grain_bit, f.header_bits};
    memcpy(info, v, sizeof v);
    return OK;
}

// One inverse transform, for the tests: ``coef`` in libaom's layout (column
// by column, a 64-sample side holding 32), added to the 8-bit block at
// ``dst`` with the decoder's arithmetic. Returns BAD_CALL for a size or a
// type out of range.
int av1_inverse_transform(const int32_t* coef, int tx_size, int tx_type, uint8_t* dst, int stride) {
    if (tx_size < 0 || tx_size >= TX_SIZES_ALL || tx_type < 0 || tx_type >= TX_TYPES) return BAD_CALL;
    inverse_transform_add(coef, tx_size, tx_type, dst, stride);
    return OK;
}

// One deblocking filter, for the tests: aom_lpf_{vertical,horizontal}_
// {4,6,8,14} on the 4-sample segment whose first sample past the edge is at
// ``s`` (rows ``pitch`` apart), with a level's blimit, limit and thresh.
int av1_loop_filter(uint8_t* s, int pitch, int vertical, int length, int blimit, int limit, int thresh) {
    if (length != 4 && length != 6 && length != 8 && length != 14) return BAD_CALL;
    lpf_segment(s, vertical ? 1 : pitch, vertical ? pitch : 1, length, blimit, limit, thresh);
    return OK;
}

// CDEF's direction search of the 8x8 block at ``img``, for the tests
// (cdef_find_dir): the direction, and its variance in ``var``.
int av1_cdef_find_dir(const uint16_t* img, int stride, int32_t* var) { return cdef_find_dir(img, stride, var); }

// CDEF's filter of one block, for the tests (cdef_filter_8_{0,1,2,3} by
// which strengths are 0): ``in`` 16-bit at the block's first sample, rows
// ``in_stride`` apart, two samples around it readable.
int av1_cdef_filter(uint8_t* dst, int dstride, const uint16_t* in, int in_stride, int pri, int sec, int dir,
                    int pri_damping, int sec_damping, int bw, int bh) {
    if (dir < 0 || dir > 7 || bw < 1 || bw > 8 || bh < 1 || bh > 8) return BAD_CALL;
    cdef_filter_block(dst, dstride, in, in_stride, pri, sec, dir, pri_damping, sec_damping, bw, bh);
    return OK;
}

// One Wiener filter of loop restoration, for the tests (av1_wiener_convolve_add_src
// on a processing unit): ``hf`` / ``vf`` the 7 taps as libaom holds them
// (their sum 0), ``src`` readable 3 samples past each side.
int av1_wiener_filter(const uint8_t* src, int src_stride, uint8_t* dst, int dst_stride, int w, int h,
                      const int16_t* hf, const int16_t* vf) {
    if (w < 1 || h < 1) return BAD_CALL;
    wiener_filter(src, src_stride, dst, dst_stride, w, h, hf, vf);
    return OK;
}

// One self-guided filter of loop restoration, for the tests
// (av1_apply_selfguided_restoration on a processing unit): parameter set
// ``ep`` (0-15), the weights ``xqd`` as coded, ``src`` readable 3 samples
// past each side.
int av1_selfguided_filter(const uint8_t* src, int w, int h, int stride, int ep, const int32_t* xqd, uint8_t* dst,
                          int dst_stride) {
    if (w < 1 || h < 1 || ep < 0 || ep > 15) return BAD_CALL;
    const int x[2] = {xqd[0], xqd[1]};
    selfguided_filter(src, stride, w, h, ep, x, dst, dst_stride);
    return OK;
}

// Superres's upscaling filter, for the tests (av1_convolve_horiz_rs_c):
// ``h`` rows of ``w`` samples from ``src`` (the sample before the first
// the filter centres on), from position ``x0_qn`` in steps of
// ``x_step_qn`` (1/16384 sample).
int av1_convolve_horiz_rs(const uint8_t* src, int src_stride, uint8_t* dst, int dst_stride, int w, int h, int x0_qn,
                          int x_step_qn) {
    if (w < 1 || h < 1 || x_step_qn < 1) return BAD_CALL;
    for (int y = 0; y < h; y++) convolve_horiz_rs(src + (ptrdiff_t)y * src_stride, dst + (ptrdiff_t)y * dst_stride, w, x0_qn, x_step_qn);
    return OK;
}

// Film grain, for the tests (add_film_grain_run): ``params`` in libaom's
// aom_film_grain_t layout (8-bit), the even ``width`` x ``height`` luma and
// the chroma planes of its subsampling noised in place.
int av1_film_grain(const void* params, uint8_t* luma, uint8_t* cb, uint8_t* cr, int height, int width, int luma_stride,
                   int chroma_stride, int ss_y, int ss_x, int mc_identity) {
    FilmGrain g;
    memcpy(&g, params, sizeof g);
    if ((width | height) & 1 || width < 2 || height < 2 || g.bit_depth != 8 || g.num_y_points > 14 ||
        g.num_cb_points > 10 || g.num_cr_points > 10 || g.ar_coeff_lag < 0 || g.ar_coeff_lag > 3 ||
        g.scaling_shift < 8 || g.scaling_shift > 11 || g.ar_coeff_shift < 6 || g.ar_coeff_shift > 9 ||
        g.grain_scale_shift < 0 || g.grain_scale_shift > 3 || ss_x < 0 || ss_x > 1 || ss_y < 0 || ss_y > ss_x)
        return BAD_CALL;
    GrainSynthesis(g).run(luma, cb, cr, height, width, luma_stride, chroma_stride, ss_y, ss_x, mc_identity);
    return OK;
}

// Decode the stream into ``out``: the planes (1 or 3) of 8-bit samples, Y of
// width x height, then U and V of ((width + ss_x) >> ss_x) x ((height + ss_y)
// >> ss_y). ``stats``: ST_COUNT tool counters; ``stage_ms`` (or null): the
// wall ms of the tiles' syntax and reconstruction, of deblocking, of CDEF,
// of loop restoration, of superres and of film grain. Returns a Status.
int av1_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, int32_t* stats, double* stage_ms,
               char* msg, int msg_len) {
    Decoder d;
    d.stats = stats;
    d.decode_tiles = true;
    try {
        d.run(data, (size_t)n);
        const Frame& fr = *d.frame;
        const int w = d.fh.upscaled_width, h = d.fh.height;
        const int cw = (w + d.seq.ss_x) >> d.seq.ss_x, ch = (h + d.seq.ss_y) >> d.seq.ss_y;
        if ((int64_t)w * h + (int64_t)(fr.num_planes - 1) * cw * ch != out_size) fail(BAD_CALL, "an output of another size");
        for (int p = 0; p < fr.num_planes; p++) {
            const int pw = p ? cw : w, ph = p ? ch : h;
            uint8_t* o = out + (p ? (size_t)w * h + (size_t)(p - 1) * cw * ch : 0);
            for (int y = 0; y < ph; y++) memcpy(o + (size_t)y * pw, &fr.plane[p][(size_t)y * fr.stride], (size_t)pw);
        }
        if (stage_ms) memcpy(stage_ms, d.stage_ms, sizeof d.stage_ms);
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
