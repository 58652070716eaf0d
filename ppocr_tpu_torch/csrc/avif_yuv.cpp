// libavif 1.4.2's YUV to BGR (avifImageYUVToRGB into an 8-bit BGR avifRGBImage
// with the defaults of avifRGBImageSetDefaults, as OpenCV 5.0's AVIF decoder
// asks for it) over 8-bit planes, for every matrix and range libavif takes.
//
// libavif hands a conversion to the copy of libyuv (version 1924) it is built
// with where libyuv has constants for the image's matrix (reformat_libyuv.c):
// BT.709, BT.601 (and unspecified) and BT.2020 NCL in either range, and
// chroma-derived NCL whose primaries are one of these. Chroma is then
// upsampled by libyuv's bilinear 2x filters (ScaleRowUp2_Linear /
// ScaleRowUp2_Bilinear and their edge rules in I420ToRGB24MatrixBilinear /
// I422ToRGB24MatrixLinear) and converted by its fixed-point YuvPixel in
// 16-bit lanes that saturate (the x86 rows). Every other matrix goes through
// libavif's own float path (reformat.c: the unorm tables, the 9-3-3-1
// bilinear upsampling of avifImageYUVAnyToRGBAnySlow, identity, YCgCo and
// the Kr/Kb formulas, (uint8_t)(0.5f + v * 255.0f)). The float arithmetic is
// evaluated in libavif's order, in float, with no fused multiply-add.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// avifImageYUVToRGB refuses these: reserved 3, YCgCo in limited range,
// BT.2020 CL, SMPTE 2085, chroma-derived CL, ICtCp, YCgCo-Re/Ro at 8 bits
// and the values past them; identity only with 4:4:4 (or 4:0:0)
bool refused(int mc, int full, bool subsampled) {
    if (mc == 0) return subsampled;
    return mc == 3 || (mc == 8 && !full) || mc == 10 || mc == 11 || mc == 13 || mc == 14 || mc >= 16;
}

// -- libyuv ------------------------------------------------------------------------------

struct YuvConstants {  // MAKEYUVCONSTANTS(name, YG, YB, UB, UG, VG, VR); UB at most 128 on x86
    int yg, yb, ub, ug, vg, vr;
};
const YuvConstants kI601 = {18997, -1160, 128, 25, 52, 102};
const YuvConstants kJPEG = {16320, 32, 113, 22, 46, 90};
const YuvConstants kH709 = {18997, -1160, 128, 14, 34, 115};
const YuvConstants kF709 = {16320, 32, 119, 12, 30, 101};
const YuvConstants k2020 = {19003, -1160, 128, 12, 42, 107};
const YuvConstants kV2020 = {16320, 32, 120, 11, 37, 94};

// the constants reformat_libyuv.c picks, or null for libavif's own path
const YuvConstants* libyuv_constants(int mc, int cp, int full) {
    int kind = mc;  // 1: BT.709, 6: BT.601, 9: BT.2020
    if (mc == 2 || mc == 5) kind = 6;
    if (mc == 12) kind = (cp == 1 || cp == 2) ? 1 : (cp == 5 || cp == 6) ? 6 : cp == 9 ? 9 : 0;
    switch (kind) {
        case 1: return full ? &kF709 : &kH709;
        case 6: return full ? &kJPEG : &kI601;
        case 9: return full ? &kV2020 : &k2020;
        default: return nullptr;
    }
}

// YUVTORGB16 / YUVTORGB of row_gcc.cc, as tables of the terms: pmulhuw of
// y * 0x0101 with the bias added, pmaddubsw of the unsigned constants and
// (u, v) - 128; then paddsw / psubsw, psraw 6 and packuswb. No term
// saturates, and a sum that does (only past 32767 or -32768) packs to
// 255 or 0 either way, so plain int sums clamped after the shift agree.
struct YuvTables {
    int y[256], bu[256], gu[256], gv[256], rv[256];
    explicit YuvTables(const YuvConstants& k) {
        for (int c = 0; c < 256; c++) {
            const int d = c - 128;
            y[c] = (int)(((uint32_t)c * 0x0101u) * (uint32_t)k.yg >> 16) + k.yb;
            bu[c] = k.ub * d;
            gu[c] = k.ug * d;
            gv[c] = k.vg * d;
            rv[c] = k.vr * d;
        }
    }
};

uint8_t pack(int v) { return (uint8_t)std::max(0, std::min(255, v >> 6)); }

void yuv_pixel(const YuvTables& t, int y, int u, int v, uint8_t* bgr) {
    const int y1 = t.y[y];
    bgr[0] = pack(y1 + t.bu[u]);
    bgr[1] = pack(y1 - (t.gu[u] + t.gv[v]));
    bgr[2] = pack(y1 + t.rv[v]);
}

// ScaleRowUp2_Linear_Any: the first sample kept, pairs at 3:1 and 1:3,
// the last sample the nearest one
void up2_linear(const uint8_t* s, uint8_t* d, int w) {
    d[0] = s[0];
    for (int x = 0; 2 * x + 2 < w; x++) {
        d[2 * x + 1] = (uint8_t)((s[x] * 3 + s[x + 1] + 2) >> 2);
        d[2 * x + 2] = (uint8_t)((s[x] + s[x + 1] * 3 + 2) >> 2);
    }
    d[w - 1] = s[(w - 1) / 2];
}

// ScaleRowUp2_Bilinear_Any: two rows from the chroma rows s (above) and t
void up2_bilinear(const uint8_t* s, const uint8_t* t, uint8_t* d, uint8_t* e, int w) {
    d[0] = (uint8_t)((3 * s[0] + t[0] + 2) >> 2);
    e[0] = (uint8_t)((s[0] + 3 * t[0] + 2) >> 2);
    for (int x = 0; 2 * x + 2 < w; x++) {
        d[2 * x + 1] = (uint8_t)((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
        d[2 * x + 2] = (uint8_t)((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
        e[2 * x + 1] = (uint8_t)((s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4);
        e[2 * x + 2] = (uint8_t)((s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4);
    }
    const int k = (w - 1) / 2;
    d[w - 1] = (uint8_t)((3 * s[k] + t[k] + 2) >> 2);
    e[w - 1] = (uint8_t)((s[k] + 3 * t[k] + 2) >> 2);
}

// I444ToRGB24MatrixFilter / I422ToRGB24MatrixLinear / I420ToRGB24MatrixBilinear
void libyuv_to_bgr(const YuvConstants& k, const uint8_t* y, const uint8_t* u, const uint8_t* v, int w, int h,
                   int ss_x, int ss_y, uint8_t* out) {
    const int cw = (w + ss_x) >> ss_x;
    const YuvTables t(k);
    std::vector<uint8_t> tmp(4 * (size_t)w);
    uint8_t *u1 = tmp.data(), *u2 = u1 + w, *v1 = u2 + w, *v2 = v1 + w;
    auto row = [&](int j, const uint8_t* ur, const uint8_t* vr) {
        for (int i = 0; i < w; i++) yuv_pixel(t, y[(size_t)j * w + i], ur[i], vr[i], out + ((size_t)j * w + i) * 3);
    };
    if (!ss_x) {  // 4:4:4
        for (int j = 0; j < h; j++) row(j, u + (size_t)j * w, v + (size_t)j * w);
        return;
    }
    if (!ss_y) {  // 4:2:2: each row upsampled across
        for (int j = 0; j < h; j++) {
            up2_linear(u + (size_t)j * cw, u1, w);
            up2_linear(v + (size_t)j * cw, v1, w);
            row(j, u1, v1);
        }
        return;
    }
    up2_linear(u, u1, w);
    up2_linear(v, v1, w);
    row(0, u1, v1);
    int j = 1;
    const uint8_t *su = u, *sv = v;
    for (int r = 0; r < h - 2; r += 2) {
        up2_bilinear(su, su + cw, u1, u2, w);
        up2_bilinear(sv, sv + cw, v1, v2, w);
        row(j++, u1, v1);
        row(j++, u2, v2);
        su += cw;
        sv += cw;
    }
    if (!(h & 1)) {
        up2_linear(su, u1, w);
        up2_linear(sv, v1, w);
        row(j, u1, v1);
    }
}

// -- libavif's own path (reformat.c) ---------------------------------------------------------

// avifCalcYUVCoefficients: the table of matrixCoefficientsTables, chroma-derived
// NCL from the primaries (avifColorPrimariesComputeYCoeffs), else BT.601
const float kPrimaries[][8] = {
    {0.64f, 0.33f, 0.3f, 0.6f, 0.15f, 0.06f, 0.3127f, 0.329f},          // BT.709, and any unknown value
    {0.67f, 0.33f, 0.21f, 0.71f, 0.14f, 0.08f, 0.310f, 0.316f},         // 4: BT.470 M
    {0.64f, 0.33f, 0.29f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f},       // 5: BT.470 BG
    {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f}, // 6, 7: BT.601, SMPTE 240
    {0.681f, 0.319f, 0.243f, 0.692f, 0.145f, 0.049f, 0.310f, 0.316f},   // 8: generic film
    {0.708f, 0.292f, 0.170f, 0.797f, 0.131f, 0.046f, 0.3127f, 0.3290f}, // 9: BT.2020
    {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.3333f, 0.3333f},             // 10: XYZ
    {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.314f, 0.351f},   // 11: SMPTE 431
    {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.3127f, 0.3290f}, // 12: SMPTE 432
    {0.630f, 0.340f, 0.295f, 0.605f, 0.155f, 0.077f, 0.3127f, 0.3290f}, // 22: EBU 3213
};

const float* primaries_of(int cp) {
    switch (cp) {
        case 4: return kPrimaries[1];
        case 5: return kPrimaries[2];
        case 6: case 7: return kPrimaries[3];
        case 8: return kPrimaries[4];
        case 9: return kPrimaries[5];
        case 10: return kPrimaries[6];
        case 11: return kPrimaries[7];
        case 12: return kPrimaries[8];
        case 22: return kPrimaries[9];
        default: return kPrimaries[0];
    }
}

void coefficients(int mc, int cp, float& kr, float& kg, float& kb) {
    kr = 0.299f;
    kb = 0.114f;
    kg = 1.0f - kr - kb;
    if (mc == 12) {
        const float* p = primaries_of(cp);
        const float rX = p[0], rY = p[1], gX = p[2], gY = p[3], bX = p[4], bY = p[5], wX = p[6], wY = p[7];
        const float rZ = 1.0f - (rX + rY), gZ = 1.0f - (gX + gY), bZ = 1.0f - (bX + bY), wZ = 1.0f - (wX + wY);
        kr = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) + wZ * (gX * bY - bX * gY))) /
             (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ)));
        kb = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) + wZ * (rX * gY - gX * rY))) /
             (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ)));
        kg = 1.0f - kr - kb;
        return;
    }
    static const struct { int mc; float kr, kb; } table[] = {
        {1, 0.2126f, 0.0722f}, {4, 0.30f, 0.11f}, {5, 0.299f, 0.114f}, {6, 0.299f, 0.114f},
        {7, 0.212f, 0.087f}, {9, 0.2627f, 0.0593f}};
    for (const auto& t : table)
        if (t.mc == mc) {
            kr = t.kr;
            kb = t.kb;
            kg = 1.0f - kr - kb;
        }
}

uint8_t to8(float v) { return (uint8_t)(0.5f + (std::min(std::max(v, 0.0f), 1.0f) * 255.0f)); }

void float_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int w, int h, int ss_x, int ss_y, int mono,
                  int mc, int cp, int full, uint8_t* out) {
    float tab_y[256], tab_uv[256];
    const float bias_y = full ? 0.0f : 16.0f, range_y = full ? 255.0f : 219.0f;
    const float bias_uv = 128.0f, range_uv = full ? 255.0f : 224.0f;
    for (int c = 0; c < 256; c++) {
        tab_y[c] = ((float)c - bias_y) / range_y;
        tab_uv[c] = mc == 0 ? tab_y[c] : ((float)c - bias_uv) / range_uv;  // identity: the luma table
    }
    float kr, kg, kb;
    coefficients(mc, cp, kr, kg, kb);
    const int cw = (w + ss_x) >> ss_x;
    for (int j = 0; j < h; j++) {
        const int uv_j = j >> ss_y;
        for (int i = 0; i < w; i++) {
            uint8_t* o = out + ((size_t)j * w + i) * 3;
            const float Y = tab_y[y[(size_t)j * w + i]];
            if (mono) {
                o[0] = o[1] = o[2] = to8(Y);
                continue;
            }
            const int uv_i = i >> ss_x;
            const size_t at = (size_t)uv_j * cw + uv_i;
            float Cb, Cr;
            if (!ss_x) {
                Cb = tab_uv[u[at]];
                Cr = tab_uv[v[at]];
            } else {  // the four nearest chroma samples, 9/16, 3/16, 3/16, 1/16
                const int adj_col = (i == 0 || (i == w - 1 && (i % 2) != 0)) ? 0 : (i % 2) != 0 ? 1 : -1;
                const int adj_row = (j == 0 || (j == h - 1 && (j % 2) != 0) || !ss_y) ? 0 : (j % 2) != 0 ? cw : -cw;
                Cb = (tab_uv[u[at]] * (9.0f / 16.0f)) + (tab_uv[u[at + adj_col]] * (3.0f / 16.0f)) +
                     (tab_uv[u[at + adj_row]] * (3.0f / 16.0f)) + (tab_uv[u[at + adj_col + adj_row]] * (1.0f / 16.0f));
                Cr = (tab_uv[v[at]] * (9.0f / 16.0f)) + (tab_uv[v[at + adj_col]] * (3.0f / 16.0f)) +
                     (tab_uv[v[at + adj_row]] * (3.0f / 16.0f)) + (tab_uv[v[at + adj_col + adj_row]] * (1.0f / 16.0f));
            }
            float R, G, B;
            if (mc == 0) {
                G = Y;
                B = Cb;
                R = Cr;
            } else if (mc == 8) {
                const float t = Y - Cb;
                G = Y + Cb;
                B = t - Cr;
                R = t + Cr;
            } else {
                R = Y + (2 * (1 - kr)) * Cr;
                B = Y + (2 * (1 - kb)) * Cb;
                G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
            }
            o[0] = to8(B);
            o[1] = to8(G);
            o[2] = to8(R);
        }
    }
}

}  // namespace

extern "C" {

// The planes of a decoded frame (Y of width x height, U and V of
// ((width + ss_x) >> ss_x) x ((height + ss_y) >> ss_y); none when mono)
// to ``out``, height x width x 3 BGR, as libavif converts them for cv2.
// Returns 0, or 1 where libavif refuses the matrix (cv2 gives None).
int avif_yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height, int ss_x, int ss_y,
                    int mono, int matrix, int primaries, int full_range, uint8_t* out) {
    if (width <= 0 || height <= 0) return 1;
    if (refused(matrix, full_range, !mono && (ss_x || ss_y))) return 1;
    const YuvConstants* k = mono ? nullptr : libyuv_constants(matrix, primaries, full_range);
    if (matrix == 0 && full_range && !mono && !ss_x && !ss_y) {  // avifImageIdentity8ToRGB8ColorFullRange
        for (size_t i = 0; i < (size_t)width * height; i++) {
            out[3 * i] = u[i];
            out[3 * i + 1] = y[i];
            out[3 * i + 2] = v[i];
        }
    } else if (k)
        libyuv_to_bgr(*k, y, u, v, width, height, ss_x, ss_y, out);
    else
        float_to_bgr(y, u, v, width, height, ss_x, ss_y, mono, matrix, primaries, full_range, out);
    return 0;
}

}  // extern "C"
