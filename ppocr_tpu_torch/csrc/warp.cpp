// Bilinear warps of uint8 images (1 to 4 channels) with a constant border,
// bit-equal to OpenCV 5.0.0's cv::warpAffine and cv::warpPerspective
// (INTER_LINEAR, BORDER_CONSTANT). Host code of the port's ops layer
// (ops/geometry.py): the synthetic training crops' rotation and the staged
// path's perspective crops.
//
// The target is the answer of OpenCV 5.0.0's x86-64 build (baseline SSE3,
// code dispatched up to AVX512_SKX, run on a CPU with AVX-512 and FMA):
// the JAX package's goldens and digests are made with it. Its warp kernels
// map each output row in blocks of 16 columns with vector code and finish
// the row's last (width mod 16) columns with scalar code, and the two
// round differently. With the inverse matrix M cast to f32:
//
//   vector columns: r = y*M[1] + M[2] (two f32 roundings), then
//                   sx = fma(M[0], x, r);
//   scalar columns: sx = fma(x, M[0], y*M[1]) + M[2], the sum rounded last;
//
// and likewise sy from M[3..5] and, for the perspective warp, the
// denominator sw from M[6..8], with sx / sw and sy / sw in f32. Both then
// interpolate with three fused lerps over the taps p00, p01 (row y0) and
// p10, p11 (row y0 + 1), a = sx - floor(sx), b = sy - floor(sy):
//
//   t = fma(a, p01 - p00, p00), u = fma(a, p11 - p10, p10),
//   v = fma(b, u - t, t),
//
// and round v to the nearest integer, ties to even, saturated to [0, 255].
// A tap outside the image reads the border value.
//
// Every step is one IEEE f32 operation or a correctly rounded fmaf, so the
// answer does not depend on the host's SIMD. Contraction is switched off
// below: the compiler must not fuse y*M[1] + M[2] into one fma.
//
// A source position that is not finite (a singular or degenerate matrix)
// reads the border here; cv2 gives the border or 0 there, by what its
// neighbouring pixels do, and that is not replayed.

#include <cmath>
#include <cstddef>
#include <cstdint>

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

namespace {

constexpr int kSimdColumns = 16;

inline float tap(const uint8_t* src, int h, int w, int cn, int x, int y, int c, const float* border) {
  if (static_cast<unsigned>(x) < static_cast<unsigned>(w) && static_cast<unsigned>(y) < static_cast<unsigned>(h))
    return src[(static_cast<size_t>(y) * w + x) * cn + c];
  return border[c];
}

// floor(v) as an int clamped to [-2, limit]: further out, both taps of the
// pair read the border all the same
inline int clamp_floor(float v, int limit) {
  if (v < -2.f) return -2;
  if (v > static_cast<float>(limit)) return limit;
  return static_cast<int>(v);
}

}  // namespace

// src: [h, w, cn] uint8; dst: [dh, dw, cn] uint8; m: the inverse map, 9 f32
// (row-major 3x3; the affine warp passes 0, 0, 1 as its last row and
// perspective 0); border: cn f32 values. Returns 0, or 1 on bad sizes.
extern "C" int warp_bilinear_u8(const uint8_t* src, int h, int w, int cn, uint8_t* dst, int dh, int dw,
                                const float* m, int perspective, const float* border) {
  if (h <= 0 || w <= 0 || dh <= 0 || dw <= 0 || cn < 1 || cn > 4) return 1;
  const int split = dw - dw % kSimdColumns;
  for (int y = 0; y < dh; ++y) {
    const float fy = static_cast<float>(y);
    const float yx = fy * m[1], yy = fy * m[4], yw = fy * m[7];
    const float rx = yx + m[2], ry = yy + m[5], rw = yw + m[8];
    uint8_t* row = dst + static_cast<size_t>(y) * dw * cn;
    for (int x = 0; x < dw; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy, sw = 1.f;
      if (x < split) {
        sx = std::fma(m[0], fx, rx);
        sy = std::fma(m[3], fx, ry);
        if (perspective) sw = std::fma(m[6], fx, rw);
      } else {
        sx = std::fma(fx, m[0], yx) + m[2];
        sy = std::fma(fx, m[3], yy) + m[5];
        if (perspective) sw = std::fma(fx, m[6], yw) + m[8];
      }
      if (perspective) {
        sx = sx / sw;
        sy = sy / sw;
      }
      uint8_t* px = row + static_cast<size_t>(x) * cn;
      if (!std::isfinite(sx) || !std::isfinite(sy)) {
        for (int c = 0; c < cn; ++c) px[c] = static_cast<uint8_t>(border[c]);
        continue;
      }
      const float x0 = std::floor(sx), y0 = std::floor(sy);
      const float a = sx - x0, b = sy - y0;
      const int ix = clamp_floor(x0, w), iy = clamp_floor(y0, h);
      const bool inside = ix >= 0 && iy >= 0 && ix + 1 < w && iy + 1 < h;
      const uint8_t* top = inside ? src + (static_cast<size_t>(iy) * w + ix) * cn : nullptr;
      const size_t down = static_cast<size_t>(w) * cn;
      for (int c = 0; c < cn; ++c) {
        float p00, p01, p10, p11;
        if (inside) {
          p00 = top[c], p01 = top[cn + c], p10 = top[down + c], p11 = top[down + cn + c];
        } else {
          p00 = tap(src, h, w, cn, ix, iy, c, border);
          p01 = tap(src, h, w, cn, ix + 1, iy, c, border);
          p10 = tap(src, h, w, cn, ix, iy + 1, c, border);
          p11 = tap(src, h, w, cn, ix + 1, iy + 1, c, border);
        }
        const float t = std::fma(a, p01 - p00, p00);
        const float u = std::fma(a, p11 - p10, p10);
        const float v = std::nearbyint(std::fma(b, u - t, t));
        px[c] = v <= 0.f ? 0 : v >= 255.f ? 255 : static_cast<uint8_t>(v);
      }
    }
  }
  return 0;
}
