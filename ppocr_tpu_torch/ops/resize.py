"""Det-input resize with the reference's rounding, in numpy (no cv2).

Counterpart of ``ppocr_tpu/ops/resize.py`` ``det_target_shape``,
``det_resize``, ``det_cap_shape`` and ``det_fit_cap``. The JAX package
resizes with ``cv2.resize(INTER_LINEAR)``; the machines that serve the
port need not have cv2, so :func:`resize_bilinear_u8` reproduces cv2's
uint8 bilinear: half-pixel centres, 11-bit fixed-point weights rounded
from f32, edge clamping, and the vectorised vertical pass's shifts. The
tests hold it to cv2 within one grey level: cv2 may finish a row's
ragged tail with a scalar rounding that can differ by 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_COEF_SCALE = 2048  # cv2 INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _taps(dst: int, src: int, zero_edges: bool):
    """Source index and (w0, w1) fixed-point weights of each output pixel."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(
        np.float32
    )
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if zero_edges:
        # columns: cv2 pins the weight to the edge pixel outside the image
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    s0 = np.clip(s, 0, src - 1)
    s1 = np.clip(s + 1, 0, src - 1)
    return s0, s1, w0, w1


def resize_bilinear_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` for a uint8 HxW or HxWxC image."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if (h, w) == (2 * out_h, 2 * out_w):
        # exact 2× downscale: cv2 switches to its area path, the rounded
        # mean of each 2×2 block (the bilinear taps below give the same)
        acc = img[0::2, 0::2].astype(np.uint16)
        acc += img[0::2, 1::2]
        acc += img[1::2, 0::2]
        acc += img[1::2, 1::2]
        acc += 2
        acc >>= 2
        return acc.astype(np.uint8)
    x0, x1, a0, a1 = _taps(out_w, w, zero_edges=True)
    y0, y1, b0, b1 = _taps(out_h, h, zero_edges=False)
    ext = (slice(None),) + (None,) * (img.ndim - 2)
    col = (slice(None), None) + ext[1:]
    # horizontal pass: ints at scale 2048 (≤ 255·2048, int32 is enough);
    # only (S >> 4) is used below
    rows = img.take(x0, axis=1).astype(np.int32) * a0[ext].astype(np.int32)
    rows += img.take(x1, axis=1).astype(np.int32) * a1[ext].astype(np.int32)
    rows >>= 4
    # vertical pass as cv2's SIMD path: ((S >> 4) · b) >> 16 per row, then
    # a rounding shift by 2
    r0 = rows.take(y0, axis=0) * b0[col].astype(np.int32)
    r0 >>= 16
    r1 = rows.take(y1, axis=0) * b1[col].astype(np.int32)
    r1 >>= 16
    r0 += r1 + 2
    r0 >>= 2
    return np.clip(r0, 0, 255).astype(np.uint8)


def det_target_shape(
    h: int, w: int, limit_type: str = "max", limit_side_len: int = 960
) -> Tuple[int, int]:
    """The (resize_h, resize_w) a source of (h, w) resolves to."""
    ratio = 1.0
    if limit_type == "min":
        if min(h, w) < limit_side_len:
            ratio = limit_side_len / (h if h < w else w)
    else:
        if max(h, w) > limit_side_len:
            ratio = limit_side_len / (h if h > w else w)

    resize_h = int(h * ratio)
    resize_w = int(w * ratio)
    # round-to-nearest /32 with floor of 32, C round semantics (half away
    # from zero, preprocess_op.cpp's round), not Python's banker's round
    resize_h = max(int(resize_h / 32.0 + 0.5) * 32, 32)
    resize_w = max(int(resize_w / 32.0 + 0.5) * 32, 32)
    return resize_h, resize_w


def det_resize(
    img: np.ndarray, limit_type: str = "max", limit_side_len: int = 960
) -> Tuple[np.ndarray, float, float]:
    """Scale so the limiting side hits ``limit_side_len``, then snap each
    side to the nearest multiple of 32 (floor 32). Returns (resized,
    ratio_h, ratio_w) where ratios are resized/src."""
    h, w = img.shape[:2]
    resize_h, resize_w = det_target_shape(h, w, limit_type, limit_side_len)
    resized = resize_bilinear_u8(img, resize_w, resize_h)
    return resized, resize_h / h, resize_w / w


def det_cap_shape(rh: int, rw: int, cap: int) -> Tuple[int, int]:
    """Shape-only :func:`det_fit_cap`."""
    if rh <= cap and rw <= cap:
        return rh, rw
    scale = cap / max(rh, rw)
    nh = min(max(int(round(rh * scale / 32) * 32), 32), cap)
    nw = min(max(int(round(rw * scale / 32) * 32), 32), cap)
    return nh, nw


def det_fit_cap(
    img: np.ndarray, ratio_h: float, ratio_w: float, cap: int
) -> Tuple[np.ndarray, float, float]:
    """Downscale a det-resized image so both sides fit within ``cap`` (the
    largest det bucket), keeping /32 alignment; ratios are resized/src."""
    rh, rw = img.shape[:2]
    nh, nw = det_cap_shape(rh, rw, cap)
    if (nh, nw) == (rh, rw):
        return img, ratio_h, ratio_w
    out = resize_bilinear_u8(img, nw, nh)
    return out, ratio_h * nh / rh, ratio_w * nw / rw
