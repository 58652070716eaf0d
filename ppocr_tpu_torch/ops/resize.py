"""Det, rec and cls input resize with the reference's rounding, in numpy
(no cv2).

Counterpart of ``ppocr_tpu/ops/resize.py`` ``det_target_shape``,
``det_resize``, ``det_cap_shape``, ``det_fit_cap``, ``crnn_resize``,
``cls_resize`` and the structure inputs' ``table_resize``, ``table_pad``
and ``resize_hw``. The JAX package
resizes with ``cv2.resize(INTER_LINEAR)``; the machines that serve the
port need not have cv2, so :func:`resize_bilinear_u8` reproduces cv2's
uint8 bilinear: half-pixel centres, 11-bit fixed-point weights rounded
from f32, edge clamping, and the vectorised vertical pass's shifts. The
tests hold it to cv2 within one grey level, and ``crnn_resize`` and
``cls_resize`` exactly on ``tests/test_torch_staged_ops.py``'s crops (no
value of theirs differs): cv2 may finish a row's ragged tail with a
scalar rounding that can differ by 1.
"""

from __future__ import annotations

import math
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


def _aspect_width(img: np.ndarray, img_h: int, img_w: int) -> int:
    """Width of ``img`` scaled to height ``img_h`` (rounded up), capped at
    ``img_w``."""
    h, w = img.shape[:2]
    scaled = math.ceil(img_h * (w / h))
    return img_w if scaled > img_w else int(scaled)


def crnn_resize(
    img: np.ndarray, max_wh_ratio: float, rec_image_shape=(3, 48, 320)
) -> np.ndarray:
    """Resize a text-line crop to rec height, cap width at
    ``img_h * max_wh_ratio``, right-pad with black to exactly that width
    (CrnnResizeImg, preprocess_op.cpp:92-117)."""
    _, img_h, _ = rec_image_shape
    img_w = int(img_h * max_wh_ratio)
    resize_w = _aspect_width(img, img_h, img_w)
    resized = resize_bilinear_u8(img, resize_w, img_h)
    if resize_w < img_w:
        padded = np.zeros((img_h, img_w) + resized.shape[2:], np.uint8)
        padded[:, :resize_w] = resized
        return padded
    return resized


def cls_resize(img: np.ndarray, cls_image_shape=(3, 48, 192)) -> np.ndarray:
    """Resize keeping aspect to cls height; the caller right-pads the batch
    buffer with zeros (the reference pads implicitly via a zeroed input
    tensor)."""
    _, img_h, img_w = cls_image_shape
    return resize_bilinear_u8(img, _aspect_width(img, img_h, img_w), img_h)


def _resize(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """:func:`resize_bilinear_u8`, refusing what ``cv2.resize`` refuses:
    an empty input or output (its ``inv_scale_x > 0`` assertion)."""
    if out_w <= 0 or out_h <= 0 or img.size == 0:
        raise ValueError(
            f"resize of a {img.shape[:2]} image to {out_h}x{out_w}: cv2.resize "
            "refuses an empty input or output"
        )
    return resize_bilinear_u8(img, out_w, out_h)


def table_resize(img: np.ndarray, max_len: int = 488) -> Tuple[np.ndarray, float]:
    """Long-side resize for table-structure inputs (TableResizeImg,
    preprocess_op.cpp:139-151): each side times max_len / the longer side,
    truncated. Returns (resized, ratio); within one grey level of cv2's
    pixels (see :func:`resize_bilinear_u8`)."""
    h, w = img.shape[:2]
    ratio = max_len / (w if w >= h else h)
    return _resize(img, int(w * ratio), int(h * ratio)), ratio


def table_pad(img: np.ndarray, max_len: int = 488) -> np.ndarray:
    """Bottom/right zero-pad to a square max_len canvas (TablePadImg,
    preprocess_op.cpp:153-159). A side longer than ``max_len`` raises
    ``ValueError``, where ``cv2.copyMakeBorder`` fails its assertion on the
    negative border."""
    h, w = img.shape[:2]
    if h > max_len or w > max_len:
        raise ValueError(
            f"table_pad: a {h}x{w} image does not fit a {max_len}x{max_len} canvas "
            "(cv2.copyMakeBorder refuses a negative border)"
        )
    out = np.zeros((max_len, max_len) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    return out


def resize_hw(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Plain resize to h x w (Resize op, preprocess_op.cpp:161-164), within
    one grey level of ``cv2.resize``."""
    return _resize(img, w, h)
