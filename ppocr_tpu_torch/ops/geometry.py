"""Host geometry helpers mirroring Utility (utility.cpp), in numpy.

Counterpart of ``ppocr_tpu/ops/geometry.py``, which calls cv2 for the
bounding rect and the perspective warp. Here ``bounding_crop`` takes the
min/max of the points itself, and ``get_rotate_crop_image`` carries its
own ``getPerspectiveTransform`` (cv2's 8×8 LU solve) and
``warpPerspective`` (inverse map, constant black border, bilinear); the
synthetic training crops' rotation has ``getRotationMatrix2D`` and
``warpAffine`` (constant border of any value) alike.

Every function is bit-equal to OpenCV 5.0.0, held so by
``tests/test_torch_staged_ops.py`` and ``tests/test_torch_synthetic.py``:
the warps replay its floating-point arithmetic step for step in
``csrc/warp.cpp`` (built with the host compiler at first use, see
``ops/native.py``). OpenCV 4.x up to 4.10 rounds the source
coordinates to 1/32 px and the weights to 2^15 instead, which moves
high-contrast pixels by several grey levels against 5.0.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from . import native

_LU_EPS = np.finfo(np.float64).eps * 100  # cv::solve's DECOMP_LU pivot floor


def xyxyxyxy2xyxy(box: Sequence[Sequence[int]]) -> List[int]:
    """Quad → axis-aligned [left, top, right, bottom] (utility.cpp:329-348)."""
    xs = [p[0] for p in box]
    ys = [p[1] for p in box]
    return [int(min(xs)), int(min(ys)), int(max(xs)), int(max(ys))]


def bounding_crop(img: np.ndarray, box: Sequence[Sequence[int]]) -> np.ndarray:
    """Axis-aligned boundingRect crop of a quad: the crop the worker uses
    by default (ocr_worker.cpp:245-259 uses cv::boundingRect, not the
    perspective crop; kept as a behavioural quirk for output parity)."""
    pts = np.asarray(box, dtype=np.int32)
    # cv::boundingRect of int points: x = min, w = max − min + 1
    x, y = int(pts[:, 0].min()), int(pts[:, 1].min())
    w = int(pts[:, 0].max()) - x + 1
    h = int(pts[:, 1].max()) - y + 1
    # cv::Rect intersection (bbox &= Rect(0, 0, cols, rows)): the far edge
    # is min(cols, x + w) with the ORIGINAL x; clamping x first would widen
    # the crop for negative origins
    x2 = min(img.shape[1], x + w)
    y2 = min(img.shape[0], y + h)
    x = max(0, x)
    y = max(0, y)
    if x2 <= x or y2 <= y:
        return np.zeros((0, 0, 3), dtype=img.dtype)
    return img[y:y2, x:x2].copy()


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: the 3×3 matrix (f64, m[2, 2] = 1)
    that maps the four ``src`` points onto the four ``dst`` points.

    The points are f32 (cv::Point2f) and the system's product terms are
    f32 products, as cv2 fills them; the 8×8 system is solved as cv2's
    ``DECOMP_LU`` solves one this small (``LUImpl``: Gaussian elimination
    with partial pivoting in f64, then back substitution), so the matrix
    is bit-equal to cv2's. A singular system (repeated or collinear
    points) gives zeros with m[2, 2] = 1 here; cv2 then falls back to an
    SVD solve, which is not replayed."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[i][:3] = a[i + 4][3:6] = float(x), float(y), 1.0
        a[i][6], a[i][7] = float(-x * u), float(-y * u)
        a[i + 4][6], a[i + 4][7] = float(-x * v), float(-y * v)
        b[i], b[i + 4] = float(u), float(v)
    for i in range(8):
        k = i
        for j in range(i + 1, 8):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < _LU_EPS:
            return np.diag([0.0, 0.0, 1.0])
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, 8):
            alpha = a[j][i] * d
            for k in range(i + 1, 8):
                a[j][k] += alpha * a[i][k]
            b[j] += alpha * b[i]
    for i in range(7, -1, -1):
        s = b[i]
        for k in range(i + 1, 8):
            s -= a[i][k] * b[k]
        b[i] = s / a[i][i]
    return np.array(b + [1.0], np.float64).reshape(3, 3)


def _invert3(m: np.ndarray) -> np.ndarray:
    """Closed-form 3×3 inverse (cofactors over the determinant), as cv2
    inverts the warp matrix."""
    (a, b, c), (d, e, f), (g, h, i) = m
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    if det == 0.0:
        return np.zeros((3, 3), np.float64)
    s = 1.0 / det
    return np.array(
        [
            [(e * i - f * h) * s, (c * h - b * i) * s, (b * f - c * e) * s],
            [(f * g - d * i) * s, (a * i - c * g) * s, (c * d - a * f) * s],
            [(d * h - e * g) * s, (b * g - a * h) * s, (a * e - b * d) * s],
        ],
        np.float64,
    )


def warp_perspective(img: np.ndarray, m: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.warpPerspective(img, m, (width, height))`` for a uint8 H×W×C
    (or H×W) image: bilinear, constant black border, bit-equal to cv2 5.0
    (``csrc/warp.cpp`` replays its arithmetic). Each output pixel's source
    position comes from the inverted matrix (f64, cast to f32); a tap
    outside the image reads 0."""
    if width <= 0 or height <= 0:
        raise ValueError(f"warp_perspective: empty output size {(width, height)}")
    inv = _invert3(np.asarray(m, np.float64)).astype(np.float32)
    return _warp(img, inv, width, height, True, 0)


def _warp(img: np.ndarray, inv: np.ndarray, width: int, height: int, perspective: bool,
          border_value) -> np.ndarray:
    """``native.warp_bilinear`` on an H×W×C or H×W image, the border value
    read as cv2 reads a Scalar: a number is (v, 0, 0, 0), a shorter
    sequence is padded with zeros, each value rounded and saturated to
    uint8."""
    src = img if img.ndim == 3 else img[..., None]
    bv = np.zeros(4, np.float64)
    values = np.atleast_1d(np.asarray(border_value, np.float64))[:4]
    bv[: values.size] = values
    bv = np.clip(np.rint(bv), 0, 255)[: src.shape[2]]
    out = native.warp_bilinear(src, inv, width, height, perspective, bv)
    return out if img.ndim == 3 else out[..., 0]


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: 2×3 (f64) rotation by ``angle`` degrees
    (counter-clockwise) about ``center`` (f32, a cv::Point2f), scaled by
    ``scale``; libm's cos and sin, as cv2 calls them."""
    a = float(angle) * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array(
        [[alpha, beta, (1 - alpha) * cx - beta * cy],
         [-beta, alpha, beta * cx + (1 - alpha) * cy]],
        np.float64,
    )


def warp_affine(img: np.ndarray, m: np.ndarray, width: int, height: int,
                border_value=0) -> np.ndarray:
    """``cv2.warpAffine(img, m, (width, height), borderValue=border_value)``
    for a uint8 H×W×C (or H×W) image: bilinear, constant border, bit-equal
    to cv2 5.0. The 2×3 matrix is inverted as cv2 inverts it (f64, cast to
    f32); a tap outside the image reads ``border_value`` (read as cv2 reads
    a Scalar)."""
    if width <= 0 or height <= 0:
        raise ValueError(f"warp_affine: empty output size {(width, height)}")
    m = np.asarray(m, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    inv = np.array([[a11, a12, b1], [a21, a22, b2], [0, 0, 1]], np.float64).astype(np.float32)
    return _warp(img, inv, width, height, False, border_value)


def get_rotate_crop_image(img: np.ndarray, box: Sequence[Sequence[int]]) -> np.ndarray:
    """Perspective crop of a quad with the tall-crop rotate heuristic
    (utility.cpp:137-190): warp to an upright rect sized by the quad's
    edge lengths; if height ≥ 1.5·width, rotate 90° (transpose + vertical
    flip). The ``perspective`` crop mode."""
    points = np.asarray(box, dtype=np.float32)
    left, top = points[:, 0].min(), points[:, 1].min()
    right, bottom = points[:, 0].max(), points[:, 1].max()
    crop = img[int(top) : int(bottom), int(left) : int(right)]
    shifted = points - np.array([left, top], np.float32)

    width = int(np.sqrt(((shifted[0] - shifted[1]) ** 2).sum()))
    height = int(np.sqrt(((shifted[0] - shifted[3]) ** 2).sum()))
    std = np.array([[0, 0], [width, 0], [width, height], [0, height]], dtype=np.float32)
    m = get_perspective_transform(shifted, std)
    # quirk preserved: the reference passes cv::BORDER_REPLICATE in the
    # FLAGS position of the 5-arg warpPerspective (utility.cpp:178-181),
    # and BORDER_REPLICATE == 1 == INTER_LINEAR, so it runs with the
    # default constant (black) border. Match that, not the intent.
    dst = warp_perspective(crop, m, width, height)
    if dst.shape[0] >= dst.shape[1] * 1.5:
        dst = np.ascontiguousarray(np.swapaxes(dst, 0, 1)[::-1])
    return dst


def sort_boxes(boxes: List[np.ndarray]) -> List[int]:
    """Top-to-bottom, left-to-right ordering with a 10 px same-row
    tolerance. Reproduces Utility::sort_boxes (utility.cpp:315-327)
    including its single-pass bubble quirk: first sort by (y, x) of the
    top-left point, then swap adjacent entries whose rows overlap within
    10 px but are left-right inverted. Returns the index order."""
    order = sorted(range(len(boxes)), key=lambda i: (boxes[i][0][1], boxes[i][0][0]))
    if len(order) > 1:
        for i in range(len(order) - 1):
            for j in range(i, -1, -1):
                a, b = boxes[order[j + 1]], boxes[order[j]]
                if abs(a[0][1] - b[0][1]) < 10 and a[0][0] < b[0][0]:
                    order[i], order[i + 1] = order[i + 1], order[i]
    return order


def iou_float(a: Sequence[float], b: Sequence[float]) -> float:
    """Axis-aligned IoU over [x1, y1, x2, y2] floats (utility.cpp:401-424):
    areas clamp at 0 (inverted boxes contribute nothing) and the epsilon
    denominator returns 0.0 on crossing degenerate boxes instead of a
    ZeroDivisionError."""
    if a[2] <= b[0] or a[0] >= b[2] or a[3] <= b[1] or a[1] >= b[3]:
        return 0.0
    ix = min(a[2], b[2]) - max(a[0], b[0])
    iy = min(a[3], b[3]) - max(a[1], b[1])
    inter = max(ix, 0.0) * max(iy, 0.0)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / (area_a + area_b - inter + 1e-8)
