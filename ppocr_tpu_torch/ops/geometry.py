"""Host geometry helpers mirroring Utility (utility.cpp), in numpy.

Counterpart of ``ppocr_tpu/ops/geometry.py``, which calls cv2 for the
bounding rect and the perspective warp. Here ``bounding_crop`` takes the
min/max of the points itself, and ``get_rotate_crop_image`` carries its
own ``getPerspectiveTransform`` (an 8×8 solve) and ``warpPerspective``
(inverse map, constant black border, bilinear in f32); the synthetic
training crops' rotation has ``getRotationMatrix2D`` and ``warpAffine``
(constant border of any value) alike.

Tolerance to cv2, held by ``tests/test_torch_staged_ops.py`` against
OpenCV 5.0, which interpolates in floating point: the warp is within 1
grey level of ``cv2.warpPerspective`` on every pixel and equal on at
least 99 % of them; equality is not promised. OpenCV 4.x up to 4.10
rounds the source coordinates to 1/32 px and the weights to 2^15 instead,
which moves high-contrast pixels by several grey levels against either of
the two. The other functions are exact.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

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
    that maps the four ``src`` points onto the four ``dst`` points."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[i] = (x, y, 1, 0, 0, 0, -x * u, -y * u)
        a[i + 4] = (0, 0, 0, x, y, 1, -x * v, -y * v)
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


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
    image: bilinear, constant black border. Each output pixel's source
    position comes from the inverted matrix; a tap outside the image reads
    0. Positions and weights are f32, the result is rounded to nearest."""
    if width <= 0 or height <= 0:
        raise ValueError(f"warp_perspective: empty output size {(width, height)}")
    inv = _invert3(np.asarray(m, np.float64)).astype(np.float32)
    xs = np.arange(width, dtype=np.float32)[None, :]
    ys = np.arange(height, dtype=np.float32)[:, None]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        den = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
        fx = np.nan_to_num((inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) / den)
        fy = np.nan_to_num((inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) / den)
    return _sample_bilinear(img, fx, fy, 0)


def _sample_bilinear(img: np.ndarray, fx: np.ndarray, fy: np.ndarray, border_value) -> np.ndarray:
    """uint8 H×W×C (or H×W) image sampled at f32 source positions, cv2's
    bilinear with a constant border: a tap outside the image reads
    ``border_value``; the result is rounded to nearest."""
    h, w = img.shape[:2]
    x0, y0 = np.floor(fx), np.floor(fy)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    # the image is padded by two pixels of border before and one after, so
    # that s = −2 (and anything further out) and s = w find both taps in
    # the padding
    sx = np.clip(x0, -2, w).astype(np.intp) + 2
    sy = np.clip(y0, -2, h).astype(np.intp) + 2
    sx1 = np.minimum(sx + 1, w + 2)
    sy1 = np.minimum(sy + 1, h + 2)
    src = img if img.ndim == 3 else img[..., None]
    c = src.shape[2]
    pad = np.empty((h + 3, w + 3, c), np.float32)
    pad[...] = np.asarray(border_value, np.float32).ravel()[:c] if np.ndim(border_value) \
        else np.float32(border_value)
    pad[2:-1, 2:-1] = src
    flat = pad.reshape(-1, c)
    row, row1 = sy * (w + 3), sy1 * (w + 3)
    top = flat.take(row + sx, axis=0) * (1 - ax) + flat.take(row + sx1, axis=0) * ax
    bot = flat.take(row1 + sx, axis=0) * (1 - ax) + flat.take(row1 + sx1, axis=0) * ax
    out = np.clip(np.rint(top * (1 - ay) + bot * ay), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: 2×3 (f64) rotation by ``angle`` degrees
    (counter-clockwise) about ``center``, scaled by ``scale``."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array(
        [[alpha, beta, (1 - alpha) * cx - beta * cy],
         [-beta, alpha, beta * cx + (1 - alpha) * cy]],
        np.float64,
    )


def warp_affine(img: np.ndarray, m: np.ndarray, width: int, height: int,
                border_value=0) -> np.ndarray:
    """``cv2.warpAffine(img, m, (width, height), borderValue=border_value)``
    for a uint8 H×W×C (or H×W) image: bilinear, constant border. The 2×3
    matrix is inverted as cv2 inverts it (f64); positions and weights are
    f32, a tap outside the image reads ``border_value``, the result is
    rounded to nearest."""
    if width <= 0 or height <= 0:
        raise ValueError(f"warp_affine: empty output size {(width, height)}")
    m = np.asarray(m, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    inv = np.array([[a11, a12, b1], [a21, a22, b2]], np.float64).astype(np.float32)
    xs = np.arange(width, dtype=np.float32)[None, :]
    ys = np.arange(height, dtype=np.float32)[:, None]
    fx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    fy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    return _sample_bilinear(img, fx, fy, border_value)


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
