"""DB (Differentiable Binarization) detection postprocess on the host.

Counterpart of ``ppocr_tpu/ops/db_postprocess.py``; behavioural mirror of
DBPostProcessor (postprocess_op.cpp:20-362) and the threshold step of
DBDetector::Run (ocr_det.cpp:136-160)::

    prob map → uint8(prob·255) → binary (> thresh·255) → [dilate 2×2]
    → contours → per contour: min-area rect → ssid ≥ 3 → score ≥ box_thresh
    → unclip by distance = area·ratio/perimeter → min-area rect → ssid ≥ 5
    → round/clamp → order clockwise → rescale to source → drop ≤ 4 px sides

The threshold, the dilation and the final filter are numpy; the contour
half is the C++ core ``csrc/dbpost.cpp`` through ``ops.native``. The JAX
package runs that half on cv2 by default, so the two packages' boxes agree
within a stated tolerance and not bit for bit (``tests/test_torch_staged_ops.py``:
corners within 2 px, and a box whose score sits on ``box_thresh`` may flip).
The JAX module's cv2 helpers ``get_mini_boxes``, ``unclip_rect`` and
``boxes_from_bitmap`` are here too, without cv2: ``cv2.boxPoints`` and
``cv2.minAreaRect`` rebuilt in numpy float32 (``box_points``,
``min_area_rect``), and the C++ core for the contours.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import native


def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: half away from zero (np.round is banker's rounding and
    would shift exact-.5 box corners by 1 px)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def order_points_clockwise(pts: np.ndarray) -> np.ndarray:
    """4 points → [top-left, top-right, bottom-right, bottom-left]
    (postprocess_op.cpp:87-104: x-sort, then y-order within the left and
    right pairs)."""
    pts = np.asarray(pts)
    box = pts[np.argsort(pts[:, 0], kind="stable")]
    left = box[:2][np.argsort(box[:2, 1], kind="stable")]
    right = box[2:][np.argsort(box[2:, 1], kind="stable")]
    return np.array([left[0], right[0], right[1], left[1]], dtype=pts.dtype)


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints``: the four corners of a rotated rect ((cx, cy), (w,
    h), degrees), as cv2 5.0 computes them: the angle in double, its
    cosine and sine halved in float32, each corner as centre ± a·h ± b·w
    in float32, left to right (the same bits as cv2 on 20,000 random
    rects; mirroring the first two through the centre is not)."""
    (cx, cy), (w, h), angle = rect
    f = np.float32
    cx, cy, w, h = f(cx), f(cy), f(w), f(h)
    rad = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(rad)) * f(0.5)
    a = f(math.sin(rad)) * f(0.5)
    return np.array(
        [
            (cx - a * h - b * w, cy + b * h - a * w),
            (cx + a * h - b * w, cy - b * h - a * w),
            (cx + a * h + b * w, cy - b * h + a * w),
            (cx - a * h + b * w, cy + b * h + a * w),
        ],
        np.float32,
    )


def get_mini_boxes(rect) -> Tuple[np.ndarray, float]:
    """Rotated rect ((cx, cy), (w, h), degrees) → its corners in the
    reference's canonical order, plus ssid = max(w, h) (GetMiniBoxes,
    postprocess_op.cpp:134-168; upstream PaddleOCR takes min(w, h), this
    reference **max**, postprocess_op.cpp:137)."""
    (cx, cy), (w, h), angle = rect
    ssid = max(w, h)
    points = box_points(((cx, cy), (w, h), angle))
    array = points[np.argsort(points[:, 0], kind="stable")]
    if array[3][1] <= array[2][1]:
        idx2, idx3 = array[3], array[2]
    else:
        idx2, idx3 = array[2], array[3]
    if array[1][1] <= array[0][1]:
        idx1, idx4 = array[1], array[0]
    else:
        idx1, idx4 = array[0], array[1]
    return np.array([idx1, idx2, idx3, idx4], dtype=np.float32), float(ssid)


def _hull(pts: np.ndarray) -> List[int]:
    """Indices of the convex hull of [N, 2] points (no repeated or collinear
    points) in ``cv2.convexHull``'s order: clockwise on the screen (y
    down) from the rightmost point, then turned, as cv2 turns it, to run
    through ascending or descending indices where some turn does. (Where
    points repeat, cv2 may name another of the copies.)"""
    p = [(float(x), float(y)) for x, y in pts]
    order = sorted(range(len(p)), key=lambda i: p[i])

    def turn(o, a, b):
        return (p[a][0] - p[o][0]) * (p[b][1] - p[o][1]) - (p[a][1] - p[o][1]) * (p[b][0] - p[o][0])

    uniq = [i for k, i in enumerate(order) if k == 0 or p[i] != p[order[k - 1]]]
    if len(uniq) < 3:
        return uniq
    lower: List[int] = []
    upper: List[int] = []
    for i in uniq:
        while len(lower) >= 2 and turn(lower[-2], lower[-1], i) <= 0:
            lower.pop()
        lower.append(i)
    for i in reversed(uniq):
        while len(upper) >= 2 and turn(upper[-2], upper[-1], i) <= 0:
            upper.pop()
        upper.append(i)
    hull = lower[:-1] + upper[:-1]
    n = len(hull)
    start = max(range(n), key=lambda k: p[hull[k]])
    hull = hull[start:] + hull[:start]
    # convexHull's cyclic shift toward a monotonic run of indices
    lo = hi = ascents = 0
    for i in range(1, n):
        ascents += hull[i - 1] < hull[i]
        if 1 < ascents <= i - 2:
            break
        lo = i if hull[i] < hull[lo] else lo
        hi = i if hull[i] > hull[hi] else hi
    if abs(hi - lo) in (1, n - 1) and (ascents <= 1 or ascents >= n - 2):
        ascending = (hi + 1) % n == lo
        i0 = lo if ascending else hi
        turned = hull[i0:] + hull[:i0]
        if i0 > 0 and all((a < b) == ascending for a, b in zip(turned, turned[1:])):
            hull = turned
    return hull


def min_area_rect(points: np.ndarray):
    """``cv2.minAreaRect`` of a point set whose hull has 3 or more points:
    ((cx, cy), (w, h), degrees in [-90, 0)), as cv2 5.0's rotating calipers
    compute it in float32 (OpenCV's rotcalipers.cpp) over the hull in
    ``cv2.convexHull``'s order (which decides ties), the angle in double.
    The C++ core's ``native.min_area_rect`` finds the same minimum by
    another route, whose floats differ from cv2's. ``tests/test_torch_db_helpers.py``
    holds this one to cv2 (exact on all but a few near-ties)."""
    f = np.float32
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    hull = [pts[i] for i in _hull(pts)]
    n = len(hull)
    if n < 3:
        raise ValueError(f"min_area_rect: the hull has {n} points")
    vect, inv = [], []
    left = bottom = right = top = 0
    left_x = right_x = hull[0][0]
    top_y = bottom_y = hull[0][1]
    for i in range(n):
        p, q = hull[i], hull[(i + 1) % n]
        if p[0] < left_x:
            left_x, left = p[0], i
        if p[0] > right_x:
            right_x, right = p[0], i
        if p[1] > top_y:
            top_y, top = p[1], i
        if p[1] < bottom_y:
            bottom_y, bottom = p[1], i
        dx, dy = float(q[0] - p[0]), float(q[1] - p[1])
        vect.append((f(dx), f(dy)))
        inv.append(f(1.0 / math.sqrt(dx * dx + dy * dy)))
    orientation = f(0)
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for vx, vy in vect:
        convexity = ax * float(vy) - ay * float(vx)
        if convexity != 0:
            orientation = f(1) if convexity > 0 else f(-1)
            break
        ax, ay = float(vx), float(vy)
    base_a, base_b = orientation, f(0)
    seq = [bottom, right, top, left]
    min_area, best = f(np.finfo(np.float32).max), None
    for _ in range(n):
        # the caliper whose side makes the smallest angle with its edge turns
        dots = (base_a * vect[seq[0]][0] + base_b * vect[seq[0]][1],
                -base_b * vect[seq[1]][0] + base_a * vect[seq[1]][1],
                -base_a * vect[seq[2]][0] - base_b * vect[seq[2]][1],
                base_b * vect[seq[3]][0] - base_a * vect[seq[3]][1])
        main, max_cos = 0, dots[0] * inv[seq[0]]
        for i in range(1, 4):
            c = dots[i] * inv[seq[i]]
            if c > max_cos:
                main, max_cos = i, c
        k = seq[main]
        lx, ly = vect[k][0] * inv[k], vect[k][1] * inv[k]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (seq[main] + 1) % n
        width = (hull[seq[1]][0] - hull[seq[3]][0]) * base_a + (hull[seq[1]][1] - hull[seq[3]][1]) * base_b
        height = -(hull[seq[2]][0] - hull[seq[0]][0]) * base_b + (hull[seq[2]][1] - hull[seq[0]][1]) * base_a
        area = width * height
        if area <= min_area:
            min_area, best = area, (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * hull[i_left][0] + hull[i_left][1] * b1
    c2 = a2 * hull[i_bottom][0] + hull[i_bottom][1] * b2
    idet = f(1) / (a1 * b2 - a2 * b1)
    px, py = (c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet
    side_w, side_h = (a1 * width, b1 * width), (a2 * height, b2 * height)
    cx, cy = px + (side_w[0] + side_h[0]) * f(0.5), py + (side_w[1] + side_h[1]) * f(0.5)
    w = f(math.sqrt(float(side_w[0]) ** 2 + float(side_w[1]) ** 2))
    h = f(math.sqrt(float(side_h[0]) ** 2 + float(side_h[1]) ** 2))
    angle = math.atan2(float(side_w[1]), float(side_w[0])) * 180 / math.pi
    while angle >= 0:
        w, h, angle = h, w, angle - 90
    while angle < -90:
        w, h, angle = h, w, angle + 90
    return (float(cx), float(cy)), (float(w), float(h)), float(f(angle))


def unclip_rect(box: np.ndarray, unclip_ratio: float):
    """Closed-form Clipper round-join offset of a quad + min-area rect.

    distance = area·ratio/perimeter (postprocess_op.cpp:20-37); the quad's
    vertices are int-truncated first, like the ClipperLib::Path
    construction at postprocess_op.cpp:48-51. Returns a rotated rect
    ((cx, cy), (w + 2d, h + 2d), degrees), or None when the polygon is
    degenerate (Clipper's empty solution). The JAX function takes
    ``cv2.contourArea`` (here the shoelace formula on the truncated points)
    and ``cv2.minAreaRect`` (here :func:`min_area_rect`)."""
    pts = box.astype(np.float32)
    area = 0.0
    perim = 0.0
    for i in range(4):
        j = (i + 1) % 4
        area += pts[i, 0] * pts[j, 1] - pts[i, 1] * pts[j, 0]
        perim += float(np.hypot(pts[i, 0] - pts[j, 0], pts[i, 1] - pts[j, 1]))
    area = abs(area / 2.0)
    if perim <= 0:
        return None
    distance = area * unclip_ratio / perim

    ipts = np.trunc(pts).astype(np.float64)
    shoelace = np.dot(ipts[:, 0], np.roll(ipts[:, 1], -1)) - np.dot(ipts[:, 1], np.roll(ipts[:, 0], -1))
    if abs(shoelace) / 2.0 <= 0:
        return None
    (cx, cy), (w, h), angle = min_area_rect(ipts)
    return ((cx, cy), (w + 2 * distance, h + 2 * distance), angle)


def boxes_from_bitmap(
    pred: np.ndarray,
    bitmap: np.ndarray,
    box_thresh: float,
    unclip_ratio: float,
    score_mode: str = "slow",
    max_candidates: int = 1000,
    min_size: int = 3,
) -> List[np.ndarray]:
    """Bitmap → list of int64 quads in pred-map coordinates
    (postprocess_op.cpp:255-331), on the C++ core; the JAX function's cv2
    contours agree within ``tests/test_torch_staged_ops.py``'s tolerances.
    A box is kept when the longer side of its min-area rect is at least
    ``min_size`` and that of its unclipped rect at least ``min_size + 2``."""
    boxes, _scores = native.boxes_from_bitmap(
        pred, bitmap, box_thresh, unclip_ratio, score_mode, max_candidates, min_size
    )
    return boxes


def dilate2x2(bit: np.ndarray) -> np.ndarray:
    """``cv2.dilate`` with a 2×2 MORPH_RECT kernel: the even kernel anchors
    at (1, 1), so out(y, x) = max in[y-1..y, x-1..x] with replicated
    borders, i.e. ink spreads down and to the right."""
    p = np.pad(bit, ((1, 0), (1, 0)), mode="edge")
    return np.maximum(
        np.maximum(p[:-1, :-1], p[:-1, 1:]), np.maximum(p[1:, :-1], p[1:, 1:])
    )


def filter_tag_det_res(
    boxes: List[np.ndarray], ratio_h: float, ratio_w: float, src_h: int, src_w: int
) -> List[np.ndarray]:
    """Order clockwise, rescale to source pixels (int-truncating division,
    matching the C++ ``int /= float``), clamp, drop quads with either
    ordered side ≤ 4 px (postprocess_op.cpp:333-362)."""
    out = []
    for box in boxes:
        box = order_points_clockwise(box).astype(np.int64)
        box[:, 0] = np.clip((box[:, 0] / ratio_w).astype(np.int64), 0, src_w - 1)
        box[:, 1] = np.clip((box[:, 1] / ratio_h).astype(np.int64), 0, src_h - 1)
        rect_w = int(np.sqrt(((box[0] - box[1]) ** 2).sum()))
        rect_h = int(np.sqrt(((box[0] - box[3]) ** 2).sum()))
        if rect_w <= 4 or rect_h <= 4:
            continue
        out.append(box)
    return out


@dataclass
class DBPostProcess:
    """Bundled DB postprocess with the reference's two config profiles
    (header defaults ocr_det.h:108-123 vs the serving profile
    ocr_worker.cpp:28-33).

    ``backend`` takes the JAX package's values and every one runs the C++
    core: "native" and "auto" as the JAX package runs them (it picks the
    core under "auto" whenever the core is built, and here it always is),
    and "cv2" (or any other value, which the JAX package treats as "cv2")
    too, since the machines that serve the port have no cv2. Under "cv2"
    the JAX package's contours come from cv2, which the core follows
    within ``tests/test_torch_staged_ops.py``'s tolerances."""

    thresh: float = 0.3
    box_thresh: float = 0.5
    unclip_ratio: float = 2.0
    score_mode: str = "slow"
    use_dilation: bool = False
    max_candidates: int = 1000
    backend: str = "auto"

    def binarize_np(self, prob_map: np.ndarray) -> np.ndarray:
        """Probability map → uint8 {0, 255} bitmap (ocr_det.cpp:144-160):
        quantize to uint8 by truncation, strict > thresh·255, then the
        optional 2×2 dilation."""
        cbuf = (prob_map * 255.0).astype(np.uint8)
        bit = ((cbuf > int(self.thresh * 255)) * 255).astype(np.uint8)
        return dilate2x2(bit) if self.use_dilation else bit

    def __call__(
        self,
        prob_map: np.ndarray,
        src_h: int,
        src_w: int,
        ratio_h: float,
        ratio_w: float,
        bitmap: Optional[np.ndarray] = None,
    ) -> List[np.ndarray]:
        """prob_map [H, W] float32 (and optionally its bitmap) → list of
        4×2 int quads in source-image coordinates."""
        if bitmap is None:
            bitmap = self.binarize_np(prob_map)
        boxes, _scores = native.boxes_from_bitmap(
            prob_map,
            bitmap,
            self.box_thresh,
            self.unclip_ratio,
            self.score_mode,
            self.max_candidates,
        )
        return filter_tag_det_res(boxes, ratio_h, ratio_w, src_h, src_w)
