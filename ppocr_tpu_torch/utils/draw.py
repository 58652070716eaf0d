"""``cv2.polylines`` with ``LINE_8`` and ``shift`` 0, in numpy (no cv2).

The JAX package draws word quads with ``cv2.polylines``
(``ppocr_tpu/utils/visualize.py``); the machines that serve the port have
no cv2, so this module rebuilds what cv2 5.0's rasterizer
(imgproc/drawing.cpp) draws for the values that call passes, pixel for
pixel. The rules, each found by probing cv2 5.0:

- ``PolyLine`` (closed): segment i runs from point i - 1 to point i,
  starting at the last point; each segment caps its end point only, so
  every vertex gets one cap.
- Thickness ≤ 1 (0 draws as 1): the 8-connected ``Line`` of the end
  points (``LineIterator`` left to right, ``clipLine`` first), no caps.
- Thickness t > 1: the segment is first cut (``clipLine``, in integer
  pixels) to the canvas grown by t on every side; nothing is drawn when
  it misses that. Its end points then go to 16-bit fixed point
  (``XY_SHIFT``), and the quadrilateral end ± dp, dp =
  cvRound((dy, dx) · (t·2^15 + (t & 1)·2^15) / |d|), is filled by
  ``FillConvexPoly``: its edges by the fixed-point ``Line2`` (the
  rounded start, ``(end − start) >> 16`` steps of the major axis, and the
  rounded end point), then one span per row between two edge walkers
  that start at the topmost corner (rows ``(y + 2^15) >> 16``, each
  walker's x stepped by its edge's rounded slope, span ends rounded with
  ``delta = XY_ONE >> 1``). The cap is a filled ``Circle`` of radius
  (t·2^15 + 2^15) >> 16 (thickness 2: a plus of 5 pixels) at the cut end
  point.

Every part paints one colour, so the rasterizer gathers the parameters
of each part's runs of pixels in Python, expands them all at once with
numpy, clips them to the canvas as OpenCV clips them, and writes the
colour once. ``tests/test_torch_visualize.py`` holds it to
``cv2.polylines`` with 0 differing pixels.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1
MAX_THICKNESS = 32767
DBL_EPSILON = 2.220446049250313e-16


def _cdiv(a: int, b: int) -> int:
    """C integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """``clipLine``: the segment cut to [0, width) × [0, height), or None
    when nothing of it lies there."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _runs(counts: np.ndarray):
    """For runs of ``counts`` pixels: each pixel's run and its step in it."""
    run = np.repeat(np.arange(len(counts)), counts)
    step = np.arange(run.size, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    return run, step


class _Pixels:
    """What one drawing paints, as the parameters of its runs:

    - ``lines``: (x, y, major, minor, y step, vertical) of an integer
      Bresenham line, ``major + 1`` pixels from (x, y);
    - ``steps``: (major start, minor start in fixed point, minor step,
      count, x major) of a ``Line2`` loop;
    - ``points``: single pixels;
    - ``fills``: (first row, rows, x of walker a, its dx, x of b, its dx)
      of a run of ``FillConvexPoly`` rows between two fixed edges;
    - ``caps``: centres of filled circles of one radius.
    """

    def __init__(self, height: int, width: int):
        self.height, self.width = height, width
        self.lines: List[tuple] = []
        self.steps: List[tuple] = []
        self.points: List[Tuple[int, int]] = []
        self.fills: List[tuple] = []
        self.caps: List[Tuple[int, int]] = []

    def flat_indices(self, radius: int) -> np.ndarray:
        """Flat indices (row · width + column) of every painted pixel."""
        h, w = self.height, self.width
        xs, ys, x1s, x2s, rows = [], [], [], [], []
        if self.lines:
            x0, y0, major, minor, sy, vert = np.array(self.lines, np.int64).T
            run, k = _runs(major + 1)
            maj, mnr = major[run], minor[run]
            # err starts at major − 2·minor and the minor axis steps while
            # err < 0: its offset at step k is ceil((2·minor·k − major) / (2·major))
            m = np.maximum((2 * mnr * k + maj - 1) // np.maximum(2 * maj, 1), 0)
            v = vert[run].astype(bool)
            xs.append(x0[run] + np.where(v, m, k))
            ys.append(y0[run] + sy[run] * np.where(v, k, m))
        if self.steps:
            start, fixed, step, count, xmajor = np.array(self.steps, np.int64).T
            run, k = _runs(count)
            a = start[run] + k
            b = (fixed[run] + k * step[run]) >> XY_SHIFT
            xm = xmajor[run].astype(bool)
            xs.append(np.where(xm, a, b))
            ys.append(np.where(xm, b, a))
        if self.points:
            p = np.array(self.points, np.int64)
            xs.append(p[:, 0])
            ys.append(p[:, 1])
        if self.fills:
            y0, n, xa, dxa, xb, dxb = np.array(self.fills, np.int64).T
            run, k = _runs(n)
            a = xa[run] + k * dxa[run]
            b = xb[run] + k * dxb[run]
            rows.append(y0[run] + k)
            x1s.append((np.minimum(a, b) + HALF) >> XY_SHIFT)
            x2s.append((np.maximum(a, b) + HALF) >> XY_SHIFT)
        if self.caps:
            c = np.array(self.caps, np.int64)
            half = _circle_half_widths(radius)
            offs = np.arange(-radius, radius + 1, dtype=np.int64)
            rows.append((c[:, 1:2] + offs).ravel())
            x1s.append((c[:, 0:1] - half).ravel())
            x2s.append((c[:, 0:1] + half).ravel())
        out = []
        if xs:
            x, y = np.concatenate(xs), np.concatenate(ys)
            keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            out.append(y[keep] * w + x[keep])
        if rows:
            # a span that misses the canvas is dropped, the rest cut to it
            y, x1, x2 = np.concatenate(rows), np.concatenate(x1s), np.concatenate(x2s)
            keep = (y >= 0) & (y < h) & (x2 >= 0) & (x1 < w) & (x1 <= x2)
            y, x1, x2 = y[keep], np.maximum(x1[keep], 0), np.minimum(x2[keep], w - 1)
            run, k = _runs(x2 - x1 + 1)
            out.append((y * w + x1)[run] + k)
        return np.concatenate(out) if out else np.zeros(0, np.int64)


def _line8(px: _Pixels, x1: int, y1: int, x2: int, y2: int):
    """``Line`` with connectivity 8: ``LineIterator(img, pt1, pt2, 8,
    leftToRight=true)``, after ``clipLine`` when a point is outside."""
    w, h = px.width, px.height
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    vert = dy > dx
    px.lines.append(
        (x1, y1, dy if vert else dx, dx if vert else dy, 1 if y2 >= y1 else -1, int(vert))
    )


def _line2(px: _Pixels, x1: int, y1: int, x2: int, y2: int):
    """``Line2``: the line between two points in 16-bit fixed point."""
    clipped = _clip_line(px.width << XY_SHIFT, px.height << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    xmajor = abs(dx) > abs(dy)
    if xmajor and dx < 0 or not xmajor and dy < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    px.points.append(((x2 + HALF) >> XY_SHIFT, (y2 + HALF) >> XY_SHIFT))
    if xmajor:
        step = _cdiv(dy << XY_SHIFT, dx | 1)
        px.steps.append(((x1 + HALF) >> XY_SHIFT, y1 + HALF, step, ((x2 - x1) >> XY_SHIFT) + 1, 1))
    else:
        step = _cdiv(dx << XY_SHIFT, dy | 1)
        px.steps.append(((y1 + HALF) >> XY_SHIFT, x1 + HALF, step, ((y2 - y1) >> XY_SHIFT) + 1, 0))


def _fill_convex(px: _Pixels, v: Sequence[Tuple[int, int]]):
    """``FillConvexPoly`` of points in 16-bit fixed point (``shift`` =
    ``XY_SHIFT``) for LINE_8: the edges by ``Line2``, then one span per row
    between two edge walkers, which start at the topmost point and take
    the next edge whenever the row reaches the end of theirs; they share
    one budget of ``len(v)`` edges."""
    n = len(v)
    prev = v[-1]
    for p in v:
        _line2(px, prev[0], prev[1], p[0], p[1])
        prev = p
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + HALF) >> XY_SHIFT, (max(xs) + HALF) >> XY_SHIFT
    ymin, ymax = (min(ys) + HALF) >> XY_SHIFT, (max(ys) + HALF) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= px.width or ymin >= px.height:
        return
    ymax = min(ymax, px.height - 1)
    # per walker: [vertex index, direction, x, dx, row where its edge ends]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while True:
                edges -= 1
                if edges < 0:  # the budget ran out: the fill ends
                    break
                ty = (v[idx][1] + HALF) >> XY_SHIFT
                if ty > y:
                    e[4] = ty
                    e[3] = _cdiv((v[idx][0] - v[idx0][0]) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = v[idx0][0]
                    e[0] = idx
                    break
                idx0 = idx
                idx = (idx + di) % n
        if edges < 0:
            break
        y_end = min(edge[0][4], edge[1][4], ymax + 1)
        first = max(y, 0)  # rows above the canvas paint nothing
        if first < y_end:
            skip = first - y
            px.fills.append((first, y_end - first, edge[0][2] + skip * edge[0][3], edge[0][3],
                             edge[1][2] + skip * edge[1][3], edge[1][3]))
        edge[0][2] += (y_end - y) * edge[0][3]
        edge[1][2] += (y_end - y) * edge[1][3]
        y = y_end
        if y > ymax:
            break


@lru_cache(maxsize=64)
def _circle_half_widths(radius: int) -> np.ndarray:
    """``Circle(..., fill=1)``: the half width of the filled circle's span
    at each row offset -radius..radius (its spans are all centred)."""
    half = np.full(2 * radius + 1, -1, np.int64)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for off, hw in ((-dy, dx), (dy, dx), (-dx, dy), (dx, dy)):
            half[off + radius] = max(half[off + radius], hw)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return half


def _thick_line(px: _Pixels, p0: Tuple[int, int], p1: Tuple[int, int], thickness: int):
    """``ThickLine`` with shift 0 and flags 2: a cap at the end point."""
    if thickness <= 1:
        _line8(px, p0[0], p0[1], p1[0], p1[1])
        return
    t = thickness
    cut = _clip_line(px.width + 2 * t, px.height + 2 * t, p0[0] + t, p0[1] + t, p1[0] + t, p1[1] + t)
    if cut is None:
        return
    x0, y0, x1, y1 = ((c - t) << XY_SHIFT for c in cut)
    dx = (x0 - x1) * (1.0 / XY_ONE)
    dy = (y1 - y0) * (1.0 / XY_ONE)
    r = dx * dx + dy * dy
    if abs(r) > DBL_EPSILON:
        r = ((t << (XY_SHIFT - 1)) + (t & 1) * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)  # cvRound: half to even
        _fill_convex(
            px,
            [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy), (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)],
        )
    px.caps.append(((x1 + HALF) >> XY_SHIFT, (y1 + HALF) >> XY_SHIFT))


def _raw_color(color, nch: int) -> np.ndarray:
    """``scalarToRawData`` for uint8: the colour's first ``nch`` channels (a
    missing one is 0), rounded and saturated."""
    vals = (list(color) if np.ndim(color) else [color]) + [0.0] * 4
    return np.clip(np.rint(np.asarray(vals[:nch], np.float64)), 0, 255).astype(np.uint8)


def polylines(img: np.ndarray, pts, color, thickness: int = 1) -> np.ndarray:
    """``cv2.polylines(img, pts, True, color, thickness)`` with LINE_8 and
    shift 0 on a uint8 [H, W] or [H, W, C] canvas: draws into ``img`` in
    place and returns it. ``pts`` is a list of integer point arrays (any
    shape that reshapes to [N, 2]), each one closed polyline; an empty one
    draws nothing. Raises ``ValueError`` where cv2 fails its assertion (a
    thickness below 0 or above 32767), and for another canvas."""
    thickness = int(thickness)
    if not 0 <= thickness <= MAX_THICKNESS:
        raise ValueError(
            f"polylines: thickness {thickness} is outside [0, {MAX_THICKNESS}] "
            "(cv2 fails its assertion there)"
        )
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"polylines: a {img.dtype} canvas of shape {img.shape}, not uint8 [H, W(, C)]")
    h, w = img.shape[:2]
    px = _Pixels(h, w)
    for poly in pts:
        v = [(int(x), int(y)) for x, y in np.asarray(poly, np.int64).reshape(-1, 2)]
        if not v:
            continue
        prev = v[-1]
        for p in v:
            _thick_line(px, prev, p, thickness)
            prev = p
    radius = ((thickness << (XY_SHIFT - 1)) + HALF) >> XY_SHIFT
    ys, xs = np.divmod(px.flat_indices(radius), w)
    if ys.size:
        raw = _raw_color(color, 1 if img.ndim == 2 else img.shape[2])
        img[ys, xs] = raw[0] if img.ndim == 2 else raw
    return img
