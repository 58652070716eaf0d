"""Host-side box helpers of the DB postprocess, in numpy.

Counterpart of the part of ``ppocr_tpu/ops/db_postprocess.py`` that the
fused path uses. The contour-based postprocess of the staged pipeline is
not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import numpy as np


def order_points_clockwise(pts: np.ndarray) -> np.ndarray:
    """4 points → [top-left, top-right, bottom-right, bottom-left]
    (postprocess_op.cpp:87-104: x-sort, then y-order within the left and
    right pairs)."""
    pts = np.asarray(pts)
    box = pts[np.argsort(pts[:, 0], kind="stable")]
    left = box[:2][np.argsort(box[:2, 1], kind="stable")]
    right = box[2:][np.argsort(box[2:, 1], kind="stable")]
    return np.array([left[0], right[0], right[1], left[1]], dtype=pts.dtype)
