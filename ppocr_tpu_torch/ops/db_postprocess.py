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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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

    The JAX package's ``backend`` field ("cv2" | "native" | "auto") is not
    carried over: this package has one backend, the C++ core."""

    thresh: float = 0.3
    box_thresh: float = 0.5
    unclip_ratio: float = 2.0
    score_mode: str = "slow"
    use_dilation: bool = False
    max_candidates: int = 1000

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
