"""Structure-analysis postprocess: table decode + PicoDet layout boxes.

Counterpart of ``ppocr_tpu/ops/structure.py``, copied as it is (host
numpy; the JAX module imports no JAX, but the port imports nothing of the
JAX package). The reference vendors these beside the DB postprocess
(postprocess_op.cpp:364-588): the PP-Structure table-structure HTML-tag
decoder and the PicoDet layout detector's distribution-focal-loss box
decode with class-wise hard NMS. The OCR worker does not call them; they
run on small decoder outputs. Their preprocessing is
``ops.resize.table_resize`` / ``table_pad`` / ``resize_hw`` and
``ops.normalize.normalize_imagenet_np``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .geometry import iou_float


# ---------------------------------------------------------------------------
# Table structure decode (TablePostProcessor semantics)


def load_table_labels(path: str, merge_no_span_structure: bool = True) -> List[str]:
    """Table-structure dict loader (Utility::ReadDict, utility.cpp:32-48).

    Interior blank lines are KEPT like the reference's std::getline loop —
    dropping them would shift every later class index and decode wrong
    tags for identical logits. Documented deviation: trailing ``\\r`` is
    stripped (a CRLF-authored dict would otherwise leak carriage returns
    into the emitted HTML — same harmless-bug fix as pipeline.charset)."""
    with open(path, "r", encoding="utf-8") as f:
        raw = f.read()
    lines = raw.split("\n")
    if lines and lines[-1] == "":
        lines = lines[:-1]  # the final newline, not an empty class
    labels = [line.rstrip("\r") for line in lines]
    if merge_no_span_structure:
        labels.append("<td></td>")
        labels = [t for t in labels if t != "<td>"]
    return ["sos"] + labels + ["eos"]


def table_decode(
    structure_probs: np.ndarray,
    loc_preds: np.ndarray,
    labels: Sequence[str],
    widths: Sequence[int],
    heights: Sequence[int],
) -> Tuple[List[List[str]], List[List[List[int]]], List[float]]:
    """[B,T,C] structure probs + [B,T,P] box regressions → per-image HTML
    tags, <td> cell boxes (denormalized, int-truncated), and mean scores
    (−1 when empty/NaN, matching postprocess_op.cpp:444-447)."""
    beg, end = labels[0], labels[-1]
    tags_batch, boxes_batch, scores = [], [], []
    for b in range(structure_probs.shape[0]):
        tags: List[str] = []
        boxes: List[List[int]] = []
        total, count = 0.0, 0
        for t in range(structure_probs.shape[1]):
            idx = int(structure_probs[b, t].argmax())
            char_score = float(structure_probs[b, t].max())
            tag = labels[idx]
            if t > 0 and tag == end:
                break
            if tag == beg:
                continue
            count += 1
            total += char_score
            tags.append(tag)
            if tag in ("<td>", "<td", "<td></td>"):
                box = []
                for p in range(loc_preds.shape[2]):
                    scale = widths[b] if p % 2 == 0 else heights[b]
                    box.append(int(loc_preds[b, t, p] * scale))
                boxes.append(box)
        score = total / count if count else float("nan")
        if np.isnan(score) or len(boxes) == 0:
            score = -1.0
        tags_batch.append(tags)
        boxes_batch.append(boxes)
        scores.append(float(score))
    return tags_batch, boxes_batch, scores


# ---------------------------------------------------------------------------
# PicoDet layout decode (PicodetPostProcessor semantics)


@dataclass
class LayoutBox:
    box: List[float]  # [x0, y0, x1, y1] in source coords
    type: str
    confidence: float


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


def dis_pred_to_bbox(
    bbox_pred: np.ndarray, x: int, y: int, stride: int, im_h: int, im_w: int, reg_max: int
) -> List[float]:
    """Distribution-focal-loss decode: expectation over reg_max bins per
    side, scaled by the FPN stride (postprocess_op.cpp:525-556)."""
    ct_x = (x + 0.5) * stride
    ct_y = (y + 0.5) * stride
    dis = [
        float((np.arange(reg_max) * _softmax(bbox_pred[i * reg_max : (i + 1) * reg_max])).sum())
        * stride
        for i in range(4)
    ]
    return [
        max(ct_x - dis[0], 0.0),
        max(ct_y - dis[1], 0.0),
        min(ct_x + dis[2], float(im_w)),
        min(ct_y + dis[3], float(im_h)),
    ]


def hard_nms(boxes: List[LayoutBox], nms_threshold: float) -> List[LayoutBox]:
    """Greedy class-internal NMS (postprocess_op.cpp:558-587)."""
    boxes = sorted(boxes, key=lambda b: -b.confidence)
    picked = [True] * len(boxes)
    for i in range(len(boxes)):
        if not picked[i]:
            continue
        for j in range(i + 1, len(boxes)):
            if picked[j] and iou_float(boxes[i].box, boxes[j].box) > nms_threshold:
                picked[j] = False
    return [b for b, keep in zip(boxes, picked) if keep]


def picodet_decode(
    cls_outs: Sequence[np.ndarray],
    reg_outs: Sequence[np.ndarray],
    labels: Sequence[str],
    ori_shape: Tuple[int, int],
    resize_shape: Tuple[int, int],
    fpn_stride: Sequence[int] = (8, 16, 32, 64),
    score_threshold: float = 0.4,
    nms_threshold: float = 0.5,
    reg_max: int = 8,
) -> List[LayoutBox]:
    """Per-level [HW, n_class] scores + [HW, 4·reg_max] regressions →
    NMS-filtered layout boxes in source-image coordinates."""
    in_h, in_w = resize_shape
    sf_h = in_h / ori_shape[0]
    sf_w = in_w / ori_shape[1]
    per_class: Dict[int, List[LayoutBox]] = {}
    for level, stride in enumerate(fpn_stride):
        fh = int(np.ceil(in_h / stride))
        fw = int(np.ceil(in_w / stride))
        cls = np.asarray(cls_outs[level]).reshape(fh * fw, len(labels))
        reg = np.asarray(reg_outs[level]).reshape(fh * fw, 4 * reg_max)
        best = cls.argmax(axis=1)
        best_score = cls.max(axis=1)
        for idx in np.nonzero(best_score > score_threshold)[0]:
            row, col = divmod(int(idx), fw)
            box = dis_pred_to_bbox(
                reg[idx], col, row, stride, in_h, in_w, reg_max
            )
            per_class.setdefault(int(best[idx]), []).append(
                LayoutBox(box, labels[int(best[idx])], float(best_score[idx]))
            )
    results: List[LayoutBox] = []
    for _, items in sorted(per_class.items()):
        for b in hard_nms(items, nms_threshold):
            b.box = [
                b.box[0] / sf_w,
                b.box[1] / sf_h,
                b.box[2] / sf_w,
                b.box[3] / sf_h,
            ]
            results.append(b)
    return results
