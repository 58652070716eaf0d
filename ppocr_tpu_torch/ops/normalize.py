"""Normalization constants of the det (ImageNet) and rec/cls ((x − 0.5)/0.5)
inputs, applied on the device after the uint8 upload, and the host-side
batch packing of the staged path (copied from
``ppocr_tpu/ops/normalize.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_SCALE = (1 / 0.229, 1 / 0.224, 1 / 0.225)
HALF_MEAN = (0.5, 0.5, 0.5)
HALF_SCALE = (2.0, 2.0, 2.0)  # 1/0.5


def pack_batch(images: Sequence[np.ndarray], width: int) -> np.ndarray:
    """Stack variable-width HWC uint8 crops into a zero-padded NHWC batch.

    Black (0) padding matches the recognizer: rec pads with black pixels
    *before* normalization (preprocess_op.cpp:115-117), so uint8 zero
    columns normalize to the same −1 the reference feeds. The cls path
    must instead mask after normalization."""
    n = len(images)
    h = images[0].shape[0]
    c = images[0].shape[2] if images[0].ndim == 3 else 1
    out = np.zeros((n, h, width, c), dtype=np.uint8)
    for i, im in enumerate(images):
        out[i, :, : im.shape[1]] = im if im.ndim == 3 else im[..., None]
    return out
