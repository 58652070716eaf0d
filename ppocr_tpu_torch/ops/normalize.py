"""Normalization constants of the det (ImageNet) and rec/cls ((x − 0.5)/0.5)
inputs, applied on the device after the uint8 upload, the host-side
normalizers (the structure inputs') and the host-side batch packing of
the staged path (copied from ``ppocr_tpu/ops/normalize.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_SCALE = (1 / 0.229, 1 / 0.224, 1 / 0.225)
HALF_MEAN = (0.5, 0.5, 0.5)
HALF_SCALE = (2.0, 2.0, 2.0)  # 1/0.5


def normalize_chw_np(
    img: np.ndarray, mean: Sequence[float], scale: Sequence[float]
) -> np.ndarray:
    """Host normalize: uint8/float HWC → float32 CHW, (x/255 − mean)·scale
    in f32 (preprocess_op.cpp:40-55)."""
    x = img.astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) * np.asarray(scale, np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def normalize_imagenet_np(img: np.ndarray) -> np.ndarray:
    return normalize_chw_np(img, IMAGENET_MEAN, IMAGENET_SCALE)


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
