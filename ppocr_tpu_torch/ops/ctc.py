"""Greedy CTC decode: device half (top-k kernel) and host half (collapse).

Counterpart of ``ppocr_tpu/ops/ctc.py`` ``ctc_topk_device`` and
``ctc_greedy_collapse``. Only [N, T] indices and max probs leave the
device, never the [N, T, V] softmax.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .kernels import ctc_topk


def ctc_topk_device(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep first argmax (int32) and max prob (f32) of [N, T, V]
    post-softmax probabilities: the CUDA kernel on the card, its plain
    version for CPU tensors (``ops.kernels.ctc_topk``)."""
    return ctc_topk(probs)


def ctc_greedy_collapse(
    indices: np.ndarray, probs: np.ndarray
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Host half: collapse repeats + drop blanks, per the reference rule.

    Keep timestep n iff ``idx[n] > 0 and not (n > 0 and idx[n] == idx[n-1])``
    (blank id 0). Confidence is the mean of kept max-probs; a crop with no
    kept steps gets NaN, which callers skip (reference: ``isnan →
    continue``). Returns (kept-index arrays per item, confidence[N])."""
    indices = np.asarray(indices)
    probs = np.asarray(probs)
    n, t = indices.shape
    keep = indices > 0
    keep[:, 1:] &= indices[:, 1:] != indices[:, :-1]
    out_indices = [indices[i][keep[i]] for i in range(n)]
    counts = keep.sum(axis=1)
    with np.errstate(invalid="ignore"):
        conf = np.where(
            counts > 0,
            np.where(keep, probs, 0.0).sum(axis=1) / np.maximum(counts, 1),
            np.nan,
        )
    return out_indices, conf.astype(np.float32)
