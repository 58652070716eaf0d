"""CTC decode: greedy (reference parity) and prefix beam search, each with
a device half and a host half.

Counterpart of ``ppocr_tpu/ops/ctc.py``. Greedy: the top-k kernel on the
device (``ctc_topk_device``), then ``ctc_greedy_collapse``; only [N, T]
indices and max probs leave the device, never the [N, T, V] softmax. Beam:
the device prunes each timestep to its k best non-blank symbols plus the
blank probability (``ctc_beam_topk_device``), and ``ctc_beam_search`` runs
the CTC prefix beam search (Hannun et al. 2014) over that lattice on the
host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .kernels import ctc_topk


def ctc_topk_device(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep first argmax (int32) and max prob (f32) of [N, T, V]
    post-softmax probabilities: the CUDA kernel on the card, its plain
    version for CPU tensors (``ops.kernels.ctc_topk``)."""
    return ctc_topk(probs)


def ctc_beam_topk_device(
    probs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device half of beam decode: [N, T, V] post-softmax → ([N, T, k]
    int32 candidate ids, [N, T, k] their probs, [N, T] blank prob).

    Blank (id 0) is set to −1 before the top-k (probabilities are ≥ 0), so
    all k slots carry non-blank symbols and the blank is carried apart.

    The candidates come back ordered by (−prob, index), which is the order
    of ``lax.top_k`` in the JAX function, whenever the k-th and (k+1)-th
    largest values of a timestep differ. ``torch.topk`` does not say which
    of several equal values it keeps at the k-th place, so with such a tie
    the *set* of ids may differ from the JAX function's (the probabilities
    never do); equal values inside the k kept ones are put in index order
    here."""
    blank = probs[..., 0]
    masked = probs.clone()
    masked[..., 0] = -1.0
    val, idx = torch.topk(masked, k, dim=-1)
    # (−prob, index) order among the kept: sort by index, then a stable
    # descending sort by value
    idx, by_index = torch.sort(idx, dim=-1)
    val = val.gather(-1, by_index)
    val, by_value = torch.sort(val, dim=-1, descending=True, stable=True)
    idx = idx.gather(-1, by_value)
    return idx.to(torch.int32), val, blank


def ctc_beam_search(
    top_idx: np.ndarray,
    top_prob: np.ndarray,
    blank_prob: np.ndarray,
    beam_size: int = 10,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Host half: CTC prefix beam search over the device-pruned lattice.

    Per prefix, track (p_blank, p_nonblank) path mass; extend with blank,
    with a repeat of the last symbol (merges into the same prefix only via
    the non-blank mass; crossing a blank starts a new copy), or with a new
    symbol. Keep the ``beam_size`` highest-mass prefixes per step.

    Returns (kept-index arrays per item, confidence[N]) like
    :func:`ctc_greedy_collapse`; confidence is the length-normalized prefix
    posterior (geometric mean per emitted char). An empty best prefix gets
    NaN so callers apply the ``isnan → skip`` rule unchanged. A copy of the
    JAX package's function, statement for statement: dict insertion order
    and the stable sort decide ties between prefixes."""
    top_idx = np.asarray(top_idx)
    top_prob = np.asarray(top_prob, np.float64)
    blank_prob = np.asarray(blank_prob, np.float64)
    n, t, k = top_idx.shape
    results: List[np.ndarray] = []
    confs = np.zeros((n,), np.float32)
    for i in range(n):
        beams = {(): (1.0, 0.0)}  # prefix -> (blank mass, non-blank mass)
        for step in range(t):
            pb = blank_prob[i, step]
            nxt: dict = {}

            def add(pref, db, dnb):
                b0, nb0 = nxt.get(pref, (0.0, 0.0))
                nxt[pref] = (b0 + db, nb0 + dnb)

            cands = top_idx[i, step]
            cprobs = top_prob[i, step]
            for prefix, (b, nb) in beams.items():
                total = b + nb
                add(prefix, total * pb, 0.0)
                last = prefix[-1] if prefix else -1
                for c, p in zip(cands, cprobs):
                    c = int(c)
                    if c == 0:
                        continue  # blank handled via blank_prob above
                    if c == last:
                        # repeat without blank gap collapses into prefix
                        add(prefix, 0.0, nb * p)
                        # blank-gapped repeat emits a second copy
                        add(prefix + (c,), 0.0, b * p)
                    else:
                        add(prefix + (c,), 0.0, total * p)
            beams = dict(
                sorted(nxt.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))[:beam_size]
            )
        best, (b, nb) = max(beams.items(), key=lambda kv: kv[1][0] + kv[1][1])
        results.append(np.array(best, np.int32))
        mass = b + nb
        confs[i] = np.float32(mass ** (1.0 / len(best))) if best else np.float32("nan")
    return results, confs


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


def ctc_greedy_decode_np(
    probs: np.ndarray, charset: Sequence[str]
) -> Tuple[List[str], np.ndarray]:
    """Full host reference decode: [N, T, V] probs → (texts, confidences).

    ``charset`` is the label list with blank at index 0 (see
    :func:`ppocr_tpu_torch.pipeline.charset.load_charset`). Items with no
    kept timesteps return "" with NaN confidence.
    """
    idx = probs.argmax(-1).astype(np.int32)
    val = probs.max(-1)
    kept, conf = ctc_greedy_collapse(idx, val)
    texts = ["".join(charset[i] for i in k) for k in kept]
    return texts, conf
