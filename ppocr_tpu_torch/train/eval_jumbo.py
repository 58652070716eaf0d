"""The trained-jumbo accuracy gate: its protocol, its scorer and its bars.

Counterpart of the JAX package's gate, ``tests/test_e2e_trained_jumbo.py``
(``_cfg``, ``_score`` and ``_score_placed``), which ``scripts/eval_jumbo.py``
also runs. It scores a recognizer whose whole ~5,008-way head is trained
(``weights/rec_scene_jumbo.npz`` over ``weights/jumbo_keys.txt``) with the
synthetic det weights, end to end through a staged or fused ``OCRWorker``:

* held-out scenes of ``text_scene_dataset("jumbo", seed)``: 34 a seed over
  seeds 90210, 777 and 31337 (≥ 200 words, ~211);
* each placed word is matched to the response word whose axis-aligned box
  covers it with the largest IoU above 0.2, and scored raw (the texts
  equal) and homoglyph-normalized (``homoglyph_normalize`` over
  ``jumbo_homoglyph_map``: DejaVu draws hundreds of the jumbo characters
  pixel-identically, so raw exact match has a ceiling well below 1);
* the bars: at least 200 words; det finds at least ``det_gt − 2 −
  det_gt // 50`` boxes; staged ≥ 0.90 normalized and ≥ 0.62 raw; fused ≥
  0.90 normalized and at most 2 normalized words below staged on the same
  scenes; a wide banner read at similarity ≥ 0.75 on both paths; and the
  staged path's words of 8 scenes of seed 777 spanning head indices above
  4,000, more than 60 distinct.

``tests/test_torch_e2e_jumbo.py`` holds the port to these bars on the CPU,
``scripts/eval_jumbo_torch.py`` scores a candidate bundle and
``chip_smoke.py`` (phase "jumbo gate") runs the protocol on the card.
"""

from __future__ import annotations

import dataclasses
import difflib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..pipeline.config import DetConfig, PipelineConfig, RecConfig
from .synthetic import homoglyph_normalize, jumbo_homoglyph_map, text_scene_dataset

EVAL_SEEDS = (90210, 777, 31337)
EVAL_SCENES = 34  # a seed: ≥ 200 words in all
MATCH_IOU = 0.2

MIN_TOTAL = 200
MIN_STAGED_NORMALIZED = 0.90
MIN_STAGED_RAW = 0.62
MIN_FUSED_NORMALIZED = 0.90
MAX_FUSED_LOSS = 2  # normalized words the fused path may read fewer than staged

# the wide banner: mixed scripts, every character a jumbo class, drawn at
# 56 px (the crop is scaled down to rec's 48) so that the width tier is
# what the check reads; a squashed crop scores ≤ ~0.4
BANNER_TEXT = "K4ᕈ7ℜ2ѩ9Ω5"
BANNER_SIZE = 56
MIN_BANNER_SIMILARITY = 0.75

# head indices decoded from the staged words of the first scenes of a seed
HEAD_SEED, HEAD_SCENES = 777, 8
MIN_HEAD_MAX_INDEX, MIN_HEAD_DISTINCT = 4000, 60


def gate_config(**kw) -> PipelineConfig:
    """The staged gate config: det at 96 px (buckets 64/96), rec 48×256 in
    batches of 4, no cls, f32. ``kw`` sets top-level fields."""
    return PipelineConfig(
        det=DetConfig(limit_type="max", limit_side_len=96, thresh=0.2, box_thresh=0.4,
                      unclip_ratio=1.8, score_mode="fast", shape_buckets=(64, 96)),
        rec=RecConfig(batch_num=4, img_h=48, img_w=256, width_buckets=(256,)),
        enable_cls=False,
        dtype="float32",
        **kw,
    )


def fused_config() -> PipelineConfig:
    """The fused gate config: 8 boxes a scene, crops sampled from the scene
    at twice the det scale (the scenes are 192 px, det runs at 96), det
    bucket 96 only."""
    cfg = gate_config(fast_path=True, fused_max_boxes=8, fused_crop_src_mult=2)
    cfg.det.shape_buckets = (96,)
    return cfg


def banner_config(fused: bool) -> PipelineConfig:
    """The banner's configs: det at 512 px (the banner is not scaled down),
    rec 48×128; staged over width buckets 128–512, fused with its crop
    canvas at 4 × 128 so that the banner takes the widest tier."""
    cfg = gate_config(fast_path=True, fused_max_boxes=8) if fused else gate_config()
    cfg.det.limit_side_len = 512
    cfg.det.shape_buckets = (96, 512)
    cfg.rec.img_w = 128
    if fused:
        cfg.fused_width_mult = 4
    else:
        cfg.rec.width_buckets = (128, 256, 384, 512)
    return cfg


@dataclasses.dataclass
class Score:
    """One path's result over the protocol's scenes."""

    exact: int = 0
    norm_exact: int = 0
    total: int = 0
    det_found: int = 0
    det_gt: int = 0
    misses: List[Tuple[str, Optional[str]]] = dataclasses.field(default_factory=list)
    # (seed, scene index) → the response's words
    words: Dict[Tuple[int, int], list] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def raw(self) -> float:
        return self.exact / self.total if self.total else 0.0

    @property
    def normalized(self) -> float:
        return self.norm_exact / self.total if self.total else 0.0

    def summary(self) -> dict:
        return {"raw": round(self.raw, 4), "normalized": round(self.normalized, 4),
                "exact": self.exact, "norm_exact": self.norm_exact, "total": self.total,
                "det_found": self.det_found, "det_gt": self.det_gt,
                "ms_per_scene": self.seconds * 1e3 / max(1, len(self.words))}


def score(worker, n_scenes: int = EVAL_SCENES, seeds: Sequence[int] = EVAL_SEEDS) -> Score:
    """Run ``n_scenes`` held-out scenes of each seed through ``worker``
    (an ``OCRWorker``) and score its words."""
    fam = jumbo_homoglyph_map()
    out = Score()
    t0 = time.perf_counter()
    for seed in seeds:
        ds = text_scene_dataset("jumbo", seed=seed)
        for s in range(n_scenes):
            scene, placed = ds.sample_scene()
            r = worker.process(scene, s)
            if r["success"] is not True:
                raise RuntimeError(f"scene {seed}/{s}: {r.get('error')}")
            out.words[(seed, s)] = r["words"]
            out.det_gt += len(placed)
            out.det_found += len(r["words"])
            exact, norm, total = score_placed(placed, r["words"], fam, out.misses)
            out.exact += exact
            out.norm_exact += norm
            out.total += total
    out.seconds = time.perf_counter() - t0
    return out


def score_placed(placed, words, fam, misses: list) -> Tuple[int, int, int]:
    """(exact, normalized exact, total) of one scene's placed ``(text, box)``
    words against the response ``words``; each normalized miss is appended
    to ``misses`` as (ground truth, read text or None)."""
    total = exact = norm_exact = 0
    for t, (x0, y0, x1, y1) in placed:
        best, biou = None, MATCH_IOU
        for word in words:
            bx = np.array(word["box"])
            wx0, wy0 = bx.min(0)
            wx1, wy1 = bx.max(0)
            ix0, iy0 = max(x0, wx0), max(y0, wy0)
            ix1, iy1 = min(x1, wx1), min(y1, wy1)
            inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
            ua = (x1 - x0) * (y1 - y0) + (wx1 - wx0) * (wy1 - wy0) - inter
            v = inter / ua if ua > 0 else 0.0
            if v > biou:
                biou, best = v, word
        total += 1
        if best is not None and best["text"] == t:
            exact += 1
        if best is not None and homoglyph_normalize(best["text"], fam) == homoglyph_normalize(t, fam):
            norm_exact += 1
        else:
            misses.append((t, best["text"] if best else None))
    return exact, norm_exact, total


def det_floor(det_gt: int) -> int:
    """The fewest boxes det may find over ``det_gt`` placed words."""
    return det_gt - 2 - det_gt // 50


def bar_failures(staged: Optional[Score] = None, fused: Optional[Score] = None,
                 min_total: int = MIN_TOTAL) -> List[str]:
    """The protocol's bars that ``staged`` and ``fused`` (either may be
    None) miss, one line each; empty when every bar holds. The fused
    path's bar against staged needs both on the same scenes."""
    out = []
    for name, sc, min_norm in (("staged", staged, MIN_STAGED_NORMALIZED),
                               ("fused", fused, MIN_FUSED_NORMALIZED)):
        if sc is None:
            continue
        if sc.total < min_total:
            out.append(f"{name}: {sc.total} words, fewer than {min_total}")
        if sc.det_found < det_floor(sc.det_gt):
            out.append(f"{name}: det found {sc.det_found} of {sc.det_gt}, "
                       f"fewer than {det_floor(sc.det_gt)}")
        if sc.normalized < min_norm:
            out.append(f"{name}: {sc.norm_exact}/{sc.total} normalized, below {min_norm}")
    if staged is not None and staged.raw < MIN_STAGED_RAW:
        out.append(f"staged: {staged.exact}/{staged.total} raw, below {MIN_STAGED_RAW}")
    if staged is not None and fused is not None and fused.norm_exact < staged.norm_exact - MAX_FUSED_LOSS:
        out.append(f"fused: {fused.norm_exact} normalized against staged {staged.norm_exact}, "
                   f"more than {MAX_FUSED_LOSS} fewer")
    return out


def head_indices(staged: Score, charset: Sequence[str]) -> set:
    """The charset indices of the characters ``staged`` read in the first
    ``HEAD_SCENES`` scenes of ``HEAD_SEED``."""
    index = {c: i for i, c in enumerate(charset)}
    seen = set()
    for s in range(HEAD_SCENES):
        for w in staged.words[(HEAD_SEED, s)]:
            seen.update(index[c] for c in w["text"] if c in index)
    return seen


def head_failures(seen: set) -> List[str]:
    out = []
    if max(seen, default=0) <= MIN_HEAD_MAX_INDEX:
        out.append(f"head indices reach only {max(seen, default=0)}, not above {MIN_HEAD_MAX_INDEX}")
    if len(seen) <= MIN_HEAD_DISTINCT:
        out.append(f"{len(seen)} distinct head indices, not more than {MIN_HEAD_DISTINCT}")
    return out


def banner_similarity(words, text: str = BANNER_TEXT) -> float:
    """Homoglyph-normalized similarity to ``text`` of the word whose box
    covers the most area (det also fires a few tiny blobs at the banner's
    fine scale); 0 when nothing was read."""
    fam = jumbo_homoglyph_map()
    best, cover = None, 0.0
    for w in words:
        bx = np.array(w["box"])
        (wx0, wy0), (wx1, wy1) = bx.min(0), bx.max(0)
        c = (wx1 - wx0) * (wy1 - wy0)
        if c > cover:
            cover, best = c, w
    if best is None:
        return 0.0
    return difflib.SequenceMatcher(
        None, homoglyph_normalize(best["text"], fam), homoglyph_normalize(text, fam)).ratio()
