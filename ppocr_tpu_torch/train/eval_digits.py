"""The trained-digits gate's protocol, served by the port.

Counterpart of the JAX package's digits gate, ``tests/test_e2e_trained.py``
(``_cfg`` and ``_score``): the bundled synthetic detector
(``weights/det_synthetic_digits.npz``) and scene recognizer
(``weights/rec_scene_digits.npz``, a 6,625-way head trained on the digit
classes of the reference charset) read the rendered digit lines of 12
scenes of ``SyntheticSceneDataset(seed=424)`` through the staged and the
fused path.

The JAX gate's bars compare the read texts with the drawn digits, which
needs the reference charset (``ppocr_keys_v1.txt``) to know which head
class is which digit; the repo does not hold it. So the port serves the
scenes from a weights-only bundle whose keys file is a placeholder of
6,623 distinct characters (``assets.make_digits_model_dir``), and its
words are held to the JAX package's ``OCRWorker`` words on the same
bundle (``assets/digits_words.json``, written by ``python
tests/test_torch_e2e_digits.py --write``) instead. The bars wait for the
charset file.
"""

from __future__ import annotations

import time
from typing import List

from ..pipeline.config import DetConfig, PipelineConfig, RecConfig
from .synthetic import SyntheticSceneDataset

SEED = 424
N_SCENES = 12
PLACEHOLDER_KEYS = 6623  # + blank and space: the reference head's 6,625 classes


def placeholder_keys(n: int = PLACEHOLDER_KEYS) -> List[str]:
    """``n`` distinct one-character keys (CJK ideographs from U+4E00), one a
    line, standing in for the reference charset's."""
    return [chr(0x4E00 + i) for i in range(n)]


def gate_config(**kw) -> PipelineConfig:
    """The JAX gate's staged config: det at 96 px (buckets 64/96), rec
    48×160 in batches of 4, no cls, f32. ``kw`` sets top-level fields."""
    return PipelineConfig(
        det=DetConfig(limit_type="max", limit_side_len=96, thresh=0.2, box_thresh=0.4,
                      unclip_ratio=1.8, score_mode="fast", shape_buckets=(64, 96)),
        rec=RecConfig(batch_num=4, img_h=48, img_w=160, width_buckets=(160,)),
        enable_cls=False,
        dtype="float32",
        **kw,
    )


def fused_config() -> PipelineConfig:
    """The JAX gate's fused config: 8 boxes a scene, det bucket 96 only."""
    cfg = gate_config(fast_path=True, fused_max_boxes=8)
    cfg.det.shape_buckets = (96,)
    return cfg


def serve(worker, n_scenes: int = N_SCENES, seed: int = SEED):
    """The words ``worker`` (an ``OCRWorker``) reads from the gate's scenes:
    ([{"placed": [[text, box]], "words": [...]} a scene], seconds)."""
    ds = SyntheticSceneDataset(seed=seed)
    out = []
    t0 = time.perf_counter()
    for s in range(n_scenes):
        scene, placed = ds.sample_scene()
        r = worker.process(scene, s)
        if r["success"] is not True:
            raise RuntimeError(f"scene {seed}/{s}: {r.get('error')}")
        out.append({"placed": [[t, list(b)] for t, b in placed], "words": r["words"]})
    return out, time.perf_counter() - t0
