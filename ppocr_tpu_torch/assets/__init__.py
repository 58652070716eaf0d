"""Committed inputs and goldens of the port's parity checks.

``scenes.npz`` holds text scenes rendered by the JAX package's
``text_scene_dataset("jumbo", ...)`` (``parity``: 192×192 scenes,
``serving``: 768×1024 scenes), so no renderer is needed where the port
runs. ``goldens.json`` holds the configs they are served with and the
JAX package's f32 fused responses (words: text, confidence, box) for
each. ``tests/test_torch_goldens.py --write`` regenerates both.

The "jumbo bundle" is the repo's self-contained trained model set:
``weights/det_synthetic_text.npz``, ``weights/rec_scene_jumbo.npz`` (a
5,008-way head) and ``weights/jumbo_keys.txt``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parent
SCENES = ASSETS / "scenes.npz"
GOLDENS = ASSETS / "goldens.json"
WEIGHTS = ASSETS.parent.parent / "weights"
JUMBO_BUNDLE = {
    "det/weights.npz": WEIGHTS / "det_synthetic_text.npz",
    "rec/weights.npz": WEIGHTS / "rec_scene_jumbo.npz",
    "rec/ppocr_keys_v1.txt": WEIGHTS / "jumbo_keys.txt",
}


def make_jumbo_model_dir(dst) -> Path:
    """Lay the jumbo bundle out as a model dir under ``dst``."""
    dst = Path(dst)
    for rel, src in JUMBO_BUNDLE.items():
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst / rel)
    return dst


def load_scenes() -> dict:
    """{"parity": [N, 192, 192, 3] uint8, "serving": [M, 768, 1024, 3]
    uint8, plus their seeds}."""
    with np.load(SCENES) as data:
        return {k: data[k] for k in data.files}


def load_goldens() -> dict:
    return json.loads(GOLDENS.read_text(encoding="utf-8"))
