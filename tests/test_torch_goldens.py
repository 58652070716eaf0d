"""Committed scenes and JAX goldens of the PyTorch port's parity checks.

``python tests/test_torch_goldens.py --write`` renders the scenes with the
JAX package's ``text_scene_dataset("jumbo", ...)`` and stores the JAX
package's f32 fused responses for two configs:

* ``small``: the 96 px det config of ``tests/test_e2e_trained_jumbo.py``
  (rec 48×256) on the fused path, on the 192×192 parity scenes;
* ``serving``: ``PipelineConfig.serving()`` with the jumbo bundle's rec
  geometry (48×256, crop canvas 512) in f32, on the 768×1024 scenes.

The tier-1 test below re-runs the JAX package on the committed scenes, so
the goldens cannot go stale.
"""

import dataclasses
import json
import os
import pathlib
import sys
import tempfile

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import pytest

from ppocr_tpu.pipeline import OCREngine, OCRWorker
from ppocr_tpu.pipeline.config import (
    ClsConfig,
    DetConfig,
    PipelineConfig,
    RecConfig,
)
from ppocr_tpu_torch import assets

PARITY_SEEDS = (2, 3, 4, 5)  # 192×192 scenes, ≥ 3 words each
SERVING_SEEDS = (2, 3)  # 768×1024 scenes, max_lines=12, ≥ 5 words each
CONF_TOL = 1e-4  # JAX CPU against its own committed output


def small_config() -> PipelineConfig:
    return PipelineConfig(
        det=DetConfig(
            limit_type="max",
            limit_side_len=96,
            thresh=0.2,
            box_thresh=0.4,
            unclip_ratio=1.8,
            score_mode="fast",
            shape_buckets=(64, 96),
        ),
        rec=RecConfig(batch_num=4, img_h=48, img_w=256, width_buckets=(256,)),
        enable_cls=False,
        dtype="float32",
        fast_path=True,
    )


def serving_config() -> PipelineConfig:
    cfg = PipelineConfig.serving()
    cfg.rec.img_h = 48
    cfg.rec.img_w = 256
    cfg.dtype = "float32"
    return cfg


def jax_config(d: dict) -> PipelineConfig:
    """A JAX-package config from its ``dataclasses.asdict`` form."""

    def sub(klass, fields):
        return klass(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})

    top = {k: v for k, v in d.items() if k not in ("det", "cls", "rec")}
    top = {k: tuple(v) if isinstance(v, list) else v for k, v in top.items()}
    return PipelineConfig(
        det=sub(DetConfig, d["det"]),
        cls=sub(ClsConfig, d["cls"]),
        rec=sub(RecConfig, d["rec"]),
        **top,
    )


def jax_responses(cfg: PipelineConfig, scenes) -> list:
    with tempfile.TemporaryDirectory() as md:
        worker = OCRWorker(OCREngine(str(assets.make_jumbo_model_dir(md)), cfg), 0)
        return [worker.process(s, i) for i, s in enumerate(scenes)]


def assert_words_match(got, want, conf_tol, box_tol=0):
    """Same word count and texts; boxes within ``box_tol`` px; confidence
    within ``conf_tol``."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert g["text"] == w["text"], (g, w)
        np.testing.assert_allclose(np.array(g["box"]), np.array(w["box"]), atol=box_tol, rtol=0)
        assert abs(g["confidence"] - w["confidence"]) <= conf_tol, (g, w)


def write():
    from ppocr_tpu.train.synthetic import text_scene_dataset

    parity = np.stack(
        [text_scene_dataset("jumbo", seed=s).sample_scene()[0] for s in PARITY_SEEDS]
    )
    serving = np.stack(
        [
            text_scene_dataset(
                "jumbo", seed=s, src_hw=(768, 1024), max_lines=12
            ).sample_scene()[0]
            for s in SERVING_SEEDS
        ]
    )
    goldens = {"configs": {}, "words": {}}
    for name, cfg, scenes, floor in (
        ("small", small_config(), parity, 3),
        ("serving", serving_config(), serving, 5),
    ):
        words = [r["words"] for r in jax_responses(cfg, scenes)]
        assert min(len(w) for w in words) >= floor, [len(w) for w in words]
        goldens["configs"][name] = dataclasses.asdict(cfg)
        goldens["words"][name] = words
    np.savez_compressed(
        assets.SCENES,
        parity=parity,
        serving=serving,
        parity_seeds=np.array(PARITY_SEEDS),
        serving_seeds=np.array(SERVING_SEEDS),
    )
    assets.GOLDENS.write_text(
        json.dumps(goldens, ensure_ascii=False, indent=1) + "\n", encoding="utf-8"
    )
    print(f"wrote {assets.SCENES} and {assets.GOLDENS}")


@pytest.fixture(scope="module")
def goldens():
    return assets.load_goldens()


def test_golden_configs_are_the_documented_ones(goldens):
    for name, cfg in (("small", small_config()), ("serving", serving_config())):
        assert goldens["configs"][name] == json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_committed_scenes_have_the_documented_shapes():
    scenes = assets.load_scenes()
    assert scenes["parity"].shape == (len(PARITY_SEEDS), 192, 192, 3)
    assert scenes["serving"].shape == (len(SERVING_SEEDS), 768, 1024, 3)
    assert scenes["parity"].dtype == np.uint8


def test_jax_package_reproduces_small_golden(goldens):
    scenes = assets.load_scenes()["parity"]
    cfg = jax_config(goldens["configs"]["small"])
    for resp, want in zip(jax_responses(cfg, scenes), goldens["words"]["small"]):
        assert resp["success"], resp
        assert_words_match(resp["words"], want, CONF_TOL)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_goldens.py --write")
    write()
