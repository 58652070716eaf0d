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


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several test processes at once on one machine; with a
    thread per core in each, PyTorch's CPU kernels spend their time waiting
    for one another. The small shapes here need no more than two."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


OPTIONS, apply_option = assets.OPTIONS, assets.apply_option
MIN_CLS_MARGIN = 0.02  # the smallest |p1 − p0| the goldens may hold


def option_configs() -> dict:
    return {f"small+{name}": apply_option(small_config(), name) for name in OPTIONS}


def serving_config() -> PipelineConfig:
    cfg = PipelineConfig.serving()
    cfg.rec.img_h = 48
    cfg.rec.img_w = 256
    cfg.dtype = "float32"
    return cfg


def small_staged_config() -> PipelineConfig:
    cfg = small_config()
    cfg.fast_path = False
    cfg.rec.width_buckets = (256, 384)
    return cfg


def staged_configs() -> dict:
    serving = serving_config()
    serving.fast_path = False
    return {
        "small-staged": small_staged_config(),
        "small-staged+cls": apply_option(small_staged_config(), "cls"),
        "serving-staged": serving,
    }


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


def model_dir_for(cfg, dst) -> str:
    """The jumbo bundle under ``dst``, with the stand-in classifier when
    ``cfg`` (of either package) enables cls."""
    return str(
        assets.make_jumbo_model_dir(dst, cls_seed=assets.CLS_SEED if cfg.enable_cls else None)
    )


def jax_responses(cfg: PipelineConfig, scenes) -> list:
    with tempfile.TemporaryDirectory() as md:
        engine = OCREngine(model_dir_for(cfg, md), cfg)
        engine.post.backend = "cv2"  # the staged path's parity baseline
        worker = OCRWorker(engine, 0)
        return [worker.process(s, i) for i, s in enumerate(scenes)]


def jax_cls_margins(cfg: PipelineConfig, scenes) -> list:
    """|p1 − p0| of the JAX package's in-graph cls for every valid crop of
    each scene, in slot order (the fused prep with ``cls_forward`` wrapped
    to hand its output to the host through ``jax.debug.callback``)."""
    import jax

    from ppocr_tpu.models import cls_mv3
    from ppocr_tpu.ops import det_resize
    from ppocr_tpu.pipeline import fused as JF
    from ppocr_tpu.pipeline.config import pick_bucket

    kept = []
    forward = cls_mv3.cls_forward

    def keeping(params, x):
        probs = forward(params, x)
        jax.debug.callback(lambda p: kept.append(np.asarray(p)), probs)
        return probs

    margins = []
    with tempfile.TemporaryDirectory() as md:
        eng = OCREngine(model_dir_for(cfg, md), cfg)
        prep = jax.jit(
            JF.build_fused_parts(**JF.fused_part_kwargs(eng, cfg.fused_max_boxes))[0]
        )
        cls_mv3.cls_forward = keeping
        try:
            for scene in scenes:
                r, _, _ = det_resize(scene, cfg.det.limit_type, cfg.det.limit_side_len)
                bh = pick_bucket(cfg.det.shape_buckets, r.shape[0])
                bw = pick_bucket(cfg.det.shape_buckets, r.shape[1])
                canvas = np.zeros((1, bh, bw, 3), np.uint8)
                canvas[0, : r.shape[0], : r.shape[1]] = r
                out = prep(
                    eng.det_params, eng.cls_params, canvas, np.array([r.shape[:2]], np.int32)
                )
                valid = np.asarray(out[3])[0]
                jax.effects_barrier()
                probs = kept.pop()
                margins.append([float(abs(p[1] - p[0])) for p in probs[valid]])
        finally:
            cls_mv3.cls_forward = forward
    return margins


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
    cases = [("small", small_config(), parity, 3), ("serving", serving_config(), serving, 5)]
    cases += [(name, cfg, parity, 2) for name, cfg in option_configs().items()]
    cases += [
        (name, cfg, serving if name.startswith("serving") else parity, 2)
        for name, cfg in staged_configs().items()
    ]
    for name, cfg, scenes, floor in cases:
        words = [r["words"] for r in jax_responses(cfg, scenes)]
        assert min(len(w) for w in words) >= floor, (name, [len(w) for w in words])
        goldens["configs"][name] = dataclasses.asdict(cfg)
        goldens["words"][name] = words
    margins = jax_cls_margins(option_configs()["small+cls"], parity)
    assert min(min(m) for m in margins) >= MIN_CLS_MARGIN, margins
    goldens["cls_margins"] = margins
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
    cases = {
        "small": small_config(),
        "serving": serving_config(),
        **option_configs(),
        **staged_configs(),
    }
    assert set(goldens["configs"]) == set(goldens["words"]) == set(cases)
    for name, cfg in cases.items():
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


@pytest.mark.parametrize("option", OPTIONS)
def test_jax_package_reproduces_option_golden(goldens, option):
    name = f"small+{option}"
    scenes = assets.load_scenes()["parity"]
    cfg = jax_config(goldens["configs"][name])
    for resp, want in zip(jax_responses(cfg, scenes), goldens["words"][name]):
        assert resp["success"], resp
        assert_words_match(resp["words"], want, CONF_TOL)


@pytest.mark.parametrize("name", ["small-staged", "small-staged+cls"])
def test_jax_package_reproduces_staged_golden(goldens, name):
    scenes = assets.load_scenes()["parity"]
    cfg = jax_config(goldens["configs"][name])
    assert cfg.fast_path is False
    for resp, want in zip(jax_responses(cfg, scenes), goldens["words"][name]):
        assert resp["success"] and set(resp["stage_times"]) >= {"det_ms", "rec_ms"}, resp
        assert ("cls_ms" in resp["stage_times"]) == cfg.enable_cls
        assert_words_match(resp["words"], want, CONF_TOL)


def test_staged_goldens_hold_words_for_every_scene(goldens):
    for name in staged_configs():
        words = goldens["words"][name]
        assert len(words) == (len(SERVING_SEEDS) if name.startswith("serving") else len(PARITY_SEEDS))
        assert min(len(w) for w in words) >= 2, name


def test_golden_cls_margins_are_comfortable(goldens):
    """Every orientation decision of the stand-in classifier is at least
    ``MIN_CLS_MARGIN`` from flipping, and one margin is stored per word
    candidate (valid crop) of each scene."""
    margins = goldens["cls_margins"]
    assert len(margins) == len(PARITY_SEEDS)
    assert min(min(m) for m in margins) >= MIN_CLS_MARGIN
    for m, words in zip(margins, goldens["words"]["small+cls"]):
        assert len(m) >= len(words) > 0


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_goldens.py --write")
    write()
