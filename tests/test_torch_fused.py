"""The port's fused request path against the JAX package on CPU, f32.

Each test feeds the same seeded numpy inputs to the JAX function and its
port. Tolerances: labels, boxes, roots, indices and texts exact; scores
and CTC probs rtol 1e-5; crop pixels atol 1e-3 (0..255 scale); resize
within 1 grey level of cv2; response confidence within 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppocr_tpu.ops import ctc as jax_ctc
from ppocr_tpu.ops import resize as jax_resize
from ppocr_tpu.pipeline import OCREngine as JaxEngine
from ppocr_tpu.pipeline import OCRWorker as JaxWorker
from ppocr_tpu.pipeline import fused as JF
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.ops import ctc as torch_ctc
from ppocr_tpu_torch.ops import resize as torch_resize
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig
from ppocr_tpu_torch.pipeline import fused as TF

from test_torch_goldens import assert_words_match, jax_config

CONF_TOL = 2e-3
PROB_RTOL = 1e-5


@pytest.fixture(scope="module")
def goldens():
    return assets.load_goldens()


@pytest.fixture(scope="module")
def parity_scenes():
    return assets.load_scenes()["parity"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return str(assets.make_jumbo_model_dir(tmp_path_factory.mktemp("jumbo")))


@pytest.fixture(scope="module")
def engines(model_dir, goldens):
    d = goldens["configs"]["small"]
    jax_eng = JaxEngine(model_dir, jax_config(d))
    torch_eng = OCREngine(model_dir, PipelineConfig.from_dict(d), device="cpu")
    return jax_eng, torch_eng


# -- connected components ----------------------------------------------------


def _fg_maps():
    rng = np.random.default_rng(0)
    maps = [rng.random((40, 56)) < p for p in (0.3, 0.55)]
    snake = np.zeros((40, 56), bool)  # a serpentine: many scan bends
    for r in range(1, 39, 4):
        snake[r, 1:55] = True
        c = 54 if (r // 4) % 2 == 0 else 1
        snake[r : r + 4, c] = True
    maps.append(snake)
    return np.stack(maps)


@pytest.mark.parametrize("max_iters", [None, 1])
def test_connected_components_equal_jax(max_iters):
    fg = _fg_maps()
    got = TF._connected_components(torch.from_numpy(fg), max_iters=max_iters).numpy()
    cc = jax.jit(lambda f: JF._connected_components(f, max_iters=max_iters))
    for b in range(fg.shape[0]):
        np.testing.assert_array_equal(got[b], np.asarray(cc(jnp.asarray(fg[b]))))


def test_connected_components_on_scene_threshold(parity_scenes):
    fg = parity_scenes[:, ::2, ::2, 0] < 128  # dark ink at det scale
    got = TF._connected_components(torch.from_numpy(fg)).numpy()
    for b in range(fg.shape[0]):
        want = jax.jit(JF._connected_components)(jnp.asarray(fg[b]))
        np.testing.assert_array_equal(got[b], np.asarray(want))


# -- blob stats ----------------------------------------------------------------


def test_blob_stats_equal_jax_with_area_tie():
    fg = np.zeros((2, 48, 64), bool)
    fg[0, 5:9, 4:14] = True  # 40 px
    fg[0, 20:24, 30:40] = True  # 40 px: a tie in area, raster-later
    fg[0, 30:40, 2:20] = True
    fg[1] = np.random.default_rng(1).random((48, 64)) < 0.45
    prob = np.random.default_rng(2).random((2, 48, 64)).astype(np.float32)
    labels = TF._connected_components(torch.from_numpy(fg))
    got = TF._blob_stats(labels, torch.from_numpy(prob), max_boxes=8)
    bs = jax.jit(lambda l, p: JF._blob_stats(l, p, max_boxes=8))
    for b in range(2):
        want = bs(jnp.asarray(labels[b].numpy()), jnp.asarray(prob[b]))
        for name in ("area", "x0", "x1", "y0", "y1", "root"):
            np.testing.assert_array_equal(got[name][b].numpy(), np.asarray(want[name]), err_msg=name)
        np.testing.assert_allclose(got["score"][b].numpy(), np.asarray(want["score"]), rtol=PROB_RTOL)
    roots = got["root"][0].tolist()
    assert roots.index(5 * 64 + 4) < roots.index(20 * 64 + 30)  # tie → raster-earlier


# -- crops ----------------------------------------------------------------------


def test_crop_resize_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 40, 60, 3)).astype(np.float32)
    b, k = 2, 5
    x0 = rng.uniform(0, 30, (b, k)).astype(np.float32)
    y0 = rng.uniform(0, 20, (b, k)).astype(np.float32)
    x1 = (x0 + rng.uniform(1, 29, (b, k))).astype(np.float32)
    y1 = (y0 + rng.uniform(1, 19, (b, k))).astype(np.float32)
    cw = np.ceil(16 * (x1 - x0 + 1) / (y1 - y0 + 1)).clip(max=64).astype(np.float32)
    got = TF._crop_resize_bilinear(
        torch.from_numpy(img), *(torch.from_numpy(a) for a in (x0, y0, x1, y1, cw)), 16, 64
    ).numpy()
    crop = jax.jit(
        jax.vmap(jax.vmap(lambda im, a, bb, c, d, w: JF._crop_resize_bilinear(im, a, bb, c, d, w, 16, 64),
                          in_axes=(None, 0, 0, 0, 0, 0)))
    )
    want = np.asarray(crop(img, x0, y0, x1, y1, cw))
    assert got.shape == want.shape == (b, k, 16, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


# -- host ops -------------------------------------------------------------------


@pytest.mark.parametrize("limit", [("max", 96), ("max", 512), ("min", 64)])
def test_det_resize_matches_cv2(limit):
    rng = np.random.default_rng(4)
    for h, w in ((192, 192), (77, 301), (768, 1024), (500, 37)):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want, wrh, wrw = jax_resize.det_resize(img, *limit)
        got, rh, rw = torch_resize.det_resize(img, *limit)
        assert got.shape == want.shape and (rh, rw) == (wrh, wrw)
        assert np.abs(got.astype(int) - want).max() <= 1
        want_c = jax_resize.det_fit_cap(want, wrh, wrw, 128)
        got_c = torch_resize.det_fit_cap(got, rh, rw, 128)
        assert got_c[0].shape == want_c[0].shape and got_c[1:] == want_c[1:]
        assert np.abs(got_c[0].astype(int) - want_c[0]).max() <= 1


def test_ctc_greedy_collapse_matches_jax():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 4, (6, 20)).astype(np.int32)
    idx[0] = 0  # all blank → NaN confidence
    prob = rng.random((6, 20)).astype(np.float32)
    got_k, got_c = torch_ctc.ctc_greedy_collapse(idx, prob)
    want_k, want_c = jax_ctc.ctc_greedy_collapse(idx, prob)
    np.testing.assert_array_equal(got_c, want_c)
    for g, w in zip(got_k, want_k):
        np.testing.assert_array_equal(g, w)


# -- the fused step and the whole slice -----------------------------------------


def _canvas_batch(scenes, cfg):
    from ppocr_tpu.pipeline.config import pick_bucket

    batch, content = [], []
    for s in scenes:
        r, _, _ = jax_resize.det_resize(s, cfg.det.limit_type, cfg.det.limit_side_len)
        bh = pick_bucket(cfg.det.shape_buckets, r.shape[0])
        bw = pick_bucket(cfg.det.shape_buckets, r.shape[1])
        c = np.zeros((bh, bw, 3), np.uint8)
        c[: r.shape[0], : r.shape[1]] = r
        batch.append(c)
        content.append(r.shape[:2])
    return np.stack(batch), np.array(content, np.int32)


def test_fused_outputs_match_build_fused_step(engines, parity_scenes):
    jax_eng, torch_eng = engines
    batch, content = _canvas_batch(parity_scenes[:2], jax_eng.config)
    want = jax.device_get(
        jax_eng.fused_ocr()._step(jax_eng.det_params, jax_eng.rec_params, None, batch, content)
    )
    got = torch_eng.fused_ocr().run_step(batch, content)
    for name in ("boxes", "valid", "ctc_idx", "roots", "quads"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("scores", "ctc_prob"):
        np.testing.assert_allclose(
            getattr(got, name), np.asarray(getattr(want, name)), rtol=PROB_RTOL, atol=1e-6, err_msg=name
        )
    assert got.valid.sum() >= 6


def test_worker_matches_jax_worker_and_goldens(engines, parity_scenes, goldens):
    jax_eng, torch_eng = engines
    jw, tw = JaxWorker(jax_eng, 0), OCRWorker(torch_eng, 0)
    for i, (scene, golden) in enumerate(zip(parity_scenes, goldens["words"]["small"])):
        want, got = jw.process(scene, i), tw.process(scene, i)
        assert got["success"], got
        assert set(got) == set(want)
        assert_words_match(got["words"], want["words"], CONF_TOL)
        assert_words_match(got["words"], golden, CONF_TOL)


def test_batched_request_equals_single_requests(engines, parity_scenes):
    _, torch_eng = engines
    fused = torch_eng.fused_ocr()
    ids = list(range(len(parity_scenes)))
    batched = fused.process_batch(list(parity_scenes), ids, batch_buckets=(1, 4))
    for scene, rid, resp in zip(parity_scenes, ids, batched):
        single = fused.process(scene, rid)
        assert resp["request_id"] == rid
        assert_words_match(resp["words"], single["words"], 1e-5)


def test_empty_image_gives_the_error_response(engines):
    resp = OCRWorker(engines[1], 3).process(np.zeros((0, 0, 3), np.uint8), 9)
    assert resp == {
        "request_id": 9, "width": 0, "height": 0, "success": False,
        "processing_time_ms": 0.0, "worker_id": 3, "error": "Empty image data provided",
    }


@pytest.mark.parametrize(
    "change,item",
    [
        (dict(fast_path=False), "A7"),
        (dict(enable_cls=True), "A5"),
        ("dilation", "A5"),
        (dict(fused_rotated_boxes=True), "A5"),
        (dict(fused_crop_src_mult=2), "A5"),
        (dict(cross_chip=True), "A10"),
        ("beam", "A4"),
    ],
)
def test_flags_outside_the_slice_raise(model_dir, change, item):
    cfg = PipelineConfig.serving()
    if change == "beam":
        cfg.rec.decode = "beam"
    elif change == "dilation":
        cfg.det.use_dilation = True
    else:
        cfg = dataclasses.replace(cfg, **change)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        OCREngine(model_dir, cfg, device="cpu")


def test_a_mesh_raises(model_dir):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        OCREngine(model_dir, PipelineConfig.serving(), device="cpu", mesh=object())


def test_warmup_runs_every_step_shape(engines, monkeypatch):
    fused = engines[1].fused_ocr()
    seen = []
    run_step = fused.run_step

    def record(batch, content):
        seen.append(batch.shape[:3])
        return run_step(batch, content)

    monkeypatch.setattr(fused, "run_step", record)
    assert fused.warmup(batch_buckets=(1, 2)) >= 0.0
    assert sorted(seen) == sorted(
        (nb, h, w) for nb in (1, 2) for h in (64, 96) for w in (64, 96)
    )
