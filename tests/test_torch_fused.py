"""The port's fused request path against the JAX package on CPU, f32.

Each test feeds the same seeded numpy inputs to the JAX function and its
port. Tolerances: labels, boxes, roots, indices and texts exact; scores
and CTC probs rtol 1e-5; crop pixels atol 1e-3 (0..255 scale); resize
within 1 grey level of cv2; response confidence within 2e-3. The options
of the fused path have their own file, ``test_torch_fused_options.py``.
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

from test_torch_goldens import (  # noqa: F401  (few_torch_threads: an autouse fixture)
    apply_option,
    assert_words_match,
    few_torch_threads,
    jax_config,
    model_dir_for,
)

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


@pytest.fixture(scope="module")
def option_engines(tmp_path_factory, goldens):
    """(JAX engine, port engine) for a set of options on top of ``small``,
    built once per set."""
    built = {}

    def get(options):
        if options not in built:
            jcfg = jax_config(goldens["configs"]["small"])
            tcfg = PipelineConfig.from_dict(goldens["configs"]["small"])
            for o in options:
                apply_option(jcfg, o)
                apply_option(tcfg, o)
            md = model_dir_for(tcfg, tmp_path_factory.mktemp("opt"))
            built[options] = (JaxEngine(md, jcfg), OCREngine(md, tcfg, device="cpu"))
        return built[options]

    return get


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


def test_flags_outside_the_slice_raise(model_dir):
    """``cross_chip`` (A10) is served now: an engine on the CPU takes the
    CPU for both stages, and its worker serves through them. Below two
    devices it raises the JAX package's error."""
    from ppocr_tpu_torch.parallel import CrossChipFusedOCR, make_mesh

    cfg = dataclasses.replace(PipelineConfig.serving(), cross_chip=True)
    worker = OCRWorker(OCREngine(model_dir, cfg, device="cpu"), 0)
    assert isinstance(worker._fused, CrossChipFusedOCR)
    assert (worker._fused.det_device, worker._fused.rec_device) == (
        torch.device("cpu"), torch.device("cpu"))
    one = OCREngine(model_dir, cfg, mesh=make_mesh(devices=["cpu"]))
    with pytest.raises(RuntimeError, match="needs >= 2 visible devices"):
        OCRWorker(one, 0)


def test_the_staged_pipeline_is_inside_the_slice(model_dir):
    cfg = dataclasses.replace(PipelineConfig.serving(), fast_path=False)
    eng = OCREngine(model_dir, cfg, device="cpu")
    assert eng.config.fast_path is False and OCRWorker(eng, 0)._fused is None


def test_a_mesh_raises(model_dir):
    """A mesh is served now (``tests/test_torch_parallel.py`` holds it to
    the JAX mesh); a mesh over cards that are not there raises and does
    not fall back to the CPU."""
    from ppocr_tpu_torch.parallel import make_mesh

    eng = OCREngine(model_dir, PipelineConfig.serving(), mesh=make_mesh(devices=["cpu"] * 2))
    assert eng.fused_ocr()._n_data() == 2 and eng.device == torch.device("cpu")
    if torch.cuda.device_count() >= 2:
        pytest.skip("needs a machine with fewer than two cards")
    with pytest.raises(RuntimeError, match="no CUDA device|invalid device"):
        OCREngine(
            model_dir, PipelineConfig.serving(), mesh=make_mesh(devices=["cuda:0", "cuda:1"])
        )


def test_warmup_runs_every_step_shape(model_dir, goldens, monkeypatch):
    cfg = PipelineConfig.from_dict(goldens["configs"]["small"])
    fused = OCREngine(model_dir, cfg, device="cpu").fused_ocr()
    seen = []
    run_step = fused.run_step

    def record(batch, content, src=None):
        seen.append(batch.shape[:3])
        return run_step(batch, content, src)

    monkeypatch.setattr(fused, "run_step", record)
    assert fused.warmup(batch_buckets=(1, 2)) >= 0.0
    assert sorted(seen) == sorted(
        (nb, h, w) for nb in (1, 2) for h in (64, 96) for w in (64, 96)
    )


# -- variant bookkeeping (the serving dispatchers' contract) ---------------------


@pytest.fixture()
def fresh_fused(model_dir, goldens):
    cfg = PipelineConfig.from_dict(goldens["configs"]["small"])
    cfg.request_batch_buckets = (1, 2)
    return TF.FusedOCR(OCREngine(model_dir, cfg, device="cpu"), max_boxes=8)


def test_variant_keys_priority_order(fresh_fused):
    assert fresh_fused.variant_keys() == [
        (1, 64, 64), (1, 64, 96), (1, 96, 64), (1, 96, 96),
        (2, 64, 64), (2, 64, 96), (2, 96, 64), (2, 96, 96),
    ]


def test_variant_keys_equal_the_jax_package(engines):
    jax_eng, torch_eng = engines
    for buckets in (None, (1, 4), (4, 1, 2)):
        assert torch_eng.fused_ocr().variant_keys(buckets) == jax_eng.fused_ocr().variant_keys(buckets)


def test_required_variants_matches_process_batch_exactly(fresh_fused, parity_scenes):
    """The shape-only predictor names exactly the step shapes a real
    process_batch dispatches: mixed det buckets and a group larger than a
    batch bucket."""
    assert fresh_fused._compiled == set()
    small = np.full((50, 50, 3), 255, np.uint8)
    imgs = [parity_scenes[0], parity_scenes[1], parity_scenes[2], small]
    predicted = fresh_fused.required_variants(imgs)
    assert predicted == [(2, 96, 96), (1, 96, 96), (1, 64, 64)]
    fresh_fused.process_batch(imgs, [1, 2, 3, 4])
    assert fresh_fused._compiled == set(predicted)
    assert fresh_fused.required_variants(imgs) == []
    assert (fresh_fused.steps_run, fresh_fused.batched_steps) == (3, 1)


def test_required_variants_equal_the_jax_package(engines):
    jax_eng, torch_eng = engines
    rng = np.random.default_rng(13)
    imgs = [np.zeros((int(h), int(w), 3), np.uint8) for h, w in rng.integers(20, 400, (9, 2))]
    jf = JF.FusedOCR(jax_eng, max_boxes=8)
    tf = TF.FusedOCR(torch_eng, max_boxes=8)
    for buckets in ((1,), (1, 2, 4)):
        assert tf.required_variants(imgs, buckets) == jf.required_variants(imgs, buckets)


def test_compile_variant_records_and_dedupes(fresh_fused):
    key = fresh_fused.variant_keys()[0]
    assert fresh_fused.compile_variant(key) is True
    assert fresh_fused.compile_variant(key) is False
    assert fresh_fused._compiled == {key}


def test_full_warmup_covers_variant_keys(fresh_fused):
    fresh_fused.warmup()
    assert fresh_fused._compiled == set(fresh_fused.variant_keys())


def test_reload_drops_the_cached_fused_and_reloads_the_charset(tmp_path, goldens):
    cfg = PipelineConfig.from_dict(goldens["configs"]["small"])
    md = assets.make_jumbo_model_dir(tmp_path)
    eng = OCREngine(str(md), cfg, device="cpu")
    fused = eng.fused_ocr()
    fused.compile_variant((1, 64, 64))
    keys = (md / "rec" / "ppocr_keys_v1.txt").read_text(encoding="utf-8").splitlines()
    keys[0] = "Ω" if keys[0] != "Ω" else "ω"
    (md / "rec" / "ppocr_keys_v1.txt").write_text("\n".join(keys) + "\n", encoding="utf-8")
    eng.reload()
    assert eng.charset[1] == keys[0]
    assert eng.fused_ocr() is not fused and eng.fused_ocr()._compiled == set()
    eng.reload(warmup=True)
    assert eng.fused_ocr()._compiled == set(eng.fused_ocr().variant_keys())
