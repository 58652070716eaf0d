"""The port's staged pipeline (det → host postprocess → crops → cls → rec)
against the JAX package on the CPU, f32.

Both packages load the same jumbo bundle (plus the stand-in classifier)
and run the ``small-staged`` config of the goldens: det 96 px with buckets
64/96, rec 48×256 with width buckets 256/384 and batches of 4. The JAX
package runs its cv2 postprocess backend; the port has the C++ core only.
Tolerances:

* per stage, on the same inputs: ``detect``'s prob map within 1e-4 of the
  JAX det step's; ``classify`` labels equal and scores within 2e-3;
  ``recognize`` texts equal and confidences within 2e-3, greedy and beam;
* the whole request: per scene the word counts differ by at most one (a
  box whose score sits on ``box_thresh`` may flip between cv2 and the C++
  core), every word of the one response has a partner in the other with
  all corners within 2 px, partners read the same text, and their
  confidences agree within 2e-3 where the boxes are equal and within 0.05
  where they differ (another crop); response keys and ``stage_times`` keys
  are equal.
"""

import asyncio
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ppocr_tpu.ops import bounding_crop as jax_bounding_crop
from ppocr_tpu.pipeline import OCREngine as JaxEngine
from ppocr_tpu.pipeline import OCRWorker as JaxWorker
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.cli import service_main
from ppocr_tpu_torch.cli.client_main import main as client_main
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig, StageTimes
from ppocr_tpu_torch.parallel import make_mesh
from ppocr_tpu_torch.serve import Dispatcher, OCRIPCClient, OCRIPCService
from ppocr_tpu_torch.utils.imcodec import encode_png

from test_torch_goldens import few_torch_threads, jax_config, model_dir_for  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
PROB_TOL = 1e-4
SCORE_TOL = 2e-3
BOX_TOL = 2
MOVED_BOX_CONF_TOL = 0.05


@pytest.fixture(scope="module")
def goldens():
    return assets.load_goldens()


@pytest.fixture(scope="module")
def scenes():
    return assets.load_scenes()["parity"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, goldens):
    cfg = PipelineConfig.from_dict(goldens["configs"]["small-staged+cls"])
    return model_dir_for(cfg, tmp_path_factory.mktemp("jumbo_cls"))


def engine_pair(model_dir, config_dict):
    jax_eng = JaxEngine(model_dir, jax_config(config_dict))
    jax_eng.post.backend = "cv2"
    return jax_eng, OCREngine(model_dir, PipelineConfig.from_dict(config_dict), device="cpu")


@pytest.fixture(scope="module")
def engines(model_dir, goldens):
    """(JAX engine, port engine) on ``small-staged+cls``; a test that wants
    no cls or another crop mode sets the two configs alike."""
    return engine_pair(model_dir, goldens["configs"]["small-staged+cls"])


@pytest.fixture(scope="module")
def crops(engines, scenes):
    """Fifteen text crops: the JAX package's bounding crops of its own
    boxes on the parity scenes, then wide ones (two crops side by side,
    aspect above the narrow width bucket's 256/48) to fill up."""
    jax_eng, _ = engines
    out = []
    for scene in scenes:
        boxes, _ = jax_eng.detect(scene)
        out += [jax_bounding_crop(scene, b) for b in boxes]
    assert len(out) >= 12
    out = out[:12]
    for a, b in ((0, 1), (3, 4), (6, 7)):
        h = min(out[a].shape[0], out[b].shape[0])
        out.append(np.ascontiguousarray(np.hstack([out[a][:h], out[b][:h], out[a][:h]])))
        assert out[-1].shape[1] / out[-1].shape[0] > 256 / 48
    return out


def det_canvas(engine, scene):
    from ppocr_tpu_torch.ops.resize import det_resize

    cfg = engine.config.det
    resized, _, _ = det_resize(scene, cfg.limit_type, cfg.limit_side_len)
    img = np.zeros((1, 96, 96, 3), np.uint8)
    img[0, : resized.shape[0], : resized.shape[1]] = resized
    return img


# -- the stages on the same inputs ---------------------------------------------


def test_det_step_prob_map_within_1e_4(engines, scenes):
    jax_eng, eng = engines
    for scene in scenes:
        img = det_canvas(eng, scene)
        want = np.asarray(jax_eng._det_step(jax_eng.det_params, img))
        got = eng._det_step(img)
        assert got.shape == want.shape == (1, 96, 96) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
        assert got.max() > 0.9  # text was found


def test_detect_boxes_within_two_pixels(engines, scenes):
    jax_eng, eng = engines
    for scene in scenes:
        want, jtimes = jax_eng.detect(scene)
        got, times = eng.detect(scene)
        assert isinstance(times, StageTimes) and len(times.as_list()) == len(jtimes.as_list()) == 3
        assert min(times.as_list()) > 0
        assert len(got) == len(want) >= 3
        for g, w in zip(got, want):
            assert g.shape == (4, 2) and g.dtype == w.dtype
            assert np.abs(g - w).max() <= BOX_TOL


def test_classify_labels_equal_scores_within_2e_3(engines, crops):
    jax_eng, eng = engines
    batch = list(crops[:13])  # 8 + 5: the second chunk is padded to 8
    batch[3] = np.ascontiguousarray(batch[3][::-1, ::-1])
    want_l, want_s, _ = jax_eng.classify(batch)
    got_l, got_s, times = eng.classify(batch)
    assert got_l == want_l and set(got_l) <= {0, 1}
    np.testing.assert_allclose(got_s, want_s, atol=SCORE_TOL, rtol=0)
    assert all(0.5 <= s <= 1.0 for s in got_s)
    assert times.postprocess_ms == 0.0 and times.inference_ms > 0


def test_cls_mask_is_applied_after_the_normalize(engines):
    """A crop narrower than the cls canvas: its padding must reach the
    classifier as 0 in normalized space. Ink in the padding columns of the
    upload must change nothing; a black pad normalized to −1 would."""
    _, eng = engines
    rng = np.random.default_rng(0)
    batch = np.zeros((1, 48, 192, 3), np.uint8)
    batch[0, :, :60] = rng.integers(0, 256, (48, 60, 3))
    widths = np.array([60], np.int32)
    base = eng._cls_step(batch, widths)
    dirty = batch.copy()
    dirty[0, :, 60:] = 255
    np.testing.assert_array_equal(eng._cls_step(dirty, widths)[1], base[1])
    assert eng._cls_step(batch, np.array([192], np.int32))[1] != base[1]


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_recognize_texts_equal_confidences_within_2e_3(model_dir, goldens, crops, decode):
    """Fifteen crops in batches of four: the last batch is padded, and the
    wide crops sort to the end and take the 384 px width bucket."""
    d = json.loads(json.dumps(goldens["configs"]["small-staged"]))
    d["rec"]["decode"] = decode
    jax_eng, eng = engine_pair(model_dir, d)
    widths = []
    rec_step = eng._rec_step
    eng._rec_step = lambda batch: (widths.append(batch.shape), rec_step(batch))[1]
    want_t, want_c, _ = jax_eng.recognize(crops)
    got_t, got_c, times = eng.recognize(crops)
    assert got_t == want_t
    np.testing.assert_allclose(got_c, want_c, atol=SCORE_TOL, rtol=0)
    assert sum(bool(t) for t in got_t) >= 12
    assert widths == [(4, 48, 256, 3)] * 3 + [(4, 48, 384, 3)]
    assert min(times.as_list()) > 0


def test_recognize_skips_nan_confidences(engines):
    """A crop that decodes to nothing keeps text "" and confidence 0."""
    _, eng = engines
    blank = np.full((20, 60, 3), 255, np.uint8)
    texts, confs, _ = eng.recognize([blank])
    assert texts == [""] and confs == [0.0]
    assert eng.recognize([]) [:2] == ([], [])


# -- the whole request ------------------------------------------------------------


def assert_staged_words_agree(got, want, where):
    pairs, extra, missing = assets.match_staged_words(got, want, BOX_TOL)
    assert len(extra) + len(missing) <= 1, (where, extra, missing)
    assert len(pairs) >= 2, where
    for g, w in pairs:
        assert g["text"] == w["text"], (where, g, w)
        tol = SCORE_TOL if g["box"] == w["box"] else MOVED_BOX_CONF_TOL
        assert abs(g["confidence"] - w["confidence"]) <= tol, (where, g, w)


@pytest.mark.parametrize("enable_cls", [False, True], ids=["nocls", "cls"])
@pytest.mark.parametrize("crop_mode", ["bounding", "perspective"])
def test_staged_request_matches_the_jax_package(engines, scenes, crop_mode, enable_cls):
    jax_eng, eng = engines
    for e in engines:
        e.config.crop_mode = crop_mode
        e.config.enable_cls = enable_cls
    try:
        jax_worker, worker = JaxWorker(jax_eng, 3), OCRWorker(eng, 3)
        for i, scene in enumerate(scenes):
            want, got = jax_worker.process(scene, i), worker.process(scene, i)
            assert got["success"] and want["success"], (got, want)
            assert list(got) == list(want)
            assert list(got["stage_times"]) == list(want["stage_times"])
            assert ("cls_ms" in got["stage_times"]) == enable_cls
            for k in ("request_id", "width", "height", "worker_id"):
                assert got[k] == want[k]
            assert all(len(v) == 3 for v in got["stage_times"].values())
            assert_staged_words_agree(got["words"], want["words"], (crop_mode, enable_cls, i))
    finally:
        for e in engines:
            e.config.crop_mode = "bounding"
            e.config.enable_cls = True


@pytest.mark.parametrize("name", ["small-staged", "small-staged+cls"])
def test_staged_request_matches_the_committed_goldens(model_dir, goldens, scenes, name):
    """What ``chip_smoke.py`` checks on the card, here on the CPU."""
    eng = OCREngine(model_dir, PipelineConfig.from_dict(goldens["configs"][name]), device="cpu")
    worker = OCRWorker(eng, 0)
    for i, (scene, want) in enumerate(zip(scenes, goldens["words"][name])):
        assert_staged_words_agree(worker.process(scene, i)["words"], want, (name, i))


def test_no_text_gives_an_empty_success_with_det_times_only(engines):
    _, eng = engines
    resp = OCRWorker(eng, 1).process(np.full((64, 64, 3), 255, np.uint8), 9)
    assert resp["success"] and resp["words"] == [] and list(resp["stage_times"]) == ["det_ms"]
    assert (resp["request_id"], resp["worker_id"]) == (9, 1)
    empty = OCRWorker(eng, 1).process(np.zeros((0, 0, 3), np.uint8), 2)
    assert empty["success"] is False and empty["error"] == "Empty image data provided"


def test_an_engine_error_becomes_an_error_response(engines, scenes, monkeypatch):
    _, eng = engines

    def boom(_):
        raise RuntimeError("CUDA error: the device went away")

    monkeypatch.setattr(eng, "_det_step", boom)
    resp = OCRWorker(eng, 0).process(scenes[0], 4)
    assert resp["success"] is False and "device went away" in resp["error"]
    assert resp["processing_time_ms"] > 0 and "words" not in resp


# -- shapes, warmup, the slice's edges ---------------------------------------------


def test_an_off_bucket_det_shape_runs_at_its_exact_shape_from_a_thread(model_dir, goldens):
    """The JAX package refuses this from a worker thread; the port has no
    such guard."""
    d = json.loads(json.dumps(goldens["configs"]["small-staged"]))
    d["det"]["shape_buckets"] = [64]
    d["det"]["limit_side_len"] = 128
    eng = OCREngine(model_dir, PipelineConfig.from_dict(d), device="cpu")
    seen = []
    det_step = eng._det_step
    eng._det_step = lambda img: (seen.append(img.shape), det_step(img))[1]
    scene = assets.load_scenes()["parity"][0]
    out = {}
    t = threading.Thread(target=lambda: out.update(r=eng.detect(scene)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(out["r"][0]) >= 3
    assert seen == [(1, 128, 128, 3)]
    no_pad = PipelineConfig.from_dict(d)
    no_pad.det.pad_to_buckets = False
    no_pad.det.limit_side_len = 96
    eng2 = OCREngine(model_dir, no_pad, device="cpu")
    assert eng2.staged_step_shapes()["det"] == [(192, 384)]
    assert len(eng2.detect(scene[:128])[0]) >= 1  # 128×192 → 64×96, unpadded


def test_warmup_runs_every_staged_step_shape(engines):
    _, eng = engines
    shapes = eng.staged_step_shapes()
    assert shapes == {
        "det": [(64, 64), (64, 96), (96, 64), (96, 96)],
        "rec": [(n, w) for n in (1, 2, 4) for w in (256, 384)],
        "cls": [1, 2, 4, 8],
    }
    ran = {"det": [], "rec": [], "cls": []}
    steps = {k: getattr(eng, f"_{k}_step") for k in ran}
    for k in ran:
        setattr(eng, f"_{k}_step", lambda b, *a, k=k: (ran[k].append(b.shape), steps[k](b, *a))[1])
    try:
        assert eng.warmup() > 0
        assert eng.warmup(det_shapes=[(32, 32)]) > 0
    finally:
        for k in ran:
            delattr(eng, f"_{k}_step")
    assert ran["det"] == [(1, h, w, 3) for h, w in shapes["det"]] * 1 + [
        (1, 32, 32, 3)
    ] and len(ran["rec"]) == 12 and len(ran["cls"]) == 8
    assert not hasattr(eng, "_fused_ocr")  # the fused path was never built


def test_check_slice_refuses_only_cross_chip_and_a_mesh(model_dir, goldens, scenes):
    """Nothing is refused any more: with a mesh (and ``cross_chip``, which
    only the fused path reads) the staged steps run on the engine's own
    device, the mesh's first, as in the JAX package, and answer as a
    single-device engine does."""
    cfg = PipelineConfig.from_dict(goldens["configs"]["small-staged"])
    want = OCRWorker(OCREngine(model_dir, cfg, device="cpu"), 0).process(scenes[0], 0)
    cfg.cross_chip = True
    eng = OCREngine(model_dir, cfg, mesh=make_mesh(devices=["cpu"] * 2))
    worker = OCRWorker(eng, 0)
    assert worker._fused is None and eng.device == torch.device("cpu")
    got = worker.process(scenes[0], 0)
    assert [(w["text"], w["box"]) for w in got["words"]] == [
        (w["text"], w["box"]) for w in want["words"]
    ]


def test_the_staged_engine_wants_a_card_unless_the_cpu_is_asked_for(model_dir):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OCREngine(model_dir, PipelineConfig.defaults())
    eng = OCREngine(model_dir, PipelineConfig.defaults(), device="cpu", dtype=torch.float32)
    assert eng.config.fast_path is False and OCRWorker(eng)._fused is None
    with pytest.raises(RuntimeError, match="enable_cls"):
        eng.classify([np.zeros((8, 8, 3), np.uint8)])


# -- the service and the CLI ---------------------------------------------------------


def small_staged(goldens, **top):
    d = json.loads(json.dumps(goldens["configs"]["small-staged"]))
    d.update(top)
    return PipelineConfig.from_dict(d)


def test_service_serves_a_staged_recognize(model_dir, goldens, scenes, tmp_path):
    svc = OCRIPCService(
        model_dir=model_dir,
        socket_path=str(tmp_path / "staged.sock"),
        cpu_workers=2,
        config=small_staged(goldens),
        device="cpu",
    )
    assert type(svc.dispatcher) is Dispatcher
    ready = threading.Event()
    t = threading.Thread(target=svc.run_blocking, args=(ready,), daemon=True)
    t.start()
    assert ready.wait(timeout=60)
    try:
        want = OCRWorker(svc.engine, 0).process(scenes[1], 0)
        path = tmp_path / "scene.png"
        path.write_bytes(encode_png(scenes[1]))
        with OCRIPCClient(svc.socket_path, timeout_ms=120000) as c:
            resp = c.send_request({"command": "recognize", "image_path": str(path)})
            status = json.loads(c.get_service_status()["status"])
        assert resp["success"] and list(resp["stage_times"]) == ["det_ms", "rec_ms"]
        assert [(w["text"], w["box"]) for w in resp["words"]] == [
            (w["text"], w["box"]) for w in want["words"]
        ]
        assert status["total_requests"] == status["successful_requests"] == 1
        assert status["warmup_progress"] is None
        with pytest.raises(ValueError, match="fused path"):
            asyncio.run(svc.incremental_warmup())
    finally:
        asyncio.run_coroutine_threadsafe(svc.stop_async(), svc._loop).result(timeout=20)
        t.join(timeout=20)
        assert not t.is_alive()


def parse(argv):
    return service_main.build_parser().parse_args(argv)


@pytest.mark.parametrize(
    "argv,fast_path,mode",
    [
        ([], True, "incremental"),
        (["--staged"], False, "full"),
        (["--profile", "defaults"], False, "full"),
        (["--profile", "defaults", "--fast-path"], True, "incremental"),
        (["--staged", "--warmup", "off"], False, "off"),
        (["--staged", "--no-warmup"], False, "off"),
        (["--warmup", "full"], True, "full"),
    ],
)
def test_warmup_auto_is_full_for_staged(argv, fast_path, mode):
    args = parse(argv)
    cfg, err = service_main.resolve_service_config(args)
    assert err is None and cfg.fast_path is fast_path
    assert service_main.resolve_warmup_mode(args, cfg) == (mode, None)


def test_incremental_warmup_is_refused_for_staged(capsys):
    rc = service_main.main(["--staged", "--warmup", "incremental", "--model-dir", "/nonexistent"])
    assert rc == 2 and "requires the fused path" in capsys.readouterr().out
    assert service_main.main(["--staged", "--fast-path"]) == 2


def test_defaults_profile_is_the_reference_header_config():
    cfg, err = service_main.resolve_service_config(parse(["--profile", "defaults"]))
    assert err is None and cfg == PipelineConfig.defaults()
    assert (cfg.det.limit_side_len, cfg.rec.img_w, cfg.rec.batch_num) == (960, 320, 6)


def test_system_info_prints_the_recommendation_and_exits(capsys):
    assert service_main.main(["--system-info", "--cls"]) == 0
    out = capsys.readouterr().out
    assert "Recommended workers:" in out and "det, cls and rec" in out
    if not torch.cuda.is_available():
        assert "Platform: cpu" in out and "Device memory" not in out


def test_strip_flag():
    argv = ["--processes", "2", "--socket=/tmp/a", "--staged", "--socket", "/tmp/b", "--cls"]
    out = service_main._strip_flag(service_main._strip_flag(argv, "--processes"), "--socket")
    assert out == ["--staged", "--cls"]
    assert service_main._strip_flag(["--cls", "--staged"], "--cls", has_value=False) == ["--staged"]


def test_service_main_staged_process_serves_and_shuts_down(model_dir, goldens, scenes, tmp_path, capsys):
    """``service_main --staged --device cpu`` as a user starts it: full
    warmup by default, a staged recognize through ``client_main``, exit 0."""
    small = goldens["configs"]["small-staged"]
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({"det": small["det"], "rec": small["rec"]}))
    png = tmp_path / "scene.png"
    png.write_bytes(encode_png(scenes[0]))
    sock = str(tmp_path / "p.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ppocr_tpu_torch.cli.service_main", "--device", "cpu",
         "--dtype", "float32", "--staged", "--model-dir", model_dir, "--socket", sock,
         "--config", str(cfg), "--status-interval", "600"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"},  # see few_torch_threads
    )
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if "listening" in line:
                break
        assert seen and "listening" in seen[-1], "".join(seen)
        assert any(line.startswith("Warmup ran every step shape") for line in seen)
        assert client_main([str(png), "--socket", sock, "--timeout", "120000"]) == 0
        resp = json.loads(capsys.readouterr().out)
        assert resp["success"] and list(resp["stage_times"]) == ["det_ms", "rec_ms"]
        assert_staged_words_agree(resp["words"], goldens["words"]["small-staged"][0], "cli")
        assert client_main(["--shutdown", "--socket", sock]) == 0
        rest, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0 and "Service stopped." in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
