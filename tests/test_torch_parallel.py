"""The port's serving over several devices against the JAX package on the CPU.

The JAX side runs on the suite's 8 virtual CPU devices (``conftest.py``);
the port's counterpart of that mesh is ``make_mesh(devices=["cpu"] * 8)``.
The JAX package's own ``test_parallel_serve.py`` and
``test_pipeline_stage.py`` need reference models that are not in the repo,
so both packages load the jumbo bundle (``assets.make_jumbo_model_dir``)
with the config of those tests: the fused path, det bucket 96, K = 8, f32,
and two batch tiers. Tolerances: texts and boxes exact, confidence within
2e-3 against the JAX package and 1e-5 against the port's own single-device
step; CTC indices exact and values rtol 1e-5.
"""

import asyncio
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from ppocr_tpu.models import rec_forward as jax_rec_forward
from ppocr_tpu.ops.ctc import ctc_topk_device as jax_ctc_topk
from ppocr_tpu.parallel import CrossChipFusedOCR as JaxCrossChip
from ppocr_tpu.parallel import make_mesh as jax_make_mesh
from ppocr_tpu.parallel.mesh import sharded_rec_infer as jax_sharded_rec_infer
from ppocr_tpu.pipeline import OCREngine as JaxEngine
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.cli import service_main
from ppocr_tpu_torch.cli.client_main import main as client_main
from ppocr_tpu_torch.models import rec_forward
from ppocr_tpu_torch.models.jax_params import rec_to_jax
from ppocr_tpu_torch.ops import kernels as K
from ppocr_tpu_torch.parallel import CrossChipFusedOCR, make_mesh, shard_batch, sharded_rec_infer
from ppocr_tpu_torch.parallel.mesh import DeviceMesh, DeviceThreads, shard_rec_params
from ppocr_tpu_torch.parallel.tensor_parallel import SplitSVTRBlock
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig
from ppocr_tpu_torch.pipeline.fused import merge_tiers
from ppocr_tpu_torch.serve import OCRIPCService
from ppocr_tpu_torch.utils.imcodec import encode_png

from test_torch_goldens import few_torch_threads, jax_config  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF_TOL = 2e-3  # against the JAX package
SELF_TOL = 1e-5  # against the port's own single-device step
CPU8 = ["cpu"] * 8


def config_dict() -> dict:
    d = assets.load_goldens()["configs"]["small"]
    d = json.loads(json.dumps(d))
    d["det"]["shape_buckets"] = [96]  # one canvas shape keeps the JAX compiles few
    d["fused_max_boxes"] = 8
    d["fused_batch_tiers"] = 2
    return d


def port_config(**top) -> PipelineConfig:
    cfg = PipelineConfig.from_dict(config_dict())
    for k, v in top.items():
        setattr(cfg, k, v)
    return cfg


# -- scenes ----------------------------------------------------------------------


def _word_crop(scene, word, margin=3):
    b = np.asarray(word["box"])
    (x0, y0), (x1, y1) = b.min(axis=0), b.max(axis=0)
    return scene[max(y0 - margin, 0) : y1 + margin, max(x0 - margin, 0) : x1 + margin]


def long_line_scene() -> np.ndarray:
    """Three words of one line of serving scene 0 side by side in a 440 px
    square: one box about seven times as wide as high, whose crop needs
    the full 512 px crop canvas (width tier 0), and few boxes (batch tier
    1)."""
    scene, words = assets.load_scenes()["serving"][0], assets.load_goldens()["words"]["serving"][0]
    by_text = {w["text"]: w for w in words}
    parts = [_word_crop(scene, by_text[t]) for t in ("𝖢ᐪᶡǃ𝗆", "ᴍᑜЬWӑ", "𝖤ӇꙔꜹάῊ")]
    h = max(p.shape[0] for p in parts)
    strip = np.full((h, sum(p.shape[1] for p in parts) + 16, 3), 255, np.uint8)
    x = 0
    for p in parts:
        strip[: p.shape[0], x : x + p.shape[1]] = p
        x += p.shape[1] + 8
    img = np.full((440, 440, 3), 255, np.uint8)
    y0, x0 = (440 - h) // 2, (440 - strip.shape[1]) // 2
    img[y0 : y0 + h, x0 : x0 + strip.shape[1]] = strip
    return img


def many_words_scene() -> np.ndarray:
    """Seven short words of the serving scenes packed into 192 px: more
    valid boxes than K/2 (batch tier 0), all narrow (width tier 1)."""
    scenes, golden = assets.load_scenes()["serving"], assets.load_goldens()["words"]["serving"]
    picks = ((0, "ѰႪ"), (0, "𝖢ᐪᶡǃ𝗆"), (0, "ⵛᔦ"), (0, "ώẼᚚⵑ"), (0, "ȧ𝔹ͷ"), (0, "ᶢ⅐ἶ"), (1, "ᴖì"))
    img = np.full((192, 192, 3), 255, np.uint8)
    y = x = 2
    row_h = 0
    for s, text in picks:
        p = _word_crop(scenes[s], next(w for w in golden[s] if w["text"] == text))
        if x + p.shape[1] > 192:
            x, y, row_h = 2, y + row_h + 4, 0
        img[y : y + p.shape[0], x : x + p.shape[1]] = p
        x += p.shape[1] + 6
        row_h = max(row_h, p.shape[0])
    return img


@pytest.fixture(scope="module")
def scenes():
    parity = assets.load_scenes()["parity"]
    return [long_line_scene(), many_words_scene(), *parity]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return str(assets.make_jumbo_model_dir(tmp_path_factory.mktemp("jumbo")))


@pytest.fixture(scope="module")
def jax_single(model_dir):
    return JaxEngine(model_dir, jax_config(config_dict()))


@pytest.fixture(scope="module")
def jax_mesh_engine(model_dir):
    return JaxEngine(model_dir, jax_config(config_dict()), mesh=jax_make_mesh(8, model=1))


@pytest.fixture(scope="module")
def single(model_dir):
    return OCREngine(model_dir, port_config(), device="cpu")


@pytest.fixture(scope="module")
def sharded(model_dir):
    return OCREngine(model_dir, port_config(), mesh=make_mesh(devices=CPU8))


def assert_same_words(got, want, tol):
    assert got["success"] and want["success"], (got, want)
    assert got["request_id"] == want["request_id"]
    assert [w["text"] for w in got["words"]] == [w["text"] for w in want["words"]]
    assert [w["box"] for w in got["words"]] == [w["box"] for w in want["words"]]
    np.testing.assert_allclose(
        [w["confidence"] for w in got["words"]],
        [w["confidence"] for w in want["words"]],
        rtol=0,
        atol=tol,
    )


# -- the mesh ------------------------------------------------------------------


def test_make_mesh_shapes_as_the_jax_package():
    for kwargs in ({"model": 2}, {"model": 1}, {"data": 2, "model": 2}, {"data": 1}):
        want = jax_make_mesh(8, **kwargs) if "data" not in kwargs else jax_make_mesh(**kwargs)
        got = make_mesh(8, devices=CPU8, **kwargs) if "data" not in kwargs else make_mesh(
            devices=CPU8, **kwargs)
        assert got.shape == dict(zip(want.axis_names, want.devices.shape))
        assert got.axis_names == tuple(want.axis_names)
        assert len(got.devices) == want.devices.size
    assert make_mesh(1, devices=CPU8).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 32 devices"):
        make_mesh(data=16, model=2, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        make_mesh(devices=CPU8, model=3)
    mesh = make_mesh(devices=["cpu", "cpu", "cuda"])
    assert mesh.devices[2] == torch.device("cuda", 0)
    assert mesh.distinct_devices == [torch.device("cpu"), torch.device("cuda", 0)]


def test_a_mesh_without_cards_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OCREngine("/nonexistent", port_config(), mesh=make_mesh(devices=["cuda:0", "cuda:1"]))


def test_shard_batch_and_rec_replicas(single):
    mesh = make_mesh(devices=["cpu"] * 4)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    parts = shard_batch(mesh, x)
    assert [p.shape[0] for p in parts] == [2] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, x[:6])
    replicas = shard_rec_params(mesh, single.rec_model)
    assert list(replicas) == [torch.device("cpu")] and replicas[torch.device("cpu")] is single.rec_model
    # a model axis of 2: one recognizer per distinct grid row, its SVTR
    # blocks split in two (by heads and hidden columns), the rest whole
    split = shard_rec_params(make_mesh(devices=CPU8, model=2), single.rec_model)
    assert list(split) == [(torch.device("cpu"),) * 2]
    (rec,) = split.values()
    assert rec is not single.rec_model
    for blk in rec.svtr:
        assert isinstance(blk, SplitSVTRBlock) and blk.heads == 4
        assert [s.w_in.shape[0] for s in blk.attn] == [180, 180]
        assert [s.w_in.shape[0] for s in blk.mlp] == [120, 120]
    torch.testing.assert_close(rec.fc.weight, single.rec_model.fc.weight, rtol=0, atol=0)


def test_sharded_rec_infer_equals_jax_and_one_step(single):
    """[8, 48, 64, 3] over 8 shards against the JAX mesh's step and the
    port's own unsharded step."""
    x = np.random.default_rng(0).normal(0, 1, (8, 48, 64, 3)).astype(np.float32)
    idx, val = sharded_rec_infer(make_mesh(devices=CPU8))(single.rec_model, x)
    with torch.inference_mode():
        probs = rec_forward(single.rec_model, torch.from_numpy(x))
    one_idx, one_val = K.ctc_topk(probs)
    np.testing.assert_array_equal(idx.numpy(), one_idx.numpy())
    np.testing.assert_allclose(val.numpy(), one_val.numpy(), rtol=1e-5)
    params = jax.tree.map(jax.numpy.asarray, rec_to_jax(single.rec_model))
    jidx, jval = jax_sharded_rec_infer(jax_make_mesh(8, model=1))(params, x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5)
    single_jax = jax.jit(lambda p, b: jax_ctc_topk(jax_rec_forward(p, b)))(params, x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(single_jax[0]))


def test_device_threads_keep_one_thread_per_device_and_raise_the_first_error():
    """Jobs of two distinct devices run on two long-lived threads, each
    device's jobs in order on its own thread, the same threads at the next
    call; one device alone runs on the calling thread."""
    import threading

    threads = DeviceThreads()
    cpu, meta = torch.device("cpu"), torch.device("meta")

    def job(tag):
        return lambda: (tag, threading.get_ident(), torch.is_inference_mode_enabled())

    jobs = [(cpu, job(0)), (meta, job(1)), (cpu, job(2))]
    first = threads.run(jobs)
    assert [r[0] for r in first] == [0, 1, 2] and all(r[2] for r in first)
    assert first[0][1] == first[2][1] != first[1][1]
    assert threading.get_ident() not in {r[1] for r in first}
    assert [r[1] for r in threads.run(jobs)] == [r[1] for r in first]
    assert threads.run([(cpu, job(3))])[0][1] == threading.get_ident()
    ran = []

    def broken():
        raise ValueError("shard 1 broke")

    with pytest.raises(ValueError, match="shard 1 broke"):
        threads.run([(cpu, lambda: ran.append(0)), (meta, broken), (cpu, lambda: ran.append(2))])
    assert ran == [0, 2]


# -- data-parallel fused serving ---------------------------------------------------


def test_pad_bucket_rounds_up_to_the_data_width(single, sharded):
    fused = sharded.fused_ocr()
    assert fused._n_data() == 8 and fused._pad_bucket(1) == 8 and fused._pad_bucket(8) == 8
    assert fused._pad_bucket(9) == 16
    assert single.fused_ocr()._pad_bucket(3) == 3
    assert [k[0] for k in fused.variant_keys((1, 4))] == [8]
    img = np.zeros((100, 200, 3), np.uint8)
    assert fused.required_variants([img] * 9, batch_buckets=(1, 8)) == [(8, 96, 96)]
    assert sharded.device == torch.device("cpu") and sharded.models_on("cpu")[1] is sharded.rec_model


def test_data_parallel_fused_equals_jax_mesh_and_single_step(scenes, single, sharded, jax_mesh_engine):
    """5 scenes on 8 shards (the parity scenes and a page without text):
    three shards are all padding. The JAX mesh step and the port's
    single-device step of the same padded batch (one step of 8) give the
    same words."""
    imgs, ids = [*scenes[2:6], np.full((192, 192, 3), 255, np.uint8)], list(range(10, 15))
    got = sharded.fused_ocr().process_batch(imgs, ids)
    want_jax = jax_mesh_engine.fused_ocr().process_batch(imgs, ids)
    want_self = single.fused_ocr().process_batch(imgs, ids, batch_buckets=(8,))
    assert len(got) == 5 and any(r["words"] for r in got)
    for g, wj, ws in zip(got, want_jax, want_self):
        assert_same_words(g, wj, CONF_TOL)
        assert_same_words(g, ws, SELF_TOL)
    assert sharded.fused_ocr().steps_run == 1


def test_tier_merge_of_shards_with_different_tiers(scenes, single, sharded, jax_mesh_engine, monkeypatch):
    """The long line needs width tier 0 and the many-word scene batch tier
    0; each shard alone picks another tier, so the batch's tier is (0, 0),
    where the minimum of the combined numbers would be 1. The other six
    shards are all padding and do not narrow it."""
    fused = sharded.fused_ocr()
    seen = []
    prep = fused._prep

    def recorded(*args):
        out = prep(*args)
        seen.append(out[6])
        return out

    monkeypatch.setattr(fused, "_prep", recorded)
    imgs, ids = scenes[:2], [0, 1]
    got = fused.process_batch(imgs, ids)
    assert seen == [1, 2] + [3] * 6  # (0, 1), (1, 0), then all-pad shards (1, 1)
    assert merge_tiers(seen, 2) == 0
    want_jax = jax_mesh_engine.fused_ocr().process_batch(imgs, ids)
    want_self = single.fused_ocr().process_batch(imgs, ids, batch_buckets=(8,))
    for g, wj, ws in zip(got, want_jax, want_self):
        assert_same_words(g, wj, CONF_TOL)
        assert_same_words(g, ws, SELF_TOL)


@pytest.mark.parametrize(
    "tiers,n,want",
    [((2, 1), 2, 0), ((3, 3, 3), 2, 3), ((5, 3), 3, 3), ((4,), 1, 4), ((1, 3, 2), 2, 0)],
)
def test_merge_tiers(tiers, n, want):
    assert merge_tiers(tiers, n) == want


# -- cross-chip --------------------------------------------------------------------


def test_cross_chip_equals_jax_and_the_single_fused_step(scenes, single, jax_single):
    devs = jax.devices()
    jax_cc = JaxCrossChip(jax_single, devs[0], devs[1])
    cc = CrossChipFusedOCR(single, "cpu", "cpu")
    assert cc.det_model is single.det_model and cc.rec_model is single.rec_model
    imgs, ids = scenes[2:5], [7, 3, 5]
    got = cc.process_stream(imgs, ids)
    assert [r["request_id"] for r in got] == ids
    want_jax = jax_cc.process_stream(imgs, ids)
    fused = single.fused_ocr()
    for g, wj, im, rid in zip(got, want_jax, imgs, ids):
        assert_same_words(g, wj, CONF_TOL)
        assert_same_words(g, fused.process(im, rid), SELF_TOL)
    with pytest.raises(ValueError, match="request_ids"):
        cc.process_stream(imgs[:1], [1, 2])


def test_a_failing_stage_raises_and_stops_the_stream(single, scenes, monkeypatch):
    cc = CrossChipFusedOCR(single, "cpu", "cpu")

    def broken(*args):
        raise RuntimeError("stage 2 broke")

    monkeypatch.setattr(cc, "_rec", broken)
    with pytest.raises(RuntimeError, match="stage 2 broke"):
        cc.process_stream(list(scenes[2:6]), [0, 1, 2, 3])


def test_a_cross_chip_worker_routes_and_reload_drops_it(model_dir, scenes, single):
    eng = OCREngine(model_dir, port_config(cross_chip=True), device="cpu")
    worker = OCRWorker(eng, worker_id=2)
    assert type(worker._fused) is CrossChipFusedOCR and worker._fused is eng.cross_chip_ocr()
    resp = worker.process(scenes[2], 9)
    assert resp["worker_id"] == 2
    assert_same_words(resp, single.fused_ocr().process(scenes[2], 9), SELF_TOL)
    assert eng.warmup() > 0
    eng.reload()
    assert not hasattr(eng, "_cross_chip_ocr") and not hasattr(eng, "_fused_ocr")
    mesh_eng = OCREngine(model_dir, port_config(), mesh=make_mesh(devices=["cpu", "cpu"]))
    assert (mesh_eng.cross_chip_ocr().det_device, mesh_eng.cross_chip_ocr().rec_device) == (
        torch.device("cpu"), torch.device("cpu"))
    one = OCREngine(model_dir, port_config(), mesh=make_mesh(devices=["cpu"]))
    with pytest.raises(RuntimeError, match="needs >= 2 visible devices"):
        one.cross_chip_ocr()


def test_the_service_rejects_cross_chip_with_batching_and_incremental_warmup(model_dir):
    batching = OCREngine(
        model_dir, port_config(cross_chip=True, request_batch_buckets=(1, 4)), device="cpu")
    with pytest.raises(ValueError, match="incompatible with request batching"):
        OCRIPCService(model_dir, engine=batching)
    svc = OCRIPCService(model_dir, engine=OCREngine(model_dir, port_config(cross_chip=True),
                                                    device="cpu"))
    with pytest.raises(ValueError, match="incremental warmup requires"):
        asyncio.run(svc.incremental_warmup())


# -- the device guard of the kernel wrappers ------------------------------------------


def test_each_launch_runs_on_its_tensors_card_and_stream(monkeypatch):
    """On a thread whose current device is card 0, a launch for tensors on
    card 1 runs under card 1's guard on card 1's current stream."""
    state = {"current": 0}
    streams = {0: 1000, 1: 1001}
    calls = []

    class Guard:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, state["current"] = state["current"], self.index

        def __exit__(self, *exc):
            state["current"] = self.prev

    def current_stream(device=None):
        index = state["current"] if device is None else torch.device(device).index
        return types.SimpleNamespace(cuda_stream=streams[index])

    def launch(name):
        def fn(*args):
            calls.append((name, state["current"], args[-1]))
            return 0

        return fn

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    lib = types.SimpleNamespace(ctc_topk_launch=launch("ctc_topk"),
                                blob_stats_launch=launch("blob_stats"))

    def fake(shape):
        return types.SimpleNamespace(shape=shape, device=torch.device("cuda", 1), data_ptr=lambda: 0)

    K._launch_ctc_topk(lib, fake((2, 3, 5)), fake((2, 3)), fake((2, 3)))
    K._launch_blob_stats(lib, fake((1, 4, 4)), fake((1, 4, 4)), fake((1, 2)), fake((13,)),
                         fake((6, 1, 2)))
    assert calls == [("ctc_topk", 1, 1001), ("blob_stats", 1, 1001)]
    assert state["current"] == 0


# -- the CLI -------------------------------------------------------------------------


def parse(argv):
    args = service_main.build_parser().parse_args(argv)
    cfg, err = service_main.resolve_service_config(args)
    assert err is None
    return args, cfg


def test_mesh_flag_on_the_cpu_resolves_and_on_absent_cards_exits_2(capsys):
    args, cfg = parse(["--mesh", "2", "--device", "cpu"])
    mesh, err = service_main.resolve_mesh(args, cfg)
    assert err is None and isinstance(mesh, DeviceMesh)
    assert mesh.devices == [torch.device("cpu")] * 2
    assert service_main.resolve_mesh(*parse([])) == (None, None)
    assert service_main.resolve_mesh(*parse(["--mesh", "2", "--staged", "--device", "cpu"])) == (
        None, 2)
    assert "--mesh requires the fused path" in capsys.readouterr().out
    if torch.cuda.device_count() >= 2:
        pytest.skip("needs a machine with fewer than two cards")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert service_main.main(["--mesh", "2", "--model-dir", "/nonexistent"]) == 2
    assert f"--mesh 2: only {n} devices visible" in capsys.readouterr().out


@pytest.mark.parametrize(
    "argv,message",
    [
        (["--cross-chip", "--batch-requests", "4"], "incompatible with --batch-requests > 1"),
        (["--cross-chip", "--staged"], "--cross-chip requires the fused path"),
        (["--cross-chip", "--warmup", "incremental"], "requires the fused path on one device"),
    ],
    ids=["batching", "staged", "incremental"],
)
def test_cross_chip_guards_exit_2(argv, message, capsys):
    assert service_main.main(argv + ["--model-dir", "/nonexistent"]) == 2
    assert message in capsys.readouterr().out


def test_cross_chip_flag_is_served_with_a_full_warmup():
    args, cfg = parse(["--cross-chip"])
    assert cfg.cross_chip and cfg.fast_path
    assert service_main.resolve_warmup_mode(args, cfg) == ("full", None)


def test_service_main_mesh_2_on_the_cpu_serves_a_request(model_dir, single, scenes, tmp_path, capsys):
    """``service_main --mesh 2 --device cpu`` as a user starts it: a
    request through the socket answers the in-process words of the
    single-device step that holds the same padded batch (a bucket of 2)."""
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({k: v for k, v in config_dict().items() if k in (
        "det", "rec", "fused_max_boxes", "fused_batch_tiers")}))
    png = tmp_path / "scene.png"
    png.write_bytes(encode_png(scenes[2]))
    sock = str(tmp_path / "mesh.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ppocr_tpu_torch.cli.service_main", "--device", "cpu",
         "--mesh", "2", "--dtype", "float32", "--model-dir", model_dir, "--socket", sock,
         "--config", str(cfg), "--warmup", "off", "--status-interval", "600"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if "listening" in line:
                break
        assert seen and "listening" in seen[-1], "".join(seen)
        assert any("Data-parallel fused serving over 2 devices" in s for s in seen)
        assert client_main([str(png), "--socket", sock, "--timeout", "120000"]) == 0
        got = json.loads(capsys.readouterr().out)
        want = single.fused_ocr().process_batch([scenes[2]], [0], batch_buckets=(2,))[0]
        assert_same_words(got, want, SELF_TOL)
        assert client_main(["--shutdown", "--socket", sock]) == 0
        rest, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0 and "Service stopped." in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_processes_pass_mesh_and_cross_chip_to_their_workers(monkeypatch, tmp_path, capsys):
    """``--processes N`` gives each worker every flag but the supervisor's
    own, so ``--mesh`` and ``--cross-chip`` reach the workers, as in the
    JAX package."""
    from ppocr_tpu_torch.serve import balancer

    seen = {}

    class Supervisor:
        def __init__(self, socket_path, n, worker_args, **kwargs):
            seen["args"] = worker_args

        async def start_async(self):
            raise RuntimeError("not started in this test")

        async def stop_async(self):
            pass

    monkeypatch.setattr(balancer, "ServiceSupervisor", Supervisor)
    sock = str(tmp_path / "p.sock")
    argv = ["--processes", "2", "--socket", sock, "--device", "cpu", "--mesh", "2",
            "--cross-chip"]
    assert service_main.main(argv) == 1
    assert seen["args"] == ["--device", "cpu", "--mesh", "2", "--cross-chip"]
    assert "not started in this test" in capsys.readouterr().out
