"""The port's utilities on the CPU: ``OCREngine.profile_trace`` and the
scripts ``scripts/measure_boot_torch.py`` and ``scripts/soak_torch.py``
(ROADMAP A12), on the jumbo bundle and the 96 px ``small`` config.

The trace must hold the fused request's ``record_function`` spans; each
script must print one JSON line with no errors (the boot times in order:
socket, first OK, all ready). On the card ``chip_smoke.py`` runs them at
full width and also finds the ``ctc_topk`` kernel in the trace.
"""

import asyncio
import glob
import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest
import torch

from ppocr_tpu_torch import assets
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig
from ppocr_tpu_torch.serve import OCRIPCService

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT_ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return str(assets.make_jumbo_model_dir(tmp_path_factory.mktemp("jumbo")))


@pytest.fixture(scope="module")
def small_config_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("config") / "small.json"
    path.write_text(json.dumps(assets.load_goldens()["configs"]["small"]))
    return str(path)


def test_profile_trace_writes_the_fused_spans(model_dir, tmp_path):
    torch.set_num_threads(2)
    cfg = PipelineConfig.from_dict(assets.load_goldens()["configs"]["small"])
    engine = OCREngine(model_dir, cfg, device="cpu")
    worker = OCRWorker(engine, 0)
    scene = assets.load_scenes()["parity"][0]
    untraced = worker.process(scene, 0)
    logdir = tmp_path / "trace"
    with engine.profile_trace(str(logdir)):
        traced = worker.process(scene, 1)
    assert traced["success"] and traced["words"] == untraced["words"]
    files = glob.glob(str(logdir / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(pathlib.Path(files[0]).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    for span in ("fused.det", "fused.cc", "fused.ctc_topk", "fused.rec", "fused.host_decode"):
        assert span in names, span
    assert not [e for e in events if e.get("cat") == "kernel"]  # no card here


def run_script(argv, timeout=120):
    out = subprocess.run([sys.executable, *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=timeout, env=SCRIPT_ENV)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0 and lines, out.stdout[-2000:] + out.stderr[-2000:]
    return json.loads(lines[-1])


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_measure_boot_on_the_cpu(model_dir, small_config_file, mode):
    result = run_script(["scripts/measure_boot_torch.py", "--device", "cpu", "--mode", mode,
                         "--model-dir", model_dir, "--config", small_config_file, "--timeout", "100"])
    assert "error" not in result and result["service_rc"] == 0
    assert 0 < result["t_socket_s"] <= result["t_first_ok_s"] <= result["t_all_ready_s"]
    assert result["first_words"] > 0
    if mode == "incremental":
        assert result["variants"] > 1


@pytest.fixture(scope="module")
def cpu_service(model_dir, tmp_path_factory):
    cfg = PipelineConfig.from_dict(assets.load_goldens()["configs"]["small"])
    svc = OCRIPCService(model_dir=model_dir, socket_path=str(tmp_path_factory.mktemp("sock") / "soak.sock"),
                        cpu_workers=2, config=cfg, device="cpu", request_timeout_ms=0)
    svc.engine.warmup()
    ready = threading.Event()
    t = threading.Thread(target=svc.run_blocking, args=(ready,), daemon=True)
    t.start()
    assert ready.wait(timeout=60)
    yield svc
    if svc.running and svc._loop is not None:
        asyncio.run_coroutine_threadsafe(svc.stop_async(), svc._loop).result(timeout=20)
    t.join(timeout=20)


@pytest.mark.parametrize("vary", [[], ["--vary-images"], ["--vary-images", "--vary-mode", "pixel"]])
def test_soak_on_the_cpu(cpu_service, vary):
    before = cpu_service.total_requests
    result = run_script(["scripts/soak_torch.py", "--socket", cpu_service.socket_path, "--duration", "2",
                         "--concurrency", "2", "--control-requests", "3", "--pid", str(os.getpid()),
                         "--track-workers", *vary])
    assert result["errors"] == 0 and result["first_error"] is None
    assert result["requests_ok"] > 0 and result["qps"] > 0 and result["control_p50_ms"] > 0
    assert result["p50_ms"] <= result["p90_ms"] <= result["p99_ms"] <= result["max_ms"]
    assert result["rss_start_kb"] > 0 and list(result["worker_rss_kb_end"]) == [str(os.getpid())]
    assert cpu_service.total_requests - before == result["requests_ok"] + 3
    assert ("JPEG" in result["payload"]) == (vary == ["--vary-images"])
