"""The port's JSON IPC service, dispatchers, client and CLIs, on the CPU.

Mirrors ``tests/test_serve.py`` and ``tests/test_warmup.py`` with the
PyTorch engine on ``device="cpu"``, the jumbo bundle and the 96 px
``small`` config of the goldens. Payloads are PNGs of the committed parity
scenes (JPEG requests: ``tests/test_torch_jpeg.py``). The served words are held
to ``OCRWorker.process`` on the same image, which the other test files
hold to the JAX package.
"""

import asyncio
import base64
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pytest

from ppocr_tpu_torch import assets
from ppocr_tpu_torch.cli import service_main
from ppocr_tpu_torch.cli.client_main import main as client_main
from ppocr_tpu_torch.cli.common import resolve_socket_path
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig
from ppocr_tpu_torch.serve import Dispatcher, OCRIPCClient, OCRIPCService
from ppocr_tpu_torch.serve.batcher import BatchingDispatcher
from ppocr_tpu_torch.serve.executor import is_device_loss
from ppocr_tpu_torch.serve.service import TOO_LARGE_ERROR
from ppocr_tpu_torch.utils.imcodec import encode_png

REPO = pathlib.Path(__file__).resolve().parent.parent


def small_config(**changes) -> PipelineConfig:
    cfg = PipelineConfig.from_dict(assets.load_goldens()["configs"]["small"])
    cfg.fused_max_boxes = 8
    for k, v in changes.items():
        setattr(cfg, k, v)
    return cfg


def words_of(resp):
    return [(w["text"], w["box"]) for w in resp["words"]]


def same_words(a, b):
    """Texts and boxes equal, confidences within 1e-5 (a batched step and a
    single one sum in another order)."""
    assert words_of(a) == words_of(b)
    for x, y in zip(a["words"], b["words"]):
        assert abs(x["confidence"] - y["confidence"]) <= 1e-5


def run_service(svc):
    """Start ``svc`` in a thread with a loop of its own; returns the thread."""
    ready = threading.Event()
    t = threading.Thread(target=svc.run_blocking, args=(ready,), daemon=True)
    t.start()
    assert ready.wait(timeout=60)
    return t


def stop_service(svc, t):
    if svc.running and svc._loop is not None:
        asyncio.run_coroutine_threadsafe(svc.stop_async(), svc._loop).result(timeout=20)
    t.join(timeout=20)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return str(assets.make_jumbo_model_dir(tmp_path_factory.mktemp("jumbo")))


@pytest.fixture(scope="module")
def scenes():
    return assets.load_scenes()["parity"]


@pytest.fixture(scope="module")
def scene_paths(tmp_path_factory, scenes):
    d = tmp_path_factory.mktemp("png")
    paths = []
    for i, s in enumerate(scenes):
        paths.append(d / f"scene{i}.png")
        paths[-1].write_bytes(encode_png(s))
    return [str(p) for p in paths]


@pytest.fixture(scope="module")
def sock_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sock")


@pytest.fixture(scope="module")
def service(model_dir, sock_dir):
    svc = OCRIPCService(
        model_dir=model_dir,
        socket_path=str(sock_dir / "svc.sock"),
        cpu_workers=2,
        config=small_config(),
        device="cpu",
    )
    svc.engine.warmup()
    t = run_service(svc)
    yield svc
    stop_service(svc, t)


@pytest.fixture(scope="module")
def expected(service, scenes):
    """What ``OCRWorker.process`` answers for each scene on the service's
    own engine."""
    worker = OCRWorker(service.engine, 0)
    return [worker.process(s, 0) for s in scenes]


@pytest.fixture()
def client(service):
    c = OCRIPCClient(service.socket_path, timeout_ms=120000)
    assert c.connect()
    yield c
    c.disconnect()


def raw_exchange(path, payload: bytes) -> dict:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(60)
    s.connect(path)
    try:
        s.sendall(payload)
        return json.loads(s.makefile("rb").readline())
    finally:
        s.close()


class TestProtocol:
    def test_recognize_inline_base64(self, client, scene_paths, expected):
        r = client.recognize_image(scene_paths[0])  # < 600 KB → inlined
        assert r["success"] is True
        assert (r["width"], r["height"]) == (192, 192)
        assert set(r) == {
            "request_id", "width", "height", "success", "processing_time_ms",
            "worker_id", "words",
        }
        same_words(r, expected[0])
        assert len(r["words"]) >= 2

    def test_recognize_by_path(self, client, scene_paths, expected):
        r = client.send_request({"command": "recognize", "image_path": scene_paths[1]})
        assert r["success"] is True
        same_words(r, expected[1])

    def test_recognize_bmp(self, client, scenes, expected):
        ok, enc = cv2.imencode(".bmp", scenes[2])
        data = base64.b64encode(enc.tobytes()).decode()
        r = client.send_request({"command": "recognize", "image_data": data})
        assert r["success"] is True
        same_words(r, expected[2])

    def test_recognize_missing_image(self, client):
        r = client.send_request({"command": "recognize"})
        assert r == {"success": False, "error": "Missing image_path or image_data"}

    def test_recognize_bad_path(self, client):
        r = client.send_request({"command": "recognize", "image_path": "/nonexistent.png"})
        assert r == {"success": False, "error": "Failed to load image from path: /nonexistent.png"}

    def test_recognize_bad_base64(self, client):
        r = client.send_request({"command": "recognize", "image_data": "!!!notbase64!!!"})
        assert r == {"success": False, "error": "Failed to decode base64 image data"}

    def test_base64_not_an_image(self, client):
        bogus = base64.b64encode(b"hello world").decode()
        r = client.send_request({"command": "recognize", "image_data": bogus})
        assert r == {"success": False, "error": "Failed to decode base64 image data"}

    def test_jpeg_gets_the_decode_error(self, client, scenes, tmp_path):
        """A lossless JPEG (SOF3), which the decoder refuses as cv2 does
        (the JPEGs it answers: ``tests/test_torch_jpeg.py``)."""
        ok, enc = cv2.imencode(".jpg", scenes[0])
        jpeg = bytearray(enc.tobytes())
        jpeg[jpeg.index(b"\xff\xc0") + 1] = 0xC3
        assert cv2.imdecode(np.frombuffer(bytes(jpeg), np.uint8), cv2.IMREAD_COLOR) is None
        enc = np.frombuffer(bytes(jpeg), np.uint8)
        data = base64.b64encode(enc.tobytes()).decode()
        r = client.send_request({"command": "recognize", "image_data": data})
        assert r == {"success": False, "error": "Failed to decode base64 image data"}
        path = tmp_path / "a.jpg"
        path.write_bytes(enc.tobytes())
        r = client.send_request({"command": "recognize", "image_path": str(path)})
        assert r == {"success": False, "error": f"Failed to load image from path: {path}"}

    def test_request_ids_count_from_where_they_are(self, client, scene_paths):
        a = client.recognize_image(scene_paths[0])["request_id"]
        client.send_request({"command": "recognize"})  # an error: takes no id
        b = client.recognize_image(scene_paths[0])["request_id"]
        assert b == a + 1

    def test_status_counts_requests(self, client, scene_paths):
        before = json.loads(client.get_service_status()["status"])
        client.recognize_image(scene_paths[0])
        after_raw = client.get_service_status()
        assert after_raw["success"] is True and isinstance(after_raw["status"], str)
        after = json.loads(after_raw["status"])
        assert after["running"] is True and after["pid"] == os.getpid()
        assert after["total_requests"] == before["total_requests"] + 1
        assert after["successful_requests"] == before["successful_requests"] + 1
        assert after["total_requests"] == after["successful_requests"] + after["failed_requests"]
        assert after["average_processing_time_ms"] > 0
        assert [w["worker_id"] for w in after["workers"]] == [0, 1]
        assert set(after["kernel_launches"]) == {"ctc_topk", "blob_stats"}

    def test_unknown_command(self, client):
        assert client.send_request({"command": "fly"}) == {
            "success": False, "error": "Unknown command: fly",
        }

    def test_invalid_json(self, client):
        client._sock.sendall(b"this is not json\n")
        r = json.loads(client._file.readline())
        assert r["success"] is False and r["error"].startswith("Invalid JSON:")
        assert client.get_service_status()["success"] is True  # the connection lives on

    def test_oversized_message_guarded(self, service):
        payload = b'{"command":"recognize","image_data":"' + b"A" * (1100 * 1024) + b'"}\n'
        r = raw_exchange(service.socket_path, payload)
        assert r == {"success": False, "error": TOO_LARGE_ERROR}
        assert TOO_LARGE_ERROR == (
            "Data too large for buffer (max 1MB). Consider using file path transmission."
        )

    @pytest.mark.parametrize(
        "payload_len,starts", [(1048575, "Data too large"), (1048574, "Invalid JSON")]
    )
    def test_oversize_boundary_matches_reference(self, service, payload_len, starts):
        """A payload of exactly 1,048,575 bytes errors; one byte less reaches
        the JSON parser (ocr_ipc_service.cpp:222)."""
        r = raw_exchange(service.socket_path, b"x" * payload_len + b"\n")
        assert r["error"].startswith(starts)

    def test_concurrent_clients(self, service, scene_paths, expected):
        results = {}

        def one(i):
            c = OCRIPCClient(service.socket_path, timeout_ms=120000)
            assert c.connect()
            results[i] = c.recognize_image(scene_paths[i % len(scene_paths)])
            c.disconnect()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(results) == list(range(6))
        assert len({r["request_id"] for r in results.values()}) == 6
        for i, r in results.items():
            assert r["success"], r
            same_words(r, expected[i % len(expected)])

    def test_chunked_request_frames(self, service, scene_paths):
        payload = json.dumps({"command": "recognize", "image_path": scene_paths[0]}).encode() + b"\n"
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(60)
        s.connect(service.socket_path)
        try:
            for i in range(0, len(payload), 7):
                s.sendall(payload[i : i + 7])
                time.sleep(0.001)
            assert json.loads(s.makefile("rb").readline())["success"] is True
        finally:
            s.close()

    def test_two_requests_one_connection(self, service):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(60)
        s.connect(service.socket_path)
        f = s.makefile("rwb")
        try:
            for _ in range(2):
                f.write(json.dumps({"command": "status"}).encode() + b"\n")
                f.flush()
                assert json.loads(f.readline())["success"] is True
        finally:
            s.close()


class TestClient:
    def test_client_reconnects_after_connection_loss(self, service):
        c = OCRIPCClient(service.socket_path, timeout_ms=60000)
        assert c.connect()
        assert c.get_service_status()["success"] is True
        c._sock.shutdown(socket.SHUT_RDWR)
        with pytest.raises(ConnectionError):
            c.get_service_status()
        assert c.get_service_status()["success"] is True  # reconnected
        c.disconnect()

    def test_empty_file_falls_back_to_path(self, tmp_path):
        p = tmp_path / "empty.png"
        p.write_bytes(b"")
        c = OCRIPCClient(str(tmp_path / "none.sock"), timeout_ms=1)
        sent = {}
        c.send_request = lambda req: sent.update(req) or {"success": False}
        c.recognize_image(str(p))
        assert "image_path" in sent and "image_data" not in sent

    def test_large_file_is_sent_by_path(self, tmp_path):
        p = tmp_path / "big.png"
        p.write_bytes(b"x" * (601 * 1024))
        c = OCRIPCClient(str(tmp_path / "none.sock"), timeout_ms=1)
        sent = {}
        c.send_request = lambda req: sent.update(req) or {"success": False}
        c.recognize_image(str(p))
        assert sent == {"command": "recognize", "image_path": str(p)}

    def test_connect_gives_up_after_its_timeout(self, tmp_path):
        c = OCRIPCClient(str(tmp_path / "none.sock"), timeout_ms=100)
        t0 = time.monotonic()
        assert c.connect() is False
        assert time.monotonic() - t0 < 5

    def test_pipe_name_mapping(self):
        assert resolve_socket_path(r"\\.\pipe\ocr_service") == "/tmp/ocr_service.sock"
        assert resolve_socket_path("/run/x.sock") == "/run/x.sock"


class SlowDispatcher:
    """Answers after ``delay`` seconds; counts what it finished."""

    def __init__(self, delay):
        self.delay, self.finished = delay, 0

    async def submit(self, image, request_id):
        await asyncio.sleep(self.delay)
        self.finished += 1
        return {"request_id": request_id, "success": True, "processing_time_ms": 1.0, "words": []}

    def worker_stats(self):
        return []

    def shutdown(self):
        pass


class TestShutdown:
    def make(self, model_dir, sock_dir, name, **kw):
        return OCRIPCService(
            model_dir=model_dir, socket_path=str(sock_dir / name), cpu_workers=1,
            config=small_config(), device="cpu", **kw,
        )

    def test_shutdown_replies_then_stops(self, model_dir, sock_dir):
        svc = self.make(model_dir, sock_dir, "down.sock")
        t = run_service(svc)
        c = OCRIPCClient(svc.socket_path, timeout_ms=30000)
        assert c.connect()
        r = c.send_shutdown_command()
        assert r == {"success": True, "message": "Shutdown command received, stopping service..."}
        c.disconnect()
        t.join(timeout=10)
        assert not t.is_alive()
        assert svc.running is False and not os.path.exists(svc.socket_path)

    def test_shutdown_drains_an_inflight_request(self, model_dir, sock_dir, scene_paths):
        """A request in flight when shutdown arrives finishes inside the
        200 ms drain window and gets its answer."""
        svc = self.make(model_dir, sock_dir, "drain.sock")
        svc.dispatcher = slow = SlowDispatcher(0.1)
        t = run_service(svc)
        got = {}

        def recognize():
            c = OCRIPCClient(svc.socket_path, timeout_ms=30000)
            got["r"] = c.send_request({"command": "recognize", "image_path": scene_paths[0]})
            c.disconnect()

        rt = threading.Thread(target=recognize)
        rt.start()
        deadline = time.monotonic() + 10
        while svc._inflight_requests == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert svc._inflight_requests == 1
        c = OCRIPCClient(svc.socket_path, timeout_ms=30000)
        assert c.send_shutdown_command()["success"] is True
        c.disconnect()
        rt.join(timeout=10)
        t.join(timeout=10)
        assert not t.is_alive() and not rt.is_alive()
        assert got["r"]["success"] is True and slow.finished == 1

    def test_request_timeout_answers_and_counts(self, model_dir, sock_dir, scene_paths):
        svc = self.make(model_dir, sock_dir, "timeout.sock", request_timeout_ms=50)
        svc.dispatcher = SlowDispatcher(1.0)
        t = run_service(svc)
        try:
            c = OCRIPCClient(svc.socket_path, timeout_ms=30000)
            r = c.send_request({"command": "recognize", "image_path": scene_paths[0]})
            assert r == {"request_id": 0, "success": False, "error": "Request timed out after 50 ms"}
            status = json.loads(c.get_service_status()["status"])
            assert (status["timed_out_requests"], status["failed_requests"]) == (1, 1)
            c.disconnect()
        finally:
            stop_service(svc, t)

    def test_recycle_after_stops_the_service_flagged(self, model_dir, sock_dir, scene_paths):
        svc = self.make(model_dir, sock_dir, "recycle.sock", recycle_after=2)
        svc.dispatcher = SlowDispatcher(0.0)
        t = run_service(svc)
        c = OCRIPCClient(svc.socket_path, timeout_ms=30000)
        for _ in range(2):
            assert c.send_request({"command": "recognize", "image_path": scene_paths[0]})["success"]
        c.disconnect()
        t.join(timeout=10)
        assert not t.is_alive()
        assert svc.recycled is True and svc.running is False


class TestBatching:
    @pytest.fixture(scope="class")
    def batching(self, model_dir, sock_dir):
        svc = OCRIPCService(
            model_dir=model_dir, socket_path=str(sock_dir / "batch.sock"), cpu_workers=1,
            config=small_config(request_batch_buckets=(1, 2, 4)), device="cpu",
        )
        assert isinstance(svc.dispatcher, BatchingDispatcher)
        svc.dispatcher.max_wait = 0.25  # a wide window: the CPU threads start slowly
        svc.engine.warmup()
        t = run_service(svc)
        yield svc
        stop_service(svc, t)

    def test_concurrent_requests_coalesce_into_one_step(self, batching, scene_paths, expected):
        results = {}

        def one(i):
            c = OCRIPCClient(batching.socket_path, timeout_ms=120000)
            results[i] = c.recognize_image(scene_paths[i])
            c.disconnect()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(4):
            assert results[i]["success"], results[i]
            same_words(results[i], expected[i])
        c = OCRIPCClient(batching.socket_path, timeout_ms=30000)
        stats = json.loads(c.get_service_status()["status"])["workers"][0]
        c.disconnect()
        assert stats["requests"] == 4 and stats["errors"] == 0
        assert stats["batched_steps"] >= 1 and stats["steps"] < 4

    def test_empty_image_is_answered_without_a_step(self, batching):
        async def run():
            return await batching.dispatcher.submit(np.zeros((0, 0, 3), np.uint8), 5)

        r = asyncio.run(run())
        assert r["success"] is False and r["error"] == "Empty image data provided"

    def test_dead_futures_are_dropped_and_the_consumer_survives(self, model_dir, scenes):
        """A batch whose step raises fails its requests and the consumer
        goes on; a request whose future died is not run at all."""
        eng = OCREngine(model_dir, small_config(request_batch_buckets=(1, 2)), device="cpu")
        disp = BatchingDispatcher(eng, num_workers=1, max_wait_ms=20)
        ran = []
        process_batch = disp.fused.process_batch

        def flaky(images, rids, arrival_times=None):
            ran.append(list(rids))
            if 13 in rids:
                raise RuntimeError("boom")
            return process_batch(images, rids, arrival_times=arrival_times)

        disp.fused.process_batch = flaky

        async def run():
            bad = await disp.submit(scenes[0], 13)
            dead = asyncio.ensure_future(disp.submit(scenes[0], 14))
            await asyncio.sleep(0)  # let it enqueue, then abandon it
            dead.cancel()
            good = await disp.submit(scenes[1], 15)
            disp.shutdown()
            return bad, good

        bad, good = asyncio.run(run())
        assert bad == {"success": False, "request_id": 13, "error": "boom"}
        assert good["success"] is True
        assert [13] in ran and all(14 not in r for r in ran)
        assert disp.errors == 1


class TestDispatcher:
    def test_first_idle_else_round_robin(self, service):
        disp = Dispatcher(service.engine, num_workers=3)
        try:
            assert [disp._pick_worker() for _ in range(3)] == [0, 1, 2]
            assert [disp._pick_worker() for _ in range(4)] == [0, 1, 2, 0]  # all busy
            assert disp._inflight == [3, 2, 2]
            disp._inflight = [1, 0, 1]
            assert disp._pick_worker() == 1
        finally:
            disp.shutdown()

    def test_worker_stats_count_requests_and_errors(self, service, scenes):
        disp = Dispatcher(service.engine, num_workers=1)

        async def run():
            ok = await disp.submit(scenes[0], 0)
            bad = await disp.submit(None, 1)
            return ok, bad

        ok, bad = asyncio.run(run())
        disp.shutdown()
        assert ok["success"] is True and bad["error"] == "Empty image data provided"
        assert disp.worker_stats() == [{"worker_id": 0, "requests": 2, "errors": 1}]
        assert disp._inflight == [0]

    def test_guard_warms_a_cold_shape_before_dispatch(self, model_dir, scenes):
        eng = OCREngine(model_dir, small_config(), device="cpu")
        disp = Dispatcher(eng, num_workers=1)
        fused = eng.fused_ocr()
        assert fused._compiled == set()
        calls = []
        compile_variant = fused.compile_variant
        fused.compile_variant = lambda key: (calls.append(key), compile_variant(key))[1]
        r = asyncio.run(disp.submit(scenes[0], 7))
        disp.shutdown()
        assert r["success"] is True
        assert calls == [(1, 96, 96)] and fused._compiled == {(1, 96, 96)}

    def test_batching_dispatcher_guard(self, model_dir, scenes):
        eng = OCREngine(model_dir, small_config(request_batch_buckets=(1, 2)), device="cpu")
        disp = BatchingDispatcher(eng, num_workers=1, max_wait_ms=200)
        calls = []
        compile_variant = disp.fused.compile_variant
        disp.fused.compile_variant = lambda key: (calls.append(key), compile_variant(key))[1]

        async def run():
            out = await asyncio.gather(disp.submit(scenes[0], 0), disp.submit(scenes[1], 1))
            disp.shutdown()
            return out

        results = asyncio.run(run())
        assert all(r["success"] for r in results)
        assert calls and set(calls) <= set(disp.fused.variant_keys())


class StubFused:
    """Fails with a CUDA error until the engine is reloaded."""

    def __init__(self, engine):
        self.engine = engine

    def required_variants(self, images):
        return []

    def process(self, image, request_id, worker_id=0):
        self.engine.calls += 1
        if not self.engine.healthy:
            raise RuntimeError(self.engine.failure)
        return {"request_id": request_id, "success": True, "worker_id": worker_id, "words": []}


class StubEngine:
    def __init__(self, failure, reload_works=True):
        self.config = PipelineConfig.serving()
        self.failure, self.reload_works = failure, reload_works
        self.healthy, self.calls, self.reloads = False, 0, []

    def fused_ocr(self):
        return StubFused(self)

    def reload(self, warmup=False):
        self.reloads.append(warmup)
        if not self.reload_works:
            raise RuntimeError("CUDA error: still gone")
        self.healthy = True


class TestRecovery:
    IMAGE = np.zeros((8, 8, 3), np.uint8)

    def test_device_loss_reloads_and_retries_once(self):
        eng = StubEngine("CUDA error: unspecified launch failure")
        disp = Dispatcher(eng, num_workers=1)
        r = asyncio.run(disp.submit(self.IMAGE, 3))
        disp.shutdown()
        assert r["success"] is True and r["request_id"] == 3
        assert eng.reloads == [True] and eng.calls == 2
        assert disp.engine_reloads == 1 and disp.reloading is False

    def test_out_of_memory_is_not_device_loss(self):
        eng = StubEngine("CUDA out of memory. Tried to allocate 2.00 GiB")
        disp = Dispatcher(eng, num_workers=1)
        r = asyncio.run(disp.submit(self.IMAGE, 3))
        disp.shutdown()
        assert r["success"] is False and "out of memory" in r["error"]
        assert eng.reloads == [] and eng.calls == 1

    def test_a_failed_reload_is_not_retried_within_the_cooldown(self):
        eng = StubEngine("CUDA error: an illegal memory access was encountered", reload_works=False)
        disp = Dispatcher(eng, num_workers=1)

        async def run():
            return [await disp.submit(self.IMAGE, i) for i in range(3)]

        results = asyncio.run(run())
        disp.shutdown()
        assert all(not r["success"] for r in results)
        assert eng.reloads == [True] and disp.engine_reloads == 0

    @pytest.mark.parametrize(
        "error,lost",
        [
            ("CUDA error: unspecified launch failure", True),
            ("CUDA error: device-side assert triggered", True),
            ("RuntimeError: CUDA error: an illegal memory access was encountered", True),
            ("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED", True),
            ("ctc_topk launch failed: CUDA error 700", True),
            ("CUDA out of memory. Tried to allocate 20.00 MiB", False),
            ("CUDA error: out of memory", False),
            ("Empty image data provided", False),
            ("index 5008 is out of bounds", False),
            ("", False),
            (None, False),
        ],
    )
    def test_is_device_loss(self, error, lost):
        assert is_device_loss(error) is lost


class TestIncrementalWarmup:
    def test_completes_and_serves_concurrently(self, model_dir, sock_dir, scenes):
        svc = OCRIPCService(
            model_dir=model_dir, socket_path=str(sock_dir / "warm.sock"), cpu_workers=1,
            config=small_config(request_batch_buckets=(1, 2)), device="cpu",
        )

        async def run():
            await svc.start_async()
            task = asyncio.get_running_loop().create_task(
                svc.incremental_warmup(log=lambda *_: None)
            )
            res = await svc.dispatcher.submit(scenes[0], 0)  # lands during the warmup
            await task
            status = json.loads(svc.get_status_info())
            await svc.stop_async()
            return res, status

        res, status = asyncio.run(run())
        assert res["success"] is True
        fused = svc.engine.fused_ocr()
        assert fused._compiled == set(fused.variant_keys())
        assert status["warmup_progress"] == {"compiled": 8, "total": 8}

    def test_pauses_while_a_request_is_in_flight(self, model_dir, sock_dir):
        svc = OCRIPCService(
            model_dir=model_dir, socket_path=str(sock_dir / "warm2.sock"), cpu_workers=1,
            config=small_config(), device="cpu",
        )
        fused = svc.engine.fused_ocr()
        warmed = []
        fused.compile_variant = lambda key: (warmed.append(key), True)[1]

        async def run():
            svc.running = True
            svc._inflight_requests = 1
            task = asyncio.get_running_loop().create_task(
                svc.incremental_warmup(log=lambda *_: None)
            )
            await asyncio.sleep(0.4)
            held = len(warmed)
            svc._inflight_requests = 0
            svc._last_request_ts = time.monotonic() - 2.0  # the idle grace is over
            await asyncio.wait_for(task, timeout=10)
            return held

        assert asyncio.run(run()) == 0
        assert len(warmed) == len(fused.variant_keys())


# -- the CLIs -----------------------------------------------------------------


def resolve(argv, tmp_path=None, file_overrides=None):
    if file_overrides is not None:
        p = tmp_path / "cfg.json"
        p.write_text(json.dumps(file_overrides))
        argv = argv + ["--config", str(p)]
    return service_main.resolve_service_config(service_main.build_parser().parse_args(argv))


class TestServiceConfig:
    def test_defaults_are_the_serving_profile_on_the_card(self):
        args = service_main.build_parser().parse_args([])
        assert (args.device, args.socket, args.cpu_workers) == ("cuda", "/tmp/ocr_service.sock", 1)
        cfg, err = resolve([])
        assert err is None and cfg == PipelineConfig.serving()

    def test_flags_map_onto_the_options(self):
        cfg, err = resolve([
            "--cls", "--rotated-boxes", "--crop-src-mult", "2", "--rec-decode", "beam",
            "--beam-size", "4", "--max-boxes", "16", "--det-buckets", "384,128",
            "--dtype", "float32", "--batch-requests", "6",
        ])
        assert err is None
        assert cfg.enable_cls and cfg.fused_rotated_boxes and cfg.fused_crop_src_mult == 2
        assert (cfg.rec.decode, cfg.rec.beam_size, cfg.fused_max_boxes) == ("beam", 4, 16)
        assert cfg.det.shape_buckets == (128, 384) and cfg.dtype == "float32"
        assert cfg.request_batch_buckets == (1, 2, 4, 6)

    def test_batch_requests_sees_config_file_fast_path(self, tmp_path):
        cfg, err = resolve(["--profile", "defaults", "--batch-requests", "4"], tmp_path, {"fast_path": True})
        assert err is None and max(cfg.request_batch_buckets) == 4

    def test_config_file_batch_buckets_beat_the_flag(self, tmp_path):
        cfg, err = resolve(["--batch-requests", "4"], tmp_path, {"request_batch_buckets": [1, 2]})
        assert err is None and cfg.request_batch_buckets == (1, 2)

    def test_config_file_bucket_lists_are_sorted(self, tmp_path):
        cfg, err = resolve([], tmp_path, {"det": {"shape_buckets": [96, 64]}})
        assert err is None and cfg.det.shape_buckets == (64, 96)

    def test_config_file_wins_over_flags_and_rejects_unknown_fields(self, tmp_path):
        cfg, err = resolve(["--max-boxes", "16"], tmp_path, {"fused_max_boxes": 8})
        assert err is None and cfg.fused_max_boxes == 8
        with pytest.raises(ValueError, match="unknown config field"):
            resolve([], tmp_path, {"no_such_field": 1})

    def test_batch_bucket_list(self):
        assert service_main.batch_bucket_list(8, "pow2") == (1, 2, 4, 8)
        assert service_main.batch_bucket_list(6, "pow2") == (1, 2, 4, 6)
        assert service_main.batch_bucket_list(1, "pow2") == (1,)
        assert service_main.batch_bucket_list(8, "single") == (8,)

    @pytest.mark.parametrize(
        "argv,message",
        [
            (["--mesh", "2"], "--mesh 2: only 0 devices visible"),
            (["--cross-chip", "--batch-requests", "4"], "incompatible with --batch-requests > 1"),
        ],
        ids=["mesh", "cross-chip"],
    )
    def test_unported_flags_exit_2_naming_their_roadmap_item(self, argv, message, capsys):
        """Both flags are served now; what exits 2 is the JAX package's own
        guard: a mesh wider than the visible cards (none here), cross-chip
        with request batching. No flag is refused by name any more."""
        import torch

        if argv[0] == "--mesh" and torch.cuda.is_available():
            pytest.skip("needs a machine without a card")
        assert service_main.main(argv + ["--model-dir", "/nonexistent"]) == 2
        out = capsys.readouterr().out
        assert message in out and "not ported" not in out
        assert not hasattr(service_main, "UNPORTED")

    @pytest.mark.parametrize(
        "argv,fast_path,processes",
        [(["--staged"], False, 1), (["--profile", "defaults"], False, 1), (["--processes", "2"], True, 2)],
        ids=["staged", "defaults-profile", "processes"],
    )
    def test_staged_and_processes_flags_resolve(self, argv, fast_path, processes, capsys):
        args = service_main.build_parser().parse_args(argv)
        cfg, err = service_main.resolve_service_config(args)
        assert err is None and "not ported" not in capsys.readouterr().out
        assert cfg.fast_path is fast_path and args.processes == processes

    def test_system_info_prints_and_exits_0(self, capsys):
        assert service_main.main(["--system-info"]) == 0
        assert "Recommended workers" in capsys.readouterr().out

    def test_a_config_file_cannot_bring_back_an_unported_feature(self, tmp_path, capsys):
        """cross_chip from a config file is served; the guards run on the
        final config, so a file cannot bring back what they refuse."""
        cfg, err = resolve([], tmp_path, {"cross_chip": True})
        assert err is None and cfg.cross_chip
        assert resolve([], tmp_path, {"cross_chip": True, "request_batch_buckets": [1, 4]}) == (None, 2)
        assert "incompatible with --batch-requests > 1" in capsys.readouterr().out
        assert resolve([], tmp_path, {"cross_chip": True, "fast_path": False}) == (None, 2)
        assert "--cross-chip requires the fused path" in capsys.readouterr().out

    def test_a_config_file_can_ask_for_the_staged_pipeline(self, tmp_path):
        cfg, err = resolve([], tmp_path, {"fast_path": False})
        assert err is None and cfg.fast_path is False

    def test_bad_flag_combinations_exit_2(self):
        assert resolve(["--staged", "--fast-path"]) == (None, 2)
        assert resolve(["--crop-src-mult", "0"]) == (None, 2)

    def test_the_default_device_needs_a_card(self, model_dir):
        """No card here, and no ``--device cpu``: the service must not start
        on the CPU by itself."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("needs a machine without a card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            service_main.main(["--model-dir", model_dir, "--socket", "/tmp/never.sock"])


class TestClientCli:
    def test_recognize_status_and_errors(self, service, scene_paths, expected, capsys):
        assert client_main([scene_paths[0], "--socket", service.socket_path, "--timeout", "120000"]) == 0
        same_words(json.loads(capsys.readouterr().out), expected[0])
        assert client_main(["--status", "--socket", service.socket_path, "--pretty"]) == 0
        status = json.loads(capsys.readouterr().out)
        assert json.loads(status["status"])["running"] is True
        assert client_main(["/nonexistent.png", "--socket", service.socket_path]) == 3
        assert json.loads(capsys.readouterr().out)["success"] is False

    def test_no_service_and_no_arguments(self, tmp_path, capsys):
        assert client_main(["--status", "--socket", str(tmp_path / "none.sock"), "--timeout", "50"]) == 2
        assert client_main([]) == 1

    def test_visualize_writes_the_jax_clients_pixels(self, service, scene_paths, tmp_path, capsys):
        """``--visualize out.png`` exits 0 and writes what the JAX client
        writes for the same response: ``visualize_boxes`` on cv2's
        ``imread`` of the image, read back by cv2."""
        from ppocr_tpu.utils.visualize import visualize_boxes as jax_visualize

        out = tmp_path / "vis.png"
        argv = [scene_paths[0], "--socket", service.socket_path, "--timeout", "120000"]
        assert client_main([*argv, "--visualize", str(out)]) == 0
        captured = capsys.readouterr()
        response = json.loads(captured.out)
        assert response["words"] and f"visualization written to {out}" in captured.err
        want = jax_visualize(cv2.imread(scene_paths[0]), response["words"])
        np.testing.assert_array_equal(cv2.imread(str(out)), want)

    def test_visualize_of_an_unreadable_image_exits_3(self, service, scene_paths, tmp_path, capsys, monkeypatch):
        bad = tmp_path / "bad.png"
        bad.write_bytes(b"not an image")
        out = tmp_path / "vis.png"
        argv = ["--socket", service.socket_path, "--timeout", "120000", "--visualize", str(out)]
        assert client_main([str(bad), *argv]) == 3  # the service cannot decode it
        assert json.loads(capsys.readouterr().out)["success"] is False
        # decoded by the service, refused by the re-read: the JAX client's message
        from ppocr_tpu_torch.utils import imcodec

        monkeypatch.setattr(imcodec, "read_image", lambda path: None)
        assert client_main([scene_paths[0], *argv]) == 3
        assert f"cannot re-read {scene_paths[0]} for visualization" in capsys.readouterr().err
        assert not out.exists()

    @pytest.mark.parametrize("name", ["vis.jpg", "vis"])
    def test_visualize_to_another_extension_exits_3(self, service, scene_paths, tmp_path, capsys, name):
        """The port writes PNG only; the JAX client writes any extension
        cv2.imwrite knows and exits 3 where it fails."""
        out = tmp_path / name
        argv = [scene_paths[0], "--socket", service.socket_path, "--timeout", "120000"]
        assert client_main([*argv, "--visualize", str(out)]) == 3
        assert "visualization failed: cannot write visualization" in capsys.readouterr().err
        assert not out.exists()


def test_service_main_process_serves_and_shuts_down(model_dir, sock_dir, scene_paths, expected, tmp_path, capsys):
    """``python -m ppocr_tpu_torch.cli.service_main --device cpu`` as a user
    starts it, driven by ``client_main``: recognize, status, shutdown, exit
    code 0."""
    cfg = tmp_path / "small.json"
    small = assets.load_goldens()["configs"]["small"]
    cfg.write_text(json.dumps({
        "det": small["det"], "rec": small["rec"], "fused_max_boxes": 8,
    }))
    sock = str(sock_dir / "proc.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ppocr_tpu_torch.cli.service_main", "--device", "cpu",
         "--dtype", "float32", "--model-dir", model_dir, "--socket", sock,
         "--config", str(cfg), "--warmup", "incremental", "--status-interval", "1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if "listening" in line:
                break
        assert seen and "listening" in seen[-1], "".join(seen)
        assert client_main([scene_paths[0], "--socket", sock, "--timeout", "120000"]) == 0
        same_words(json.loads(capsys.readouterr().out), expected[0])
        assert client_main(["--status", "--socket", sock]) == 0
        status = json.loads(json.loads(capsys.readouterr().out)["status"])
        assert status["total_requests"] == 1 and status["pid"] == proc.pid
        assert status["warmup_progress"]["total"] == 4
        assert client_main(["--shutdown", "--socket", sock]) == 0
        rest, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0 and "Service stopped." in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
