"""The port's multi-process serving layer (``ppocr_tpu_torch.serve.balancer``):
request-level routing, merged status, shutdown fan-out, backend failover,
supervisor restart and rolling recycle. The cases of ``tests/test_balancer.py``
against the port's classes, hermetic through the same protocol-faithful
fake worker (``tests/fake_service_worker.py``: no engine loads); then the
real thing once, ``service_main --processes 2 --device cpu`` with two
staged worker services on the CPU."""

import asyncio
import json
import os
import pathlib
import sys
import time

import pytest

from ppocr_tpu_torch.serve.balancer import (
    RECYCLE_EXIT_CODE,
    Backend,
    OCRBalancer,
    ServiceSupervisor,
)

FAKE = str(pathlib.Path(__file__).parent / "fake_service_worker.py")


def fake_prefix():
    return [sys.executable, FAKE]


async def _client_request(sock, payload):
    reader, writer = await asyncio.open_unix_connection(sock)
    writer.write((json.dumps(payload) + "\n").encode())
    await writer.drain()
    resp = json.loads(await reader.readline())
    writer.close()
    await writer.wait_closed()
    return resp


def run(coro):
    return asyncio.run(coro)


@pytest.fixture()
def supervisor(tmp_path):
    sock = str(tmp_path / "bal.sock")
    sup = ServiceSupervisor(
        sock,
        2,
        worker_args=[],
        argv_prefix=fake_prefix(),
        boot_timeout=20.0,
        restart_delay=0.1,
    )
    return sup


class TestBalancerRouting:
    def test_requests_balance_and_respond(self, supervisor):
        async def go():
            await supervisor.start_async()
            mon = asyncio.get_running_loop().create_task(supervisor.monitor())
            try:
                tags = []
                for _ in range(8):
                    r = await _client_request(
                        supervisor.socket_path,
                        {"command": "recognize", "image_path": "/x.png"},
                    )
                    assert r["success"] is True
                    tags.append(r["worker_tag"])
                # one persistent connection, many lines
                reader, writer = await asyncio.open_unix_connection(
                    supervisor.socket_path
                )
                for _ in range(4):
                    writer.write(b'{"command":"recognize"}\n')
                    await writer.drain()
                    r = json.loads(await reader.readline())
                    assert r["success"] is True
                    tags.append(r["worker_tag"])
                writer.close()
                return tags
            finally:
                mon.cancel()
                await supervisor.stop_async()

        tags = run(go())
        assert len(tags) == 12

    def test_merged_status_and_shutdown(self, supervisor):
        async def go():
            await supervisor.start_async()
            try:
                for _ in range(5):
                    await _client_request(
                        supervisor.socket_path, {"command": "recognize"}
                    )
                st = await _client_request(
                    supervisor.socket_path, {"command": "status"}
                )
                merged = json.loads(st["status"])
                resp = await _client_request(
                    supervisor.socket_path, {"command": "shutdown"}
                )
                # shutdown fans out: workers exit 0 (not recycle code)
                for p in supervisor.procs:
                    rc = p.wait(timeout=10)
                    assert rc == 0
                return st, merged, resp
            finally:
                await supervisor.stop_async()

        st, merged, resp = run(go())
        assert st["success"] is True
        assert merged["total_requests"] == 5
        assert merged["successful_requests"] == 5
        assert len(merged["processes"]) == 2
        assert resp["message"].startswith("Shutdown command received")

    def test_failover_when_backend_dies(self, supervisor):
        async def go():
            await supervisor.start_async()
            mon = asyncio.get_running_loop().create_task(supervisor.monitor())
            try:
                await _client_request(
                    supervisor.socket_path, {"command": "recognize"}
                )
                # kill worker 0 outright; requests must keep succeeding
                supervisor.procs[0].kill()
                supervisor.procs[0].wait(timeout=5)
                oks = 0
                for _ in range(6):
                    r = await _client_request(
                        supervisor.socket_path, {"command": "recognize"}
                    )
                    oks += bool(r.get("success"))
                return oks
            finally:
                mon.cancel()
                await supervisor.stop_async()

        assert run(go()) == 6


class TestRoutingReachesEveryWorker:
    def test_concurrent_requests_reach_both_workers_without_a_status_poll(self, tmp_path):
        """A backend that was never tried counts as up, and one whose
        connect failed is tried again after ``down_for``: a second worker
        and a restarted one get traffic without any status poll."""
        sup = ServiceSupervisor(
            str(tmp_path / "r.sock"), 2, worker_args=["--delay-ms", "100"],
            argv_prefix=fake_prefix(), boot_timeout=20.0, restart_delay=0.1,
        )

        async def burst():
            rs = await asyncio.gather(
                *[_client_request(sup.socket_path, {"command": "recognize"}) for _ in range(6)]
            )
            assert all(r["success"] for r in rs)
            return [b.requests for b in sup.backends]

        async def go():
            await sup.start_async()
            mon = asyncio.get_running_loop().create_task(sup.monitor())
            try:
                first = await burst()
                sup.procs[0].kill()
                sup.procs[0].wait(timeout=5)
                await burst()  # worker 0's channels fail over; it is marked down
                deadline = time.monotonic() + 15
                while sup.restarts == 0 and time.monotonic() < deadline:
                    await asyncio.sleep(0.1)
                await asyncio.sleep(1.5)  # the respawn binds; down_for passes
                before = [b.requests for b in sup.backends]
                after = await burst()
                return first, before, after
            finally:
                mon.cancel()
                await sup.stop_async()

        first, before, after = run(go())
        assert min(first) >= 1, first
        assert after[0] > before[0] and after[1] > before[1], (before, after)


class TestSupervisorRecycle:
    def test_worker_self_recycles_and_restarts(self, tmp_path):
        sock = str(tmp_path / "rec.sock")
        sup = ServiceSupervisor(
            sock,
            1,
            worker_args=["--recycle-after", "3"],
            argv_prefix=fake_prefix(),
            boot_timeout=20.0,
            restart_delay=0.1,
        )

        async def go():
            await sup.start_async()
            mon = asyncio.get_running_loop().create_task(sup.monitor())
            try:
                first_pid = sup.procs[0].pid
                results = []
                for _ in range(8):
                    r = await _client_request(sock, {"command": "recognize"})
                    results.append(r.get("success", False))
                    await asyncio.sleep(0.05)
                deadline = time.monotonic() + 10
                # restarts increments before the respawn lands; wait for
                # the new process object itself
                while (
                    sup.procs[0].pid == first_pid
                    and time.monotonic() < deadline
                ):
                    await asyncio.sleep(0.1)
                return first_pid, sup.procs[0].pid, results, sup.restarts
            finally:
                mon.cancel()
                await sup.stop_async()

        first_pid, new_pid, results, restarts = run(go())
        assert restarts >= 1  # worker exited with the recycle code → relaunched
        assert new_pid != first_pid
        # requests during the recycle window may fail over/retry; the vast
        # majority must succeed and service must be live at the end
        assert sum(results) >= 6

    def test_recycle_exit_code_contract(self, tmp_path):
        """The fake worker honors the real service's contract: exit 3 on
        self-recycle, exit 0 on explicit shutdown (checked above)."""
        import subprocess

        sock = str(tmp_path / "one.sock")
        p = subprocess.Popen(
            [*fake_prefix(), "--socket", sock, "--recycle-after", "1"]
        )
        deadline = time.monotonic() + 10
        while not os.path.exists(sock) and time.monotonic() < deadline:
            time.sleep(0.05)

        async def one():
            return await _client_request(sock, {"command": "recognize"})

        r = run(one())
        assert r["success"] is True
        assert p.wait(timeout=10) == RECYCLE_EXIT_CODE


class TestBackendConnectionPool:
    def test_concurrent_inflight_per_backend(self, tmp_path):
        """The pooled connections let N requests ride ONE worker
        concurrently — a single locked connection would serialize them
        (8×100 ms ≈ 800 ms) and starve worker-side request batching."""
        sock = str(tmp_path / "pool.sock")
        sup = ServiceSupervisor(
            sock,
            1,
            worker_args=["--delay-ms", "100"],
            argv_prefix=fake_prefix(),
            boot_timeout=20.0,
        )

        async def go():
            await sup.start_async()
            try:
                t0 = time.monotonic()
                results = await asyncio.gather(
                    *[
                        _client_request(sock, {"command": "recognize"})
                        for _ in range(8)
                    ]
                )
                dt = time.monotonic() - t0
                return results, dt
            finally:
                await sup.stop_async()

        results, dt = run(go())
        assert all(r["success"] for r in results)
        assert dt < 0.45, f"8 concurrent 100 ms requests took {dt:.2f}s"


class TestRollingRecycle:
    def test_supervisor_rotates_replacement_first(self, tmp_path):
        """recycle_after in supervisor mode = rolling rotation: the
        replacement worker boots on a generation socket, the backend
        retargets, the old worker drains via shutdown (exit 0) — requests
        never fail and capacity never drops to zero."""
        sock = str(tmp_path / "rot.sock")
        sup = ServiceSupervisor(
            sock,
            1,
            worker_args=[],
            argv_prefix=fake_prefix(),
            boot_timeout=20.0,
            recycle_after=5,
        )

        async def go():
            await sup.start_async()
            mon = asyncio.get_running_loop().create_task(sup.monitor())
            try:
                old_proc = sup.procs[0]
                results = []
                deadline = time.monotonic() + 20
                while sup.recycles == 0 and time.monotonic() < deadline:
                    r = await _client_request(sock, {"command": "recognize"})
                    results.append(r.get("success", False))
                    await asyncio.sleep(0.05)
                # service stays live after rotation
                r = await _client_request(sock, {"command": "recognize"})
                results.append(r.get("success", False))
                old_rc = old_proc.wait(timeout=10)
                return results, old_rc
            finally:
                mon.cancel()
                await sup.stop_async()

        results, old_rc = run(go())
        assert sup.recycles >= 1
        assert sup.gen[0] >= 1
        assert sup.backends[0].socket_path.endswith("g1")
        assert all(results), results  # zero failed requests across rotation
        assert old_rc == 0  # old worker drained via graceful shutdown


class TestRotationShutdownNoOrphan:
    def test_stop_mid_rotation_kills_booting_replacement(self, tmp_path):
        """stop_async during a rolling rotation must terminate the
        still-booting replacement process (regression: it was only
        promoted into self.procs after its socket appeared, so a
        mid-boot shutdown orphaned it)."""
        sock = str(tmp_path / "orph.sock")
        sup = ServiceSupervisor(
            sock,
            1,
            worker_args=["--boot-delay-ms", "1500"],
            argv_prefix=fake_prefix(),
            boot_timeout=30.0,
            recycle_after=2,
        )

        async def go():
            await sup.start_async()
            mon = asyncio.get_running_loop().create_task(sup.monitor())
            try:
                for _ in range(2):
                    r = await _client_request(sock, {"command": "recognize"})
                    assert r["success"]
                deadline = time.monotonic() + 15
                while not sup._booting and time.monotonic() < deadline:
                    await asyncio.sleep(0.05)
                assert sup._booting, "rotation never spawned a replacement"
                repl = next(iter(sup._booting))
                return mon, repl
            except BaseException:
                mon.cancel()
                await sup.stop_async()
                raise

        async def run_all():
            mon, repl = await go()
            mon.cancel()
            await sup.stop_async()
            return repl

        repl = run(run_all())
        assert repl.poll() is not None, "replacement process orphaned"


class TestBackendUnavailable:
    def test_all_backends_down_yields_error_response(self, tmp_path):
        sock = str(tmp_path / "down.sock")
        backend = Backend(str(tmp_path / "nothing.sock"))
        bal = OCRBalancer(sock, [backend])
        bal.retry_window = 0.5  # permanently-down backends: fail fast here

        async def go():
            await bal.start_async()
            try:
                return await _client_request(sock, {"command": "recognize"})
            finally:
                await bal.stop_async()

        r = run(go())
        assert r["success"] is False
        assert "unavailable" in r["error"].lower()


class TestReviewFixes:
    """Faults found in review of the JAX package's balancer, held here too."""

    def test_partial_line_client_does_not_wedge_pool(self, tmp_path):
        """A client that dies mid-write (EOF without the newline) must not
        have its partial line forwarded — the worker would wait forever
        for the separator and permanently wedge a pooled channel."""
        sock = str(tmp_path / "part.sock")
        sup = ServiceSupervisor(
            sock, 1, worker_args=[], argv_prefix=fake_prefix(),
            boot_timeout=20.0,
        )

        async def go():
            await sup.start_async()
            try:
                r, w = await asyncio.open_unix_connection(sock)
                w.write(b'{"command":"recognize"')  # no newline
                await w.drain()
                w.close()  # EOF mid-line
                # service still fully live for well-formed clients
                resp = await asyncio.wait_for(
                    _client_request(sock, {"command": "recognize"}), 10
                )
                return resp
            finally:
                await sup.stop_async()

        resp = run(go())
        assert resp["success"] is True

    def test_acquire_times_out_when_pool_capacity_lost(self):
        """Waiters blocked on the free-channel queue must honor the
        acquire timeout even when _discard() frees capacity without a
        queue put (worker crash drains the pool)."""
        b = Backend("/tmp/nonexistent-balancer-test.sock", pool_size=1)

        async def go():
            b._open = 1  # simulate a held channel (no queue entry)
            t0 = time.monotonic()
            with pytest.raises(ConnectionError):
                await b._acquire(timeout=0.6)
            return time.monotonic() - t0

        dt = run(go())
        assert dt < 5.0  # raised near the timeout, not hung

    def test_abbreviated_flags_rejected(self):
        """argparse abbreviations must be off: an accepted '--proc 4'
        would survive the supervisor's exact-name strip and make every
        worker re-spawn its own supervisor (fork bomb)."""
        from ppocr_tpu_torch.cli.service_main import build_parser

        with pytest.raises(SystemExit):
            build_parser().parse_args(["--proc", "4"])

    def test_bad_flags_exit_2_before_any_worker_is_spawned(self, tmp_path, capsys):
        """Under --processes the flags are resolved once in the supervisor
        process: a config file that asks for cross-chip with batching, a
        mesh wider than the visible cards, or a bad combination, exits 2
        instead of failing N worker boots."""
        from ppocr_tpu_torch.cli.service_main import main

        import torch

        cfg = tmp_path / "cfg.json"
        cfg.write_text('{"cross_chip": true, "request_batch_buckets": [1, 4]}')
        sock = str(tmp_path / "x.sock")
        assert main(["--processes", "2", "--config", str(cfg), "--socket", sock]) == 2
        assert "incompatible with --batch-requests > 1" in capsys.readouterr().out
        if not torch.cuda.is_available():
            assert main(["--processes", "2", "--mesh", "2", "--socket", sock]) == 2
            assert "only 0 devices visible" in capsys.readouterr().out
        assert main(["--processes", "2", "--staged", "--fast-path", "--socket", sock]) == 2
        assert main(["--processes", "2", "--staged", "--warmup", "incremental", "--socket", sock]) == 2
        assert not list(tmp_path.glob("x.sock*"))

    def test_worker_command_is_the_ports_service_main(self, tmp_path):
        sup = ServiceSupervisor(str(tmp_path / "b.sock"), 2, worker_args=["--staged"])
        assert sup.argv_prefix == [sys.executable, "-m", "ppocr_tpu_torch.cli.service_main"]
        assert sup.worker_socket(1) == str(tmp_path / "b.sock") + ".w1"
        assert sup.worker_socket(1, gen=2) == str(tmp_path / "b.sock") + ".w1g2"


BIG_OK = {
    "request_id": 1,
    "success": True,
    "processing_time_ms": 12.5,
    "words": [{"text": "x" * 50, "box": [[0, 0]] * 4}] * 200,
}
SMALL_TIMEOUT = {"success": False, "error": "Processing timed out after 1s"}
BIG_TIMEOUT = {"success": False, "error": "Processing timed out after 1s: " + "x" * 8000}


class TestResponseSplice:
    """The balancer forwards worker response BYTES untouched: it must not
    parse + re-serialize large recognize payloads (that would double the
    host JSON cost the multi-process design exists to spread)."""

    @pytest.mark.parametrize(
        "response,big,counters",
        [
            # a large success: spliced, counted ok, its time regex-extracted
            (BIG_OK, True, (1, 1, 0, 12.5)),
            # a small error is parsed exactly
            (SMALL_TIMEOUT, False, (1, 0, 1, 0.0)),
            # a multi-KB failure (e.g. a CUDA error string) must not be
            # sniffed as success: the unescaped "success":false sequence can
            # only be the top-level field (string contents escape quotes)
            (BIG_TIMEOUT, True, (1, 0, 1, 0.0)),
        ],
        ids=["large-success", "small-timeout", "large-timeout"],
    )
    def test_response_is_spliced_and_accounted(self, tmp_path, response, big, counters):
        payload = (json.dumps(response, separators=(",", ":")) + "\n").encode()
        assert (len(payload) > 4096) == big
        wsock = str(tmp_path / "wk.sock")
        sock = str(tmp_path / "bal.sock")

        async def worker(reader, writer):
            while await reader.readline():
                writer.write(payload)
                await writer.drain()

        async def go():
            server = await asyncio.start_unix_server(worker, path=wsock)
            bal = OCRBalancer(sock, [Backend(wsock)])
            await bal.start_async()
            try:
                reader, writer = await asyncio.open_unix_connection(
                    sock, limit=4 * 1024 * 1024
                )
                writer.write(b'{"command":"recognize"}\n')
                await writer.drain()
                raw = await reader.readline()
                writer.close()
                return raw, (bal.forwarded, bal.forwarded_ok, bal.timed_out, bal.forwarded_time_ms)
            finally:
                await bal.stop_async()
                server.close()

        raw, counted = run(go())
        assert raw == payload  # byte-identical splice
        assert counted == pytest.approx(counters)


class TestRotateReaping:
    def test_reap_escalates_and_leaves_no_zombie(self, tmp_path):
        """A retired worker that ignores SIGTERM must still be reaped
        (kill + wait) — each unreaped proc would be a zombie for the
        supervisor's whole lifetime ."""
        import subprocess

        sup = ServiceSupervisor(
            str(tmp_path / "b.sock"), 1, worker_args=[],
            argv_prefix=fake_prefix(),
        )
        proc = subprocess.Popen(
            ["bash", "-c", 'trap "" TERM; sleep 30']
        )

        async def go():
            proc.terminate()  # ignored by the trap
            await sup._reap(proc)

        t0 = time.monotonic()
        run(go())
        assert proc.returncode is not None  # reaped, not a zombie
        assert time.monotonic() - t0 < 15


class TestBootFailFast:
    def test_crashed_worker_fails_boot_quickly(self, tmp_path):
        """A worker that dies at boot (bad flag) must fail start_async in
        seconds, not hang for the full --boot-timeout hour ."""
        sup = ServiceSupervisor(
            str(tmp_path / "b.sock"), 1, worker_args=[],
            argv_prefix=[sys.executable, "-c", "import sys; sys.exit(2)"],
            boot_timeout=3600.0,
        )

        async def go():
            t0 = time.monotonic()
            with pytest.raises(RuntimeError):
                await sup.start_async()
            return time.monotonic() - t0

        dt = run(go())
        assert dt < 10, dt

    def test_stop_during_boot_aborts_wait(self, tmp_path):
        """self.running flipping off mid-boot (Ctrl-C) aborts the socket
        wait instead of polling out the timeout."""
        sup = ServiceSupervisor(
            str(tmp_path / "b.sock"), 1, worker_args=[],
            argv_prefix=[sys.executable, "-c", "import time; time.sleep(60)"],
            boot_timeout=3600.0,
        )

        async def go():
            async def stopper():
                await asyncio.sleep(0.3)
                sup.running = False

            sup.running = True
            t = asyncio.get_running_loop().create_task(stopper())
            t0 = time.monotonic()
            ok = await sup._wait_socket("/nonexistent.sock", 3600.0,
                                       sup._spawn(0))
            await t
            return ok, time.monotonic() - t0

        ok, dt = run(go())
        assert ok is False and dt < 5
        # clean up the sleeping child
        for p in sup.procs:
            if p is not None and p.poll() is None:
                p.terminate()

    def test_merged_status_polls_backends_concurrently(self, tmp_path):
        """One slow backend must not stall status by its delay PER
        backend — polls gather concurrently."""
        socks = []
        for i in range(3):
            socks.append(str(tmp_path / f"w{i}.sock"))

        async def slow_worker(reader, writer):
            while await reader.readline():
                await asyncio.sleep(0.5)
                writer.write(
                    (json.dumps({"success": True, "status": "{}"}) + "\n").encode()
                )
                await writer.drain()

        async def go():
            servers = [
                await asyncio.start_unix_server(slow_worker, path=s)
                for s in socks
            ]
            bal = OCRBalancer(
                str(tmp_path / "bal.sock"), [Backend(s) for s in socks]
            )
            t0 = time.monotonic()
            r = await bal._merged_status()
            dt = time.monotonic() - t0
            for s in servers:
                s.close()
            return r, dt

        r, dt = run(go())
        assert r["success"] is True
        assert dt < 1.2, dt  # ~0.5 s concurrent, not ~1.5 s serial


# -- the real thing: two worker services of the port behind the balancer ------


def test_service_main_processes_2_serves_replaces_a_worker_and_shuts_down(tmp_path):
    """``service_main --processes 2 --staged --device cpu``: both workers
    answer through the public socket (merged status shows both), a killed
    worker is replaced, ``shutdown`` fans out, the supervisor exits 0 and
    no child is left."""
    import signal
    import subprocess

    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.serve import OCRIPCClient
    from ppocr_tpu_torch.utils.imcodec import encode_png

    goldens = assets.load_goldens()
    small = goldens["configs"]["small-staged"]
    model_dir = str(assets.make_jumbo_model_dir(tmp_path / "jumbo"))
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps({"det": small["det"], "rec": small["rec"]}))
    scene = assets.load_scenes()["parity"][0]
    png = tmp_path / "scene.png"
    png.write_bytes(encode_png(scene))
    sock = str(tmp_path / "pub.sock")
    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "ppocr_tpu_torch.cli.service_main", "--processes", "2",
         "--device", "cpu", "--dtype", "float32", "--staged", "--model-dir", model_dir,
         "--socket", sock, "--config", str(cfg), "--status-interval", "600",
         "--boot-timeout", "120"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        process_group=0,  # so that a failure here can take the workers along
        # the suite runs several test processes at once: two threads for each
        # worker's CPU kernels, not one per core
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )

    def status(c):
        return json.loads(c.get_service_status()["status"])

    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if "OCR balancer listening" in line:
                break
        assert seen and "OCR balancer listening" in seen[-1], "".join(seen)
        assert sum("ready in" in line for line in seen) == 2
        request = {"command": "recognize", "image_path": str(png)}
        with OCRIPCClient(sock, timeout_ms=120000) as c:
            # least-busy routing sends sequential requests to one worker;
            # concurrent ones reach both
            out = {}

            def one(i):
                with OCRIPCClient(sock, timeout_ms=120000) as cc:
                    out[i] = cc.send_request(request)

            import threading

            threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert len(out) == 6 and all(r["success"] for r in out.values())
            texts = {tuple(w["text"] for w in r["words"]) for r in out.values()}
            assert texts == {tuple(w["text"] for w in goldens["words"]["small-staged"][0])}
            st = status(c)
            assert st["total_requests"] == st["successful_requests"] == 6
            per = st["processes"]
            assert len(per) == 2 and all("error" not in p for p in per)
            assert sum(p["total_requests"] for p in per) == 6
            assert min(p["total_requests"] for p in per) >= 1
            pids = [p["pid"] for p in per]
            assert len(set(pids)) == 2 and proc.pid not in pids

            os.kill(pids[0], signal.SIGKILL)
            for _ in range(4):  # served by the survivor meanwhile
                assert c.send_request(request)["success"]
            deadline = time.monotonic() + 240  # a boot is slow on a loaded machine
            new_pids = []
            while time.monotonic() < deadline:
                per = status(c)["processes"]
                new_pids = [p.get("pid") for p in per]
                if None not in new_pids and pids[0] not in new_pids:
                    break
                time.sleep(0.5)
            assert None not in new_pids and pids[0] not in new_pids and pids[1] in new_pids
            assert c.send_shutdown_command()["success"] is True
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "Service stopped." in rest
        for pid in set(pids + new_pids):
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if proc.poll() is None:
            proc.wait(timeout=10)
