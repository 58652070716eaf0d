"""Multi-process serving: a supervisor + request-level Unix-socket balancer.

Counterpart of ``ppocr_tpu/serve/balancer.py`` (asyncio and ``subprocess``
only). Why: in one service process the JSON, base64 and image decode of
every request, the host postprocess and the thread hops around the device
work all share one interpreter lock. The reference scales with N worker
*threads* sharing one process (cpu_worker_pool.cpp:7-16); a Python port of
that shape cannot scale past the lock, so the equivalent here is N service
*processes* behind one public socket:

    client ──▶ public socket ──▶ OCRBalancer (asyncio, line-level L7)
                                   ├──▶ worker process 0 (own socket)
                                   ├──▶ worker process 1
                                   └──▶ …

* The balancer speaks the same NDJSON protocol as the service. Each
  request LINE is routed to the least-busy live backend (not each
  connection), so one chatty client cannot pin a process.
* ``status`` is answered by the balancer itself with merged counters from
  every live backend (the reference's single-process counters, summed).
* ``shutdown`` is fanned out to all backends, then the balancer stops.
* The supervisor restarts workers that exit, which includes deliberate
  self-recycling: ``--recycle-after N`` makes a worker drain and exit with
  code 3 after N recognize requests, bounding whatever a long-lived
  process accumulates. The remaining workers keep serving while one
  boots.

Workers share ONE card: each process has its own CUDA context and its own
copy of the models, and the card runs their kernels in turn. What
parallelizes across processes is the host-side request handling.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

# compact worker serialization (service._compact) → the key:value pair has
# no spaces; used to account large forwarded responses without parsing them
_PTIME_RE = re.compile(rb'"processing_time_ms":([0-9.eE+\-]+)')

RECYCLE_EXIT_CODE = 3
MAX_LINE = 1048576 + 65536
# backend (worker-facing) channels use a far larger line limit: the 1 MB
# guard is a REQUEST-size parity rule; responses are unbounded by design
# (service.py deliberately drops the reference's response cap) and a dense
# page's word list can exceed 1 MB of JSON
BACKEND_MAX_LINE = 64 * 1048576


class Backend:
    """One worker process' socket + a CONNECTION POOL of request pipes.

    NDJSON is strictly request-reply per connection, so concurrency to a
    worker = number of pooled connections. A single locked connection
    would cap the whole balancer at one in-flight request per worker and,
    worse, starve the worker's cross-request batching (the
    BatchingDispatcher coalesces across connections)."""

    def __init__(self, socket_path: str, pool_size: int = 8):
        self.socket_path = socket_path
        self.pool_size = pool_size
        self._free: asyncio.Queue = asyncio.Queue()
        self._open = 0
        # epoch bumps on retarget(): channels from an older epoch are
        # discarded on release so in-flight requests to the old worker
        # finish normally but nothing new reaches it (rolling recycle)
        self._epoch = 0
        self.inflight = 0
        self.requests = 0
        self.errors = 0
        # a failed connect marks the backend down for ``down_for`` seconds:
        # routing prefers the others meanwhile and then tries it again (a
        # refused connect costs nothing), so a restarted worker gets traffic
        # back. A backend never tried yet counts as up. (The JAX package
        # prefers backends with an open channel, so there a second or a
        # restarted worker gets no request until a status poll has
        # connected to it.)
        self._down_until = 0.0

    down_for = 1.0

    @property
    def down(self) -> bool:
        return time.monotonic() < self._down_until

    async def _acquire(self, timeout: float = 5.0):
        deadline = time.monotonic() + timeout
        while True:
            if self._free.empty() and self._open < self.pool_size:
                self._open += 1
                # capture BEFORE the await: a retarget() during the connect
                # must leave this channel (to the old socket) epoch-stale
                epoch = self._epoch
                try:
                    r, w = await asyncio.wait_for(
                        asyncio.open_unix_connection(
                            self.socket_path, limit=BACKEND_MAX_LINE
                        ),
                        timeout,
                    )
                    self._down_until = 0.0
                    return (r, w, epoch)
                except (OSError, asyncio.TimeoutError) as e:
                    self._open -= 1
                    self._down_until = time.monotonic() + self.down_for
                    raise ConnectionError(
                        f"backend {self.socket_path} down: {e}"
                    )
                except BaseException:
                    # cancellation mid-connect must release the capacity
                    # reservation too
                    self._open -= 1
                    raise
            try:
                # bounded wait, then re-check capacity: _discard() frees
                # capacity without waking queue waiters, so an unbounded
                # get() could sleep forever after a worker crash drains
                # the pool
                ch = await asyncio.wait_for(self._free.get(), 0.25)
            except asyncio.TimeoutError:
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"backend {self.socket_path}: no channel within "
                        f"{timeout:.0f}s"
                    )
                continue
            if ch[2] == self._epoch and not ch[1].is_closing():
                return ch
            self._discard(ch)  # stale epoch/closed; make/get another

    def _discard(self, ch):
        self._open -= 1
        try:
            ch[1].close()
        except Exception:
            pass

    def _release(self, ch):
        if ch[2] == self._epoch and not ch[1].is_closing():
            self._free.put_nowait(ch)
        else:
            self._discard(ch)

    def retarget(self, socket_path: str):
        """Atomically point new requests at a different worker socket;
        pooled channels to the old worker drain and are discarded."""
        self.socket_path = socket_path
        self._epoch += 1
        self._down_until = 0.0

    async def close(self):
        while not self._free.empty():
            self._discard(self._free.get_nowait())

    # generous per-exchange bound: the worker enforces its own per-request
    # timeout well under this; the bound exists so a wedged exchange (e.g.
    # a truncated line the worker will wait on forever) cannot leak a pool
    # slot permanently
    io_timeout = 120.0

    async def roundtrip(self, line: bytes) -> bytes:
        """One request-reply exchange on a pooled connection; up to
        ``pool_size`` exchanges run concurrently per backend."""
        ch = await self._acquire()
        reader, writer = ch[0], ch[1]
        try:
            writer.write(line)
            await writer.drain()
            resp = await asyncio.wait_for(reader.readline(), self.io_timeout)
            if not resp:
                raise ConnectionError("backend closed connection")
            if not resp.endswith(b"\n"):
                # EOF mid-line: the channel is desynced — never reuse it
                raise ConnectionError("backend response truncated")
        except BaseException:
            # BaseException: a CancelledError parked in readline must
            # still discard the channel, or the pool slot (_open) leaks
            # permanently
            self._discard(ch)
            raise
        self._release(ch)
        return resp


class OCRBalancer:
    """Line-level balancer over N backend service sockets."""

    def __init__(self, socket_path: str, backends: List[Backend]):
        self.socket_path = socket_path
        self.backends = backends
        self.running = False
        # lifetime counters (worker-process counters reset on recycle, so
        # the public merged status is accounted here at the balancer)
        self.forwarded = 0
        self.forwarded_ok = 0
        self.forwarded_time_ms = 0.0
        self.timed_out = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._stopped = asyncio.Event()
        self.on_shutdown = None  # supervisor hook

    # -- routing -----------------------------------------------------------

    # requests ride out a worker restart up to this long before erroring
    # (a relaunch is process start, weight load, kernel build lookup and
    # the worker's warmup)
    retry_window = 15.0

    async def _forward(self, line: bytes) -> "bytes | dict":
        """Route one request line; failover to another backend on error,
        and keep retrying inside ``retry_window`` when ALL backends are
        momentarily down (e.g. the only worker is mid-recycle) so clients
        see latency, not failures.

        Returns the worker's RAW newline-terminated response bytes so the
        balancer never parses + re-serializes a large recognize payload
        (that would double the host JSON cost the multi-process design
        exists to spread); only the small error dict is built here."""
        last_err = None
        deadline = time.monotonic() + self.retry_window
        while True:
            tried = []
            for _ in range(len(self.backends)):
                b = min(
                    (x for x in self.backends if x not in tried),
                    key=lambda x: (x.down, x.inflight),
                    default=None,
                )
                if b is None:
                    break
                tried.append(b)
                b.inflight += 1
                try:
                    resp = await b.roundtrip(line)
                    b.requests += 1
                    self._account(resp)
                    return resp
                except Exception as e:
                    b.errors += 1
                    last_err = e
                finally:
                    b.inflight -= 1
            if not self.running or time.monotonic() >= deadline:
                return {
                    "success": False,
                    "error": f"All backends unavailable: {last_err}",
                }
            await asyncio.sleep(0.2)

    def _account(self, resp: bytes) -> None:
        """Lifetime counters from a forwarded response without a full
        parse of large payloads: responses ≤4 KB (every error/status
        shape) are parsed exactly; larger ones are necessarily successful
        recognize payloads, so only processing_time_ms is regex-extracted."""
        self.forwarded += 1
        if len(resp) <= 4096:
            try:
                parsed = json.loads(resp)
            except Exception:
                parsed = {}
            if parsed.get("success"):
                self.forwarded_ok += 1
                self.forwarded_time_ms += parsed.get(
                    "processing_time_ms", 0.0
                )
            elif "timed out" in str(parsed.get("error", "")):
                self.timed_out += 1
            return
        # byte sniff is exact here: inside JSON strings every '"' is
        # escaped as '\"', so the unescaped key:value sequence below can
        # only be the response's own top-level success field (a multi-KB
        # failure exists, e.g. a CUDA error string in "error")
        if b'"success":false' in resp:
            if b"timed out" in resp:
                self.timed_out += 1
            return
        self.forwarded_ok += 1
        m = _PTIME_RE.search(resp)
        if m:
            try:
                self.forwarded_time_ms += float(m.group(1))
            except ValueError:
                pass

    # -- aggregated commands ----------------------------------------------

    async def _merged_status(self) -> dict:
        """Reference-shaped counters accounted at the balancer over its
        lifetime (worker counters reset on recycle), plus live per-process
        detail fanned out from each backend."""
        async def poll(i, b):
            try:
                r = await b.roundtrip(b'{"command":"status"}\n')
                st = json.loads(json.loads(r)["status"])
                st["process"] = i
                return st
            except Exception as e:
                return {"process": i, "error": str(e)}

        # concurrent polls: one saturated backend (its pool's ~5 s acquire
        # deadline) must not stall the status reply by 5 s PER backend —
        # exactly when an operator is polling
        per = list(
            await asyncio.gather(
                *(poll(i, b) for i, b in enumerate(self.backends))
            )
        )
        ok = self.forwarded_ok
        merged = {
            "running": self.running,
            "total_requests": self.forwarded,
            "successful_requests": ok,
            "average_processing_time_ms": (
                self.forwarded_time_ms / ok if ok else 0.0
            ),
            "failed_requests": self.forwarded - ok,
            "timed_out_requests": self.timed_out,
            "processes": per,
        }
        return {"success": True, "status": json.dumps(merged, separators=(",", ":"))}

    async def _fanout_shutdown(self) -> dict:
        for b in self.backends:
            try:
                await b.roundtrip(b'{"command":"shutdown"}\n')
            except Exception:
                pass
        if self.on_shutdown is not None:
            self.on_shutdown()
        asyncio.get_running_loop().create_task(self._delayed_stop())
        return {
            "success": True,
            "message": "Shutdown command received, stopping service...",
        }

    async def _delayed_stop(self):
        await asyncio.sleep(0.05)
        await self.stop_async()

    # -- connection handling -----------------------------------------------

    async def _handle_client(self, reader, writer):
        try:
            while self.running:
                try:
                    line = await reader.readline()
                except (asyncio.LimitOverrunError, ValueError):
                    from .service import TOO_LARGE_ERROR, _compact

                    writer.write(
                        _compact({"success": False, "error": TOO_LARGE_ERROR})
                    )
                    await writer.drain()
                    break
                if not line:
                    break
                if not line.endswith(b"\n"):
                    # client died mid-write (EOF without separator) — a
                    # forwarded partial line would make the worker wait
                    # forever for the newline and wedge a pool channel
                    break
                cmd = None
                # only small lines can be status/shutdown; parsing a ~300 KB
                # base64 recognize line here would double the JSON cost per
                # request (the worker parses it anyway)
                if len(line) <= 4096:
                    try:
                        cmd = json.loads(line).get("command")
                    except Exception:
                        pass  # backend replies with the invalid-JSON error
                if cmd == "status":
                    resp = await self._merged_status()
                elif cmd == "shutdown":
                    resp = await self._fanout_shutdown()
                else:
                    resp = await self._forward(line)
                if isinstance(resp, (bytes, bytearray)):
                    # raw worker response spliced through untouched
                    # (newline-terminated by Backend.roundtrip's contract)
                    data = resp
                else:
                    data = (
                        json.dumps(
                            resp, ensure_ascii=False, separators=(",", ":")
                        )
                        + "\n"
                    ).encode()
                writer.write(data)
                await writer.drain()
                if cmd == "shutdown":
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # -- lifecycle ---------------------------------------------------------

    async def start_async(self):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._stopped = asyncio.Event()
        self._server = await asyncio.start_unix_server(
            self._handle_client, path=self.socket_path, limit=MAX_LINE
        )
        self.running = True

    async def stop_async(self):
        if not self.running:
            return
        self.running = False
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for b in self.backends:
            await b.close()
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        self._stopped.set()


class ServiceSupervisor:
    """Spawns + restarts N worker service processes and runs the balancer.

    The restart loop is the recovery the reference lacks entirely: a
    worker that crashes or exits is relaunched with the same arguments
    (it finds the built kernel libraries by their hash and runs its own
    warmup) while the remaining workers keep serving through the balancer.

    ``recycle_after`` enables ROLLING recycle: the supervisor watches each
    worker's served-request count and, one worker at a time, boots a
    replacement process on a fresh socket, atomically retargets the
    backend (in-flight requests to the old worker drain on their pooled
    channels), then retires the old process, so capacity never drops
    below (n-1)/n. (Worker SELF-recycling, also supported via the
    service's own --recycle-after in single-process mode, is the wrong
    tool under a balancer: all workers cross the threshold together under
    even load, and the service has no capacity while they all boot.)
    """

    def __init__(
        self,
        socket_path: str,
        n_processes: int,
        worker_args: List[str],
        restart_delay: float = 1.0,
        # a boot is process start, weight load, kernel build lookup (the
        # first process on a machine compiles the kernels) and warmup
        boot_timeout: float = 3600.0,
        argv_prefix: Optional[List[str]] = None,
        recycle_after: int = 0,
    ):
        self.socket_path = socket_path
        self.n = n_processes
        self.worker_args = worker_args
        self.restart_delay = restart_delay
        self.boot_timeout = boot_timeout
        self.recycle_after = int(recycle_after)
        self.recycles = 0
        self._booting: set = set()  # replacement procs not yet promoted
        self.gen = [0] * n_processes
        # how to launch one worker (overridable for hermetic tests)
        self.argv_prefix = argv_prefix or [
            sys.executable,
            "-m",
            "ppocr_tpu_torch.cli.service_main",
        ]
        self.procs: List[Optional[subprocess.Popen]] = [None] * n_processes
        self.restarts = 0
        self.running = False
        # gen-0 paths come from worker_socket so the balancer and the
        # workers can never disagree on the path scheme
        self.backends = [
            Backend(self.worker_socket(i)) for i in range(n_processes)
        ]
        self.balancer = OCRBalancer(socket_path, self.backends)
        self.balancer.on_shutdown = self._mark_stopping

    def _mark_stopping(self):
        self.running = False

    def worker_socket(self, i: int, gen: Optional[int] = None) -> str:
        g = self.gen[i] if gen is None else gen
        return f"{self.socket_path}.w{i}" + (f"g{g}" if g else "")

    def _spawn(self, i: int, gen: Optional[int] = None) -> subprocess.Popen:
        argv = [
            *self.argv_prefix,
            "--socket",
            self.worker_socket(i, gen),
            *self.worker_args,
        ]
        return subprocess.Popen(
            argv,
            stdout=subprocess.DEVNULL if os.environ.get(
                "PPOCR_WORKER_QUIET"
            ) else None,
            stderr=subprocess.STDOUT if os.environ.get(
                "PPOCR_WORKER_QUIET"
            ) else None,
        )

    async def _wait_socket(
        self, path: str, timeout: float, proc: Optional[subprocess.Popen] = None
    ) -> bool:
        """Wait for a worker socket; gives up EARLY when the worker died
        or the supervisor is stopping — a worker that crashes at boot
        (bad flag, bad model dir) must not hang the supervisor for the
        whole --boot-timeout hour."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if os.path.exists(path):
                try:
                    r, w = await asyncio.open_unix_connection(path)
                    w.close()
                    await w.wait_closed()
                    return True
                except OSError:
                    pass
            if proc is not None and proc.poll() is not None:
                return False  # child exited without binding the socket
            if not self.running:
                return False  # Ctrl-C / stop during boot
            await asyncio.sleep(0.2)
        return False

    async def start_async(self):
        self.running = True
        # boot sequentially: the first worker builds the kernel libraries
        # and the later ones find them by hash; concurrent warmups would
        # also share the one card and the host's cores
        for i in range(self.n):
            t0 = time.monotonic()
            self.procs[i] = self._spawn(i)
            ok = await self._wait_socket(
                self.worker_socket(i), self.boot_timeout, self.procs[i]
            )
            if ok:
                print(
                    f"worker {i + 1}/{self.n} ready in "
                    f"{time.monotonic() - t0:.0f}s",
                    flush=True,
                )
            if not ok:
                # don't leave half-booted workers running in the dark
                for p in self.procs:
                    if p is not None and p.poll() is None:
                        p.terminate()
                raise RuntimeError(
                    f"worker {i} did not open {self.worker_socket(i)} "
                    f"within {self.boot_timeout:.0f}s (it exited, or "
                    "--boot-timeout is too short for its warmup)"
                )
        await self.balancer.start_async()

    async def _served_requests(self, i: int) -> int:
        """Requests served by worker i's CURRENT process (status poll)."""
        try:
            resp = await self.backends[i].roundtrip(b'{"command":"status"}\n')
            st = json.loads(json.loads(resp)["status"])
            return int(st.get("total_requests", 0))
        except Exception:
            return -1

    async def _rotate(self, i: int):
        """Rolling recycle of worker i: replacement first, then retire."""
        new_gen = self.gen[i] + 1
        new_proc = self._spawn(i, new_gen)
        # until the replacement is promoted into self.procs it would leak
        # on stop_async()/monitor-cancel mid-boot — track it for cleanup
        self._booting.add(new_proc)
        ok = False
        try:
            ok = await self._wait_socket(
                self.worker_socket(i, new_gen), self.boot_timeout, new_proc
            )
        finally:
            # boot failed, shutdown, or monitor cancelled mid-boot: the
            # replacement never reaches self.procs, so kill it here
            self._booting.discard(new_proc)
            if (not ok or not self.running) and new_proc.poll() is None:
                new_proc.terminate()
                await self._reap(new_proc)
        if not ok or not self.running:
            return
        old_proc = self.procs[i]
        old_path = self.worker_socket(i)
        self.gen[i] = new_gen
        self.procs[i] = new_proc
        self.backends[i].retarget(self.worker_socket(i))
        self.recycles += 1
        # graceful retire: drain via the service's own shutdown command
        w = None
        try:
            r, w = await asyncio.open_unix_connection(old_path)
            w.write(b'{"command":"shutdown"}\n')
            await w.drain()
            await asyncio.wait_for(r.readline(), 10)
        except Exception:
            pass
        finally:
            if w is not None:
                w.close()  # a wedged exchange must not leak the fd
        if old_proc is not None:
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, lambda: old_proc.wait(timeout=15)
                )
            except subprocess.TimeoutExpired:
                old_proc.terminate()
                # the retired proc is in neither self.procs nor _booting
                # anymore, so nothing else will ever wait() on it — reap
                # here or each failed graceful retire leaks a zombie for
                # the supervisor's whole lifetime
                await self._reap(old_proc)

    async def _reap(self, proc) -> None:
        """wait() a terminated child off-loop; escalate to kill."""
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, lambda: proc.wait(timeout=5))
        except subprocess.TimeoutExpired:
            proc.kill()
            await loop.run_in_executor(None, proc.wait)

    async def monitor(self):
        """Restart exited workers (crash recovery) and run rolling recycles
        (one at a time) when a worker crosses ``recycle_after`` served
        requests."""
        while self.running:
            for i, p in enumerate(self.procs):
                if p is not None and p.poll() is not None and self.running:
                    self.restarts += 1
                    await asyncio.sleep(self.restart_delay)
                    if not self.running:  # shutdown landed during the sleep
                        break
                    self.procs[i] = self._spawn(i)
                    # no socket wait here: _forward's failover/retry covers
                    # the boot window, and a monitor blocked for one boot
                    # (up to --boot-timeout) would stall every other
                    # crash restart and all rolling recycles
            if self.recycle_after and self.running:
                for i in range(self.n):
                    served = await self._served_requests(i)
                    if served >= self.recycle_after and self.running:
                        await self._rotate(i)
                        break  # one rotation per sweep
            await asyncio.sleep(0.3 if not self.recycle_after else 1.0)

    async def stop_async(self):
        self.running = False
        await self.balancer.stop_async()
        procs = list(self.procs) + list(self._booting)
        self._booting.clear()
        for p in procs:
            if p is not None and p.poll() is None:
                p.terminate()
        # reap OFF the event loop (a SIGTERM-ignoring worker used to
        # freeze the loop 10 s per process — blocking a second Ctrl-C and
        # in-flight client writes) and always wait() after kill
        for p in procs:
            if p is not None:
                await self._reap(p)
