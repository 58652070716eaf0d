"""Unix-socket JSON IPC service.

Counterpart of ``ppocr_tpu/serve/service.py`` for one process. Protocol
mirror of OCRIPCService (ocr_ipc_service.cpp:310-448), with the
Windows named pipe replaced by a Unix domain socket:

  request  {"command": "recognize", "image_path": …}           → worker JSON
           {"command": "recognize", "image_data": <base64>}    → worker JSON
           {"command": "status"}    → {"success": true, "status": "<json>"}
           {"command": "shutdown"}  → reply, then stop after ≤200 ms drain
  errors   {"success": false, "error": …}  (same messages as the reference)

request_id is 0-based exactly like the reference (fetch_add(1) returns the
pre-increment value, ocr_ipc_service.cpp:49,426).

Framing: newline-delimited compact JSON in both directions (the message-
type pipe framed for the reference; a stream socket needs explicit
framing). The 1 MB inbound guard and its exact error text are preserved;
the reference's 64 KB response cap is NOT (it silently truncates large
word lists — a flaw, not a capability).

Counters: total_requests / successful_requests / average_processing_time_ms
are all real here — the reference declares but never increments the latter
two (latent bug, ocr_ipc_service.h:91-93).

Images are decoded by ``utils.imcodec`` (PNG, BMP, JPEG, PPM/PGM/PBM/PAM,
Sun raster, PFM, Radiance HDR and GIF, as cv2 decodes them): a payload it
cannot decode gets the reference's own error response, and a grey PFM,
which cv2 decodes to [H, W], the JAX service's worker error.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
import os
import threading
import time
from typing import Optional

import numpy as np

from ..ops.kernels import launch_counts
from ..pipeline import OCREngine, PipelineConfig
from ..utils.imcodec import decode_image, read_image
from .executor import Dispatcher

MAX_MESSAGE_BYTES = 1048576  # reference PIPE_INPUT_BUFFER_SIZE (1 MB)
SHUTDOWN_DRAIN_MS = 200

TOO_LARGE_ERROR = (
    "Data too large for buffer (max 1MB). Consider using file path transmission."
)


def _compact(obj: dict) -> bytes:
    return (json.dumps(obj, ensure_ascii=False, separators=(",", ":")) + "\n").encode(
        "utf-8"
    )


def decode_base64_image(data: str) -> Optional[np.ndarray]:
    """base64 → BGR image, the cv::imdecode step of the reference
    (ocr_ipc_service.cpp:16-43); ``None`` when either decode fails."""
    try:
        raw = base64.b64decode(data, validate=True)
    except (binascii.Error, ValueError):
        return None
    return decode_image(raw)


class OCRIPCService:
    """Serves the OCR pipeline over a Unix socket."""

    def __init__(
        self,
        model_dir: str,
        socket_path: str = "/tmp/ocr_service.sock",
        cpu_workers: int = 1,
        gpu_workers: int = 0,
        config: Optional[PipelineConfig] = None,
        engine: Optional[OCREngine] = None,
        request_timeout_ms: float = 30000.0,
        recycle_after: int = 0,
        device=None,
    ):
        """``device``: where a new engine runs (default: the card; without
        one it raises). Ignored when ``engine`` is given."""
        # the reference instantiates exactly one pool: gpu if gpu_workers>0
        # else cpu (ocr_ipc_service.cpp:58-66); here both map to logical
        # workers over the single device engine
        self.socket_path = socket_path
        self.num_workers = gpu_workers if gpu_workers > 0 else cpu_workers
        self.engine = engine or OCREngine(model_dir, config, device=device)
        cfg = self.engine.config
        if cfg.fast_path and max(cfg.request_batch_buckets) > 1:
            if cfg.cross_chip:
                # guarded here too, not only in the CLI: a direct caller
                # would otherwise silently get the single-device batcher
                raise ValueError(
                    "cross_chip is incompatible with request batching "
                    "(request_batch_buckets > 1): the batching dispatcher "
                    "serves the single-chip fused step"
                )
            from .batcher import BatchingDispatcher

            self.dispatcher = BatchingDispatcher(self.engine, self.num_workers)
        else:
            self.dispatcher = Dispatcher(self.engine, self.num_workers)

        self.running = False
        # per-request wall-clock ceiling (the reference client honors
        # --timeout, ocr_ipc_client.cpp:102-133, but its service would pin
        # a connection forever on a wedged worker — fixed here);
        # 0 or negative disables the ceiling
        self.request_timeout = (
            request_timeout_ms / 1000.0 if request_timeout_ms > 0 else None
        )
        # self-recycle after N recognize requests (0 = never): a graceful
        # drain and exit code 3, for a supervisor that restarts the process
        # (under serve.balancer the supervisor recycles workers itself)
        self.recycle_after = int(recycle_after)
        self.recycled = False
        # 0-based like the reference: fetch_add(1) RETURNS the old value
        # (ocr_ipc_service.cpp:49,426), so the first request_id is 0
        self.request_counter = 0
        self.total_requests = 0
        self.successful_requests = 0
        self.failed_requests = 0
        self.timed_out_requests = 0
        self.total_processing_time = 0.0
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._active_clients = 0
        self._inflight_requests = 0
        # monotonic stamp of the last completed recognize — incremental
        # warmup requires a short idle grace past it before burning loop
        # time on the next background compile (see incremental_warmup)
        self._last_request_ts = 0.0
        self._stopped = asyncio.Event()
        # incremental-warmup progress, surfaced in status (None = full
        # warmup / not started)
        self.warmup_progress: Optional[dict] = None

    # -- incremental warmup --------------------------------------------------

    async def incremental_warmup(self, log=print) -> float:
        """Warm the fused serving variant set ONE STEP SHAPE AT A TIME on
        the event loop while the service is already accepting requests,
        as the reference loads-then-serves in seconds (ocr_det.cpp:23-91,
        ocr_service_main.cpp:124-129). A request whose shape has not run
        yet is handled by the dispatchers' warm-before-dispatch guard (it
        effectively jumps the warmup queue); everything else proceeds on
        shapes that have. Requires the fused path on one device or a mesh
        (cross-chip serving keeps the full warmup). Returns seconds."""
        cfg = self.engine.config
        if not cfg.fast_path or cfg.cross_chip:
            raise ValueError(
                "incremental warmup requires the fused path on one device or a mesh"
            )
        fused = self.engine.fused_ocr()
        keys = fused.variant_keys()
        t0 = time.time()
        self.warmup_progress = {"compiled": 0, "total": len(keys)}
        for i, key in enumerate(keys):
            # Yield MEANINGFULLY before each blank step. A bare sleep(0)
            # re-queues this coroutine ahead of freshly-polled I/O
            # callbacks, so a request whose bytes arrived during the
            # previous step would advance only about one socket read per
            # step. A real tick lets all pending I/O + handler steps run
            # first; then hold while requests are in flight (plus a 1 s
            # idle grace so request bursts don't pay a blank step between
            # members). Under sustained load background warmup pauses
            # entirely — the dispatchers' guard still warms demanded
            # shapes, so the demanded subset completes anyway and
            # warmup_progress in status shows the pause honestly.
            await asyncio.sleep(0.05)
            while self.running and (
                self._inflight_requests > 0
                or time.monotonic() - self._last_request_ts < 1.0
            ):
                await asyncio.sleep(0.05)
            if not self.running and self._server is None:
                break  # service stopped mid-warmup
            if fused.compile_variant(key):
                log(
                    f"[warmup] fused variant {key} warmed "
                    f"({i + 1}/{len(keys)}, {time.time() - t0:.1f}s)"
                )
            self.warmup_progress["compiled"] = i + 1
        return time.time() - t0

    # -- status ------------------------------------------------------------

    def get_status_info(self) -> str:
        """JSON string, embedded verbatim under the response's "status"
        key — matching the reference's string-in-string encoding
        (ocr_ipc_service.cpp:372, 438-448)."""
        # success-only mean: the time sum only accumulates for successful
        # requests, so dividing by total would understate latency exactly
        # when the service degrades
        avg = (
            self.total_processing_time / self.successful_requests
            if self.successful_requests > 0
            else 0.0
        )
        return json.dumps(
            {
                "running": self.running,
                "pid": os.getpid(),
                "total_requests": self.total_requests,
                "successful_requests": self.successful_requests,
                "average_processing_time_ms": avg,
                # beyond-reference observability:
                "failed_requests": self.failed_requests,
                "timed_out_requests": self.timed_out_requests,
                "engine_reloads": getattr(self.dispatcher, "engine_reloads", 0),
                "reloading": getattr(self.dispatcher, "reloading", False),
                "warmup_progress": self.warmup_progress,
                "workers": self.dispatcher.worker_stats(),
                # launches of the hand-written kernels in this process
                "kernel_launches": launch_counts(),
            },
            separators=(",", ":"),
        )

    # -- request processing --------------------------------------------------

    async def process_request(self, line: bytes) -> dict:
        try:
            try:
                request = json.loads(line.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                return {"success": False, "error": f"Invalid JSON: {e}"}

            command = request.get("command", "")
            if command == "recognize":
                loop = asyncio.get_running_loop()
                image = None
                error_msg = ""
                image_path = request.get("image_path", "")
                image_b64 = request.get("image_data", "")
                # decode off the event loop: a ~1 MB base64 PNG costs tens
                # of ms to decode, which would stall every other
                # connection and defeat the batcher's coalescing window
                if image_path:
                    image = await loop.run_in_executor(
                        None, read_image, image_path
                    )
                    if image is None:
                        error_msg = f"Failed to load image from path: {image_path}"
                elif image_b64:
                    image = await loop.run_in_executor(
                        None, decode_base64_image, image_b64
                    )
                    if image is None:
                        error_msg = "Failed to decode base64 image data"
                else:
                    error_msg = "Missing image_path or image_data"
                if error_msg:
                    return {"success": False, "error": error_msg}

                request_id = self.request_counter
                self.request_counter += 1
                self.total_requests += 1
                self._inflight_requests += 1
                try:
                    result = await asyncio.wait_for(
                        self.dispatcher.submit(image, request_id),
                        timeout=self.request_timeout,
                    )
                except asyncio.TimeoutError:
                    self.timed_out_requests += 1
                    self.failed_requests += 1
                    return {
                        "request_id": request_id,
                        "success": False,
                        "error": (
                            f"Request timed out after "
                            f"{int(self.request_timeout * 1000)} ms"
                        ),
                    }
                except Exception as e:
                    # counted here so total == successful + failed holds
                    # even on dispatcher-level failures
                    self.failed_requests += 1
                    return {
                        "request_id": request_id,
                        "success": False,
                        "error": str(e),
                    }
                finally:
                    self._inflight_requests -= 1
                    self._last_request_ts = time.monotonic()
                if result.get("success"):
                    self.successful_requests += 1
                    self.total_processing_time += result.get(
                        "processing_time_ms", 0.0
                    )
                else:
                    self.failed_requests += 1
                return result

            if command == "status":
                return {"success": True, "status": self.get_status_info()}

            if command == "shutdown":
                asyncio.get_running_loop().create_task(self._delayed_stop())
                return {
                    "success": True,
                    "message": "Shutdown command received, stopping service...",
                }

            return {"success": False, "error": f"Unknown command: {command}"}
        except Exception as e:  # mirror the catch-all (ocr_ipc_service.cpp:417-423)
            return {"success": False, "error": str(e)}

    async def _delayed_stop(self):
        """Reply-then-stop with ≤200 ms drain (ocr_ipc_service.cpp:385-404).

        Drains on IN-FLIGHT REQUESTS, not open connections: keep-alive
        clients hold connections open while idle, which would burn the
        full window and then kill requests mid-dispatch on other
        connections."""
        for _ in range(20):
            await asyncio.sleep(0.01)
            if self._inflight_requests == 0:
                break
        await self.stop_async()

    # -- connection handling -------------------------------------------------

    async def _handle_client(self, reader: asyncio.StreamReader, writer):
        self._active_clients += 1
        try:
            while self.running:
                try:
                    line = await reader.readline()
                except (asyncio.LimitOverrunError, ValueError):
                    writer.write(_compact({"success": False, "error": TOO_LARGE_ERROR}))
                    await writer.drain()
                    break
                if not line:
                    break
                # the reference rejects at bytes_read == buffer-1, i.e. a
                # payload of 1,048,575 bytes already errors; with the \n
                # included that is len(line) >= 1 MB (ocr_ipc_service.cpp:222)
                if len(line) >= MAX_MESSAGE_BYTES:
                    writer.write(_compact({"success": False, "error": TOO_LARGE_ERROR}))
                    await writer.drain()
                    continue
                response = await self.process_request(line.rstrip(b"\n"))
                writer.write(_compact(response))
                await writer.drain()
                if (
                    response.get("message", "").startswith("Shutdown command")
                    and response.get("success") is True
                ):
                    break  # close after shutdown reply (ocr_ipc_service.cpp:272-275)
                if (
                    self.recycle_after
                    and not self.recycled
                    and self.total_requests >= self.recycle_after
                ):
                    # reply-then-recycle: graceful drain like shutdown, but
                    # flagged so the CLI exits with the recycle code
                    self.recycled = True
                    asyncio.get_running_loop().create_task(
                        self._delayed_stop()
                    )
        except (ConnectionResetError, BrokenPipeError):
            pass  # broken-pipe isolation per connection
        finally:
            self._active_clients -= 1
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # -- lifecycle -------------------------------------------------------------

    async def start_async(self):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        self._server = await asyncio.start_unix_server(
            self._handle_client,
            path=self.socket_path,
            limit=MAX_MESSAGE_BYTES + 65536,
        )
        self.running = True

    async def stop_async(self):
        if not self.running:
            return
        self.running = False
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.dispatcher.shutdown()
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        self._stopped.set()

    async def serve_forever(self):
        await self.start_async()
        await self._stopped.wait()

    # -- sync wrappers (service_main-style usage) -----------------------------

    def run_blocking(self, ready_event: Optional[threading.Event] = None):
        """Run the service on a private event loop until shutdown."""

        async def _main():
            await self.start_async()
            if ready_event is not None:
                ready_event.set()
            await self._stopped.wait()

        asyncio.run(_main())
