"""Request dispatcher: the counterpart of the reference's worker pools.

Counterpart of ``ppocr_tpu/serve/executor.py``. The reference keeps N OS
threads, each owning a private trio of predictors, and picks the first
idle worker else round-robin (cpu_worker_pool.cpp:43-56). Here N logical
workers share one engine on one device (replicating the weights N times
buys nothing on one card) and run in a thread pool. All threads queue on
the default CUDA stream, so the requests' device work interleaves in
stream order; what overlaps is one request's host work (resize, decode)
with another's queued device work, since PyTorch releases the GIL while it
waits for the device.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..pipeline import OCREngine, OCRWorker

# error-text markers of a lost or wedged device, as the CUDA runtime and
# PyTorch print them: they trigger an engine reload and one retry. After
# a sticky error (an illegal address, a launch failure) every later call
# in the process fails the same way and only a restart helps; the reload
# then fails too, and the cooldown keeps it from being retried per request.
DEVICE_LOSS_MARKERS = (
    "cuda error",
    "cudnn error",
    "cublas error",
    "device-side assert",
    "unspecified launch failure",
    "illegal memory access",
    "device unavailable",
    "device lost",
    "no cuda-capable device",
)
# an allocation failure is the request's fault (or the batch's size), not
# the device's: reloading the weights would not help
NOT_DEVICE_LOSS_MARKERS = ("out of memory",)


def is_device_loss(error: str) -> bool:
    e = (error or "").lower()
    if any(m in e for m in NOT_DEVICE_LOSS_MARKERS):
        return False
    return any(m in e for m in DEVICE_LOSS_MARKERS)


class EngineRecoveryMixin:
    """Device-loss recovery shared by the dispatchers: reload the engine on
    the asyncio event loop, at most once per cooldown window."""

    _recover_cooldown = 5.0

    def _init_recovery(self):
        self.engine_reloads = 0
        # surfaced in service status: a reload with its warmup blocks the
        # event loop, and operators should be able to tell that from a hang
        self.reloading = False
        self._reload_lock = asyncio.Lock()
        self._last_attempt = 0.0  # cooldown keys off ATTEMPTS: a failed
        # reload must not be retried per-request (reload storm)
        self._last_attempt_ok = False

    async def _recover_engine(self) -> bool:
        """Returns True when the engine is freshly healthy — either this
        call reloaded it, or another request's reload just succeeded
        within the cooldown window (the caller should retry either way)."""
        async with self._reload_lock:
            now = time.monotonic()
            if (
                self._last_attempt
                and now - self._last_attempt < self._recover_cooldown
            ):
                # a reload just ran (or just failed): don't thrash the
                # event loop with another attempt, but DO
                # tell the caller to retry if that reload succeeded —
                # its request predates the recovery and deserves the
                # one retry like the request that triggered it
                return self._last_attempt_ok
            reload_fn = getattr(self.engine, "reload", None)
            if reload_fn is None:
                return False
            self.reloading = True
            self._last_attempt_ok = False
            try:
                reload_fn(warmup=True)
            except Exception:
                # stamp the failed attempt (cooldown engages; without it a
                # wedged device re-runs a blocking reload per request) and
                # report unhealthy instead of letting the exception kill
                # the caller (the batcher's consumer task)
                return False
            finally:
                self.reloading = False
                self._last_attempt = time.monotonic()
            self._last_attempt_ok = True
            self.engine_reloads += 1
            self._after_engine_reload()
            return True

    def _after_engine_reload(self):  # pragma: no cover - overridden
        pass


class Dispatcher(EngineRecoveryMixin):
    """Async facade over a pool of logical OCR workers."""

    def __init__(self, engine: OCREngine, num_workers: int = 1):
        self.engine = engine
        self.workers: List[OCRWorker] = [
            OCRWorker(engine, worker_id=i) for i in range(num_workers)
        ]
        # in-flight COUNT per worker, not an idle bool: with round-robin
        # overflow a worker can carry two requests, and the first one
        # finishing must not mark it idle while the second still runs
        # (it would skew the first-idle policy onto one worker)
        self._inflight: List[int] = [0] * num_workers
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._pool = ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="ocr-worker"
        )
        # per-worker health counters (the reference has no worker health
        # beyond a global request count)
        self._requests: List[int] = [0] * num_workers
        self._errors: List[int] = [0] * num_workers
        self._init_recovery()

    def _after_engine_reload(self):
        """Workers cache the engine's fused wrapper — rebuild them so they
        bind the reloaded modules."""
        self.workers = [
            OCRWorker(self.engine, worker_id=i)
            for i in range(len(self.workers))
        ]

    def _pick_worker(self) -> int:
        """First idle worker, else round-robin — the reference's policy
        (cpu_worker_pool.cpp:43-56)."""
        with self._lock:
            for i, n in enumerate(self._inflight):
                if n == 0:
                    self._inflight[i] += 1
                    return i
            i = next(self._rr) % len(self.workers)
            self._inflight[i] += 1
            return i

    def _run(self, worker_idx: int, image: Optional[np.ndarray], request_id: int):
        try:
            result = self.workers[worker_idx].process(image, request_id)
            with self._lock:
                self._requests[worker_idx] += 1
                if not result.get("success"):
                    self._errors[worker_idx] += 1
            return result
        finally:
            with self._lock:
                self._inflight[worker_idx] -= 1

    def worker_stats(self):
        with self._lock:
            return [
                {"worker_id": i, "requests": self._requests[i], "errors": self._errors[i]}
                for i in range(len(self.workers))
            ]

    async def submit(
        self, image: Optional[np.ndarray], request_id: int
    ) -> dict:
        """Submit a request; resolves with the worker's response dict
        (the promise/future rendezvous of cpu_worker_pool.cpp:34-41).
        A device-loss error triggers an engine reload (with warmup, on the
        event loop) and ONE retry — the recovery the reference lacks."""
        loop = asyncio.get_running_loop()
        cfg = self.engine.config
        if (
            cfg.fast_path
            and not cfg.cross_chip
            and image is not None
            and image.size
        ):
            # incremental warmup: run missing step shapes once here on the
            # event loop, so that the first call of a shape (cuDNN's
            # algorithm search, the kernel build) is not raced by several
            # worker threads. No-op on a warm variant set.
            fused = self.engine.fused_ocr()
            for key in fused.required_variants([image]):
                fused.compile_variant(key)
        idx = self._pick_worker()
        result = await loop.run_in_executor(
            self._pool, self._run, idx, image, request_id
        )
        if not result.get("success") and is_device_loss(result.get("error")):
            if await self._recover_engine():
                idx = self._pick_worker()
                result = await loop.run_in_executor(
                    self._pool, self._run, idx, image, request_id
                )
        return result

    def shutdown(self):
        self._pool.shutdown(wait=True)
