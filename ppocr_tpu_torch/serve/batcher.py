"""Cross-request batching dispatcher for the fused serving path.

Counterpart of ``ppocr_tpu/serve/batcher.py``. Concurrent recognize
requests are coalesced (up to ``max_batch`` within a ``max_wait_ms``
window) into ONE fused step: a step's cost on the card is mostly its
kernel launches, which a batch shares. Degrades to per-request dispatch
when traffic is sparse: a lone request waits at most ``max_wait_ms``.

Requires ``PipelineConfig(fast_path=True, request_batch_buckets=(1,…,N))``
so that warmup visits every batch-size variant.
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..pipeline import OCREngine
from .executor import EngineRecoveryMixin, is_device_loss


class BatchingDispatcher(EngineRecoveryMixin):
    """Async facade matching serve.executor.Dispatcher's submit() API."""

    def __init__(
        self,
        engine: OCREngine,
        num_workers: int = 1,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 3.0,
    ):
        self.engine = engine
        self.fused = engine.fused_ocr()
        self.max_batch = max_batch or max(engine.config.request_batch_buckets)
        self.max_wait = max_wait_ms / 1000.0
        self.num_workers = num_workers
        self._pool = ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="ocr-batch"
        )
        self._queue: Optional[asyncio.Queue] = None
        self._consumer: Optional[asyncio.Task] = None
        self._loop = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._batch_tasks: set = set()
        # observability (surfaced via service status)
        self.requests = 0
        self.errors = 0
        self.consumer_restarts = 0
        self._init_recovery()

    async def submit(self, image: Optional[np.ndarray], request_id: int) -> dict:
        if image is None or image.size == 0:
            return {
                "request_id": int(request_id),
                "width": 0,
                "height": 0,
                "success": False,
                "processing_time_ms": 0.0,
                "worker_id": 0,
                "error": "Empty image data provided",
            }
        loop = asyncio.get_running_loop()
        if (
            self._queue is None
            or self._loop is not loop  # asyncio.Queue is loop-bound: a
            # dispatcher outliving its loop must rebind, not hot-spin on
            # "bound to a different event loop" errors
            or (self._consumer is not None and self._consumer.done())
        ):
            # (re)start the consumer — it is supervised and should never
            # die, but a dead consumer must never strand new submits
            if self._loop is not loop:
                self._queue = None
            self._queue = self._queue or asyncio.Queue()
            self._sem = self._sem or asyncio.Semaphore(self.num_workers)
            self._loop = loop
            self._consumer = loop.create_task(self._consume())
        fut = loop.create_future()
        await self._queue.put((image, request_id, fut, time.perf_counter()))
        return await fut

    async def _consume(self):
        """Supervised gather loop: collects a batch, hands it to a bounded
        number of in-flight batch tasks (the step of batch n+1 overlaps
        the host decode of batch n), and survives ANY exception — a crash
        can never silently strand every later submit()."""
        loop = asyncio.get_running_loop()
        while True:
            items = []
            try:
                items.append(await self._queue.get())
                deadline = loop.time() + self.max_wait
                while len(items) < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0 and self._queue.empty():
                        break
                    try:
                        items.append(
                            await asyncio.wait_for(
                                self._queue.get(), max(timeout, 0.0005)
                            )
                        )
                    except asyncio.TimeoutError:
                        break
                # drop requests whose future is already dead (client timed
                # out / disconnected): running device work for them wastes
                # whole batch slots under exactly the overload that caused
                # the timeouts
                items = [it for it in items if not it[2].done()]
                if not items:
                    continue
                self.requests += len(items)
                await self._sem.acquire()
                task = loop.create_task(self._run_batch(items))
                self._batch_tasks.add(task)
                task.add_done_callback(self._batch_tasks.discard)
            except asyncio.CancelledError:
                self._fail_items(items, "Service shutting down")
                raise
            except Exception as e:  # fail the batch, keep consuming
                self.errors += len(items)
                self.consumer_restarts += 1
                self._fail_items(items, str(e))
                if is_device_loss(str(e)):
                    await self._recover_engine()
                await asyncio.sleep(0.05)  # never hot-spin the event loop

    async def _run_batch(self, items):
        """One batch through the fused engine; failures resolve every
        future (never strand a client) and device loss triggers the
        reload on the event loop."""
        loop = asyncio.get_running_loop()
        fused = self.fused  # bind before any await: recovery may swap it
        images = [it[0] for it in items]
        rids = [it[1] for it in items]
        arrivals = [it[3] for it in items]
        try:
            # incremental warmup: run any step shape this batch needs once
            # ON THE EVENT LOOP before handing the batch to a worker thread
            # (the first call of a shape pays cuDNN's algorithm search and
            # the kernel build). No-op once the variant set is warm.
            for key in fused.required_variants(images):
                fused.compile_variant(key)
            results = await loop.run_in_executor(
                self._pool,
                lambda: fused.process_batch(
                    images, rids, arrival_times=arrivals
                ),
            )
            for (_, _, fut, _), res in zip(items, results):
                if not res.get("success"):
                    self.errors += 1
                if not fut.done():
                    fut.set_result(res)
        except asyncio.CancelledError:
            self._fail_items(items, "Service shutting down")
            raise
        except Exception as e:
            self.errors += len(items)
            self._fail_items(items, str(e))
            if is_device_loss(str(e)):
                # reload on the event loop so later batches hit a
                # healthy, re-warmed engine
                await self._recover_engine()
        finally:
            self._sem.release()

    @staticmethod
    def _fail_items(items, error: str):
        for _, rid, fut, _arr in items:
            if not fut.done():
                fut.set_result(
                    {
                        "success": False,
                        "request_id": int(rid),
                        "error": error,
                    }
                )

    def _after_engine_reload(self):
        self.fused = self.engine.fused_ocr()

    def worker_stats(self):
        return [
            {
                "worker_id": 0,
                "requests": self.requests,
                "errors": self.errors,
                "consumer_restarts": self.consumer_restarts,
                # fused steps run, and how many held more than one request
                "steps": self.fused.steps_run,
                "batched_steps": self.fused.batched_steps,
            }
        ]

    def shutdown(self):
        if self._consumer is not None:
            self._consumer.cancel()
        for t in list(self._batch_tasks):
            t.cancel()
        # fail anything still queued so clients get a prompt error instead
        # of waiting out the service-level timeout
        if self._queue is not None:
            while True:
                try:
                    items = [self._queue.get_nowait()]
                except asyncio.QueueEmpty:
                    break
                self._fail_items(items, "Service shutting down")
        self._pool.shutdown(wait=False)
