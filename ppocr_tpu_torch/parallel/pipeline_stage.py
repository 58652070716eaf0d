"""Cross-chip pipeline staging: det and geometry on one device, rec on
another.

Counterpart of ``ppocr_tpu/parallel/pipeline_stage.py``.

Stage 1 (``det_device``): det forward → connected components → blob boxes
→ (optional cls) → rec-input crop sampling: ``prep`` of
``pipeline.fused.build_fused_parts``. Stage 2 (``rec_device``): recognizer
+ CTC top-k (the ``ctc_topk`` kernel on a card): ``rec``.

The handoff is the normalized crop batch [B·K, h, w, 3] in the compute
dtype, copied to ``rec_device`` after ``prep`` (the prob map, four times
larger, never leaves ``det_device``), with ``rec_device``'s stream ordered
after ``det_device``'s copy; the tier is a host integer. In JAX the
asynchronous dispatch overlaps stage 1 of request n+1 with stage 2 of
request n. Here ``prep`` waits for its device (the connected-components
loop, the tier read), so :meth:`CrossChipFusedOCR.process_stream` runs
stage 2 on a long-lived thread of its own, at most two hand-offs behind,
while the caller's thread runs the next request's stage 1.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .mesh import as_device, device_scope


class CrossChipFusedOCR:
    """Two-stage fused pipeline over an explicit (det_device, rec_device)
    pair, sharing an OCREngine's weights, config and postprocessing."""

    def __init__(self, engine, det_device, rec_device, max_boxes: Optional[int] = None):
        from ..pipeline.fused import FusedOCR, build_fused_parts, fused_part_kwargs

        cfg = engine.config
        self.engine = engine
        self.det_device = as_device(det_device)
        self.rec_device = as_device(rec_device)
        self.max_boxes = max_boxes or cfg.fused_max_boxes
        # the single source of the build kwargs, shared with FusedOCR, so
        # that the two paths cannot drift
        kw = fused_part_kwargs(engine, self.max_boxes)
        self.with_cls = kw["cls_shape"] is not None
        self.decode = kw["decode"]
        self.beam_size = cfg.rec.beam_size
        self.rotated = kw["rotated"]
        self.crop_src_mult = kw["crop_src_mult"]
        self._prep, self._rec = build_fused_parts(**kw)
        # each stage's modules on its own device
        det_model, _, cls_model = engine.models_on(self.det_device)
        self.det_model = det_model
        self.cls_model = cls_model if self.with_cls else None
        self.rec_model = engine.models_on(self.rec_device)[1]
        # the host decode is FusedOCR's
        self._words = FusedOCR._words_from_outputs
        # stage 2 runs on one long-lived thread: PyTorch's per-thread state
        # (cuDNN and cuBLAS handles and their plan caches) is built there
        # once, by warmup(), and not per request
        self._stage2_thread = ThreadPoolExecutor(1, thread_name_prefix="ocr-rec-stage")

    # -- the two stages ------------------------------------------------------

    def _stage1(self, canvas: np.ndarray, content_hw: np.ndarray, src=None):
        """``prep`` on ``det_device`` and the crops' handoff: returns
        ((crops on ``rec_device``, the copy's event or None, tier),
        (boxes, quads, valid, score, roots) as numpy)."""
        det, rec = self.det_device, self.rec_device
        with device_scope(det), torch.inference_mode():
            up = lambda a: torch.from_numpy(a).to(det)  # noqa: E731
            crops_n, boxes, quads, valid, score, roots, tier = self._prep(
                self.det_model,
                self.cls_model,
                up(canvas),
                up(content_hw),
                up(src) if src is not None else None,
            )
            # prep has read its tier, so its outputs are complete: these
            # small copies wait for nothing queued after them
            geometry = tuple(t.cpu().numpy() for t in (boxes, quads, valid, score, roots))
            copied = None
            if det != rec:
                crops_n = crops_n.to(rec, non_blocking=True)
                if det.type == "cuda":
                    copied = torch.cuda.Event()
                    copied.record(torch.cuda.current_stream(det))
        return (crops_n, copied, tier), geometry

    def _stage2(self, crops_n, copied, tier: int):
        """``rec`` on ``rec_device`` after the handoff; returns (idx, val,
        blank or None) as numpy."""
        with device_scope(self.rec_device), torch.inference_mode():
            if copied is not None and self.rec_device.type == "cuda":
                torch.cuda.current_stream(self.rec_device).wait_event(copied)
            idx, val, blank = self._rec(self.rec_model, crops_n, tier)
            return tuple(t.cpu().numpy() if t is not None else None for t in (idx, val, blank))

    def _dispatch(self, canvas: np.ndarray, content_hw: np.ndarray, src: Optional[np.ndarray] = None):
        """Both stages for one padded [1, H, W, 3] canvas (plus the
        m×-resolution crop source when ``fused_crop_src_mult > 1``):
        (boxes, quads, valid, score, roots, idx, val, blank) as numpy."""
        handoff, geometry = self._stage1(canvas, content_hw, src)
        return geometry + self._stage2_thread.submit(self._stage2, *handoff).result()

    def _canvas(self, image: np.ndarray):
        """Host resize into the det bucket canvas: (canvas [1, bh, bw, 3],
        content_hw [1, 2], src or None, (ratio_h, ratio_w))."""
        from ..ops.resize import det_fit_cap, det_resize, resize_bilinear_u8
        from ..pipeline.config import pick_bucket

        cfg = self.engine.config
        resized, ratio_h, ratio_w = det_resize(image, cfg.det.limit_type, cfg.det.limit_side_len)
        resized, ratio_h, ratio_w = det_fit_cap(
            resized, ratio_h, ratio_w, cfg.det.shape_buckets[-1]
        )
        rh, rw = resized.shape[:2]
        bh = pick_bucket(cfg.det.shape_buckets, rh)
        bw = pick_bucket(cfg.det.shape_buckets, rw)
        canvas = np.zeros((1, bh, bw, 3), np.uint8)
        canvas[0, :rh, :rw] = resized
        src = None
        m = self.crop_src_mult
        if m > 1:
            # the m× crop source comes from the original image
            src = np.zeros((1, bh * m, bw * m, 3), np.uint8)
            src[0, : rh * m, : rw * m] = resize_bilinear_u8(image, rw * m, rh * m)
        return canvas, np.array([[rh, rw]], np.int32), src, (ratio_h, ratio_w)

    # -- requests ------------------------------------------------------------

    def _finish(self, image, request_id, worker_id, handoff, geometry, ratios, t_dispatch):
        """Stage 2 of one request and its response (on the stage-2 thread)."""
        from ..pipeline.fused import _outputs

        out = _outputs(1, self.max_boxes, *geometry, *self._stage2(*handoff))
        words = self._words(self, out, 0, *ratios, image.shape[1], image.shape[0])
        return {
            "request_id": int(request_id),
            "width": int(image.shape[1]),
            "height": int(image.shape[0]),
            "success": True,
            # per request: its dispatch to its own fetch
            "processing_time_ms": (time.perf_counter() - t_dispatch) * 1e3,
            "worker_id": worker_id,
            "words": words,
        }

    def process_stream(
        self, images: Sequence[np.ndarray], request_ids: Sequence[int], worker_id: int = 0
    ) -> List[Dict]:
        """Pipelined processing in request order: stage 1 of each request
        runs on the calling thread and hands over to the stage-2 thread,
        with at most two hand-offs waiting, so that det(n+1) on
        ``det_device`` overlaps rec(n) on ``rec_device``.
        ``processing_time_ms`` is per request, from its dispatch to its own
        fetch."""
        if len(images) != len(request_ids):
            # a silent truncation would drop dispatched work
            raise ValueError(f"{len(images)} images for {len(request_ids)} request_ids")
        futures: List[Future] = []
        try:
            for image, rid in zip(images, request_ids):
                t_dispatch = time.perf_counter()
                canvas, content_hw, src, ratios = self._canvas(image)
                handoff, geometry = self._stage1(canvas, content_hw, src)
                if len(futures) >= 2:
                    futures[-2].result()  # bounds the hand-offs in flight; raises its error
                futures.append(self._stage2_thread.submit(
                    self._finish, image, rid, worker_id, handoff, geometry, ratios, t_dispatch
                ))
        finally:
            wait(futures)  # no stage 2 outlives the call, on success or error
        return [f.result() for f in futures]

    def process(self, image_bgr: np.ndarray, request_id: int = 0, worker_id: int = 0) -> Dict:
        return self.process_stream([image_bgr], [request_id], worker_id=worker_id)[0]

    def warmup(self) -> float:
        """Run both stages once for every det bucket pair on blank input.
        Returns seconds."""
        t0 = time.perf_counter()
        buckets = self.engine.config.det.shape_buckets
        m = self.crop_src_mult
        for h in buckets:
            for w in buckets:
                self._dispatch(
                    np.zeros((1, h, w, 3), np.uint8),
                    np.array([[h, w]], np.int32),
                    np.zeros((1, h * m, w * m, 3), np.uint8) if m > 1 else None,
                )
        return time.perf_counter() - t0
