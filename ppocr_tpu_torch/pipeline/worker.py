"""Request processor with the reference's JSON response schema.

Counterpart of ``ppocr_tpu/pipeline/worker.py``; behavioural mirror of
OCRWorker::processRequest and its JSON serialization
(ocr_worker.cpp:150-311)::

    {"request_id", "width", "height", "success", "processing_time_ms",
     "worker_id", "words": [{"text", "confidence", "box": [[x,y]×4]}]}
    / {"request_id", "success": false, "error", "worker_id", ...}

With ``fast_path`` a request is one fused step (with ``cross_chip``, its
two stages on two devices); otherwise it runs the staged pipeline det →
crop → (cls) → rec and the response also carries ``stage_times``.
Preserved quirks of the staged path:

* crops are axis-aligned cv::boundingRect rects unless ``crop_mode`` is
  ``"perspective"``;
* cls rotates on label == 1 alone, ignoring ``cls.thresh`` and the score;
* no detection → success with an empty words list.

Deviation, as in the JAX package: when a degenerate crop is dropped, the
reference misaligns texts and boxes (ocr_worker.cpp:255-301); here
box/text pairs stay attached.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
from torch.profiler import record_function

from ..ops.geometry import bounding_crop, get_rotate_crop_image
from .engine import OCREngine

log = logging.getLogger(__name__)


class OCRWorker:
    """A logical worker bound to an engine; workers share the engine's
    modules and its FusedOCR (or CrossChipFusedOCR)."""

    def __init__(self, engine: OCREngine, worker_id: int = 0):
        self.engine = engine
        self.worker_id = worker_id
        cfg = engine.config
        if not cfg.fast_path:
            self._fused = None
        elif cfg.cross_chip:
            self._fused = engine.cross_chip_ocr()
        else:
            self._fused = engine.fused_ocr()

    def _staged(self, image_bgr: np.ndarray) -> Dict:
        """The staged request's ``words`` and ``stage_times``."""
        engine = self.engine
        boxes, det_times = engine.detect(image_bgr)
        stage_times = {"det_ms": det_times.as_list()}
        crop_fn = (
            get_rotate_crop_image if engine.config.crop_mode == "perspective" else bounding_crop
        )
        crops: List[np.ndarray] = []
        kept_boxes: List[np.ndarray] = []
        with record_function("staged.crops"):
            for box in boxes:
                crop = crop_fn(image_bgr, box)
                if crop.shape[0] > 0 and crop.shape[1] > 0:
                    crops.append(crop)
                    kept_boxes.append(box)
        if not crops:
            return {"words": [], "stage_times": stage_times}

        if engine.config.enable_cls and engine.cls_model is not None:
            labels, _scores, cls_times = engine.classify(crops)
            stage_times["cls_ms"] = cls_times.as_list()
            for i, label in enumerate(labels):
                # quirk preserved: rotate purely on label == 1, the
                # configured cls.thresh is never consulted
                if label == 1:
                    crops[i] = np.ascontiguousarray(crops[i][::-1, ::-1])  # 180°

        texts, confs, rec_times = engine.recognize(crops)
        stage_times["rec_ms"] = rec_times.as_list()
        words = [
            {
                "text": texts[i],
                "confidence": float(confs[i]),
                "box": [[int(x), int(y)] for x, y in kept_boxes[i]],
            }
            for i in range(len(crops))
        ]
        return {"words": words, "stage_times": stage_times}

    def process(self, image_bgr: Optional[np.ndarray], request_id: int) -> Dict:
        base = {
            "request_id": int(request_id),
            "width": 0,
            "height": 0,
            "success": False,
            "processing_time_ms": 0.0,
            "worker_id": self.worker_id,
        }
        if image_bgr is None or image_bgr.size == 0:
            return {**base, "error": "Empty image data provided"}
        base["width"] = int(image_bgr.shape[1])
        base["height"] = int(image_bgr.shape[0])
        start = time.perf_counter()
        try:
            if self._fused is not None:
                return self._fused.process(image_bgr, request_id, worker_id=self.worker_id)
            out = self._staged(image_bgr)
            base["processing_time_ms"] = (time.perf_counter() - start) * 1e3
            return {**base, "success": True, **out}
        except Exception as e:  # error response, as the reference worker
            log.exception("request %s failed", request_id)
            return {
                **base,
                "processing_time_ms": (time.perf_counter() - start) * 1e3,
                "error": str(e),
            }
