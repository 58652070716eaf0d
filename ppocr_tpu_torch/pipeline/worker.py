"""Request processor with the reference's JSON response schema.

Counterpart of ``ppocr_tpu/pipeline/worker.py`` (fused branch)::

    {"request_id", "width", "height", "success", "processing_time_ms",
     "worker_id", "words": [{"text", "confidence", "box": [[x,y]×4]}]}
    / {"request_id", "success": false, "error", "worker_id", ...}
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np

from .engine import OCREngine

log = logging.getLogger(__name__)


class OCRWorker:
    """A logical worker bound to an engine; workers share the engine's
    modules and its FusedOCR."""

    def __init__(self, engine: OCREngine, worker_id: int = 0):
        self.engine = engine
        self.worker_id = worker_id
        self._fused = engine.fused_ocr()

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
            return self._fused.process(image_bgr, request_id, worker_id=self.worker_id)
        except Exception as e:  # error response, as the reference worker
            log.exception("request %s failed", request_id)
            return {
                **base,
                "processing_time_ms": (time.perf_counter() - start) * 1e3,
                "error": str(e),
            }
