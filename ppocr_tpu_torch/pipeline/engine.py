"""OCR engine: the det, rec and (optional) cls modules on one device, plus
the charset.

Counterpart of ``ppocr_tpu/pipeline/engine.py`` for the fused path. A
model dir holds ``det/weights.npz``, ``rec/weights.npz``, with
``enable_cls`` also ``cls/weights.npz`` (the JAX package's npz pytrees,
carried over by ``models.jax_params``), and ``rec/ppocr_keys_v1.txt``.
Importing Paddle's ``inference.pdiparams`` is not ported yet (ROADMAP A9),
nor is the staged pipeline (A7), nor serving over several devices (A10).

The engine runs on ``device="cuda"`` unless the caller passes another
device; with no card and no explicit device it raises.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from ..models.jax_params import cls_from_jax, det_from_jax, rec_from_jax
from ..utils.checkpoint import load_params_npz
from .charset import load_charset
from .config import PipelineConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_slice(config: PipelineConfig, mesh=None) -> None:
    """Raise ``NotImplementedError`` for any option the port does not serve
    yet, naming its ROADMAP item, instead of ignoring it."""
    c = config
    unported = [
        (not c.fast_path, "the staged pipeline (fast_path=False)", "A7"),
        (c.cross_chip, "cross_chip", "A10"),
        (mesh is not None, "a device mesh", "A10"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to ppocr_tpu_torch yet (ROADMAP {item})"
            )


def resolve_device(device=None) -> torch.device:
    """``device`` or the card; raises when the card is asked for (or
    defaulted to) and CUDA is not available."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU"
        )
    return dev


class OCREngine:
    """Owns the det, rec and (with ``enable_cls``) cls modules on one
    device."""

    def __init__(
        self,
        model_dir: str,
        config: Optional[PipelineConfig] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        mesh=None,
    ):
        self.config = config or PipelineConfig.serving()
        check_slice(self.config, mesh)
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else _DTYPES[self.config.dtype]
        self._load_params()

    def _load_tree(self, name: str):
        path = os.path.join(self.model_dir, name, "weights.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found: the port loads weights.npz bundles only; "
                "importing inference.pdiparams is ROADMAP A9"
            )
        return load_params_npz(path)

    def _load_params(self):
        self.charset = load_charset(
            os.path.join(self.model_dir, "rec", "ppocr_keys_v1.txt")
        )
        det = det_from_jax(self._load_tree("det"))
        rec = rec_from_jax(self._load_tree("rec"))
        self.det_model = det.to(device=self.device, dtype=self.dtype)
        self.rec_model = rec.to(device=self.device, dtype=self.dtype)
        self.cls_model = None
        if self.config.enable_cls:
            cls = cls_from_jax(self._load_tree("cls"))
            self.cls_model = cls.to(device=self.device, dtype=self.dtype)
        head = self.rec_model.fc.bias.shape[0]
        if head == len(self.charset) - 1:
            # a use_space_char=False export: every emitted index still maps
            # to the right charset entry; the space class never fires
            warnings.warn(
                f"rec head emits {head} classes, one fewer than the "
                f"charset's {len(self.charset)} (blank + keys + space): "
                "treating as a no-space-class export",
                stacklevel=3,
            )
        elif head != len(self.charset):
            raise ValueError(
                f"rec head emits {head} classes but the charset file "
                f"defines {len(self.charset)} (keys + blank + space, "
                "ocr_rec.h:82-84) — weights.npz and ppocr_keys_v1.txt in "
                f"{self.model_dir}/rec are from different bundles"
            )

    def fused_ocr(self):
        """Lazy engine-owned FusedOCR (the fused det→rec request)."""
        if not hasattr(self, "_fused_ocr"):
            from .fused import FusedOCR

            self._fused_ocr = FusedOCR(self, max_boxes=self.config.fused_max_boxes)
        return self._fused_ocr

    def reload(self, warmup: bool = False) -> None:
        """Rebuild the device state after a (transient) device failure: load
        the weights and the charset again (a bundle swapped on disk is
        picked up whole) and drop the cached FusedOCR with its record of
        warmed step shapes. Workers hold the old FusedOCR and must be
        rebuilt by their owner (the serving dispatchers do so)."""
        self._load_params()
        if hasattr(self, "_fused_ocr"):
            del self._fused_ocr
        if warmup:
            self.warmup()

    def warmup(self) -> float:
        """One blank request per fused step shape; returns seconds."""
        return self.fused_ocr().warmup()
