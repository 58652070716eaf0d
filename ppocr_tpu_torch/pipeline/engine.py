"""OCR engine: the det, rec and (optional) cls modules on one device, plus
the charset, the fused request and the three staged steps.

Counterpart of ``ppocr_tpu/pipeline/engine.py``. A model dir holds
``det/weights.npz``, ``rec/weights.npz``, with ``enable_cls`` also
``cls/weights.npz`` (the JAX package's npz pytrees, carried over by
``models.jax_params``), and ``rec/ppocr_keys_v1.txt``. Importing Paddle's
``inference.pdiparams`` is not ported yet (ROADMAP A9).

With ``mesh`` (a ``parallel.DeviceMesh``) the engine serves over several
devices: ``self.device`` is the mesh's first device, each distinct device
holds one replica of the modules (``models_on``), and the fused path
splits a request batch over the mesh's data rows. ``cross_chip_ocr`` runs
det and geometry on one device and rec on another.

The staged pipeline is the reference's own: ``detect`` (det forward, host
DB postprocess), ``classify`` and ``recognize`` (aspect-sorted
micro-batches, CTC decode), each returning its [preprocess, inference,
postprocess] times. Each step uploads uint8 NHWC, normalizes on the
device, and fetches only small tensors: the prob map, (label, score)
pairs, or the CTC top-k of the kernel ``ops.kernels.ctc_topk`` instead of
the [N, T, V] softmax.

Shapes: det pads the resized /32 image up to a closed (H, W) bucket pair;
a resize outside the buckets simply runs at its exact shape (the JAX
package refuses that from a worker thread, where its compile would hang
the TPU link; nothing is compiled per shape here). cls and rec pad the
batch to power-of-two buckets and rec pads the width to its buckets, so
that ``warmup`` can run every step shape once: a shape's first call pays
cuDNN's choice of algorithm.

The engine runs on ``device="cuda"`` unless the caller passes another
device; with no card and no explicit device it raises.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..models.cls_mv3 import cls_forward
from ..models.det_db import det_forward
from ..models.jax_params import cls_from_jax, det_from_jax, rec_from_jax
from ..models.rec_svtr import rec_forward
from ..ops.ctc import (
    ctc_beam_search,
    ctc_beam_topk_device,
    ctc_greedy_collapse,
    ctc_topk_device,
)
from ..ops.db_postprocess import DBPostProcess
from ..ops.normalize import (
    HALF_MEAN,
    HALF_SCALE,
    IMAGENET_MEAN,
    IMAGENET_SCALE,
    pack_batch,
)
from ..ops.resize import cls_resize, crnn_resize, det_resize
from ..parallel.mesh import as_device, replicate
from ..utils.checkpoint import load_params_npz
from .charset import load_charset
from .config import PipelineConfig, batch_buckets, pick_bucket

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class StageTimes:
    """Per-stage [preprocess, inference, postprocess] wall-clock ms,
    mirroring the ``times`` vectors of ocr_det.cpp:168-175 etc., kept and
    surfaced in the response instead of discarded."""

    preprocess_ms: float = 0.0
    inference_ms: float = 0.0
    postprocess_ms: float = 0.0

    def as_list(self) -> List[float]:
        return [self.preprocess_ms, self.inference_ms, self.postprocess_ms]


def _normalize(batch_u8: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor):
    return (batch_u8.float() / 255.0 - mean) * scale


@torch.inference_mode()
def det_step(model, img_u8: torch.Tensor, consts, dtype) -> torch.Tensor:
    """uint8 [B, H, W, 3] → f32 prob map [B, H, W]."""
    x = _normalize(img_u8, consts["imagenet_mean"], consts["imagenet_scale"])
    return det_forward(model, x.to(dtype)).float()


@torch.inference_mode()
def cls_step(model, imgs_u8: torch.Tensor, widths: torch.Tensor, consts, dtype):
    """uint8 [N, H, W, 3] and the true widths [N] → f32 [2, N]: the label
    (first argmax) and its probability. The columns ≥ width are zeroed
    AFTER the normalize: the reference classifier pads in normalized space
    (ocr_cls.cpp:52-56), where a black pixel would be −1, not 0."""
    x = _normalize(imgs_u8, consts["half_mean"], consts["half_scale"])
    col = torch.arange(imgs_u8.shape[2], device=imgs_u8.device)
    mask = (col[None, :] < widths[:, None]).to(x.dtype)
    probs = cls_forward(model, (x * mask[:, None, :, None]).to(dtype)).float()
    # label 1 on a strictly larger p1: argmax's first index on a tie
    label = (probs[:, 1] > probs[:, 0]).float()
    return torch.stack([label, probs.amax(dim=-1)])


@torch.inference_mode()
def rec_step(model, imgs_u8: torch.Tensor, consts, dtype, beam_candidates: int = 0):
    """uint8 [N, H, W, 3] → the CTC decode operands as one f32 tensor, so
    that one copy brings them to the host. Greedy (``beam_candidates`` 0):
    [2, N, T], the first argmax per timestep (``ctc_topk``: the CUDA
    kernel on the card) and its probability. Beam: [N, T, 2k + 1], the k
    candidate ids, their probabilities and the blank probability."""
    x = _normalize(imgs_u8, consts["half_mean"], consts["half_scale"])
    probs = rec_forward(model, x.to(dtype))
    if beam_candidates:
        idx, val, blank = ctc_beam_topk_device(probs.float(), beam_candidates)
        return torch.cat([idx.float(), val, blank.unsqueeze(-1)], dim=-1)
    with record_function("staged.ctc_topk"):
        idx, val = ctc_topk_device(probs)
    return torch.stack([idx.float(), val])


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
    device, or one replica per distinct device of ``mesh``."""

    def __init__(
        self,
        model_dir: str,
        config: Optional[PipelineConfig] = None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        mesh=None,
    ):
        """``mesh``: an optional ``parallel.DeviceMesh``. The modules are
        replicated over its devices and the fused path shards request
        batches over its "data" axis; ``device`` is then ignored."""
        self.config = config or PipelineConfig.serving()
        self.model_dir = model_dir
        self.mesh = mesh
        if mesh is not None:
            for dev in mesh.distinct_devices:
                resolve_device(dev)  # a mesh over absent cards raises here
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else _DTYPES[self.config.dtype]
        det = self.config.det
        self.post = DBPostProcess(
            thresh=det.thresh,
            box_thresh=det.box_thresh,
            unclip_ratio=det.unclip_ratio,
            score_mode=det.score_mode,
            use_dilation=det.use_dilation,
        )
        # normalization constants, uploaded once
        self._consts = {
            name: torch.tensor(value, dtype=torch.float32, device=self.device)
            for name, value in (
                ("imagenet_mean", IMAGENET_MEAN),
                ("imagenet_scale", IMAGENET_SCALE),
                ("half_mean", HALF_MEAN),
                ("half_scale", HALF_SCALE),
            )
        }
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
        # device → (det, rec, cls) replica; the engine's own device holds
        # the modules above, every other device a copy (``models_on``)
        self._replicas = {
            as_device(self.device): (self.det_model, self.rec_model, self.cls_model)
        }
        self._replicas_lock = threading.Lock()
        if self.mesh is not None:
            for dev in self.mesh.distinct_devices:
                self.models_on(dev)
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

    def models_on(self, device) -> Tuple:
        """(det, rec, cls) modules on ``device``: the engine's own on its
        device, elsewhere one copy per device, made at the first call."""
        dev = as_device(device)
        with self._replicas_lock:
            if dev not in self._replicas:
                self._replicas[dev] = tuple(
                    replicate(m, dev) if m is not None else None
                    for m in (self.det_model, self.rec_model, self.cls_model)
                )
            return self._replicas[dev]

    # -- staged steps: numpy in, numpy out ----------------------------------

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _det_step(self, img_u8: np.ndarray) -> np.ndarray:
        out = det_step(self.det_model, self._upload(img_u8), self._consts, self.dtype)
        return out.cpu().numpy()

    def _cls_step(self, imgs_u8: np.ndarray, widths: np.ndarray):
        out = cls_step(
            self.cls_model, self._upload(imgs_u8), self._upload(widths), self._consts, self.dtype
        ).cpu().numpy()
        return out[0].astype(np.int32), out[1]

    def _rec_step(self, imgs_u8: np.ndarray):
        """Greedy: (idx [N, T] int32, prob [N, T]); beam: (idx [N, T, k]
        int32, prob [N, T, k], blank prob [N, T])."""
        rec = self.config.rec
        k = rec.beam_candidates if rec.decode == "beam" else 0
        out = rec_step(self.rec_model, self._upload(imgs_u8), self._consts, self.dtype, k)
        out = out.cpu().numpy()
        if k:
            return out[..., :k].astype(np.int32), out[..., k : 2 * k], out[..., 2 * k]
        return out[0].astype(np.int32), out[1]

    # -- public stage APIs (reference: DBDetector/Classifier/CRNNRecognizer
    #    ::Run, same [pre, infer, post] times contract) --------------------

    def detect(self, image_bgr: np.ndarray) -> Tuple[List[np.ndarray], StageTimes]:
        """Full DB detection → quad boxes in source coordinates
        (DBDetector::Run behaviour, ocr_det.cpp:93-176)."""
        times = StageTimes()
        det = self.config.det
        t0 = time.perf_counter()
        with record_function("staged.det_pre"):
            resized, ratio_h, ratio_w = det_resize(
                image_bgr, det.limit_type, det.limit_side_len
            )
            rh, rw = resized.shape[:2]
            buckets = det.shape_buckets
            if det.pad_to_buckets and rh <= buckets[-1] and rw <= buckets[-1]:
                # zero-pad up to the closed (H, W) bucket pair; the prob map
                # is cropped back below so postprocess sees the exact resize
                # shape
                bh, bw = pick_bucket(buckets, rh), pick_bucket(buckets, rw)
                img = np.zeros((1, bh, bw, 3), np.uint8)
                img[0, :rh, :rw] = resized
            else:
                img = np.ascontiguousarray(resized[None])
        t1 = time.perf_counter()
        with record_function("staged.det_step"):
            prob = self._det_step(img)[0, :rh, :rw]
        t2 = time.perf_counter()
        with record_function("staged.det_post"):
            boxes = self.post(prob, image_bgr.shape[0], image_bgr.shape[1], ratio_h, ratio_w)
        t3 = time.perf_counter()
        times.preprocess_ms = (t1 - t0) * 1e3
        times.inference_ms = (t2 - t1) * 1e3
        times.postprocess_ms = (t3 - t2) * 1e3
        return boxes, times

    def classify(
        self, crops: Sequence[np.ndarray]
    ) -> Tuple[List[int], List[float], StageTimes]:
        """Batch orientation classification (Classifier::Run,
        ocr_cls.cpp:23-106): labels ∈ {0, 1} and max softmax scores."""
        if self.cls_model is None:
            raise RuntimeError("classify needs an engine built with enable_cls")
        times = StageTimes()
        cfg = self.config.cls
        _, img_h, img_w = cfg.image_shape
        labels: List[int] = [0] * len(crops)
        scores: List[float] = [0.0] * len(crops)
        buckets = batch_buckets(cfg.batch_num)
        for beg in range(0, len(crops), cfg.batch_num):
            chunk = crops[beg : beg + cfg.batch_num]
            t0 = time.perf_counter()
            with record_function("staged.cls_pre"):
                n = pick_bucket(buckets, len(chunk))
                batch = np.zeros((n, img_h, img_w, 3), np.uint8)
                widths = np.zeros((n,), np.int32)
                for i, crop in enumerate(chunk):
                    r = cls_resize(crop, cfg.image_shape)
                    batch[i, :, : r.shape[1]] = r
                    widths[i] = r.shape[1]
            t1 = time.perf_counter()
            with record_function("staged.cls_step"):
                lab, sc = self._cls_step(batch, widths)
            t2 = time.perf_counter()
            for i in range(len(chunk)):
                labels[beg + i] = int(lab[i])
                scores[beg + i] = float(sc[i])
            times.preprocess_ms += (t1 - t0) * 1e3
            times.inference_ms += (t2 - t1) * 1e3
        return labels, scores, times

    def recognize(
        self, crops: Sequence[np.ndarray]
    ) -> Tuple[List[str], List[float], StageTimes]:
        """Batched CTC recognition (CRNNRecognizer::Run, ocr_rec.cpp:24-135):
        aspect-sorted micro-batches, width-bucketed shapes, greedy or beam
        decode with the reference's keep/NaN rules. Crops that decode to
        nothing keep text "" / score 0 (the reference leaves the slot
        untouched on NaN). Padding rows of a batch are black images whose
        outputs are dropped."""
        times = StageTimes()
        cfg = self.config.rec
        n_img = len(crops)
        texts = [""] * n_img
        confs = [0.0] * n_img
        ratios = [c.shape[1] / c.shape[0] for c in crops]
        indices = np.argsort(ratios, kind="stable")
        bbuckets = batch_buckets(cfg.batch_num)

        for beg in range(0, n_img, cfg.batch_num):
            idx = indices[beg : beg + cfg.batch_num]
            t0 = time.perf_counter()
            with record_function("staged.rec_pre"):
                max_ratio = max([cfg.img_w / cfg.img_h] + [ratios[i] for i in idx])
                width = pick_bucket(cfg.width_buckets, int(cfg.img_h * max_ratio))
                resized = [
                    crnn_resize(crops[i], width / cfg.img_h, (3, cfg.img_h, width)) for i in idx
                ]
                nb = pick_bucket(bbuckets, len(idx))
                batch = pack_batch(resized, width)
                if nb > len(idx):
                    pad = np.zeros((nb - len(idx),) + batch.shape[1:], np.uint8)
                    batch = np.concatenate([batch, pad])
            t1 = time.perf_counter()
            with record_function("staged.rec_step"):
                outs = [o[: len(idx)] for o in self._rec_step(batch)]
            t2 = time.perf_counter()
            with record_function("staged.rec_decode"):
                if cfg.decode == "beam":
                    kept, conf = ctc_beam_search(*outs, beam_size=cfg.beam_size)
                else:
                    kept, conf = ctc_greedy_collapse(*outs)
                for j, i in enumerate(idx):
                    if np.isnan(conf[j]):
                        continue  # the reference skips NaN results (ocr_rec.cpp:123)
                    texts[i] = "".join(self.charset[k] for k in kept[j])
                    confs[i] = float(conf[j])
            t3 = time.perf_counter()
            times.preprocess_ms += (t1 - t0) * 1e3
            times.inference_ms += (t2 - t1) * 1e3
            times.postprocess_ms += (t3 - t2) * 1e3
        return texts, confs, times

    # -- fused single-dispatch path ------------------------------------------

    def fused_ocr(self):
        """Lazy engine-owned FusedOCR (the fused det→rec request)."""
        if not hasattr(self, "_fused_ocr"):
            from .fused import FusedOCR

            self._fused_ocr = FusedOCR(self, max_boxes=self.config.fused_max_boxes)
        return self._fused_ocr

    def cross_chip_ocr(self):
        """Lazy engine-owned CrossChipFusedOCR: det and geometry on the
        first device, rec on the second; the devices are the mesh's, else
        the visible cards, else (an engine on the CPU) the CPU twice."""
        if not hasattr(self, "_cross_chip_ocr"):
            from ..parallel.pipeline_stage import CrossChipFusedOCR

            if self.mesh is not None:
                devs = self.mesh.devices
            elif self.device.type == "cuda":
                devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            else:
                devs = [self.device, self.device]
            if len(devs) < 2:
                raise RuntimeError("cross_chip staging needs >= 2 visible devices")
            self._cross_chip_ocr = CrossChipFusedOCR(self, devs[0], devs[1])
        return self._cross_chip_ocr

    def reload(self, warmup: bool = False) -> None:
        """Rebuild the device state after a (transient) device failure: load
        the weights and the charset again (a bundle swapped on disk is
        picked up whole) and drop the cached FusedOCR and CrossChipFusedOCR
        with their record of warmed step shapes. Workers hold the old ones
        and must be rebuilt by their owner (the serving dispatchers do
        so)."""
        self._load_params()
        for cached in ("_fused_ocr", "_cross_chip_ocr"):
            if hasattr(self, cached):
                delattr(self, cached)
        if warmup:
            self.warmup()

    # -- tracing -----------------------------------------------------------

    def profile_trace(self, logdir: str):
        """A ``torch.profiler`` trace context (SURVEY.md §5: the reference
        only wall-clocks stages; this captures the host spans and, on a
        card, the device's kernels, viewable in Perfetto or
        chrome://tracing)::

            with engine.profile_trace("/tmp/ocr-trace"):
                worker.process(image, 1)

        It records CPU activity, and CUDA activity when the engine's device
        is a card, with the port's ``record_function`` spans (``fused.*``,
        ``staged.*``). On exit it writes one Chrome trace,
        ``<host>_<pid>.<timestamp>.pt.trace.json``, into ``logdir`` (created
        if missing); the JAX package's ``jax.profiler.trace`` writes an XPlane
        under ``logdir/plugins/profile/`` instead. The profiler follows the
        thread that enters the context: enter it on the thread that runs
        the request (the engine's own call, not through the service)."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))

    def staged_step_shapes(self, det_shapes: Sequence[Tuple[int, int]] = ()) -> dict:
        """The closed set of staged step shapes: det (H, W) bucket pairs
        (or ``det_shapes``), rec (batch, width) buckets, cls batch buckets
        (empty without a classifier)."""
        cfg = self.config
        if not det_shapes:
            if cfg.det.pad_to_buckets:
                b = cfg.det.shape_buckets
                det_shapes = [(h, w) for h in b for w in b]
            else:
                det_shapes = [(192, 384)]
        rec = [
            (n, w) for n in batch_buckets(cfg.rec.batch_num) for w in cfg.rec.width_buckets
        ]
        cls = batch_buckets(cfg.cls.batch_num) if self.cls_model is not None else []
        return {"det": list(det_shapes), "rec": rec, "cls": cls}

    def warmup(self, det_shapes: Sequence[Tuple[int, int]] = ()) -> float:
        """Run every step shape once on blank input, so that a shape's
        first call (cuDNN's choice of algorithm and, the very first time,
        the kernel build) is paid here and not under a request: the fused
        step shapes with ``fast_path`` (the cross-chip stages' under
        ``cross_chip``), else every staged det, rec and cls step shape.
        Returns seconds."""
        t0 = time.perf_counter()
        if self.config.fast_path:
            if self.config.cross_chip:
                self.cross_chip_ocr().warmup()
            else:
                self.fused_ocr().warmup()
            return time.perf_counter() - t0
        shapes = self.staged_step_shapes(det_shapes)
        for h, w in shapes["det"]:
            self._det_step(np.zeros((1, h, w, 3), np.uint8))
        for n, w in shapes["rec"]:
            self._rec_step(np.zeros((n, self.config.rec.img_h, w, 3), np.uint8))
        _, h, w = self.config.cls.image_shape
        for n in shapes["cls"]:
            self._cls_step(np.zeros((n, h, w, 3), np.uint8), np.zeros((n,), np.int32))
        return time.perf_counter() - t0
