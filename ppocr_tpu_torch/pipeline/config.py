"""Typed pipeline configuration with the reference's two profiles.

A copy of ``ppocr_tpu/pipeline/config.py`` (same fields, same defaults, so
one config object means the same thing to both packages). The reference
hard-codes hyperparameters in two places: the stage-class header defaults
(ocr_det.h:108-123 etc.) and the serving profile the worker ctor passes
(ocr_worker.cpp:14-63). Both are reproduced here as named constructors.

The port serves only part of this surface so far; the engine raises
``NotImplementedError`` for a field outside it (``engine.check_slice``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class DetConfig:
    limit_type: str = "max"
    limit_side_len: int = 960
    thresh: float = 0.3
    box_thresh: float = 0.5
    unclip_ratio: float = 2.0
    score_mode: str = "slow"
    use_dilation: bool = False
    # closed det-shape set: the resized /32 image is zero-padded up to the
    # next (H, W) bucket pair, so warmup can visit every shape once
    pad_to_buckets: bool = True
    shape_buckets: Tuple[int, ...] = (192, 384, 512, 672, 960)


@dataclass
class ClsConfig:
    thresh: float = 0.98
    batch_num: int = 8
    image_shape: Tuple[int, int, int] = (3, 48, 192)  # C, H, W


@dataclass
class RecConfig:
    batch_num: int = 6
    img_h: int = 48
    img_w: int = 320
    # padded-width buckets of the staged path (multiples of 8)
    width_buckets: Tuple[int, ...] = (320, 448, 640, 896, 1280, 1792)
    # CTC decode: "greedy" (reference parity, ocr_rec.cpp:97-128) or "beam"
    decode: str = "greedy"
    beam_size: int = 10
    # per-timestep candidate symbols the device prunes the lattice to
    beam_candidates: int = 5


@dataclass
class PipelineConfig:
    det: DetConfig = field(default_factory=DetConfig)
    cls: ClsConfig = field(default_factory=ClsConfig)
    rec: RecConfig = field(default_factory=RecConfig)
    # the reference worker defaults to no orientation classification
    # (ocr_worker.h:57: enable_cls = false)
    enable_cls: bool = False
    # single-dispatch fused det→rec pipeline (pipeline.fused); the
    # defaults() parity profile keeps the staged pipeline
    fast_path: bool = False
    # cross-request batch-size buckets for the fused path; (1,) disables
    # request batching
    request_batch_buckets: Tuple[int, ...] = (1,)
    # fused path: top-K blob candidates per image (rec runs B·K crops)
    fused_max_boxes: int = 32
    # fused path: crop-canvas width cap = this × rec.img_w (power of two);
    # the recognizer runs on the narrowest power-of-two slice that fits
    # the batch's widest valid crop (width tiers)
    fused_width_mult: int = 2
    # fused path: batch-count tiers. Valid crops are compacted to the
    # front of each image's K slots and the recognizer runs on the
    # narrowest slice (K, K/2, ..., K/2^(n-1)) that holds them; 1 disables
    fused_batch_tiers: int = 3
    # fused path: crop-source resolution multiplier (1 = crops sampled
    # from the det-scale canvas)
    fused_crop_src_mult: int = 1
    # fused path: route per-blob bbox/score through the blob-stats kernel
    # (ops.kernels.blob_stats) instead of the [K, H, W] masked reductions
    fused_blob_kernel: bool = False
    # fused path: min-area rotated rect quads instead of axis-aligned boxes
    fused_rotated_boxes: bool = False
    # fused path: det/geometry on device 0, rec on device 1
    cross_chip: bool = False
    # crop mode of the staged path: "bounding" | "perspective"
    crop_mode: str = "bounding"
    # compute dtype of the model forwards: "bfloat16" | "float32"
    dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        """Inverse of ``dataclasses.asdict`` (lists back to tuples), e.g.
        for the configs stored beside the goldens in ``assets/``."""

        def sub(klass, fields):
            return klass(
                **{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
            )

        top = {k: v for k, v in d.items() if k not in ("det", "cls", "rec")}
        top = {k: tuple(v) if isinstance(v, list) else v for k, v in top.items()}
        return cls(
            det=sub(DetConfig, d["det"]),
            cls=sub(ClsConfig, d["cls"]),
            rec=sub(RecConfig, d["rec"]),
            **top,
        )

    @classmethod
    def defaults(cls) -> "PipelineConfig":
        """Stage-header defaults (det 960/0.3/0.5/2.0/slow, rec 48×320×6)."""
        return cls()

    @classmethod
    def serving(cls) -> "PipelineConfig":
        """The worker's serving profile (ocr_worker.cpp:28-62): det
        512/0.2/0.4/1.8/fast, cls 0.98×8, rec 16×28×192, served by the
        fused single-dispatch path."""
        return cls(
            fast_path=True,
            det=DetConfig(
                limit_type="max",
                limit_side_len=512,
                thresh=0.2,
                box_thresh=0.4,
                unclip_ratio=1.8,
                score_mode="fast",
                use_dilation=False,
                shape_buckets=(128, 192, 256, 384, 512),
            ),
            cls=ClsConfig(thresh=0.98, batch_num=8),
            rec=RecConfig(
                batch_num=16,
                img_h=28,
                img_w=192,
                width_buckets=(192, 256, 320, 448, 640, 896, 1280),
            ),
        )


def batch_buckets(max_batch: int) -> List[int]:
    """Power-of-two batch-size buckets up to the configured batch num."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return sorted(set(out))


def pick_bucket(buckets, value: int) -> int:
    """Smallest bucket ≥ value, else the largest bucket."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]
