"""Serving over several devices.

Counterpart of ``ppocr_tpu/parallel``:

* data parallelism: a request batch split over the data rows of a
  :class:`DeviceMesh`, each shard's fused step on its device, one host
  thread per distinct device (``OCREngine(mesh=...)``, ``--mesh N``);
* pipeline parallelism: det and geometry on one device, rec on another,
  with the crop batch handed over between them
  (:class:`CrossChipFusedOCR`, ``--cross-chip``).

Training over several devices (data and tensor parallel) is not ported
yet (ROADMAP A10).
"""

from .mesh import DeviceMesh, make_mesh, shard_batch, sharded_rec_infer
from .pipeline_stage import CrossChipFusedOCR

__all__ = [
    "CrossChipFusedOCR",
    "DeviceMesh",
    "make_mesh",
    "shard_batch",
    "sharded_rec_infer",
]
