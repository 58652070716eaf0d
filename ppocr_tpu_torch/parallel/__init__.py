"""Serving and training over several devices.

Counterpart of ``ppocr_tpu/parallel`` and of the mesh half of
``ppocr_tpu/train``. One process drives every device of a
:class:`DeviceMesh`, as the JAX package's single controller does:

* data parallel serving: a request batch split over the data rows of the
  mesh, each shard's fused step on its device, one host thread per
  distinct device (``OCREngine(mesh=...)``, ``--mesh N``);
* pipeline parallel serving: det and geometry on one device, rec on
  another, with the crop batch handed over between them
  (:class:`CrossChipFusedOCR`, ``--cross-chip``);
* training (``train.make_train_step(mesh=...)``,
  ``make_det_train_step(mesh=...)``, ``finetune_rec(mesh=...)``): data
  parallel over the rows, each row with its own copy of the model
  (:class:`MeshReplicas`), and tensor parallel over the "model" axis for
  the recognizer's SVTR blocks (``tensor_parallel``, the layout of the
  JAX package's ``param_shardings``);
* :func:`dryrun_multichip`: one step of each trainer over n devices.
"""

from .dryrun import dryrun_multichip
from .mesh import DeviceMesh, make_mesh, shard_batch, shard_rec_params, sharded_rec_infer
from .pipeline_stage import CrossChipFusedOCR
from .tensor_parallel import MeshReplicas, SplitSVTRBlock, param_shardings, split_rec

__all__ = [
    "CrossChipFusedOCR",
    "DeviceMesh",
    "MeshReplicas",
    "SplitSVTRBlock",
    "dryrun_multichip",
    "make_mesh",
    "param_shardings",
    "shard_batch",
    "shard_rec_params",
    "sharded_rec_infer",
    "split_rec",
]
