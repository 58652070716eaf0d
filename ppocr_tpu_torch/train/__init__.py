"""Training: the recognizer's CTC step, the detector's balanced-BCE step,
each on one device or over a device mesh (data parallel, and tensor
parallel over the recognizer's SVTR blocks), and the recognizer
fine-tuning recipe (``finetune_rec``); the counterpart of
``ppocr_tpu/train``."""

from .trainer import (
    TrainState,
    ctc_train_loss,
    det_train_loss,
    make_det_train_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "ctc_train_loss",
    "det_train_loss",
    "make_det_train_step",
    "make_train_step",
]
