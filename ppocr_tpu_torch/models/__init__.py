from .cls_mv3 import ClsMV3, cls_forward, init_cls_params
from .det_db import DetDB, det_forward, init_det_params
from .jax_params import cls_from_jax, det_from_jax, det_to_jax, rec_from_jax, rec_to_jax
from .layers import set_trainable
from .rec_svtr import (
    RecSVTR,
    init_rec_params,
    rec_forward,
    rec_forward_logits,
    rec_timesteps,
)

__all__ = [
    "ClsMV3",
    "DetDB",
    "RecSVTR",
    "cls_forward",
    "cls_from_jax",
    "det_forward",
    "det_from_jax",
    "det_to_jax",
    "init_cls_params",
    "init_det_params",
    "init_rec_params",
    "rec_forward",
    "rec_forward_logits",
    "rec_from_jax",
    "rec_timesteps",
    "rec_to_jax",
    "set_trainable",
]
