from .cls_mv3 import ClsMV3, cls_forward, init_cls_params
from .det_db import DetDB, det_forward
from .jax_params import cls_from_jax, det_from_jax, rec_from_jax
from .rec_svtr import RecSVTR, rec_forward, rec_forward_logits, rec_timesteps

__all__ = [
    "ClsMV3",
    "DetDB",
    "RecSVTR",
    "cls_forward",
    "cls_from_jax",
    "det_forward",
    "det_from_jax",
    "init_cls_params",
    "rec_forward",
    "rec_forward_logits",
    "rec_from_jax",
    "rec_timesteps",
]
