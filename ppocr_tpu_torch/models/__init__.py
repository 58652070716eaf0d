from .det_db import DetDB, det_forward
from .jax_params import det_from_jax, rec_from_jax
from .rec_svtr import RecSVTR, rec_forward, rec_forward_logits, rec_timesteps

__all__ = [
    "DetDB",
    "RecSVTR",
    "det_forward",
    "det_from_jax",
    "rec_forward",
    "rec_forward_logits",
    "rec_from_jax",
    "rec_timesteps",
]
