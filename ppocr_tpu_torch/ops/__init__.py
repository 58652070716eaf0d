from .ctc import ctc_greedy_collapse, ctc_topk_device
from .resize import det_cap_shape, det_fit_cap, det_resize, det_target_shape

__all__ = [
    "ctc_greedy_collapse",
    "ctc_topk_device",
    "det_cap_shape",
    "det_fit_cap",
    "det_resize",
    "det_target_shape",
]
