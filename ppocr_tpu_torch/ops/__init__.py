from .ctc import (
    ctc_beam_search,
    ctc_beam_topk_device,
    ctc_greedy_collapse,
    ctc_topk_device,
)
from .db_postprocess import order_points_clockwise
from .resize import det_cap_shape, det_fit_cap, det_resize, det_target_shape

__all__ = [
    "ctc_beam_search",
    "ctc_beam_topk_device",
    "ctc_greedy_collapse",
    "ctc_topk_device",
    "det_cap_shape",
    "det_fit_cap",
    "det_resize",
    "det_target_shape",
    "order_points_clockwise",
]
