from .ctc import (
    ctc_beam_search,
    ctc_beam_topk_device,
    ctc_greedy_collapse,
    ctc_topk_device,
)
from .db_postprocess import DBPostProcess, filter_tag_det_res, order_points_clockwise
from .geometry import (
    bounding_crop,
    get_rotate_crop_image,
    iou_float,
    sort_boxes,
    xyxyxyxy2xyxy,
)
from .normalize import pack_batch
from .resize import (
    cls_resize,
    crnn_resize,
    det_cap_shape,
    det_fit_cap,
    det_resize,
    det_target_shape,
)

__all__ = [
    "DBPostProcess",
    "bounding_crop",
    "cls_resize",
    "crnn_resize",
    "ctc_beam_search",
    "ctc_beam_topk_device",
    "ctc_greedy_collapse",
    "ctc_topk_device",
    "det_cap_shape",
    "det_fit_cap",
    "det_resize",
    "det_target_shape",
    "filter_tag_det_res",
    "get_rotate_crop_image",
    "iou_float",
    "order_points_clockwise",
    "pack_batch",
    "sort_boxes",
    "xyxyxyxy2xyxy",
]
