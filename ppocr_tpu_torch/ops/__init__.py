from .ctc import (
    ctc_beam_search,
    ctc_beam_topk_device,
    ctc_greedy_collapse,
    ctc_greedy_decode_np,
    ctc_topk_device,
)
from .db_postprocess import (
    DBPostProcess,
    boxes_from_bitmap,
    filter_tag_det_res,
    get_mini_boxes,
    order_points_clockwise,
    unclip_rect,
)
from .geometry import (
    bounding_crop,
    get_rotate_crop_image,
    iou_float,
    sort_boxes,
    xyxyxyxy2xyxy,
)
from .normalize import normalize_chw_np, normalize_imagenet_np, pack_batch
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
    "boxes_from_bitmap",
    "cls_resize",
    "crnn_resize",
    "ctc_beam_search",
    "ctc_beam_topk_device",
    "ctc_greedy_collapse",
    "ctc_greedy_decode_np",
    "ctc_topk_device",
    "det_cap_shape",
    "det_fit_cap",
    "det_resize",
    "det_target_shape",
    "filter_tag_det_res",
    "get_mini_boxes",
    "get_rotate_crop_image",
    "iou_float",
    "normalize_chw_np",
    "normalize_imagenet_np",
    "order_points_clockwise",
    "pack_batch",
    "sort_boxes",
    "unclip_rect",
    "xyxyxyxy2xyxy",
]
