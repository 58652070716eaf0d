"""Normalization constants of the det (ImageNet) and rec ((x − 0.5)/0.5)
inputs; the fused step applies them on the device after the uint8
upload (copied from ``ppocr_tpu/ops/normalize.py``)."""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_SCALE = (1 / 0.229, 1 / 0.224, 1 / 0.225)
HALF_MEAN = (0.5, 0.5, 0.5)
HALF_SCALE = (2.0, 2.0, 2.0)  # 1/0.5
