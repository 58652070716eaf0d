"""PyTorch / CUDA port of ``ppocr_tpu`` for NVIDIA Hopper (H100).

The JAX package ``ppocr_tpu`` stays the reference; this package runs the
same fused det → rec serving request with torch modules, hand-written
CUDA kernels for the two Pallas kernels (``ops.kernels``) and numpy host
code. It imports neither JAX nor anything of ``ppocr_tpu`` (nor cv2/PIL).

Library use::

    from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig
    engine = OCREngine(model_dir, PipelineConfig.serving())  # device="cuda"
    response = OCRWorker(engine).process(image_bgr, request_id=1)
"""
