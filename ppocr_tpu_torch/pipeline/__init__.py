from .config import PipelineConfig
from .engine import OCREngine
from .worker import OCRWorker

__all__ = ["OCREngine", "OCRWorker", "PipelineConfig"]
