from .config import ClsConfig, DetConfig, PipelineConfig, RecConfig
from .engine import OCREngine, StageTimes
from .sysinfo import WorkerRecommendation, worker_recommendation
from .worker import OCRWorker

__all__ = [
    "ClsConfig",
    "DetConfig",
    "OCREngine",
    "OCRWorker",
    "PipelineConfig",
    "RecConfig",
    "StageTimes",
    "WorkerRecommendation",
    "worker_recommendation",
]
