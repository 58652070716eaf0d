"""Deployment sizing advice: the OCRWorker::getWorkerRecommendation analog
(ocr_worker.cpp:313-395), restated for one engine on one NVIDIA card.

Counterpart of ``ppocr_tpu/pipeline/sysinfo.py``. The reference sizes
thread-pool workers against CPU cores because each worker owns private
model replicas. Here one engine owns the models on the card; "workers"
are host-side request handlers whose job is to keep the device queue
full, so the recommendation keys on the device count and the host's
cores. It states no memory size that is not read from the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class WorkerRecommendation:
    devices: int
    platform: str
    device_name: str
    cpu_cores: int
    recommended_workers: int
    device_mem_total_mb: Optional[int]  # as the device reports it; None on the CPU
    notes: str

    def pretty(self) -> str:
        mem = (
            f"Device memory: {self.device_mem_total_mb} MB total, as the device reports it\n"
            if self.device_mem_total_mb is not None
            else ""
        )
        return (
            f"Platform: {self.platform} ({self.devices} device(s): {self.device_name}), "
            f"{self.cpu_cores} host core(s)\n"
            f"Recommended workers: {self.recommended_workers}\n"
            f"{mem}{self.notes}"
        )


def worker_recommendation(enable_cls: bool = False) -> WorkerRecommendation:
    """Sizing advice for the visible devices; on a machine without a card
    it describes the CPU (the engine itself still wants ``device="cpu"``
    said explicitly)."""
    import torch

    cpu = os.cpu_count() or 1
    if torch.cuda.is_available():
        n_dev = torch.cuda.device_count()
        platform, name = "cuda", torch.cuda.get_device_name(0)
        mem = int(torch.cuda.get_device_properties(0).total_memory // (1 << 20))
    else:
        n_dev, platform, name, mem = 1, "cpu", "host CPU", None
    # two host workers per device overlap one request's host work (resize,
    # postprocess, decode) with another's device work; more only helps if
    # image decode dominates
    workers = min(max(2 * n_dev, 2), max(cpu, 2))
    models = "det, cls and rec" if enable_cls else "det and rec"
    return WorkerRecommendation(
        devices=n_dev,
        platform=platform,
        device_name=name,
        cpu_cores=cpu,
        recommended_workers=workers,
        device_mem_total_mb=mem,
        notes=(
            "Unlike the reference (one model replica per worker thread), all "
            f"workers of a process share one set of {models} modules on the "
            "device; --processes N loads one set per process."
        ),
    )
