"""Where a serving request's time goes in the PyTorch port, on one card.

    python3 scripts/profile_torch_request.py [--requests 8] [--blob-kernel]

Serves the committed scenes (``ppocr_tpu_torch/assets``: two 768×1024 and
four 192×192) one request at a time through ``OCRWorker.process`` in the
serving-jumbo config (``PipelineConfig.serving()`` with the jumbo bundle's
rec 48×256) in bf16, after ``warmup()``. It prints one JSON object:

* ``wall_ms``: per-request host wall time without the profiler, p50 per
  scene size, ending in ``torch.cuda.synchronize()``, after one untimed
  pass over the scenes;
* under ``torch.profiler`` (which adds host overhead), for the 768×1024
  scenes, per request: the device busy time (sum of kernel times; one
  stream, so kernels do not overlap), the idle share of the wall time, the
  kernel launch count, the connected-components iterations
  (``fused.cc_iter`` spans), each ``fused.*`` span's host time and device
  time (first kernel start to last kernel end, gaps included), and the
  top kernels.

Needs a CUDA card; the card's name and power limit are printed with the
numbers.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ppocr_tpu_torch import assets  # noqa: E402
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig  # noqa: E402

SPANS = (
    "fused.host_resize", "fused.det", "fused.cc", "fused.blob_stats",
    "fused.crops", "fused.rec", "fused.ctc_topk", "fused.host_decode",
)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def dev_ms(e) -> float:
    return getattr(e, "self_device_time_total", 0.0) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--blob-kernel", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_request: no CUDA device available", file=sys.stderr)
        return 1
    scenes = assets.load_scenes()
    cfg = PipelineConfig.from_dict(assets.load_goldens()["configs"]["serving"])
    cfg.dtype = "bfloat16"
    cfg.fused_blob_kernel = args.blob_kernel
    sizes = {"768x1024": list(scenes["serving"]), "192x192": list(scenes["parity"])}
    with tempfile.TemporaryDirectory() as md:
        eng = OCREngine(str(assets.make_jumbo_model_dir(md)), cfg)
        eng.warmup()
        worker = OCRWorker(eng, 0)
        for imgs in sizes.values():  # first real requests: rec tiers warm up
            for img in imgs:
                worker.process(img, 0)
        walls = {}
        for size, imgs in sizes.items():
            walls[size] = []
            for i in range(args.requests):
                t0 = time.perf_counter()
                worker.process(imgs[i % len(imgs)], i)
                torch.cuda.synchronize()
                walls[size].append((time.perf_counter() - t0) * 1e3)
        requests = [sizes["768x1024"][i % 2] for i in range(args.requests)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i, img in enumerate(requests):
                worker.process(img, i)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / len(requests)
    n = len(requests)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in kernels if not e.key.startswith("fused.")]  # not annotations
    busy = sum(dev_ms(e) for e in kernels) / n
    spans = {s: {"host_ms": 0.0, "device_ms": 0.0} for s in SPANS}
    cc_iters = 0
    for e in prof.events():
        if e.name == "fused.cc_iter" and e.device_type == DeviceType.CPU:
            cc_iters += 1
        if e.name in spans:
            side = "host_ms" if e.device_type == DeviceType.CPU else "device_ms"
            spans[e.name][side] += e.time_range.elapsed_us() / 1e3 / n
    top = sorted(kernels, key=dev_ms, reverse=True)[:12]
    print(json.dumps({
        "card": card(),
        "config": "serving-jumbo bf16", "fused_blob_kernel": args.blob_kernel,
        "wall_ms": {k: {"p50": statistics.median(v), "n": len(v)} for k, v in walls.items()},
        "profiled_768x1024": {
            "requests": n,
            "wall_ms_per_request": prof_wall,
            "device_busy_ms_per_request": busy,
            "device_idle_share": 1.0 - busy / prof_wall,
            "kernel_launches_per_request": sum(e.count for e in kernels) / n,
            "cc_iterations_per_request": cc_iters / n,
            "spans": spans,
            "top_kernels": [
                {"name": e.key[:90], "device_ms_per_request": dev_ms(e) / n, "count_per_request": e.count / n}
                for e in top
            ],
        },
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
