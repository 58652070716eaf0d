"""Where a training step's time goes in the PyTorch port, on one card.

    python3 scripts/profile_torch_train.py [--steps 10]

Two steps of ``ppocr_tpu_torch.train.trainer``, each from numpy batches
made here (no cv2, no PIL):

* **rec**: ``make_train_step`` from the jumbo recognizer (5,008-wide head)
  on 32 crops of 48×320 (T = 40), ``finetune_rec``'s defaults, made from
  the committed JPEG crops of the serving scenes' golden words, with
  labels of 1–30 classes;
* **det**: ``make_det_train_step`` from ``init_det_params(0)`` on 8 cuts
  of 512×512 from the serving scenes, masks from the golden boxes.

The profiler lists the optimizer's ``record_function`` range as a device
event too; it is left out of the busy time and the kernel list.

For each, after 5 untimed steps, it prints one JSON object: the step's
host wall time without the profiler (median over ``--steps``, each step
ending in ``torch.cuda.synchronize()``, so it is the latency of one step
and not the pipelined period), and under ``torch.profiler`` (which adds
host overhead) per step: the device busy time (sum of kernel times; one
stream), the idle share of the profiled wall time, the kernel launch
count and the top kernels. f32 with cuDNN's default TF32 convolutions.
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
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ppocr_tpu_torch import assets  # noqa: E402
from ppocr_tpu_torch.models import init_det_params  # noqa: E402
from ppocr_tpu_torch.ops.resize import crnn_resize  # noqa: E402
from ppocr_tpu_torch.train import make_det_train_step, make_train_step  # noqa: E402
from ppocr_tpu_torch.utils.checkpoint import load_params_npz  # noqa: E402
from ppocr_tpu_torch.utils.imcodec import decode_image  # noqa: E402

DET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
DET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def dev_ms(e) -> float:
    return getattr(e, "self_device_time_total", 0.0) / 1e3


def rec_batch(rng) -> dict:
    cases, texts = assets.load_jpeg_cases()
    crops = [decode_image(cases[f"crop{i}"][0]) for i in range(len(texts))]
    x = np.stack([crnn_resize(crops[i % len(crops)], 320 / 48, (3, 48, 320)) for i in range(32)])
    lens = rng.integers(1, 31, 32)
    labels = rng.integers(1, 5008, (32, 30)).astype(np.int32)
    pads = (np.arange(30)[None, :] >= lens[:, None]).astype(np.float32)
    return {"images": (x.astype(np.float32) / 255.0 - 0.5) * 2.0,
            "labels": np.where(pads > 0, 0, labels).astype(np.int32), "label_paddings": pads}


def det_batch(rng) -> dict:
    scenes = assets.load_scenes()["serving"]
    words = assets.load_goldens()["words"]["serving"]
    imgs, masks = [], []
    for i in range(8):
        k = i % len(scenes)
        y0, x0 = int(rng.integers(0, 768 - 512 + 1)), int(rng.integers(0, 1024 - 512 + 1))
        m = np.zeros(scenes[k].shape[:2], np.float32)
        for w in words[k]:
            b = np.asarray(w["box"])
            m[b[:, 1].min() : b[:, 1].max() + 1, b[:, 0].min() : b[:, 0].max() + 1] = 1.0
        imgs.append((scenes[k][y0 : y0 + 512, x0 : x0 + 512].astype(np.float32) / 255.0
                     - DET_MEAN) / DET_STD)
        masks.append(m[y0 : y0 + 512, x0 : x0 + 512])
    return {"images": np.stack(imgs).astype(np.float32), "masks": np.stack(masks)}


def measure(name, make, params, batch, steps) -> dict:
    _, init_fn, step_fn = make()
    state = init_fn(params)
    for _ in range(5):  # untimed: cuDNN picks its algorithms, the allocator fills
        state, loss = step_fn(state, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, loss = step_fn(state, batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / n
    # device events, less the ranges of annotations such as the optimizer's
    # "Optimizer.step#AdamW.step", which would count its kernels twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and not e.key.startswith("Optimizer.")]
    busy = sum(dev_ms(e) for e in kernels) / n
    top = sorted(kernels, key=dev_ms, reverse=True)[:10]
    return {
        "step": name, "card": card(), "loss": float(loss),
        "wall_ms_per_step": {"p50": statistics.median(walls), "n": len(walls)},
        "profiled": {
            "steps": n, "wall_ms_per_step": prof_wall, "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / prof_wall,
            "kernel_launches_per_step": sum(e.count for e in kernels) / n,
            "top_kernels": [{"name": e.key[:90], "device_ms_per_step": dev_ms(e) / n,
                             "count_per_step": e.count / n} for e in top],
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    jumbo = load_params_npz(str(assets.WEIGHTS / "rec_scene_jumbo.npz"))
    runs = (
        ("rec 32 x 48x320, jumbo", lambda: make_train_step(learning_rate=5e-4), jumbo,
         rec_batch(rng)),
        ("det 8 x 512x512, init_det_params(0)", lambda: make_det_train_step(learning_rate=1e-3),
         init_det_params(0), det_batch(rng)),
    )
    for name, make, params, batch in runs:
        print(json.dumps(measure(name, make, params, batch, args.steps), indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
