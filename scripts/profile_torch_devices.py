"""Where the time of the port's serving over several devices goes, on one card.

    python3 scripts/profile_torch_devices.py [--rounds 3]

Serves phase 4's eight requests of ``chip_smoke.py`` (the committed scenes:
two 768×1024 and four 192×192, twice over) in the serving-jumbo config
(``PipelineConfig.serving()``, rec 48×256, bf16, ``fused_blob_kernel``)
one request at a time, every path warmed first, the paths in turns for
``--rounds`` rounds (forward, then backward):

* ``single``: ``OCRWorker.process`` on an engine on card 0;
* ``data_parallel``: the same on an engine over
  ``make_mesh(devices=["cuda:0", "cuda:0"])``: two data shards, one card;
* ``cross_chip``: ``cross_chip_ocr().process`` of that engine, both stages
  on card 0, stage 2 on its long-lived thread;
* ``cross_chip_inline``: the same two stages called on the calling thread;
* ``cross_chip_fresh_thread``: stage 2 on a thread started for the
  request, i.e. without the per-thread state (cuDNN and cuBLAS handles,
  plan caches) that the long-lived thread keeps;
* ``cross_chip_stream``: ``process_stream`` of the eight requests, wall
  per request; ``cross_chip_stream_switch_0.5ms`` the same with the
  interpreter's thread switch interval at 0.5 ms instead of 5 ms (set and
  restored around the call), which shows how much of the stream's time is
  one stage waiting for the interpreter lock the other holds.

It prints one JSON object: per path the p50 host wall ms of a request
(ending when its words are decoded; the fetches synchronise), and for the
cross-chip path the p50 host ms of stage 1 (resize, ``prep``, the small
fetches, the hand-off) and of stage 2 (rec, CTC top-k, its fetch). The
card's name and power limit are printed with the numbers. Two cards are
not measured: the device line of a call has one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from ppocr_tpu_torch import assets  # noqa: E402
from ppocr_tpu_torch.parallel import make_mesh  # noqa: E402
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig  # noqa: E402


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_devices: needs a CUDA card", file=sys.stderr)
        return 1
    scenes = assets.load_scenes()
    singles = ((list(scenes["serving"]) + list(scenes["parity"])) * 2)[:8]
    cfg = PipelineConfig.from_dict(assets.load_goldens()["configs"]["serving"])
    cfg.dtype = "bfloat16"
    cfg.fused_blob_kernel = True
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = str(assets.make_jumbo_model_dir(tmp + "/jumbo"))
        single = OCREngine(model_dir, cfg)
        dp = OCREngine(model_dir, cfg, mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
    cc = dp.cross_chip_ocr()
    single.warmup()
    dp.warmup()
    cc.warmup()

    stages = {"stage1": [], "stage2": []}

    def inline(image, rid):
        t0 = time.perf_counter()
        canvas, content_hw, src, ratios = cc._canvas(image)
        handoff, geometry = cc._stage1(canvas, content_hw, src)
        t1 = time.perf_counter()
        out = cc._finish(image, rid, 0, handoff, geometry, ratios, t0)
        stages["stage1"].append((t1 - t0) * 1e3)
        stages["stage2"].append((time.perf_counter() - t1) * 1e3)
        return out

    def fresh_thread(image, rid):
        canvas, content_hw, src, ratios = cc._canvas(image)
        t0 = time.perf_counter()
        handoff, geometry = cc._stage1(canvas, content_hw, src)
        box = {}
        t = threading.Thread(target=lambda: box.update(r=cc._finish(
            image, rid, 0, handoff, geometry, ratios, t0)))
        t.start()
        t.join()
        return box["r"]

    paths = {
        "single": OCRWorker(single, 0).process,
        "data_parallel": OCRWorker(dp, 0).process,
        "cross_chip": cc.process,
        "cross_chip_inline": inline,
        "cross_chip_fresh_thread": fresh_thread,
    }
    streams = {"cross_chip_stream": None, "cross_chip_stream_switch_0.5ms": 0.0005}
    walls = {name: [] for name in (*paths, *streams)}
    for round_ in range(args.rounds):
        order = list(paths) + list(streams)
        for name in order if round_ % 2 == 0 else order[::-1]:
            if name in streams:
                default = sys.getswitchinterval()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    sys.setswitchinterval(streams[name] or default)
                    out = cc.process_stream(singles, list(range(len(singles))))
                finally:
                    sys.setswitchinterval(default)
                walls[name].append((time.perf_counter() - t0) * 1e3 / len(singles))
                if not all(r["success"] for r in out):
                    raise RuntimeError("a streamed request failed")
                continue
            for i, image in enumerate(singles):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = paths[name](image, i)
                walls[name].append((time.perf_counter() - t0) * 1e3)
                if not r["success"]:
                    raise RuntimeError(f"{name}: {r.get('error')}")
    print(json.dumps({
        "profile_devices": "serving-jumbo bf16, fused_blob_kernel, chip_smoke phase 4's 8 "
        f"requests, {args.rounds} rounds in turns; two shards / both stages on ONE card; two "
        "cards not measured",
        "request_p50_ms": {k: statistics.median(v) for k, v in walls.items()},
        "cross_chip_inline_stage_p50_ms": {k: statistics.median(v) for k, v in stages.items()},
        "card": card(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
