"""Held-out jumbo e2e scorer on the PyTorch port: the gate's protocol,
standalone, with its bars.

The counterpart of ``scripts/eval_jumbo.py``: the same flags (``--cpu``
becomes ``--device``), the same JSON keys, and the protocol of
``ppocr_tpu_torch.train.eval_jumbo`` (seeds 90210, 777 and 31337, 34
scenes each, IoU > 0.2 matching, homoglyph normalisation). It lays the
bundle out as a weights-only model dir in a temporary directory, so it
needs no ``--model-dir``:

    python scripts/eval_jumbo_torch.py --rec runs/rec_scene_jumbo_torch.npz
    python scripts/eval_jumbo_torch.py                 # committed bundle
    python scripts/eval_jumbo_torch.py --fused         # fused path (crop_src_mult=2)
    python scripts/eval_jumbo_torch.py --both          # both paths, and the fused-vs-staged bar
    python scripts/eval_jumbo_torch.py --device cpu    # on the CPU

Runs on the card unless ``--device cpu`` is given. Prints one JSON line a
path and exits 1 when a bar of the gate is not met (with ``--scenes``, the
200-word bar is not applied).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rec", default=os.path.join(REPO, "weights", "rec_scene_jumbo.npz"))
    p.add_argument("--det", default=os.path.join(REPO, "weights", "det_synthetic_text.npz"))
    p.add_argument("--fused", action="store_true", help="score the fused path only")
    p.add_argument("--both", action="store_true", help="score staged, then fused")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--scenes", type=int, default=0,
                   help="override scenes/seed (default: the gate's 34)")
    args = p.parse_args(argv)

    import torch

    from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker
    from ppocr_tpu_torch.train import eval_jumbo as G

    if args.device == "cuda":  # the gate is an f32 protocol: no TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    paths = ("staged", "fused") if args.both else ("fused",) if args.fused else ("staged",)
    md = tempfile.mkdtemp(prefix="jumbo_eval_")
    try:
        os.makedirs(os.path.join(md, "det"))
        os.makedirs(os.path.join(md, "rec"))
        shutil.copy(os.path.join(REPO, "weights", "jumbo_keys.txt"),
                    os.path.join(md, "rec", "ppocr_keys_v1.txt"))
        shutil.copy(args.det, os.path.join(md, "det", "weights.npz"))
        shutil.copy(args.rec, os.path.join(md, "rec", "weights.npz"))
        kw = {"n_scenes": args.scenes} if args.scenes else {}
        scores = {}
        for path in paths:
            cfg = G.fused_config() if path == "fused" else G.gate_config()
            scores[path] = sc = G.score(OCRWorker(OCREngine(md, cfg, device=args.device), 0), **kw)
            print(json.dumps({
                "rec": args.rec,
                "path": path,
                "raw": round(sc.raw, 4),
                "normalized": round(sc.normalized, 4),
                "exact": sc.exact,
                "norm_exact": sc.norm_exact,
                "total": sc.total,
                "det_found": sc.det_found,
                "det_gt": sc.det_gt,
                "misses": ["%s -> %s" % m for m in sc.misses][:40],
                "device": args.device,
                "ms_per_scene": round(sc.summary()["ms_per_scene"], 2),
            }, ensure_ascii=False), flush=True)
    finally:
        shutil.rmtree(md, ignore_errors=True)
    failed = G.bar_failures(scores.get("staged"), scores.get("fused"),
                            min_total=0 if args.scenes else G.MIN_TOTAL)
    for line in failed:
        print(f"below the gate: {line}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
