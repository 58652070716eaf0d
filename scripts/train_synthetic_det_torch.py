"""Train the DB detector on synthetic text scenes, with the PyTorch port.

Counterpart of ``scripts/train_synthetic_det.py``, with its flags and
``--device`` in place of ``--cpu``:

    python scripts/train_synthetic_det_torch.py --alphabet jumbo --steps 2000 \\
        --out runs/det.npz

It runs on the card (``--device cuda``, the default; it raises when there
is none) or, on request, on the CPU (``--device cpu``). The scenes are the
port's ``train/synthetic.py``, drawn as the JAX package draws them:
``--alphabet digits`` (the default, ``weights/det_synthetic_digits.npz``'s
data) as cv2 5.0 draws its Hershey fonts (``train/cv2_text.py``), the
others from the committed glyph atlas as Pillow draws them; ``ascii`` and
``full`` read the reference charset named by ``--charset-file`` (without it
they raise ``ReferenceCharsetMissing``). The output npz is in the JAX layout:
copy it to ``<model_dir>/det/weights.npz`` to serve it with either package.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ppocr_tpu_torch.models import det_forward, det_to_jax, init_det_params
from ppocr_tpu_torch.ops.db_postprocess import DBPostProcess
from ppocr_tpu_torch.pipeline.engine import resolve_device
from ppocr_tpu_torch.train import make_det_train_step
from ppocr_tpu_torch.train import synthetic
from ppocr_tpu_torch.train.trainer import run_steps
from ppocr_tpu_torch.utils.checkpoint import save_params_npz


def rect_iou(a, b):
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
    inter = iw * ih
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def evaluate(model, device, ds, n_scenes, *, thresh, box_thresh, unclip):
    """Detection recall/precision at IoU 0.3 over held-out scenes, through
    the serving postprocess (``DBPostProcess``, fast score)."""
    post = DBPostProcess(thresh=thresh, box_thresh=box_thresh, unclip_ratio=unclip,
                         score_mode="fast")
    dh, dw = ds.det_hw
    sh, sw = ds.src_hw
    tp = fp = fn = 0
    for _ in range(n_scenes):
        batch, scenes = ds.det_batch(1)
        with torch.no_grad():
            prob = det_forward(model, torch.from_numpy(batch["images"]).to(device))
        boxes = post(prob.float().cpu().numpy()[0], sh, sw, dh / sh, dw / sw)
        pred = [(q[:, 0].min(), q[:, 1].min(), q[:, 0].max(), q[:, 1].max()) for q in boxes]
        gts = [b for _, b in scenes[0][1]]
        matched = set()
        for p in pred:
            best, best_iou = None, 0.3
            for gi, g in enumerate(gts):
                if gi in matched:
                    continue
                v = rect_iou(p, g)
                if v > best_iou:
                    best, best_iou = gi, v
            if best is None:
                fp += 1
            else:
                matched.add(best)
                tp += 1
        fn += len(gts) - len(matched)
    return tp / max(tp + fn, 1), tp / max(tp + fp, 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--det-h", type=int, default=96)
    p.add_argument("--det-w", type=int, default=96)
    p.add_argument("--src-h", type=int, default=192)
    p.add_argument("--src-w", type=int, default=192)
    p.add_argument("--eval-scenes", type=int, default=32)
    p.add_argument("--alphabet", choices=["digits", "ascii", "full", "jumbo"], default="digits",
                   help="digits = cv2 Hershey digit lines; ascii / full = "
                   "DejaVu lines over the reference charset (94 / ~218 classes); jumbo = "
                   "every DejaVu-drawable char (~5,000 classes: det is class-agnostic, this "
                   "widens the glyph-shape distribution)")
    p.add_argument("--max-len", type=int, default=None,
                   help="max chars per rendered line (default: 5 digits, 6 otherwise)")
    p.add_argument("--out", required=True, help="where the weights npz is written")
    p.add_argument("--charset-file", default=None,
                   help="the reference charset (ppocr_keys_v1.txt) that --alphabet ascii / "
                   "full read")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)

    def make_ds(seed):
        kw = dict(src_hw=(args.src_h, args.src_w), det_hw=(args.det_h, args.det_w))
        if args.max_len:
            kw["max_len"] = args.max_len
        if args.alphabet == "digits":
            return synthetic.SyntheticSceneDataset(seed=seed, **kw)
        return synthetic.text_scene_dataset(args.alphabet, seed=seed,
                                            charset_file=args.charset_file, **kw)

    ds = make_ds(0)
    _, init_fn, step_fn = make_det_train_step(device, learning_rate=args.lr)
    state = init_fn(init_det_params(seed=0))

    t0 = time.time()

    def on_step(step, state, loss):
        if step % 100 == 0 or step == 1:
            print(f"step {step:5d}  loss {float(loss):12.6f}  ({(time.time() - t0):.0f}s)",
                  flush=True)

    state = run_steps(step_fn, state, lambda: ds.det_batch(args.batch)[0], args.steps,
                      on_step=on_step)

    recall, precision = evaluate(state.model, device, make_ds(777), args.eval_scenes,
                                 thresh=0.2, box_thresh=0.4, unclip=1.8)
    print(f"eval over {args.eval_scenes} scenes: recall {recall:.3f}  precision {precision:.3f}")

    save_params_npz(args.out, det_to_jax(state.model))
    print(f"saved weights to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
