"""Train the recognizer on synthetic text, with the PyTorch port.

Counterpart of ``scripts/train_synthetic_rec.py``, with its flags and
``--device`` in place of ``--cpu``:

    python scripts/train_synthetic_rec_torch.py --scene-crops --alphabet jumbo \\
        --img-w 256 --aug-rotate 8 --batch 48 --steps 14000 \\
        --init-weights weights/rec_scene_full.npz --out runs/rec_jumbo.npz

It runs on the card (``--device cuda``, the default; it raises when there
is none) or, on request, on the CPU (``--device cpu``). The data is the
port's ``train/synthetic.py``, drawn as the JAX package draws it: the
DejaVu scenes (``--scene-crops`` with ``ascii``, ``full`` or ``jumbo``)
from the committed glyph atlas (Pillow's drawing), and the cv2 Hershey
lines (``--alphabet digits``, and the direct lines of ``ascii``) through
``train/cv2_text.py`` (cv2 5.0's drawing with its upright Rubik face). The
direct lines of ``full`` need characters upright Rubik lacks and raise
``CV2FallbackFaceNotPorted`` (ROADMAP A17). The batches are made on a
host thread (``BatchPrefetcher``) while the card steps. ``digits``,
``ascii`` and ``full`` train against the reference charset, which the
JAX script reads from a fixed path and this one from ``--charset-file``
(without it they raise ``ReferenceCharsetMissing``):

    python scripts/train_synthetic_rec_torch.py --scene-crops --alphabet digits \\
        --img-w 160 --charset-file ppocr_keys_v1.txt --out runs/rec_scene_digits.npz

The output npz is in the JAX layout: copy it to ``<model_dir>/rec/
weights.npz`` (with ``weights/jumbo_keys.txt`` as its charset for the
jumbo alphabet) to serve it with either package.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ppocr_tpu_torch.models import init_rec_params, rec_forward, rec_to_jax
from ppocr_tpu_torch.ops.ctc import ctc_greedy_decode_np
from ppocr_tpu_torch.pipeline.charset import load_charset
from ppocr_tpu_torch.pipeline.engine import resolve_device
from ppocr_tpu_torch.train import make_train_step
from ppocr_tpu_torch.train import synthetic
from ppocr_tpu_torch.train.finetune import charset_classes, reinit_ctc_head
from ppocr_tpu_torch.train.trainer import cosine_decay_schedule, normalize_rec_images, run_steps
from ppocr_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--img-h", type=int, default=48)
    p.add_argument("--img-w", type=int, default=192)
    p.add_argument("--scene-crops", action="store_true",
                   help="train on detector-scene crops (unclip margins + crnn_resize) "
                   "instead of direct line renders")
    p.add_argument("--aug-rotate", type=float, default=0.0,
                   help="scene-crops mode: random crop rotation in +-degrees")
    p.add_argument("--hard-frac", type=float, default=0.0,
                   help="oversample near-homoglyph chars: fraction of sampled lines "
                   "that get one such char injected (training only)")
    p.add_argument("--alphabet", choices=["digits", "ascii", "full", "jumbo"], default="digits",
                   help="digits = cv2 Hershey digit lines (scenes with --scene-crops); ascii / "
                   "full = DejaVu scene lines with --scene-crops, else cv2 Hershey lines (full: "
                   "not drawn, A17), over the reference charset (94 / ~218 classes of the "
                   "6,625-way head); jumbo = every DejaVu-drawable char (~5,000 classes) "
                   "against a re-sized head and weights/jumbo_keys.txt")
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--eval-batches", type=int, default=1)
    p.add_argument("--init-weights", default=None,
                   help="warm-start from an npz bundle (the CTC head is re-initialized "
                   "whenever its size differs from the target charset)")
    p.add_argument("--out", required=True, help="where the weights npz is written")
    p.add_argument("--charset-file", default=None,
                   help="the reference charset (ppocr_keys_v1.txt) that --alphabet digits / "
                   "ascii / full read")
    p.add_argument("--save-every", type=int, default=0,
                   help="write the params to --out every N steps (0 = only at the end)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.alphabet == "jumbo":
        if not args.scene_crops:
            p.error("--alphabet jumbo requires --scene-crops (PIL renderer)")
        charset = charset_classes(list(synthetic.jumbo_alphabet()))
    else:
        if not args.charset_file:
            raise synthetic.ReferenceCharsetMissing(f"--alphabet {args.alphabet}")
        charset = load_charset(args.charset_file)

    def make_scenes():
        kw = {"max_len": args.max_len} if args.max_len else {}
        if args.hard_frac > 0:
            kw["hard_frac"] = args.hard_frac
            if args.alphabet == "jumbo":
                kw["hard_chars"] = synthetic.jumbo_hard_chars()
            else:
                kw["hard_chars"] = "".join(c for fam in synthetic.HOMOGLYPHS for c in fam)
        if args.alphabet == "digits":
            return synthetic.SyntheticSceneDataset(seed=7, **kw)
        return synthetic.text_scene_dataset(args.alphabet, seed=7,
                                            charset_file=args.charset_file, **kw)

    if args.scene_crops:
        ds = synthetic.SceneCropRecDataset(charset, make_scenes(), img_h=args.img_h,
                                           img_w=args.img_w, aug_rotate_deg=args.aug_rotate)
    else:
        if args.alphabet == "digits":
            alphabet = "0123456789"
        else:
            alphabet = synthetic.dejavu_alphabet(args.charset_file,
                                                 ascii_only=args.alphabet == "ascii")
        ds = synthetic.SyntheticRecDataset(charset, alphabet=alphabet, img_h=args.img_h,
                                           img_w=args.img_w)

    # cosine decay to ~0 sharpens late-stage character accuracy
    schedule = cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
    _, init_fn, step_fn = make_train_step(device, learning_rate=schedule)
    params = load_params_npz(args.init_weights) if args.init_weights else init_rec_params(seed=0)
    if len(charset) != np.asarray(params["head"]["fc"]["b"]).shape[0]:
        params = reinit_ctc_head(params, len(charset), seed=0)
    state = init_fn(params)

    t0 = time.time()

    def on_step(step, state, loss):
        if step % 100 == 0 or step == 1:
            print(f"step {step:5d}  loss {float(loss):12.6f}  ({(time.time() - t0):.0f}s)",
                  flush=True)
        if args.save_every and step % args.save_every == 0:
            save_params_npz(args.out, rec_to_jax(state.model))
            print(f"  checkpointed -> {args.out} (step {step})", flush=True)

    state = run_steps(step_fn, state, lambda: ds.batch(args.batch)[0], args.steps,
                      on_step=on_step)

    # greedy decode on fresh samples
    exact = total = 0
    samples = []
    with torch.no_grad():
        for _ in range(args.eval_batches):
            eval_batch, texts = ds.batch(64)
            x = normalize_rec_images(torch.from_numpy(eval_batch["images"]).to(device))
            probs = rec_forward(state.model, x).float().cpu().numpy()
            decoded, _ = ctc_greedy_decode_np(probs, charset)
            exact += sum(d == t for d, t in zip(decoded, texts))
            total += len(texts)
            samples = list(zip(decoded, texts))[:8]
    print(f"eval: {exact}/{total} exact line matches; samples:")
    for d, t in samples:
        print(f"  gt={t!r:12} pred={d!r}")

    save_params_npz(args.out, rec_to_jax(state.model))
    print(f"saved weights to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
