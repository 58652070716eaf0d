"""Fine-tune the recognizer on a labeled crop directory.

Counterpart of ``scripts/finetune_rec.py``, with its flags plus
``--device``:

    python -m ppocr_tpu_torch.cli.finetune_main --label-file data/rec_gt.txt \
        --init weights/rec_scene_digits.npz --steps 2000 --out /tmp/ft

Label file format (PaddleOCR rec_gt): ``relative/path.png<TAB>text`` per
line (PNG, BMP, JPEG, PPM/PGM/PBM/PAM, Sun raster, PFM, HDR or GIF crops). Exports a
serving bundle (weights.npz in the JAX layout + ppocr_keys_v1.txt) under
--out; copy both into <model_dir>/rec/ to serve with either package. Runs
on the card (``--device cuda``, the default; it raises when there is none)
or, on request, on the CPU (``--device cpu`` or ``--cpu``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label-file", required=True)
    p.add_argument("--image-root", default=None)
    p.add_argument("--init", default=None, help="starting weights.npz (else random init)")
    p.add_argument("--charset", default=None, help="fixed charset file (else built from labels)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--img-h", type=int, default=48)
    p.add_argument("--img-w", type=int, default=320)
    p.add_argument("--ckpt-every", type=int, default=0, help="train checkpoint interval (0 = off)")
    p.add_argument("--ckpt-keep", type=int, default=2)
    p.add_argument("--out", required=True)
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    from ..train.finetune import finetune_rec

    path = finetune_rec(
        args.label_file,
        args.out,
        image_root=args.image_root,
        init_weights=args.init,
        charset_file=args.charset,
        steps=args.steps,
        batch_size=args.batch,
        learning_rate=args.lr,
        img_h=args.img_h,
        img_w=args.img_w,
        ckpt_every=args.ckpt_every,
        ckpt_keep=args.ckpt_keep,
        device="cpu" if args.cpu else args.device,
    )
    print(f"exported serving bundle: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
