"""Host time of the jumbo recipe's rotated rec batch, and of its warps.

Times ``SceneCropRecDataset(charset, text_scene_dataset("jumbo", seed=7),
img_h=48, img_w=256, aug_rotate_deg=8).batch(48)``, the batch that
``scripts/train_jumbo_torch.sh`` renders on its prefetch thread, and the
``warp_affine`` calls inside it (each crop's ±8° rotation), on the host
this runs on. ``--root`` times the port of another checkout (say, the
parent commit unpacked beside this one) with this same script:

    python scripts/time_rec_batch_torch.py
    python scripts/time_rec_batch_torch.py --root .archive_check/parent

Prints one JSON line: the median and minimum ms per batch, the median ms
per batch spent in ``warp_affine``, and its share of the batch. One batch
is made and left out first (the atlas is read then).
"""

import argparse
import json
import os
import platform
import statistics
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   help="the checkout whose ppocr_tpu_torch is timed (default: this one)")
    p.add_argument("--batches", type=int, default=20)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    from ppocr_tpu_torch.train import synthetic as S
    from ppocr_tpu_torch.train.finetune import charset_classes

    warp_s = []
    warp = S.warp_affine

    def timed_warp(*a, **kw):
        t = time.perf_counter()
        out = warp(*a, **kw)
        warp_s[-1] += time.perf_counter() - t
        return out

    S.warp_affine = timed_warp
    ds = S.SceneCropRecDataset(charset_classes(list(S.jumbo_alphabet())),
                               S.text_scene_dataset("jumbo", seed=7), img_h=48, img_w=256,
                               aug_rotate_deg=8)
    batch_ms, warp_ms = [], []
    for i in range(args.batches + 1):
        warp_s.append(0.0)
        t = time.perf_counter()
        ds.batch(48)
        if i:  # the first batch reads the atlas
            batch_ms.append((time.perf_counter() - t) * 1e3)
            warp_ms.append(warp_s[-1] * 1e3)
    print(json.dumps({
        "root": os.path.abspath(args.root), "host": platform.node(),
        "machine": platform.machine(), "cpus": os.cpu_count(),
        "batch": 48, "aug_rotate_deg": 8, "batches": args.batches,
        "ms_per_batch_median": statistics.median(batch_ms), "ms_per_batch_min": min(batch_ms),
        "warp_ms_per_batch_median": statistics.median(warp_ms),
        "warp_share": statistics.median(warp_ms) / statistics.median(batch_ms)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
