"""Host time of the port's cv2 text drawing (``train/cv2_text.py``) on the
digit datasets, beside cv2's own where cv2 is installed.

    python3 scripts/time_cv2_text_torch.py [--repeats 20]

Times, in turns, with the median of ``--repeats`` runs each (after one
untimed run, which builds ``csrc/cv2_text.cpp`` and fills its glyph
cache): one 48-line ``SyntheticRecDataset`` batch of digit lines
(48×320, ``render_line``), one digit ``SyntheticSceneDataset`` scene
(192×192, up to three lines) and one ``put_text`` of 8 digits at 32 px.
Where cv2 5.0.0 (the version the port replays) and the JAX package
import, the same three through ``ppocr_tpu.train.synthetic`` and
``cv2.putText`` are timed beside them, and the port's batches and scenes
are checked equal to them; another cv2 (or none) is named in the output
and not timed. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

DIGITS = "0123456789"


def _median_ms(fn, repeats: int) -> float:
    fn()
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def workloads(synthetic, put_text):
    """The three timed calls over ``synthetic`` (either package's module)
    and ``put_text`` (cv2.putText's signature)."""
    rec = synthetic.SyntheticRecDataset(list(DIGITS), alphabet=DIGITS, img_h=48, img_w=320, seed=0)
    scenes = synthetic.SyntheticSceneDataset(seed=0)
    line = np.full((48, 320, 3), 255, np.uint8)
    return {"rec_batch_48": lambda: rec.batch(48), "scene": scenes.sample_scene,
            "put_text_8_digits": lambda: put_text(line, "01234567", (5, 38), 0, 1.2, (0, 0, 0), 2, 16)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=20)
    args = p.parse_args(argv)
    from ppocr_tpu_torch.train import cv2_text
    from ppocr_tpu_torch.train import synthetic as port

    runs = {"port": workloads(port, cv2_text.put_text)}
    try:
        import cv2

        version = cv2.__version__
        from ppocr_tpu.train import synthetic as jax_synthetic
    except ImportError:
        cv2, version = None, None
    if version == "5.0.0":
        runs["cv2"] = workloads(jax_synthetic, cv2.putText)
        for name in ("rec_batch_48", "scene"):  # the same seeds draw the same pixels
            a, b = runs["port"][name](), runs["cv2"][name]()
            same = np.array_equal(a[0]["images"], b[0]["images"]) if name == "rec_batch_48" else (
                np.array_equal(a[0], b[0]) and a[1] == b[1])
            if not same:
                raise SystemExit(f"{name}: the port's drawing differs from cv2's")
        runs = {k: workloads(jax_synthetic if k == "cv2" else port,
                             cv2.putText if k == "cv2" else cv2_text.put_text) for k in runs}
    out = {k: {} for k in runs}
    for name in runs["port"]:
        for k in runs:  # in turns
            out[k][f"{name}_ms"] = _median_ms(runs[k][name], args.repeats)
    if "cv2" in out:
        out["port_over_cv2"] = {k: out["port"][k] / out["cv2"][k] for k in out["port"]}
    out["cv2_version"] = version
    out["host"] = {"machine": platform.machine(), "processor": platform.processor(), "cpus": os.cpu_count(),
                   "python": platform.python_version()}
    print(json.dumps({"cv2_text_host_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
