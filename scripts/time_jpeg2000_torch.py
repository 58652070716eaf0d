"""Host time of the port's JPEG 2000 decoder (``utils/imcodec.py`` with
``csrc/jpeg2000.cpp``) on the first 768×1024 serving scene, beside cv2's
where cv2 is installed.

    python3 scripts/time_jpeg2000_torch.py [--repeats 25]

The payloads are the committed ones of ``assets/image_cases.npz``: the
scene as cv2's default (lossless, 5/3) ``.jp2``, as Pillow's irreversible
(9/7) raw codestream at a rate of 20, and as Pillow's five-layer JP2 (rates
160 to 10). Times, in turns, with the median of ``--repeats`` runs each
after one untimed (which builds ``csrc/jpeg2000.cpp``): ``decode_image``
(code-blocks and wavelet rows on as many host threads as there are cores,
at most 8), the codestream decode alone on one thread
(``native.j2k_decode(..., threads=1)``), each checked equal to the
committed cv2 answer, and, where cv2 5.0.0 (the version the port replays)
imports, ``cv2.imdecode`` at cv2's own thread count and at
``cv2.setNumThreads(1)``, each port decode checked equal to it; another
cv2 (or none) is named in the output and not timed. Prints one JSON line.
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

PAYLOADS = ("scene0_jp2", "scene0_j2k_lossy", "scene0_jp2_5layers")


def _median_ms(fn, repeats: int) -> float:
    fn()
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def one_thread(data: bytes):
    """The codestream decode alone, on one host thread."""
    from ppocr_tpu_torch.ops import native
    from ppocr_tpu_torch.utils import imcodec

    offset = 0 if data[:4] == imcodec.J2K_MAGIC else imcodec._jp2_header(data)[0]
    codestream = data[offset:]
    _, (x0, y0, x1, y1, n, _), _ = native.j2k_header(codestream)
    return lambda: native.j2k_decode(codestream, 0, 0, n, x1, y1, threads=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=25)
    args = p.parse_args(argv)
    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.utils import imcodec

    cases = assets.load_image_cases()
    runs = {}
    for name in PAYLOADS:
        data = cases[name][0]
        runs[f"port_{name}"] = lambda data=data: imcodec.decode_image(data)
        runs[f"port_1thread_{name}"] = one_thread(data)
        if not (imcodec.decode_image(data) == cases[name][1]).all():
            raise SystemExit(f"{name}: the port's decode differs from the committed cv2 answer")
    try:
        import cv2
    except ImportError:
        cv2 = None
    threads = None
    version = None if cv2 is None else cv2.__version__
    if version != "5.0.0":  # another cv2 (or none) is named, not timed
        cv2 = None
    if cv2 is not None:
        threads = cv2.getNumThreads()
        for name in PAYLOADS:
            buf = np.frombuffer(cases[name][0], np.uint8)
            if not (cv2.imdecode(buf, cv2.IMREAD_COLOR) == imcodec.decode_image(cases[name][0])).all():
                raise SystemExit(f"{name}: the port's decode differs from this cv2's")
            runs[f"cv2_{name}"] = lambda buf=buf: cv2.imdecode(buf, cv2.IMREAD_COLOR)

            def single(buf=buf):
                cv2.setNumThreads(1)
                try:
                    cv2.imdecode(buf, cv2.IMREAD_COLOR)
                finally:
                    cv2.setNumThreads(threads)
            runs[f"cv2_1thread_{name}"] = single
    out = {k: [] for k in runs}
    for k in runs:
        runs[k]()  # one untimed each
    for _ in range(args.repeats):
        for k, fn in runs.items():  # in turns
            t = time.perf_counter()
            fn()
            out[k].append((time.perf_counter() - t) * 1e3)
    ms = {k: statistics.median(v) for k, v in out.items()}
    result = {"ms": ms, "bytes": {n: len(cases[n][0]) for n in PAYLOADS},
              "cv2_version": version, "cv2_timed": cv2 is not None, "cv2_threads": threads,
              "host": {"machine": platform.machine(), "processor": platform.processor(), "cpus": os.cpu_count(),
                       "python": platform.python_version()}}
    if cv2 is not None:
        result["port_over_cv2"] = {n: ms[f"port_{n}"] / ms[f"cv2_{n}"] for n in PAYLOADS}
        result["port_1thread_over_cv2_1thread"] = {n: ms[f"port_1thread_{n}"] / ms[f"cv2_1thread_{n}"]
                                                   for n in PAYLOADS}
    print(json.dumps({"jpeg2000_host_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
