"""Host time of the port's AVIF decoder (``utils/imcodec.py`` with
``csrc/av1.cpp`` and ``csrc/avif_yuv.cpp``) on the first 768×1024 serving
scene, beside cv2's where cv2 is installed.

    python3 scripts/time_avif_torch.py [--repeats 25]

The payloads are the committed ones of ``assets/image_cases.npz``: the
scene as cv2's lossless AVIF at its default speed (``scene0_avif``) and as
a lossy 4:4:4 AVIF with the in-loop filters off (libavif 1.4.2's writer,
q90, speed 6, identity matrix: ``scene0_avif_lossy``) and as cv2's
quality-95 AVIF (4:2:0, BT.601 in full range, the in-loop filters off:
``scene0_avif_q95``) and as cv2's default AVIF (quality 50: 4:2:0, BT.601,
deblocking and CDEF: ``scene0_avif_default``) and as cv2's default
quality at speed 4 (the same with Wiener loop restoration on luma:
``scene0_avif_restored``) and as Pillow's 4:2:0 q60 AVIF with libaom's
film-grain test vector 4 (``scene0_avif_grain``) and as the first frame
of cv2's lossless animation (an ``avis`` file of three frames: the AV1
stream is the colour track's first sample; ``scene0_avif_sequence``), and the largest
committed superres frame (``avif_superres_case_cdef_lr``: 4:4:4, 311x256
coded 249 wide (denominator 10), deblocked, CDEF, switchable loop restoration; the
tests' own writer, ``tests/test_torch_avif_superres.py``). For each,
times, in turns,
with the median of ``--repeats`` runs each after one untimed (which builds
``csrc/av1.cpp``): ``decode_image`` (the boxes and the hand-over in
Python, the AV1 decode on one host thread), the AV1 stream's decode alone
(``native.av1_decode``), split into its stages as the decoder clocks them
(the tiles' syntax and reconstruction, deblocking, CDEF, loop
restoration, superres, film grain: the medians of each over the same
runs), and libavif's YUV to BGR alone
(``native.avif_yuv_to_bgr`` of the decoded planes, with the sequence
header's colour description), all checked equal to the committed cv2
answer,
and, where cv2 5.0.0 (the version the port replays) imports,
``cv2.imdecode`` at cv2's own thread count and at
``cv2.setNumThreads(1)``; another cv2 (or none) is named in the output and
not timed. Prints one JSON line, the payloads by name, then one line of
the sequence's boxes' parse alone (``imcodec._avif_parse``: ftyp, meta,
the moov and its sample tables), the median of ``--repeats`` runs.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import struct
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

PAYLOADS = ("scene0_avif", "scene0_avif_lossy", "scene0_avif_q95", "scene0_avif_default", "scene0_avif_restored",
            "scene0_avif_grain", "scene0_avif_sequence", "avif_superres_case_cdef_lr")
STAGES = ("port_av1_tiles", "port_av1_deblock", "port_av1_cdef", "port_av1_lr", "port_av1_superres",
          "port_av1_grain")


def av1_stream(data: bytes) -> bytes:
    """The primary item's bytes of a file as libavif writes it (iloc
    version 0, 4-byte offsets and lengths, item 1 first); of an image
    sequence, the colour track's first sample."""
    if data[8:12] == b"avis":
        from ppocr_tpu_torch.utils import imcodec

        _, (offset, size), _, _ = imcodec._avif_track_source(data, imcodec._avif_parse(data)[2])
        return data[offset:offset + size]
    at = data.index(b"iloc") + 4
    off, length = struct.unpack(">II", data[at + 14:at + 22])
    return data[off:off + length]


def time_payload(name: str, repeats: int) -> dict:
    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.ops import native
    from ppocr_tpu_torch.utils import imcodec

    data, want = assets.load_image_cases()[name]
    stream = av1_stream(data)
    status, info, reason = native.av1_info(stream)
    if status:
        raise SystemExit(f"{name}: {reason}")
    planes = native.av1_decode(stream, info)[1]
    colour = (int(info[4]), int(info[5]), int(info[8]), int(info[6]), int(info[9]))  # ss_x, ss_y, matrix, cp, range
    if not (imcodec.decode_image(data) == want).all() or not (native.avif_yuv_to_bgr(planes, *colour) == want).all():
        raise SystemExit(f"{name}: the port's decode differs from the committed cv2 answer")
    stage_ms = np.zeros(len(STAGES))
    stages = {k: [] for k in STAGES}

    def av1_only():
        native.av1_decode(stream, info, stage_ms=stage_ms)
        for k, v in zip(STAGES, stage_ms.tolist()):
            stages[k].append(v)

    runs = {"port": lambda: imcodec.decode_image(data), "port_av1_only": av1_only,
            "port_yuv_to_bgr_only": lambda: native.avif_yuv_to_bgr(planes, *colour)}
    try:
        import cv2
    except ImportError:
        cv2 = None
    version = None if cv2 is None else cv2.__version__
    threads = None
    if version != "5.0.0":  # another cv2 (or none) is named, not timed
        cv2 = None
    if cv2 is not None:
        threads = cv2.getNumThreads()
        buf = np.frombuffer(data, np.uint8)
        if not (cv2.imdecode(buf, cv2.IMREAD_COLOR) == want).all():
            raise SystemExit(f"{name}: this cv2's decode differs from the committed one")
        runs["cv2"] = lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR)

        def single():
            cv2.setNumThreads(1)
            try:
                cv2.imdecode(buf, cv2.IMREAD_COLOR)
            finally:
                cv2.setNumThreads(threads)
        runs["cv2_1thread"] = single
    out = {k: [] for k in runs}
    for fn in runs.values():
        fn()  # one untimed each
    for v in stages.values():
        v.clear()
    for _ in range(repeats):
        for k, fn in runs.items():  # in turns
            t = time.perf_counter()
            fn()
            out[k].append((time.perf_counter() - t) * 1e3)
    ms = {k: statistics.median(v) for k, v in {**out, **stages}.items()}
    result = {"ms": ms, "bytes": len(data), "size": list(want.shape), "base_q_idx": int(info[13]),
              "subsampling": [int(info[4]), int(info[5])], "matrix": int(info[8]), "full_range": int(info[9]),
              "cv2_version": version, "cv2_timed": cv2 is not None, "cv2_threads": threads}
    if cv2 is not None:
        result["port_over_cv2"] = ms["port"] / ms["cv2"]
        result["port_over_cv2_1thread"] = ms["port"] / ms["cv2_1thread"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=25)
    args = p.parse_args(argv)
    result = {name: time_payload(name, args.repeats) for name in PAYLOADS}
    result["host"] = {"machine": platform.machine(), "processor": platform.processor(), "cpus": os.cpu_count(),
                      "python": platform.python_version()}
    print(json.dumps({"avif_host_ms": result}))
    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.utils import imcodec

    data = assets.load_image_cases()["scene0_avif_sequence"][0]
    parse = []
    for _ in range(args.repeats + 1):
        t = time.perf_counter()
        imcodec._avif_parse(data)
        parse.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"avif_sequence_moov_parse_ms": statistics.median(parse[1:]), "bytes": len(data)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
