"""Soak / load test of the PyTorch port's OCR service.

Drives sustained concurrent ``recognize`` load over the Unix-socket
protocol of ``ppocr_tpu_torch.cli.service_main`` and prints one JSON
summary line: requests per second, client wall p50/p90/p99, errors, the
p50 of sequential control requests taken before the load, and the RSS
growth of the service (``--pid``) and, with ``--track-workers``, of every
worker process named in the merged ``status``.

    python -m ppocr_tpu_torch.cli.service_main --model-dir DIR \\
        --socket /tmp/ocr.sock --batch-requests 4 &
    python scripts/soak_torch.py --socket /tmp/ocr.sock --duration 60 \\
        --concurrency 4 [--pid SERVICE_PID] [--track-workers]

The port's counterpart of ``scripts/soak.py``. Its default payload is the
first serving scene of ``ppocr_tpu_torch/assets/scenes.npz`` (768×1024)
as a PNG from ``imcodec.encode_png``; ``--image PATH`` sends a file's
bytes instead. ``--vary-images`` makes every payload unique: ``comment``
mode splices a counter into a COM segment of the same scene as a JPEG
(``assets.load_jpeg_cases``' ``scene0``: the decoded pixels stay the
same), ``pixel`` mode changes one pixel and encodes the PNG again. It
needs neither cv2 nor JAX. ``scripts/soak.py``'s gate (``--check``,
``--update-good``, ``SOAK_GOOD.json``) is left out: a gate against a
committed run belongs to the port's benchmark (ROADMAP A6).
"""

import argparse
import base64
import json
import os
import statistics
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppocr_tpu_torch import assets  # noqa: E402
from ppocr_tpu_torch.serve.client import OCRIPCClient  # noqa: E402
from ppocr_tpu_torch.utils.imcodec import decode_image, encode_png  # noqa: E402


def rss_kb(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def percentile(sorted_ms, q: float):
    """The nearest-rank percentile of an ascending list (None when empty)."""
    if not sorted_ms:
        return None
    return sorted_ms[min(len(sorted_ms) - 1, int(len(sorted_ms) * q))]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--socket", default="/tmp/ocr_service.sock")
    p.add_argument("--image", default=None,
                   help="send this file's bytes (default: the first serving scene as a PNG)")
    p.add_argument("--duration", type=float, default=60.0, help="seconds of load")
    p.add_argument("--concurrency", type=int, default=4, help="client threads, one connection each")
    p.add_argument("--timeout", type=float, default=30000.0, help="per-request timeout, ms")
    p.add_argument("--pid", type=int, default=0, help="service pid for RSS tracking")
    p.add_argument("--vary-images", action="store_true",
                   help="make every request's payload unique; --vary-mode picks how")
    p.add_argument("--vary-mode", choices=["comment", "pixel"], default="comment",
                   help="comment = the scene as a JPEG with a counter in a COM segment "
                   "(same pixels, unique bytes, ~0 client CPU); pixel = change one pixel "
                   "and encode the PNG again (client CPU per request)")
    p.add_argument("--track-workers", action="store_true",
                   help="also read each worker process's RSS through the pids in the "
                   "merged status (--processes N serving)")
    p.add_argument("--control-requests", type=int, default=30,
                   help="sequential single requests on one connection before the load; "
                   "their p50 is the run's control (0 disables)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.image:
        with open(args.image, "rb") as f:
            base_bytes = f.read()
        base_img = decode_image(base_bytes)
        if base_img is None:
            print(json.dumps({"error": f"cannot decode {args.image}"}))
            return 1
        payload_kind = os.path.basename(args.image)
    else:
        base_img = assets.load_scenes()["serving"][0]
        base_bytes = encode_png(base_img)
        payload_kind = "serving scene 0, PNG"
    if args.vary_images and args.vary_mode == "comment":
        cases, _ = assets.load_jpeg_cases()
        base_bytes = cases["scene0"][0]
        payload_kind = "serving scene 0, JPEG with a unique COM segment"
    elif args.vary_images:
        payload_kind += "; each request a PNG of it with one pixel changed"
    base_b64 = base64.b64encode(base_bytes).decode()

    def worker_pids() -> dict:
        """pid → RSS kB of every worker process in the merged status."""
        try:
            c = OCRIPCClient(args.socket, timeout_ms=5000)
            c.connect()
            st = json.loads(c.send_request({"command": "status"})["status"])
            c.disconnect()
            procs = st.get("processes") or [st]
            return {p["pid"]: rss_kb(p["pid"]) for p in procs if p.get("pid")}
        except Exception:
            return {}

    rss_start = rss_kb(args.pid) if args.pid else -1
    workers_start = worker_pids() if args.track_workers else {}
    latencies, errors, lock = [], [0], threading.Lock()
    first_error = []

    control_p50 = None
    if args.control_requests > 0:
        c = OCRIPCClient(args.socket, timeout_ms=args.timeout)
        c.connect()
        ctimes = []
        for _ in range(args.control_requests):
            t0 = time.perf_counter()
            r = c.send_request({"command": "recognize", "image_data": base_b64})
            if r.get("success"):
                ctimes.append((time.perf_counter() - t0) * 1e3)
        c.disconnect()
        if ctimes:
            control_p50 = statistics.median(ctimes)

    def comment_payload(counter: int) -> str:
        """The JPEG with a COM segment carrying ``counter`` right after SOI:
        decoders skip it, so the pixels stay, the bytes differ."""
        com = b"\xff\xfe\x00\x12" + f"soak{counter:012d}".encode()
        return base64.b64encode(base_bytes[:2] + com + base_bytes[2:]).decode()

    stop_at = time.time() + args.duration

    def worker(tid: int):
        client = OCRIPCClient(args.socket, timeout_ms=args.timeout)
        client.connect()
        rng = np.random.default_rng(tid)
        i = 0
        while time.time() < stop_at:
            if args.vary_images and args.vary_mode == "pixel":
                img = base_img.copy()
                img[int(rng.integers(0, img.shape[0])), int(rng.integers(0, img.shape[1]))] = (
                    rng.integers(0, 255, img.shape[2:] or 1))
                data = base64.b64encode(encode_png(img)).decode()
            elif args.vary_images:
                data = comment_payload(tid * 10_000_000 + i)
            else:
                data = base_b64
            t0 = time.perf_counter()
            try:
                resp = client.send_request({"command": "recognize", "image_data": data})
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    if resp.get("success"):
                        latencies.append(dt)
                    else:
                        errors[0] += 1
                        first_error[:] = first_error or [resp.get("error")]
            except Exception as e:
                with lock:
                    errors[0] += 1
                    first_error[:] = first_error or [repr(e)]
            i += 1
        client.disconnect()

    t0 = time.time()
    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(args.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0

    rss_end = rss_kb(args.pid) if args.pid else -1
    workers_end = worker_pids() if args.track_workers else {}
    lat = sorted(latencies)
    n = len(lat)
    summary = {
        "requests_ok": n,
        "errors": errors[0],
        "first_error": first_error[0] if first_error else None,
        "duration_s": wall,
        "qps": n / wall if wall > 0 else 0.0,
        "p50_ms": statistics.median(lat) if n else None,
        "p90_ms": percentile(lat, 0.90),
        "p99_ms": percentile(lat, 0.99),
        "max_ms": lat[-1] if n else None,
        "concurrency": args.concurrency,
        "payload": payload_kind,
        "payload_bytes": len(base_bytes),
        "control_p50_ms": control_p50,
        "rss_start_kb": rss_start,
        "rss_end_kb": rss_end,
        "rss_growth_kb_per_req": (rss_end - rss_start) / max(n, 1) if rss_start > 0 else None,
        "worker_rss_kb_start": workers_start or None,
        "worker_rss_kb_end": workers_end or None,
        "worker_rss_growth_kb_per_req": {
            pid: (workers_end[pid] - kb) / max(n, 1)
            for pid, kb in workers_start.items() if pid in workers_end and kb > 0
        } or None,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
