"""Time to serve of the PyTorch port's OCR service.

Boots ``python -m ppocr_tpu_torch.cli.service_main`` in a subprocess and
prints one JSON line with:

  t_socket_s       the service socket accepts a connection
  t_first_ok_s     the first successful ``recognize`` response
  t_all_ready_s    every fused step shape has run once: read from
                   ``warmup_progress`` in ``status`` (compiled == total)
                   under ``--mode incremental`` (and ``auto`` on the fused
                   path); ``full`` runs them all before the socket opens
                   and ``off`` warms only on demand, so there it equals
                   t_first_ok_s

    python scripts/measure_boot_torch.py --mode incremental
    python scripts/measure_boot_torch.py --mode full --device cpu

The port's counterpart of ``scripts/measure_boot.py``. Its default model
dir is the repo's jumbo bundle (``assets.make_jumbo_model_dir``, served
with rec 48×256) in a temporary directory, its default payload the first
serving scene as a PNG (``imcodec.encode_png``), so it needs neither cv2
nor JAX. There is no ``--cold``: eager PyTorch keeps no compile cache. What
a first boot pays instead is the build of the kernel libraries, once per
source hash, into ``ppocr_tpu_torch/_build/``; ``libraries_before`` and
``libraries_after`` list what was there before and after the boot (the
CUDA kernels are ``libppocr_kernels-*.so``; remove ``_build/`` for a
first boot).
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ppocr_tpu_torch import assets  # noqa: E402
from ppocr_tpu_torch.ops.kernels import BUILD_DIR  # noqa: E402
from ppocr_tpu_torch.serve.client import OCRIPCClient  # noqa: E402
from ppocr_tpu_torch.utils.imcodec import encode_png  # noqa: E402

JUMBO_CONFIG = {"rec": {"img_h": 48, "img_w": 256}}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["auto", "full", "incremental", "off"], default="incremental",
                   help="the service's --warmup")
    p.add_argument("--device", default="cuda", help="the service's --device (cuda or cpu)")
    p.add_argument("--model-dir", default=None,
                   help="bundle to serve (default: the repo's jumbo bundle, rec 48x256)")
    p.add_argument("--config", default=None,
                   help="the service's --config (default with the jumbo bundle: rec 48x256)")
    p.add_argument("--image", default=None,
                   help="payload file (default: the first serving scene as a PNG)")
    p.add_argument("--socket", default=None, help="socket path (default: in a temporary directory)")
    p.add_argument("--batch-requests", type=int, default=4)
    p.add_argument("--det-buckets", default=None,
                   help="comma list forwarded to --det-buckets (default: the serving set)")
    p.add_argument("--timeout", type=float, default=600.0, help="ceiling of the whole boot, seconds")
    p.add_argument("--extra", default="", help="extra service_main arguments, space-separated")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    tmp = tempfile.TemporaryDirectory(prefix="ocr_boot_")
    model_dir, config = args.model_dir, args.config
    if model_dir is None:
        model_dir = str(assets.make_jumbo_model_dir(os.path.join(tmp.name, "jumbo")))
        if config is None:
            config = os.path.join(tmp.name, "service.json")
            with open(config, "w") as f:
                json.dump(JUMBO_CONFIG, f)
    if args.image:
        with open(args.image, "rb") as f:
            payload = f.read()
    else:
        payload = encode_png(assets.load_scenes()["serving"][0])
    img_b64 = base64.b64encode(payload).decode()
    sock = args.socket or os.path.join(tmp.name, "boot.sock")

    cmd = [sys.executable, "-m", "ppocr_tpu_torch.cli.service_main", "--model-dir", model_dir,
           "--socket", sock, "--warmup", args.mode, "--device", args.device,
           "--batch-requests", str(args.batch_requests), "--status-interval", "3600"]
    if config:
        cmd += ["--config", config]
    if args.det_buckets:
        cmd += ["--det-buckets", args.det_buckets]
    if args.extra:
        cmd += args.extra.split()

    def libraries():
        return sorted(p.name for p in BUILD_DIR.glob("lib*.so")) if BUILD_DIR.is_dir() else []

    result = {"mode": args.mode, "device": args.device, "batch_requests": args.batch_requests,
              "det_buckets": args.det_buckets or "default", "libraries_before": libraries()}
    if os.path.exists(sock):
        os.unlink(sock)
    log_path = os.path.join(tmp.name, "service.log")
    logf = open(log_path, "wb")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)
    deadline = t0 + args.timeout
    rc = 0
    try:
        t_socket = None
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(f"service exited rc={proc.returncode} before its socket opened")
            c = OCRIPCClient(sock, timeout_ms=1000)
            if c.connect():
                t_socket = time.perf_counter() - t0
                c.disconnect()
                break
            time.sleep(0.05)
        result["t_socket_s"] = t_socket

        cli = OCRIPCClient(sock, timeout_ms=int(args.timeout * 1000))
        t_first = None
        failures = 0
        while t_socket is not None and time.perf_counter() < deadline:
            if proc.poll() is not None:
                raise RuntimeError("service died mid-measure")
            try:
                r = cli.send_request({"command": "recognize", "image_data": img_b64})
            except Exception:
                time.sleep(0.1)
                continue
            if r.get("success"):
                t_first = time.perf_counter() - t0
                result["first_words"] = len(r.get("words", []))
                break
            failures += 1  # the on-demand warmup never fails a request
            result["last_error"] = r.get("error")
            if failures >= 20:
                raise RuntimeError(f"recognize keeps failing: {r.get('error')}")
            time.sleep(0.1)
        result["t_first_ok_s"] = t_first

        t_all = t_first
        while t_first is not None and time.perf_counter() < deadline:
            try:
                st = json.loads(cli.send_request({"command": "status"})["status"])
            except Exception:
                time.sleep(0.1)
                continue
            wp = st.get("warmup_progress")
            if wp is None or wp.get("compiled", 0) >= wp.get("total", 0):
                t_all = max(time.perf_counter() - t0, t_first) if wp else t_first
                result["variants"] = (wp or {}).get("total")
                result["kernel_launches"] = st.get("kernel_launches")
                break
            time.sleep(0.1)
        result["t_all_ready_s"] = t_all
        cli.disconnect()
        if None in (result["t_socket_s"], result["t_first_ok_s"], result["t_all_ready_s"]):
            rc = 1
    except RuntimeError as e:
        result["error"] = str(e)
        rc = 1
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        logf.close()
        result["service_rc"] = proc.returncode
        result["libraries_after"] = libraries()
        if rc and os.path.exists(log_path):
            with open(log_path, "rb") as f:
                result["service_log_tail"] = f.read()[-2000:].decode(errors="replace")
        tmp.cleanup()

    print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
