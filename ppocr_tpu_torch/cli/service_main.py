"""ocr-service: start the OCR IPC service.

Counterpart of ``ppocr_tpu/cli/service_main.py``, with the same flags.
Flag-compatible with the reference service CLI (ocr_service_main.cpp:89-110
— defaults ./models, pipe ocr_service, gpu-workers 0, cpu-workers 1), plus
extras (--profile, --dtype, --warmup, --device). Ctrl-C stops the service
cleanly (the reference's ConsoleHandler); a status line is printed every
30 s like the reference's status loop (ocr_service_main.cpp:134-148).

The service runs on the card (``--device cuda``, the default; it exits
when there is none) or, on request, on the CPU (``--device cpu``).

``--staged`` (or ``--profile defaults`` without ``--fast-path``) serves the
staged det → cls → rec pipeline; ``--processes N`` starts N worker
services behind the request balancer (``serve.balancer``), each with the
same flags; ``--system-info`` prints the worker sizing advice and exits.

Over several devices, on the fused path: ``--mesh N`` splits each fused
step's batch over the first N visible cards (``--device cpu``: N shards
on the CPU) and exits 2 when fewer cards are visible; ``--cross-chip``
runs det and geometry on the first device and rec on the second (not
with ``--batch-requests > 1``; ``--warmup auto`` is then ``full``).

Usage:
    python -m ppocr_tpu_torch.cli.service_main --model-dir ./models \
        --socket /tmp/ocr_service.sock --cpu-workers 4
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys

from .common import resolve_socket_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ocr-service",
        description="PP-OCR IPC service (PyTorch, one NVIDIA card)",
        # abbreviations are forbidden: the supervisor strips flags from
        # worker argv by EXACT name ('--processes', '--socket',
        # '--recycle-after'); an accepted abbreviation like '--proc 4'
        # would survive the strip and make every worker re-spawn its own
        # supervisor (a fork bomb)
        allow_abbrev=False,
    )
    p.add_argument("--model-dir", default="./models", help="model directory (det/ cls/ rec/)")
    p.add_argument(
        "--socket",
        "--pipe-name",
        dest="socket",
        default="/tmp/ocr_service.sock",
        help=r"unix socket path (reference pipe names \\.\pipe\NAME are mapped to /tmp/NAME.sock)",
    )
    p.add_argument("--gpu-workers", type=int, default=0, help="accepted for flag parity; >0 selects the device pool")
    p.add_argument("--cpu-workers", type=int, default=1, help="number of logical workers")
    p.add_argument("--profile", choices=["serving", "defaults"], default="serving")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument(
        "--cls",
        action="store_true",
        help="enable orientation classification (off by default, like the reference)",
    )
    p.add_argument(
        "--fast-path",
        action="store_true",
        help="single-dispatch fused det→(cls)→rec pipeline (the default "
        "for --profile serving since round 3; kept for compatibility)",
    )
    p.add_argument(
        "--staged",
        action="store_true",
        help="serve the staged exact-parity pipeline (det → contours → "
        "crop → rec, one device step per stage) instead of the default "
        "fused single-dispatch path: the reference's own contour, unclip "
        "and crop semantics",
    )
    p.add_argument("--no-warmup", action="store_true", help="alias for --warmup off")
    p.add_argument(
        "--warmup",
        choices=["auto", "full", "incremental", "off"],
        default="auto",
        help="when every step shape runs once on blank input (cuDNN's "
        "algorithm search and the kernel build happen on a shape's first "
        "call): full = before accepting connections; incremental = start "
        "serving immediately and warm one fused step shape at a time on "
        "the event loop between requests (a request for a cold shape warms "
        "it on demand, jumping the queue); auto (default) = incremental for "
        "the fused path, full for --staged; off = only on demand. "
        "--no-warmup is an alias for off",
    )
    p.add_argument("--status-interval", type=float, default=30.0)
    p.add_argument(
        "--batch-requests",
        type=int,
        default=1,
        help="fast-path only: coalesce up to N concurrent requests into one "
        "fused step (adds warmup steps per batch bucket)",
    )
    p.add_argument(
        "--batch-buckets",
        choices=["pow2", "single"],
        default="pow2",
        help="batch-size buckets for --batch-requests N: pow2 = 1,2,4,...,N "
        "(least padded compute per request, more shapes to warm); "
        "single = N only (partial batches pad up)",
    )
    p.add_argument(
        "--det-buckets",
        default=None,
        help="comma-separated det shape buckets (e.g. 192,384,512); "
        "fewer buckets = fewer shapes to warm, more input padding",
    )
    p.add_argument(
        "--rec-decode",
        choices=["greedy", "beam"],
        default="greedy",
        help="CTC decode (fused and staged): greedy (reference parity) or "
        "prefix beam search (recovers labelings greedy misses)",
    )
    p.add_argument(
        "--beam-size", type=int, default=10, help="beam width for --rec-decode beam"
    )
    p.add_argument(
        "--max-boxes",
        type=int,
        default=None,
        help="fast-path only: top-K blob candidates per image (default 32); "
        "lower = less padded rec compute per request",
    )
    p.add_argument(
        "--cross-chip",
        action="store_true",
        help="fast-path only: stage det/geometry on device 0 and rec on "
        "device 1 (the mesh's first two devices with --mesh); not with "
        "--batch-requests > 1",
    )
    p.add_argument(
        "--rotated-boxes",
        action="store_true",
        help="fast-path only: emit min-area rotated rect quads "
        "(angle sweep on the device) instead of axis-aligned boxes",
    )
    p.add_argument(
        "--crop-src-mult",
        type=int,
        default=None,
        help="fast-path only: sample rec/cls crops from an N×-resolution "
        "resize of the source image instead of the det-scale canvas "
        "(default 1). Recovers staged-path crop sharpness when det "
        "downscales (large inputs, small --det-buckets) at N² the image "
        "upload bytes per request",
    )
    p.add_argument(
        "--mesh",
        type=int,
        default=1,
        help="fast-path only: split each fused request batch over the data "
        "axis of an N-device mesh (the first N visible cards; with --device "
        "cpu, N shards on the CPU)",
    )
    p.add_argument(
        "--request-timeout",
        type=float,
        default=30000.0,
        help="per-request wall-clock ceiling in ms; 0 disables it "
        "(reference clients honor --timeout; the service enforces it too "
        "so a wedged request cannot pin a connection forever)",
    )
    p.add_argument(
        "--system-info",
        action="store_true",
        help="print worker sizing recommendation and exit (getWorkerRecommendation analog)",
    )
    p.add_argument(
        "--processes",
        type=int,
        default=1,
        help="multi-process serving: N worker service processes behind a "
        "request-level balancer on the public socket (the GIL-proof "
        "replacement for the reference's N worker threads). Workers boot "
        "one after the other; each loads its own copy of the models.",
    )
    p.add_argument(
        "--recycle-after",
        type=int,
        default=0,
        help="self-recycle the service process after N recognize requests "
        "(graceful drain, exit code 3). Under --processes > 1 the "
        "supervisor owns recycling instead: it boots a replacement first, "
        "then retires the old worker.",
    )
    p.add_argument(
        "--boot-timeout",
        type=float,
        default=3600.0,
        help="--processes mode: seconds to wait for each worker's socket "
        "(a worker's boot is process start, weight load, kernel build "
        "lookup and, with --warmup full, every step shape once)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device the engine runs on: cuda (default; the service "
        "exits when no card is available) or cpu",
    )
    p.add_argument(
        "--config",
        default=None,
        help="JSON file with PipelineConfig field overrides applied on top "
        "of --profile (nested keys mirror the dataclasses, e.g. "
        '{"det": {"shape_buckets": [64, 96]}, "rec": {"img_w": 256}})',
    )
    return p


def apply_config_overrides(config, data: dict):
    """Recursively apply a JSON override dict onto the nested dataclass
    config (lists become tuples to match the bucket fields; *bucket* lists
    are sorted ascending — pick_bucket and the det_fit_cap downscale both
    assume it, and the flag path sorts for the same reason)."""
    for k, v in data.items():
        if not hasattr(config, k):
            raise ValueError(f"unknown config field: {k}")
        cur = getattr(config, k)
        if isinstance(v, dict):
            apply_config_overrides(cur, v)
        elif isinstance(v, list):
            setattr(config, k, tuple(sorted(v) if "buckets" in k else v))
        else:
            setattr(config, k, v)


def batch_bucket_list(max_batch: int, mode: str = "pow2") -> tuple:
    """Batch-bucket list for cross-request batching: "pow2" = 1,2,4,…,N;
    "single" = (N,) — partial batches pad up, trading a little padded
    compute for ~N/log2(N)× fewer step shapes to warm."""
    if mode == "single":
        return (max_batch,)
    bb, b = [], 1
    while b < max_batch:
        bb.append(b)
        b *= 2
    return tuple(bb + [max_batch])


def resolve_service_config(args):
    """Flags → profile + overrides → validated PipelineConfig.

    Returns (config, None) or (None, exit_code). Split from _amain so the
    flag/file precedence rules are testable without booting a service."""
    from ..pipeline import PipelineConfig

    config = (
        PipelineConfig.serving()
        if args.profile == "serving"
        else PipelineConfig.defaults()
    )
    config.dtype = args.dtype
    config.enable_cls = bool(args.cls)
    # the serving profile defaults to the fused path; --staged selects the
    # staged pipeline, --fast-path forces fused for the defaults profile
    if args.staged and args.fast_path:
        print("--staged and --fast-path are mutually exclusive", flush=True)
        return None, 2
    if args.staged:
        config.fast_path = False
    elif args.fast_path:
        config.fast_path = True
    if args.det_buckets:
        config.det.shape_buckets = tuple(
            sorted(int(v) for v in args.det_buckets.split(","))
        )
    if args.max_boxes:
        config.fused_max_boxes = args.max_boxes
    if args.crop_src_mult is not None:
        if args.crop_src_mult < 1:
            print("--crop-src-mult must be >= 1", flush=True)
            return None, 2
        config.fused_crop_src_mult = args.crop_src_mult
    config.fused_rotated_boxes = bool(args.rotated_boxes)
    config.cross_chip = bool(args.cross_chip)
    config.rec.decode = args.rec_decode
    config.rec.beam_size = args.beam_size
    if args.config:
        # config file wins over flags (applied last): the precise typed
        # surface for fields the flag set doesn't reach
        with open(args.config) as f:
            apply_config_overrides(config, json.load(f))
    # --batch-requests is evaluated on the FINAL fast_path state (a config
    # file may be what enables the fused path); an explicit
    # request_batch_buckets from the file still wins over the flag
    if (
        args.batch_requests > 1
        and config.fast_path
        and config.request_batch_buckets == (1,)
    ):
        config.request_batch_buckets = batch_bucket_list(
            args.batch_requests, args.batch_buckets
        )

    # checked on the FINAL config state, after the config-file overrides,
    # which could otherwise bring back exactly what these guards refuse
    if config.cross_chip and not config.fast_path:
        print("--cross-chip requires the fused path (drop --staged)", flush=True)
        return None, 2
    if config.cross_chip and max(config.request_batch_buckets or (1,)) > 1:
        # the batching dispatcher serves the single-chip fused step
        print(
            "--cross-chip is incompatible with --batch-requests > 1 "
            "(cross-request batching uses the single-chip fused step)",
            flush=True,
        )
        return None, 2
    return config, None


def resolve_mesh(args, config):
    """--mesh N → (DeviceMesh or None, None) or (None, exit_code): N > 1
    needs the fused path and N visible cards (``--device cpu``: N shards
    on the CPU)."""
    if args.mesh <= 1:
        return None, None
    if not config.fast_path:
        print(
            "--mesh requires the fused path (the staged parity pipeline is "
            "single-device — drop --staged)",
            flush=True,
        )
        return None, 2
    import torch

    from ..parallel import make_mesh

    if args.device == "cpu":
        return make_mesh(devices=["cpu"] * args.mesh), None
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_dev < args.mesh:
        print(f"--mesh {args.mesh}: only {n_dev} devices visible", flush=True)
        return None, 2
    return make_mesh(args.mesh, model=1), None


def resolve_warmup_mode(args, config):
    """--warmup / --no-warmup → ("full" | "incremental" | "off", None) or
    (None, exit_code): ``auto`` is incremental for the fused path on one
    device or a mesh, and full for the staged and cross-chip ones, whose
    step shapes have no on-demand guard."""
    mode = "off" if args.no_warmup else args.warmup
    guarded = config.fast_path and not config.cross_chip
    if mode == "auto":
        return ("incremental" if guarded else "full"), None
    if mode == "incremental" and not guarded:
        print(
            "--warmup incremental requires the fused path on one device or a mesh "
            "(drop --staged/--cross-chip or use --warmup full)",
            flush=True,
        )
        return None, 2
    return mode, None


async def _amain(args) -> int:
    from ..serve import OCRIPCService

    config, err = resolve_service_config(args)
    if err is not None:
        return err
    warmup_mode, err = resolve_warmup_mode(args, config)
    if err is not None:
        return err
    mesh, err = resolve_mesh(args, config)
    if err is not None:
        return err

    print(f"Loading models from {args.model_dir} on {args.device} ...", flush=True)
    engine = None
    if mesh is not None:
        from ..pipeline import OCREngine

        engine = OCREngine(args.model_dir, config, mesh=mesh)
        print(
            f"Data-parallel fused serving over {args.mesh} devices "
            f"({', '.join(str(d) for d in mesh.devices)})",
            flush=True,
        )
    service = OCRIPCService(
        model_dir=args.model_dir,
        socket_path=resolve_socket_path(args.socket),
        cpu_workers=args.cpu_workers,
        gpu_workers=args.gpu_workers,
        config=config,
        engine=engine,
        request_timeout_ms=args.request_timeout,
        recycle_after=args.recycle_after,
        device=args.device,
    )
    if warmup_mode == "full":
        secs = service.engine.warmup()
        print(f"Warmup ran every step shape in {secs:.1f}s", flush=True)

    await service.start_async()
    print(
        f"OCR service listening on {service.socket_path} "
        f"({service.num_workers} workers)",
        flush=True,
    )

    loop = asyncio.get_running_loop()
    warmup_task = None
    if warmup_mode == "incremental":
        n = len(service.engine.fused_ocr().variant_keys())
        print(
            f"Incremental warmup: serving now; warming {n} fused step "
            "shapes in the background (status shows warmup_progress)",
            flush=True,
        )

        async def _warm():
            secs = await service.incremental_warmup()
            print(
                f"Incremental warmup finished: {n} variants in {secs:.1f}s",
                flush=True,
            )

        warmup_task = loop.create_task(_warm())

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, lambda: asyncio.ensure_future(service.stop_async()))

    async def status_loop():
        while service.running:
            await asyncio.sleep(args.status_interval)
            if service.running:
                print(f"[status] {service.get_status_info()}", flush=True)

    status_task = loop.create_task(status_loop())
    await service._stopped.wait()
    for task in (status_task, warmup_task):
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    if service.recycled:
        print(
            f"Service recycled after {service.total_requests} requests.",
            flush=True,
        )
        return 3  # the recycle exit code: a supervisor relaunches
    print("Service stopped.", flush=True)
    return 0


def _strip_flag(argv, flag, has_value=True):
    out, skip = [], 0
    for a in argv:
        if skip:
            skip -= 1
            continue
        if a == flag:
            skip = 1 if has_value else 0
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


async def _supervisor_main(args, argv) -> int:
    """--processes N: spawn N worker services + the request balancer
    (serve.balancer) on the public socket."""
    from ..serve.balancer import ServiceSupervisor

    worker_args = _strip_flag(_strip_flag(list(argv), "--processes"), "--socket")
    worker_args = _strip_flag(worker_args, "--pipe-name")
    # the SUPERVISOR owns recycling in multi-process mode (rolling
    # rotation, replacement-first); workers must not self-recycle
    worker_args = _strip_flag(worker_args, "--recycle-after")
    sup = ServiceSupervisor(
        resolve_socket_path(args.socket),
        args.processes,
        worker_args,
        boot_timeout=args.boot_timeout,
        recycle_after=args.recycle_after,
    )
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, lambda: asyncio.ensure_future(sup.stop_async()))
    print(
        f"Starting {args.processes} worker processes "
        f"(recycle after {args.recycle_after or 'never'})...",
        flush=True,
    )
    try:
        await sup.start_async()
    except RuntimeError as e:
        await sup.stop_async()
        print(f"Supervisor failed to start: {e}", flush=True)
        return 1
    print(
        f"OCR balancer listening on {sup.socket_path} "
        f"({args.processes} worker processes)",
        flush=True,
    )
    mon = loop.create_task(sup.monitor())
    await sup.balancer._stopped.wait()
    mon.cancel()
    try:
        await mon
    except asyncio.CancelledError:
        pass
    await sup.stop_async()
    print("Service stopped.", flush=True)
    return 0


def main(argv=None) -> int:
    raw_argv = list(argv) if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(raw_argv)
    if args.system_info:
        from ..pipeline.sysinfo import worker_recommendation

        print(worker_recommendation(enable_cls=args.cls).pretty())
        return 0
    try:
        if args.processes > 1:
            # the flags are checked once here, so that a bad combination
            # exits 2 and does not fail N worker boots one after the other;
            # the workers get every flag but the supervisor's own
            config, err = resolve_service_config(args)
            if err is None:
                _, err = resolve_warmup_mode(args, config)
            if err is None:
                _, err = resolve_mesh(args, config)
            if err is not None:
                return err
            return asyncio.run(_supervisor_main(args, raw_argv))
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
