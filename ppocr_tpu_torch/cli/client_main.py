"""ocr-client: talk to a running OCR service.

Flag-compatible with the reference client CLI (ocr_client_main.cpp:68-93):
``--pipe-name``/``--socket``, ``--timeout`` ms, ``--status``, ``--shutdown``,
or a positional image path. Prints the raw JSON response, like the
reference prints the service's reply verbatim. A copy of
``ppocr_tpu/cli/client_main.py``; ``--visualize`` is accepted and refused
until ``utils/visualize.py`` is ported (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import json
import sys

from .common import resolve_socket_path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ocr-client", description="OCR IPC client")
    p.add_argument("image", nargs="?", help="image file to recognize")
    p.add_argument(
        "--socket",
        "--pipe-name",
        dest="socket",
        default="/tmp/ocr_service.sock",
    )
    p.add_argument(
        "--timeout",
        type=int,
        default=5000,
        help="timeout in ms (reference default, ocr_client_main.cpp:63)",
    )
    p.add_argument("--status", action="store_true", help="query service status")
    p.add_argument("--shutdown", action="store_true", help="stop the service")
    p.add_argument("--pretty", action="store_true", help="pretty-print the JSON")
    p.add_argument(
        "--visualize",
        metavar="OUT.png",
        help="draw the detected word quads on the input image and save "
        "(not ported yet: ROADMAP A12)",
    )
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.status or args.shutdown or args.image):
        parser.print_help()
        return 1
    if args.visualize:
        print(
            "--visualize is not ported to ppocr_tpu_torch yet (ROADMAP A12)",
            file=sys.stderr,
        )
        return 2

    from ..serve import OCRIPCClient

    client = OCRIPCClient(resolve_socket_path(args.socket), args.timeout)
    if not client.connect():
        print(f"Failed to connect to OCR service at {args.socket}", file=sys.stderr)
        return 2
    try:
        if args.shutdown:
            response = client.send_shutdown_command()
        elif args.status:
            response = client.get_service_status()
        else:
            response = client.recognize_image(args.image)
    except ConnectionError as e:
        # mid-request failure (recycle, response timeout, peer close):
        # a clean error like the connect path, not a traceback
        print(f"Request failed: {e}", file=sys.stderr)
        return 2
    finally:
        client.disconnect()

    if args.pretty:
        print(json.dumps(response, ensure_ascii=False, indent=2))
    else:
        print(json.dumps(response, ensure_ascii=False, separators=(",", ":")))
    return 0 if response.get("success") else 3


if __name__ == "__main__":
    sys.exit(main())
