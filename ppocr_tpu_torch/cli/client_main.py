"""ocr-client: talk to a running OCR service.

Flag-compatible with the reference client CLI (ocr_client_main.cpp:68-93):
``--pipe-name``/``--socket``, ``--timeout`` ms, ``--status``, ``--shutdown``,
or a positional image path. Prints the raw JSON response, like the
reference prints the service's reply verbatim. A copy of
``ppocr_tpu/cli/client_main.py``. ``--visualize`` re-reads the image with
``imcodec.read_image`` (``cv2.imread``'s answer) and writes a PNG through
``utils.visualize``; any other extension exits 3, where the JAX client
writes whatever ``cv2.imwrite`` can encode.
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
        help="draw the detected word quads on the input image and save it as "
        "a PNG (Utility::VisualizeBboxes analog, utility.cpp:50-102)",
    )
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.status or args.shutdown or args.image):
        parser.print_help()
        return 1

    from ..serve import OCRIPCClient

    recognized = not (args.status or args.shutdown)
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
    if args.visualize and recognized and response.get("success"):
        from ..utils.imcodec import read_image
        from ..utils.visualize import visualize_boxes

        img = read_image(args.image)
        if img is None:
            print(
                f"cannot re-read {args.image} for visualization",
                file=sys.stderr,
            )
            return 3
        try:
            visualize_boxes(img, response.get("words", []), args.visualize)
        except (IOError, ValueError) as e:
            print(f"visualization failed: {e}", file=sys.stderr)
            return 3
        print(f"visualization written to {args.visualize}", file=sys.stderr)
    return 0 if response.get("success") else 3


if __name__ == "__main__":
    sys.exit(main())
