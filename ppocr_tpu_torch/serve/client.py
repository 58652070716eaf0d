"""Synchronous IPC client — behavioral mirror of OCRIPCClient
(ocr_ipc_client.cpp) over a Unix socket. A copy of
``ppocr_tpu/serve/client.py``: the protocol is the same.

Transport selection matches the reference (ocr_ipc_client.cpp:143-178):
files under 600 KB are base64-inlined if the resulting JSON stays under
1 MB, otherwise the file path is sent. Connect retries while the socket is
missing/busy within the timeout window (the WaitNamedPipeA loop analog).
"""

from __future__ import annotations

import base64
import json
import os
import socket
import threading
import time
from typing import Optional

INLINE_FILE_LIMIT = 600 * 1024  # ocr_ipc_client.cpp:149
MAX_JSON_BYTES = 1048576


class OCRIPCClient:
    def __init__(self, socket_path: str = "/tmp/ocr_service.sock", timeout_ms: int = 30000):
        self.socket_path = socket_path
        self.timeout_ms = timeout_ms
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._lock = threading.Lock()  # one request/response in flight

    # -- connection --------------------------------------------------------

    def connect(self) -> bool:
        with self._lock:  # racing with disconnect()/other senders
            if self._sock is not None:
                return True
            return self._connect_locked()

    def is_connected(self) -> bool:
        return self._sock is not None

    def disconnect(self):
        with self._lock:
            self._teardown_locked()

    def __enter__(self):
        if not self.connect():
            raise ConnectionError(f"cannot connect to {self.socket_path}")
        return self

    def __exit__(self, *exc):
        self.disconnect()

    # -- request/response ----------------------------------------------------

    def send_request(self, request: dict) -> dict:
        """Blocking request/response (ocr_ipc_client.cpp:180-221).

        A dead connection is torn down before the error propagates, so
        the next call auto-reconnects (the service recycles routinely
        under --recycle-after; a client that can never reconnect records
        100% errors from then on). A response timeout also
        tears the connection down: the late reply would otherwise land
        in the buffer and desync every later request/response pair."""
        payload = (
            json.dumps(request, ensure_ascii=False, separators=(",", ":")) + "\n"
        ).encode("utf-8")
        with self._lock:
            if self._sock is None and not self._connect_locked():
                raise ConnectionError(f"cannot connect to {self.socket_path}")
            try:
                self._sock.sendall(payload)
                line = self._file.readline()
            except (OSError, socket.timeout) as e:
                self._teardown_locked()
                raise ConnectionError(
                    f"request failed ({e}); connection reset — the next "
                    "call will reconnect"
                ) from e
            if not line:
                self._teardown_locked()
                raise ConnectionError("service closed the connection")
        return json.loads(line.decode("utf-8"))

    def _connect_locked(self) -> bool:
        """connect() body without re-taking the lock (callers hold it)."""
        deadline = time.monotonic() + self.timeout_ms / 1000.0
        while True:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.settimeout(max(self.timeout_ms / 1000.0, 0.001))
                s.connect(self.socket_path)
                self._sock = s
                self._file = s.makefile("rb")
                return True
            except (FileNotFoundError, ConnectionRefusedError, socket.timeout):
                s.close()
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.05)  # retry-while-busy (ocr_ipc_client.cpp:102-133)

    def _teardown_locked(self):
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- commands --------------------------------------------------------------

    def recognize_image(self, image_path: str) -> dict:
        """Inline small files as base64; fall back to path transmission
        (ocr_ipc_client.cpp:143-178)."""
        request = {"command": "recognize"}
        abs_path = os.path.abspath(image_path)
        try:
            size = os.path.getsize(abs_path)
        except OSError:
            size = None
        encoded = None
        # reference semantics: inline only when 0 < size < 600 KB AND the
        # read succeeds; empty or unreadable files fall back to path
        # transmission (ocr_ipc_client.cpp:148-170 — its empty-base64
        # check covers both)
        if size is not None and 0 < size < INLINE_FILE_LIMIT:
            try:
                with open(abs_path, "rb") as f:
                    encoded = base64.b64encode(f.read()).decode("ascii")
            except OSError:
                encoded = None
        if encoded and len(encoded) + 200 < MAX_JSON_BYTES:
            request["image_data"] = encoded
        else:
            request["image_path"] = abs_path
        return self.send_request(request)

    def get_service_status(self) -> dict:
        return self.send_request({"command": "status"})

    def send_shutdown_command(self) -> dict:
        return self.send_request({"command": "shutdown"})
