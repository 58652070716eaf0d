"""Shared CLI helpers."""

from __future__ import annotations

import re


def resolve_socket_path(name: str) -> str:
    r"""Accept either a Unix socket path or a reference-style Windows pipe
    name (``\\.\pipe\ocr_service``), mapping the latter to /tmp so scripts
    written against the reference CLI keep working."""
    m = re.match(r"^\\\\\.\\pipe\\(.+)$", name)
    if m:
        return f"/tmp/{m.group(1)}.sock"
    return name
