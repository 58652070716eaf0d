"""Character dictionary of the CTC recognizer (copy of
``ppocr_tpu/pipeline/charset.py``).

Reproduces CRNNRecognizer's dict construction (ocr_rec.h:82-84): read
lines, insert blank "#" at index 0, append a single space. A trailing
``\\r`` is stripped and the file must be valid UTF-8.
"""

from __future__ import annotations

from typing import List


def load_charset(path: str) -> List[str]:
    with open(path, "rb") as f:
        raw = f.read().decode("utf-8")
    lines = raw.split("\n")
    if lines and lines[-1] == "":
        lines = lines[:-1]
    labels = [line.rstrip("\r") for line in lines]
    return ["#"] + labels + [" "]
