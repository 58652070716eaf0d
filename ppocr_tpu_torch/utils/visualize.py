"""Result visualization, the Utility::VisualizeBboxes analog
(utility.cpp:50-70): draw the detected word quads on the source image and
save it (quads only, like the reference: no text or confidence labels).

Counterpart of ``ppocr_tpu/utils/visualize.py``. The JAX function draws
with ``cv2.polylines`` and writes with ``cv2.imwrite``; the machines that
serve the port have no cv2, so the quads are drawn by ``utils.draw``
(``cv2.polylines``' pixels) and the file is written by
``imcodec.encode_png``. One difference remains: ``cv2.imwrite`` writes
any extension it has an encoder for, and this function writes PNG only
(``.png`` in any case); any other extension raises ``IOError``, which the
client turns into exit code 3, as the JAX client does when the write
fails. The PNG's bytes may differ from cv2's; its decoded pixels do not.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from .draw import polylines
from .imcodec import encode_png


def visualize_boxes(
    image_bgr: np.ndarray,
    words: Sequence[Dict],
    output_path: str | None = None,
    color=(0, 255, 0),  # green, CV_RGB(0,255,0) like the reference
    thickness: int = 2,
) -> np.ndarray:
    """Draw each word's quad; ``words`` is the response's words list
    ([{text, confidence, box: [[x,y]×4]}]). Returns the drawn copy.
    Raises ``IOError`` when ``output_path`` cannot be written, or does not
    end in ``.png``, and ``ValueError`` where ``cv2.polylines`` fails its
    assertion (a thickness outside [0, 32767]) or the canvas is not a
    uint8 image ``encode_png`` takes."""
    canvas = image_bgr.copy()
    quads = [np.asarray(word["box"], np.int32).reshape(-1, 1, 2) for word in words]
    if quads:  # one call draws what one call per quad draws: one colour
        polylines(canvas, quads, color, thickness)
    if output_path:
        ext = os.path.splitext(output_path)[1]
        if ext.lower() != ".png":
            raise IOError(
                f"cannot write visualization to {output_path}: this package "
                f"encodes PNG only, not {ext or 'a file without an extension'}"
            )
        data = encode_png(canvas)
        try:
            with open(output_path, "wb") as f:
                f.write(data)
        except OSError as e:
            raise IOError(f"cannot write visualization to {output_path}: {e}") from e
    return canvas
