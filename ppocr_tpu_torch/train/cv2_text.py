"""Text drawn as cv2 5.0's ``putText`` / ``getTextSize`` draw it, for the
upright face cv2 embeds ("Rubik for OpenCV Light").

Counterpart of the JAX package's calls to ``cv2.putText`` and
``cv2.getTextSize`` (``ppocr_tpu/train/synthetic.py``: ``render_line``,
the digit scenes). cv2 5.0 draws its ``FONT_HERSHEY_*`` fonts as filled
TrueType outlines: ``hersheyToTruetype`` maps the font and the thickness
to a face, a whole pixel size and a weight, and a copy of stb_truetype
with TrueType variations draws each glyph. ``assets/cv2_text.npz``,
written by ``scripts/make_cv2_text_assets_torch.py`` where cv2 is, holds
the upright face's cmap and, at each weight the upright fonts select
(400, 600, 800), every glyph's varied outline (stb's vertex list), box
and advance. ``csrc/cv2_text.cpp`` (built at first use, like the
decoders) lays the glyphs out, rasterises them and blends them in. The
machines that train the port have no cv2, PIL or fontTools.

The map from the Hershey arguments (``hersheyToTruetype``):

    font              face     size = round(fontScale * 100 / d)   weight (thickness <= 1, else)
    SIMPLEX           sans     d = 3.7                             400, 600
    PLAIN             sans     d = 6.6                             400, 800
    DUPLEX            sans     d = 3.7                             600, 800
    COMPLEX           serif    d = 3.7                             400, 800
    TRIPLEX           serif    d = 3.7                             600, 800
    COMPLEX_SMALL     serif    d = 4.6                             400, 800
    SCRIPT_SIMPLEX    italic   d = 4.0                             300, 500
    SCRIPT_COMPLEX    italic   d = 4.0                             400, 600

"sans" and "serif" are both the upright Rubik; the rounding is ties to
even. ``lineType`` changes nothing (every type is drawn anti-aliased).

Not ported (ROADMAP A17): the italic face (``FONT_HERSHEY_SCRIPT_*``,
``FONT_ITALIC``), WenQuanYi Micro Hei (cv2 draws a character upright
Rubik lacks from it, e.g. Greek or CJK), and cv2's fallback glyph for a
character neither maps (line breaks and tabs, which cv2 lays out itself,
are characters Rubik does not map). These raise
:class:`CV2FallbackFaceNotPorted` before anything is drawn.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FONT_HERSHEY_SIMPLEX = 0
FONT_HERSHEY_PLAIN = 1
FONT_HERSHEY_DUPLEX = 2
FONT_HERSHEY_COMPLEX = 3
FONT_HERSHEY_TRIPLEX = 4
FONT_HERSHEY_COMPLEX_SMALL = 5
FONT_HERSHEY_SCRIPT_SIMPLEX = 6
FONT_HERSHEY_SCRIPT_COMPLEX = 7
FONT_ITALIC = 16
FILLED = -1
LINE_4 = 4
LINE_8 = 8
LINE_AA = 16

# hersheyToTruetype for the upright fonts: font -> (size divisor, weight at
# thickness <= 1, else); the script fonts take the italic face (A17)
_HERSHEY = {
    FONT_HERSHEY_SIMPLEX: (3.7, 400, 600),
    FONT_HERSHEY_PLAIN: (6.6, 400, 800),
    FONT_HERSHEY_DUPLEX: (3.7, 600, 800),
    FONT_HERSHEY_COMPLEX: (3.7, 400, 800),
    FONT_HERSHEY_TRIPLEX: (3.7, 600, 800),
    FONT_HERSHEY_COMPLEX_SMALL: (4.6, 400, 800),
}
_ITALIC_FONTS = (FONT_HERSHEY_SCRIPT_SIMPLEX, FONT_HERSHEY_SCRIPT_COMPLEX)


class CV2FontsNotPorted(NotImplementedError):
    """A part of cv2 5.0's text drawing that the port does not replay."""


class CV2FallbackFaceNotPorted(CV2FontsNotPorted):
    """cv2 would draw this text with a face other than the upright Rubik
    (ROADMAP A17): the italic face, WenQuanYi Micro Hei, or its glyph for a
    character no face maps."""

    def __init__(self, what: str):
        super().__init__(
            f"{what}: cv2 5.0 draws this with a face other than its upright Rubik (the "
            "italic face, WenQuanYi Micro Hei or its missing-glyph fallback), which the "
            "port does not draw yet: ROADMAP A17. Upright Rubik covers digits, ASCII, "
            "Latin-1 and Cyrillic (rubik_covers)."
        )


_U8P, _I16P, _I32P = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16),
                      ctypes.POINTER(ctypes.c_int32))
_table_keys = itertools.count(1)  # names each table to the C++ glyph cache


class RubikFace:
    """The committed tables of upright Rubik: its cmap and, per weight, the
    vertex lists, boxes and advances ``csrc/cv2_text.cpp`` draws from."""

    def __init__(self, meta: dict, arrays: Dict[str, np.ndarray]):
        self.meta = meta
        self.ascent = int(meta["ascent"])
        self.weights = tuple(int(w) for w in meta["weights"])
        self.cmap = dict(zip(arrays["codepoints"].tolist(), arrays["cmap_glyph"].tolist()))
        self._arrays = {}  # the tables' arrays stay alive with the pointers to them
        self.tables = {}  # weight -> the C call's table arguments
        for w in self.weights:
            t = {k: np.ascontiguousarray(arrays[f"w{w}_{k}"], dtype)
                 for k, dtype in (("types", np.uint8), ("xy", np.int16), ("vstart", np.int32),
                                  ("boxes", np.int16), ("advances", np.int16))}
            self._arrays[w] = t
            self.tables[w] = (next(_table_keys), t["types"].ctypes.data_as(_U8P), t["xy"].ctypes.data_as(_I16P),
                              t["vstart"].ctypes.data_as(_I32P), t["boxes"].ctypes.data_as(_I16P),
                              t["advances"].ctypes.data_as(_I16P), len(t["advances"]))

    def covers(self, text: str) -> bool:
        return all(ord(c) in self.cmap for c in text)

    def glyphs(self, text: str) -> np.ndarray:
        return np.array([self.cmap[ord(c)] for c in text], np.int32)


@functools.lru_cache(maxsize=None)
def load_face() -> RubikFace:
    from ..assets import load_cv2_text

    return RubikFace(*load_cv2_text())


def rubik_covers(text: str) -> bool:
    """Whether upright Rubik maps every character of ``text`` (then
    ``put_text`` draws it with a Hershey font that is not a script one)."""
    return load_face().covers(text)


def hershey_to_truetype(font_face: int, font_scale: float, thickness: int) -> Tuple[int, int]:
    """(pixel size, weight) cv2 draws an upright Hershey font at; raises
    :class:`CV2FallbackFaceNotPorted` for the italic ones."""
    font = int(font_face) & ~FONT_ITALIC
    if font not in _HERSHEY and font not in _ITALIC_FONTS:
        raise ValueError(f"Unknown font {font_face}")
    if font in _ITALIC_FONTS or int(font_face) & FONT_ITALIC:
        raise CV2FallbackFaceNotPorted(f"font {font_face} (italic)")
    divisor, light, heavy = _HERSHEY[font]
    size = round(float(font_scale) * 100.0 / divisor)  # cvRound: ties to even
    if size < 0:
        raise ValueError(f"fontScale {font_scale} gives a negative pixel size")
    return size, light if int(thickness) <= 1 else heavy


_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..ops.native import load_cv2_text_library

            _lib = load_cv2_text_library()
    return _lib


def _draw(face: RubikFace, text: str, size: int, weight: int, org: Tuple[int, int],
          img: Optional[np.ndarray], color: Sequence[int]) -> Tuple[int, Optional[int]]:
    """Draw ``text`` into ``img`` (uint8 [H, W] or [H, W, C], rows
    contiguous), or only measure it when ``img`` is None; returns (advance
    in pixels, ink bottom relative to org.y: the last inked row + 1, or
    None)."""
    glyphs = face.glyphs(text)
    out = np.zeros(2, np.int32)
    if img is None:
        ptr, rows, cols, cn, step, col = None, 0, 0, 1, 0, None
    else:
        rows, cols = img.shape[:2]
        cn = 1 if img.ndim == 2 else img.shape[2]
        ptr, step = img.ctypes.data_as(_U8P), img.strides[0]
        col = (ctypes.c_uint8 * cn)(*color[:cn])
    status = _library().cv2_text_draw(
        glyphs.ctypes.data_as(_I32P), len(glyphs), *face.tables[weight], size, face.ascent, int(org[0]),
        int(org[1]), ptr, rows, cols, cn, step, col, out.ctypes.data_as(_I32P))
    if status:
        raise ValueError(f"cv2_text_draw: bad arguments (image {None if img is None else img.shape})")
    bottom = None if out[1] == np.iinfo(np.int32).min else int(out[1])
    return int(out[0]), bottom


def _colour(color, cn: int) -> Tuple[int, ...]:
    """cv2's ``Scalar`` → the image's depth: each value rounded (ties to
    even) and saturated to [0, 255]; missing values are 0."""
    vals = list(color) if isinstance(color, (tuple, list, np.ndarray)) else [color]
    vals = [float(v) for v in vals[:4]] + [0.0] * max(0, 4 - len(vals))
    return tuple(min(255, max(0, round(v))) for v in vals[:cn])


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], font_face: int, font_scale: float, color,
             thickness: int = 1, line_type: int = LINE_8, bottom_left_origin: bool = False) -> np.ndarray:
    """``cv2.putText`` for the upright Hershey fonts: draws ``text`` into
    ``img`` (uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4]) in place,
    ``org`` the baseline's left end, and returns ``img``. Raises
    :class:`CV2FallbackFaceNotPorted` before drawing when cv2 would use
    another face."""
    face = load_face()
    size, weight = hershey_to_truetype(font_face, font_scale, thickness)
    missing = [c for c in text if ord(c) not in face.cmap]
    if missing:
        raise CV2FallbackFaceNotPorted(f"characters {''.join(sorted(set(missing)))!r}")
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8:
        raise TypeError("put_text draws into a uint8 numpy image")
    cn = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or cn not in (1, 3, 4):
        raise ValueError(f"put_text: an image of 1, 3 or 4 channels, not {img.shape}")
    x, y = int(org[0]), int(org[1])
    view = img[::-1] if bottom_left_origin else img  # cv2 draws on the flipped image
    if bottom_left_origin:
        y = img.shape[0] - 1 - y
    work = view if view.flags["C_CONTIGUOUS"] else np.ascontiguousarray(view)
    _draw(face, text, size, weight, (x, y), work, _colour(color, cn))
    if work is not view:
        view[...] = work
    return img


def get_text_size(text: str, font_face: int, font_scale: float, thickness: int) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize``: ((width, height), baseline). The width is the
    sum of the glyphs' whole-pixel advances plus one, the height the pixel
    size, the baseline how far the ink reaches below it."""
    face = load_face()
    size, weight = hershey_to_truetype(font_face, font_scale, thickness)
    missing = [c for c in text if ord(c) not in face.cmap]
    if missing:
        raise CV2FallbackFaceNotPorted(f"characters {''.join(sorted(set(missing)))!r}")
    if not text:
        return (0, 0), 0
    advance, bottom = _draw(face, text, size, weight, (0, 0), None, ())
    return (advance + 1, size), max(0, bottom if bottom is not None else 0)
