"""Write ``ppocr_tpu_torch/assets/cv2_text.npz``: what cv2 5.0's
``putText`` draws its upright Hershey fonts from.

    python scripts/make_cv2_text_assets_torch.py [--check 2000] [--out PATH]

This script alone in the port imports cv2 and fontTools; it runs where
cv2 5.0.0 (the opencv-python wheel) is installed. The machines that
train the port read the asset through
``ppocr_tpu_torch.assets.load_cv2_text`` and draw with
``ppocr_tpu_torch.train.cv2_text``.

cv2 5.0 keeps three gzip'd TrueType faces inside its library
(``cv2.abi3.so``): WenQuanYi Micro Hei, "Rubik for OpenCV Light Italic"
and "Rubik for OpenCV Light". The upright Rubik is found by scanning
the library for gzip members and reading each face's name table (its
full name, name ID 4), not by an offset. It is a variable font (``wght``
300–900, default 300); the upright Hershey fonts select the weights
400, 600 and 800 (``train/cv2_text.py``).

cv2 applies the variations in its copy of stb_truetype, and this script
replays that arithmetic on fontTools' parse of the tables:

* the normalised coordinate is (w − 300) / 600 quantised to F2Dot14, then
  mapped through ``avar`` (0.1875, 0.51251220703125 and 0.8125 for 400,
  600 and 800);
* each tuple's scalar is taken in 16.16 fixed point, truncated;
* a tuple's untouched points get their deltas by integer interpolation
  (IUP) from the tuple's raw deltas, the quotient truncated toward zero,
  before the scalar applies; in a contour whose first point is untouched,
  the points after its last touched point take that point's delta (not
  an interpolation that wraps to the contour's first touched point);
* each point is floor(default + Σ scalar · delta), an int16; a composite
  glyph's component offsets vary the same way, its components are varied
  glyphs;
* a glyph without contours (the spaces) keeps its default advance; any
  other advance is floor(hmtx advance + Σ scalar · (Δpp2.x − Δpp1.x)),
  and the glyph's box is its glyf header box with the high x side moved
  by the advance's change (the bitmap stb allocates, and so where a
  heavy glyph is clipped).

Per weight the asset holds every glyph's stb vertex list (move, line and
quadratic curve vertices on int16 points, implied on-curve points at
(a + b) >> 1, composite components one after another), box and advance;
and the face's cmap, its ascender (the pixel size's unit) and its names.

Before writing, the port's drawing is held to cv2 on every mapped
character alone at each weight and at sizes 9 to 150 px, and on
``--check`` random strings (digits, ASCII and the whole cmap; sizes,
weights and origins drawn at random, some clipped at an edge): pixels,
``getTextSize`` and, for strings, colour blends on a random background
must be equal. It fails otherwise and writes nothing.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import zipfile
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ppocr_tpu_torch.train import cv2_text  # noqa: E402

OUT = os.path.join(REPO, "ppocr_tpu_torch", "assets", "cv2_text.npz")
FACE_NAME = "Rubik for OpenCV Light"
WEIGHTS = (400, 600, 800)
# the Hershey call that selects each weight at size = round(scale * 100 / 3.7)
SELECTS = {400: (cv2_text.FONT_HERSHEY_SIMPLEX, 1), 600: (cv2_text.FONT_HERSHEY_SIMPLEX, 2),
           800: (cv2_text.FONT_HERSHEY_DUPLEX, 2)}
VMOVE, VLINE, VCURVE = 1, 2, 3


def embedded_faces(path: str):
    """(file offset, sfnt bytes) of every gzip'd TrueType face in ``path``."""
    data = open(path, "rb").read()
    pos = data.find(b"\x1f\x8b\x08")
    while pos >= 0:
        d = zlib.decompressobj(16 + zlib.MAX_WBITS)
        try:
            head = d.decompress(data[pos:pos + 4096], 16)
            if head[:4] in (b"\x00\x01\x00\x00", b"true"):
                d = zlib.decompressobj(16 + zlib.MAX_WBITS)
                yield pos, d.decompress(data[pos:])
        except zlib.error:
            pass
        pos = data.find(b"\x1f\x8b\x08", pos + 1)


def find_rubik():
    """(TTFont of the upright Rubik, its offset in cv2's library)."""
    import cv2
    from fontTools.ttLib import TTFont

    lib = os.path.join(os.path.dirname(cv2.__file__), "cv2.abi3.so")
    for offset, raw in embedded_faces(lib):
        font = TTFont(io.BytesIO(raw))
        if font["name"].getDebugName(4) == FACE_NAME:
            return font, offset, cv2.__version__
    raise SystemExit(f"no face named {FACE_NAME!r} in {lib}")


def fixed_ratio(num: float, den: float) -> float:
    """num / den as a 16.16 fixed-point value, truncated."""
    return (int(num * 65536) * 65536 // int(den * 65536)) / 65536


def normalized(font, weight: int) -> float:
    axis = font["fvar"].axes[0]
    v = round((weight - axis.defaultValue) / (axis.maxValue - axis.defaultValue) * 16384) / 16384
    seg = sorted(font["avar"].segments["wght"].items())
    for (a, va), (b, vb) in zip(seg, seg[1:]):
        if a <= v <= b:
            return va + (vb - va) * (v - a) / (b - a)
    raise ValueError(v)


def scalar(s: float, axes) -> float:
    start, peak, end = axes["wght"]
    if peak == 0 or s <= start and s != peak or s >= end and s != peak:
        return 0.0
    if s == peak:
        return 1.0
    return fixed_ratio(s - start, peak - start) if s < peak else fixed_ratio(end - s, end - peak)


def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _interp(p: int, c1: int, d1: int, c2: int, d2: int) -> int:
    if c1 == c2:
        return d1 if d1 == d2 else 0
    if c1 > c2:
        c1, d1, c2, d2 = c2, d2, c1, d1
    if p <= c1:
        return d1
    if p >= c2:
        return d2
    return _cdiv((p - c1) * (d2 - d1) + d1 * (c2 - c1), c2 - c1)


def iup(deltas, coords, ends):
    """cv2's IUP of one tuple's raw deltas (None = untouched)."""
    d = list(deltas)
    start = 0
    for end in ends:
        if d[start] is None:
            last = end
            while deltas[last] is None and last > start:
                last -= 1
            if last == start:  # no touched point
                d[start:end + 1] = [(0, 0)] * (end + 1 - start)
                start = end + 1
                continue
            anchor = prev = last
        else:
            anchor = prev = start
        nxt = -1
        for i in range(start, end + 1):
            if deltas[i] is not None:
                if nxt == i:
                    nxt = -1
                prev = i
                continue
            if nxt < 0:
                nxt = next((j for j in range(i + 1, end + 1) if deltas[j] is not None), anchor)
            d[i] = tuple(_interp(coords[i][k], coords[prev][k], d[prev][k], coords[nxt][k], d[nxt][k])
                         for k in (0, 1))
        start = end + 1
    return d


class Varier:
    """Glyph outlines, boxes and advances of ``font`` at one weight."""

    def __init__(self, font, weight: int):
        self.glyf, self.gvar, self.hmtx = font["glyf"], font["gvar"], font["hmtx"]
        self.s = normalized(font, weight)

    def _deltas(self, name: str, base, ends):
        acc = np.zeros((len(base), 2))
        n = len(base) - 4
        for tv in self.gvar.variations.get(name, []):
            sc = scalar(self.s, tv.axes)
            if sc == 0:
                continue
            d = list(tv.coordinates)
            if any(x is None for x in d):
                if ends is None:  # a composite's untouched offsets stay
                    d = [x if x is not None else (0, 0) for x in d]
                else:
                    d = iup(d[:n], [tuple(int(v) for v in p) for p in base[:n]], ends) + \
                        [x if x is not None else (0, 0) for x in d[n:]]
            acc += sc * np.array(d, float)
        return acc

    def _base(self, name):
        g = self.glyf[name]
        if g.isComposite():
            pts = [(c.x, c.y) for c in g.components]
            return g, np.array(pts + [(0, 0)] * 4, float), None
        if g.numberOfContours <= 0:
            return g, np.zeros((4, 2)), None
        coords, ends, _ = g.getCoordinates(self.glyf)
        return g, np.array([tuple(p) for p in coords] + [(0, 0)] * 4, float), [int(e) for e in ends]

    def vertices(self, name: str):
        """stb's vertex list: [(type, x, y, cx, cy)]."""
        g, base, ends = self._base(name)
        if g.isComposite():
            offs = np.floor(base + self._deltas(name, base, None))
            out = []
            for c, (ox, oy) in zip(g.components, offs):
                if hasattr(c, "transform") or hasattr(c, "firstPt"):
                    raise SystemExit(f"{name}: a scaled or point-matched component is not replayed")
                for t, x, y, cx, cy in self.vertices(c.glyphName):
                    out.append((t, x + ox, y + oy, cx + ox if t == VCURVE else 0, cy + oy if t == VCURVE else 0))
            return out
        if ends is None:
            return []
        pts = np.floor(base + self._deltas(name, base, ends))[:-4].astype(int)
        _, _, flags = g.getCoordinates(self.glyf)
        return stb_vertices([tuple(p) for p in pts], [f & 1 for f in flags], ends)

    def advance(self, name: str) -> int:
        g, base, ends = self._base(name)
        if not g.isComposite() and ends is None:
            return self.hmtx[name][0]
        acc = self._deltas(name, base, ends)
        return int(np.floor(self.hmtx[name][0] + acc[-3][0] - acc[-4][0]))

    def box(self, name: str):
        g = self.glyf[name]
        if not hasattr(g, "xMin"):
            return (0, 0, 0, 0)
        return (g.xMin, g.yMin, g.xMax + self.advance(name) - self.hmtx[name][0], g.yMax)


def stb_vertices(coords, on, ends):
    """stbtt__GetGlyphShapeTT's conversion of on/off-curve points."""
    out = []
    n = len(coords)
    next_move = j = was_off = start_off = 0
    sx = sy = cx = cy = scx = scy = 0

    def close():
        if start_off:
            if was_off:
                out.append((VCURVE, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            out.append((VCURVE, sx, sy, scx, scy))
        else:
            out.append((VCURVE, sx, sy, cx, cy) if was_off else (VLINE, sx, sy, 0, 0))

    i = 0
    while i < n:
        x, y = coords[i]
        if next_move == i:
            if i:
                close()
            start_off = not on[i]
            if start_off:
                scx, scy = x, y
                if not on[i + 1]:
                    sx, sy = (x + coords[i + 1][0]) >> 1, (y + coords[i + 1][1]) >> 1
                else:
                    sx, sy = coords[i + 1]
                    i += 1
            else:
                sx, sy = x, y
            out.append((VMOVE, sx, sy, 0, 0))
            was_off = 0
            next_move = 1 + ends[j]
            j += 1
        elif not on[i]:
            if was_off:
                out.append((VCURVE, (cx + x) >> 1, (cy + y) >> 1, cx, cy))
            cx, cy, was_off = x, y, 1
        else:
            out.append((VCURVE, x, y, cx, cy) if was_off else (VLINE, x, y, 0, 0))
            was_off = 0
        i += 1
    if n:
        close()
    return out


def build(font):
    cmap = font.getBestCmap()
    codepoints = sorted(cmap)
    names = list(dict.fromkeys(cmap[cp] for cp in codepoints))
    slot = {name: i for i, name in enumerate(names)}
    arrays = {"codepoints": np.array(codepoints, np.int32),
              "cmap_glyph": np.array([slot[cmap[cp]] for cp in codepoints], np.int32)}
    for w in WEIGHTS:
        var = Varier(font, w)
        types, xy, vstart, boxes, advances = [], [], [0], [], []
        for name in names:
            vs = var.vertices(name)
            types += [v[0] for v in vs]
            xy += [v[1:] for v in vs]
            vstart.append(len(types))
            boxes.append(var.box(name))
            advances.append(var.advance(name))
        arrays[f"w{w}_types"] = np.array(types, np.uint8)
        arrays[f"w{w}_xy"] = np.array(xy, np.int16).reshape(-1, 4)
        arrays[f"w{w}_vstart"] = np.array(vstart, np.int32)
        arrays[f"w{w}_boxes"] = np.array(boxes, np.int16).reshape(-1, 4)
        arrays[f"w{w}_advances"] = np.array(advances, np.int16)
    return arrays


def check(face, n_random: int, seed: int = 0) -> int:
    """Hold ``train.cv2_text`` (drawing from ``face``) to cv2; returns the
    number of cases. Raises SystemExit at the first difference."""
    import cv2

    cv2_text.load_face = lambda: face  # draw from the tables in memory
    chars = [chr(cp) for cp in sorted(face.cmap)]
    n = 0

    def same(text, org, font, scale, thick, shape=(300, 700), bg=None, color=(0, 0, 0)):
        nonlocal n
        img = np.full(shape, 255, np.uint8) if bg is None else bg.copy()
        want = cv2.putText(img.copy(), text, org, font, scale, color, thick, cv2.LINE_AA)
        got = cv2_text.put_text(img.copy(), text, org, font, scale, color, thick, cv2_text.LINE_AA)
        size_want = cv2.getTextSize(text, font, scale, thick)
        size_got = cv2_text.get_text_size(text, font, scale, thick)
        n += 1
        if not np.array_equal(want, got) or tuple(size_want[0]) != size_got[0] or size_want[1] != size_got[1]:
            raise SystemExit(f"differs from cv2: {text!r} at {org}, font {font}, scale {scale!r}, thickness "
                             f"{thick}: {int((want != got).sum())} pixels, size {size_want} vs {size_got}")

    for w in WEIGHTS:
        font, thick = SELECTS[w]
        for size in (9, 15, 27, 64, 100, 150):
            scale = size * 0.037
            for ch in chars:
                same(ch, (250, 200), font, scale, thick)
        print(f"weight {w}: every character alone at 6 sizes", flush=True)
    rng = np.random.default_rng(seed)
    pools = ["0123456789", "".join(chr(c) for c in range(33, 127)), "".join(chars)]
    for i in range(n_random):
        text = "".join(rng.choice(list(pools[i % 3]), int(rng.integers(1, 9))))
        font = int(rng.choice([0, 1, 2, 3, 4, 5]))
        scale = float(rng.uniform(0.3, 2.5))
        thick = int(rng.integers(1, 4))
        org = (int(rng.integers(-30, 400)), int(rng.integers(-10, 320)))
        bg = rng.integers(0, 256, (300, 700, 3), dtype=np.uint8) if i % 4 == 0 else None
        color = tuple(int(c) for c in rng.integers(0, 256, 3)) if bg is not None else (0, 0, 0)
        same(text, org, font, scale, thick, bg=bg, color=color)
    print(f"{n_random} random strings", flush=True)
    return n


def write(meta, arrays, out):
    """An npz (deflate level 9, fixed timestamps: the same tables give the
    same bytes) with ``meta`` as a JSON byte array."""
    arrays = dict(arrays, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED, compresslevel=9) as z:
        for k, v in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(v), allow_pickle=False)
            info = zipfile.ZipInfo(k + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            z.writestr(info, buf.getvalue(), compresslevel=9)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", type=int, default=2000, help="random strings held to cv2")
    p.add_argument("--out", default=OUT)
    args = p.parse_args()
    font, offset, version = find_rubik()
    arrays = build(font)
    meta = {"face": FACE_NAME, "version": font["name"].getDebugName(5), "license": "SIL Open Font License 1.1",
            "source": f"cv2 {version}, cv2.abi3.so gzip member at {offset:#x}",
            "ascent": int(font["hhea"].ascent), "weights": list(WEIGHTS)}
    n = check(cv2_text.RubikFace(meta, arrays), args.check)
    write(meta, arrays, args.out)
    print(f"held to cv2 on {n} cases; wrote {args.out} ({os.path.getsize(args.out) / 1e6:.3f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
