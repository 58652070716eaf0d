"""Text drawn as Pillow draws it with the DejaVu faces, from a glyph atlas.

Counterpart of ``PILTextRenderer`` in ``ppocr_tpu/train/synthetic.py``
(:class:`AtlasTextRenderer`; ``PILTextRenderer`` is an alias). The JAX
package draws its synthetic scenes with Pillow 12.1 (raqm layout, which
shapes with HarfBuzz, and FreeType 2.14.1); the machines that train the
port have neither, nor the fonts. ``assets/glyph_atlas.npz``, written by
``scripts/make_glyph_atlas_torch.py``, holds what Pillow's drawing reads
from them for the six faces at 24, 28, 32 and 36 px: each face's cmap,
each glyph's FreeType bitmap (its inked rectangle and offset), control
box and advance, the HarfBuzz lookups that apply to these characters
(the f-ligatures, pair kerning, the Lao nikhahit's mark anchors) with
their values in 26.6 pixels, and each character's Unicode script.

The layout replays raqm and HarfBuzz: raqm's script itemisation (common
characters take their neighbours' script, paired brackets their opener's),
one shaping run per script, the characters HarfBuzz's shapers split in
a run of a given script (the Thai shaper's SARA AM, the USE shaper's
canonical decompositions), the Sans faces' contour forms of a run of
Chao tone letters (U+02E5–U+02E9), ligatures, kerning, mark attachment
and zeroed mark advances. Pillow's
``font_render`` and ``bounding_box_and_anchors`` follow: pen positions
rounded from 26.6 (``PIXEL``), the box of control boxes and pen line, the
ascender anchor, glyph bitmaps merged into one mask as alphas, and
``ImageDraw``'s blend of the mask into the image with Pillow's integer
``DIV255``. :func:`draw_text` gives ``ImageDraw.text`` exactly and
:meth:`AtlasFont.getbbox` gives ``ImageDraw.textbbox``.

A character the atlas lacks for the chosen face raises
:class:`LayoutUnsupported`.
"""

from __future__ import annotations

import functools
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEJAVU_DIR = "/usr/share/fonts/truetype/dejavu"
DEJAVU_FONTS = (
    "DejaVuSans.ttf",
    "DejaVuSans-Bold.ttf",
    "DejaVuSerif.ttf",
    "DejaVuSerif-Bold.ttf",
    "DejaVuSansMono.ttf",
    "DejaVuSansMono-Bold.ttf",
)
SIZES = (24, 28, 32, 36)

# raqm's paired punctuation (raqm.c ``paired_chars``): opener at an even
# index, its closer after it
_PAIRED = (
    0x0028, 0x0029, 0x003C, 0x003E, 0x005B, 0x005D, 0x007B, 0x007D,
    0x00AB, 0x00BB, 0x2018, 0x2019, 0x201C, 0x201D, 0x2039, 0x203A,
    0x3008, 0x3009, 0x300A, 0x300B, 0x300C, 0x300D, 0x300E, 0x300F,
    0x3010, 0x3011, 0x3014, 0x3015, 0x3016, 0x3017, 0x3018, 0x3019,
    0x301A, 0x301B,
)
_PAIR_INDEX = {cp: i for i, cp in enumerate(_PAIRED)}
_COMMON, _INHERITED = "Zyyy", "Zinh"


class LayoutUnsupported(ValueError):
    """The atlas cannot lay this string out as Pillow would (a character
    it lacks for the face, or a contextual form it does not hold)."""


def _pixel(x: int) -> int:
    """FreeType 26.6 → whole pixels, rounded (Pillow's ``PIXEL``)."""
    return ((x + 32) & -64) >> 6


def _roundf(v) -> int:
    """C's ``roundf``: halves away from zero."""
    r = int(np.floor(abs(v) + np.float32(0.5)))
    return r if v >= 0 else -r


def resolve_scripts(cps: Sequence[int], scripts: Sequence[str]) -> List[str]:
    """raqm 0.10's ``_raqm_resolve_scripts``: each common or inherited
    character takes the script before it (a paired bracket its opener's),
    leading ones the first real script after them."""
    n = len(cps)
    out = list(scripts)
    stack: List[Tuple[str, int]] = []
    last_script_index = -1
    last_set_index = -1
    last_script: Optional[str] = None
    for i in range(n):
        s = out[i]
        if s == _COMMON and last_script_index != -1:
            pair = _PAIR_INDEX.get(cps[i], -1)
            if pair >= 0:
                if pair % 2 == 0:
                    out[i] = last_script
                    last_set_index = i
                    stack.append((out[i], pair))
                else:
                    opener = pair & ~1
                    while stack and stack[-1][1] != opener:
                        stack.pop()
                    if stack:
                        out[i] = stack[-1][0]
                        last_script = out[i]
                    else:
                        out[i] = last_script
                    last_set_index = i
            else:
                out[i] = last_script
                last_set_index = i
        elif s == _INHERITED and last_script_index != -1:
            out[i] = last_script
            last_set_index = i
        else:
            for j in range(last_set_index + 1, i):
                out[j] = s
            last_script = s
            last_script_index = i
            last_set_index = i
    for i in range(n - 2, -1, -1):
        if out[i] in (_COMMON, _INHERITED):
            out[i] = out[i + 1]
    return out


class AtlasFace:
    """One face of the atlas: its cmap, its glyphs at each size, and the
    HarfBuzz lookups that act on them."""

    def __init__(self, atlas: "GlyphAtlas", index: int, meta: dict, arrays: dict):
        self.atlas = atlas
        self.name = meta["file"]
        p = f"f{index}/"
        self.cmap: Dict[int, int] = dict(
            zip(arrays[p + "cmap_cp"].tolist(), arrays[p + "cmap_gid"].tolist())
        )
        gids = arrays[p + "gids"].tolist()
        self.slot_of: Dict[int, int] = {g: i for i, g in enumerate(gids)}
        self.is_mark = arrays[p + "is_mark"].astype(bool)
        self.adv = arrays[p + "adv"]  # [S, n] 26.6
        self.cbox = arrays[p + "cbox"]  # [S, n, 4] xMin, yMin, xMax, yMax px
        self.ink = arrays[p + "ink"]  # [S, n, 4] left, top, w, h px
        self.ink_off = arrays[p + "ink_off"]  # [S, n] into pix
        self.pix = arrays[p + "pix"]
        self.ascender = meta["ascender_px"]
        self.noink = frozenset(meta["noink_cps"])  # DejaVuSans' inkless characters
        self.hb_scale = [
            (np.float32(x) / np.float32(meta["upem"]), np.float32(y) / np.float32(meta["upem"]))
            for x, y in meta["hb_scale"]
        ]
        self.plans = meta["scripts"]  # script → {"liga", "kern", "markbase"}
        self.default_plan = meta["default_script_plan"]
        # a run of tone letters: each letter's form before the next, and the
        # last one's after its predecessor, keyed by the pair's slots
        tone = meta["tone"] or {"next": [], "last": [], "scripts": []}
        self.tone_next, self.tone_last = (
            {(self.slot_of[a], self.slot_of[b]): self.slot_of[f] for a, b, f in tone[k]}
            for k in ("next", "last")
        )
        self.tone_scripts = frozenset(tone["scripts"])
        self.decompose = {  # script → {codepoint: slots HarfBuzz splits it into}
            iso: {int(cp): [self.slot_of[g] for g in gs] for cp, gs in d.items()}
            for iso, d in meta["decompose"].items()
        }
        self.ligatures: Dict[str, Dict[int, list]] = {}
        for lk, rules in meta["ligatures"].items():
            table: Dict[int, list] = {}
            for first, comps, lig in rules:
                if first in self.slot_of and lig in self.slot_of and all(c in self.slot_of for c in comps):
                    table.setdefault(self.slot_of[first], []).append(
                        (tuple(self.slot_of[c] for c in comps), self.slot_of[lig])
                    )
            self.ligatures[lk] = table
        self.kern: Dict[str, list] = {}
        for lk, n_sub in meta["kern"].items():
            self.kern[lk] = [
                (arrays[f"{p}kern{lk}_{t}_c1"], arrays[f"{p}kern{lk}_{t}_c2"],
                 arrays[f"{p}kern{lk}_{t}_delta"])
                for t in range(n_sub)
            ]
        self.markbase: Dict[str, list] = {}  # lookup → subtables of (marks, bases)
        for lk, tables in meta["markbase"].items():
            self.markbase[lk] = [
                ({self.slot_of[g]: (c, a) for g, c, a in t["marks"] if g in self.slot_of},
                 {self.slot_of[g]: anchors for g, anchors in t["bases"] if g in self.slot_of})
                for t in tables
            ]

    def glyph(self, s: int, slot: int) -> Tuple[np.ndarray, int, int]:
        """(ink bitmap [h, w] uint8, left, top) of a glyph at size index s."""
        left, top, w, h = (int(v) for v in self.ink[s, slot])
        off = int(self.ink_off[s, slot])
        return self.pix[off: off + w * h].reshape(h, w), left, top


class AtlasFont:
    """A face at one pixel size: the stand-in of ``ImageFont.FreeTypeFont``
    (``path`` and ``size`` as there)."""

    def __init__(self, face: AtlasFace, size: int, path: str):
        self.face = face
        self.size = size
        self.path = path
        self.s = self.face.atlas.sizes.index(size)

    def _plan(self, script: str) -> dict:
        return self.face.plans.get(script, self.face.default_plan)

    def layout(self, text: str) -> List[Tuple[int, int, int, int]]:
        """HarfBuzz's glyphs through raqm: [(slot, x_advance, x_offset,
        y_offset)], 26.6."""
        face, s = self.face, self.s
        cps = [ord(c) for c in text]
        missing = [c for c in text if ord(c) not in face.cmap
                   or face.cmap[ord(c)] not in face.slot_of]
        if missing:
            raise LayoutUnsupported(f"{face.name} at {self.size} px lacks {missing!r}")
        scripts = resolve_scripts(cps, [self.face.atlas.script_of(cp) for cp in cps])
        out: List[Tuple[int, int, int, int]] = []
        i = 0
        while i < len(cps):
            j = i
            while j < len(cps) and scripts[j] == scripts[i]:
                j += 1
            out += self._shape(cps[i:j], scripts[i], s)
            i = j
        return out

    def _shape(self, cps: List[int], script: str, s: int) -> List[Tuple[int, int, int, int]]:
        face = self.face
        plan = self._plan(script)
        split = face.decompose.get(script, {})
        # HarfBuzz shapes a right-to-left script's run reversed unless it
        # holds a digit and no letter (hb_ensure_native_direction): each
        # cluster's glyphs come out reversed and kern pairs read backwards
        cats = [unicodedata.category(chr(cp)) for cp in cps]
        rtl = script in face.atlas.rtl_scripts and not (
            "Nd" in cats and not any(c[0] == "L" for c in cats))
        slots: List[int] = []
        for cp in cps:
            if cp in split:
                slots += split[cp][::-1] if rtl else split[cp]
            else:
                slots.append(face.slot_of[face.cmap[cp]])
        if script in face.tone_scripts:  # ccmp, laid out in the run's own direction
            slots = self._tone_forms(slots[::-1])[::-1] if rtl else self._tone_forms(slots)
        for lk in plan["liga"]:  # GSUB ligatures, lookup by lookup
            table = face.ligatures[lk]
            k = 0
            while k < len(slots):
                for comps, lig in table.get(slots[k], ()):
                    if tuple(slots[k + 1: k + 1 + len(comps)]) == comps:
                        slots[k: k + 1 + len(comps)] = [lig]
                        break
                k += 1
        n = len(slots)
        adv = [int(face.adv[s, g]) for g in slots]
        xoff = [0] * n
        yoff = [0] * n
        attach = [-1] * n
        for lk in plan["kern"]:  # pair adjustment of the first glyph's advance
            subtables = face.kern[lk]
            for k in range(n - 1):
                first = k + 1 if rtl else k
                a, b = slots[first], slots[2 * k + 1 - first]
                for c1, c2, delta in subtables:
                    k1 = int(c1[a])
                    if k1 >= 0:
                        adv[first] += int(delta[s, k1, int(c2[b])])
                        break
        for lk in plan["markbase"]:  # mark-to-base attachment
            for k in range(n):
                base = k - 1
                while base >= 0 and face.is_mark[slots[base]]:
                    base -= 1
                for marks, bases in face.markbase[lk]:
                    if slots[k] not in marks:
                        continue
                    if base < 0 or slots[base] not in bases:
                        continue  # HarfBuzz tries the lookup's next subtable
                    cls, mark_anchor = marks[slots[k]]
                    base_anchor = bases[slots[base]][cls]
                    if base_anchor is None:
                        continue
                    (bx, by), (mx, my) = (self._anchor(a) for a in (base_anchor, mark_anchor))
                    xoff[k], yoff[k] = _roundf(bx - mx), _roundf(by - my)
                    attach[k] = base
                    break
        for k in range(n):  # marks' advances are zeroed after GPOS
            if face.is_mark[slots[k]]:
                adv[k] = 0
        for k in range(n):  # attachment offsets are relative to the base's pen
            if attach[k] >= 0:
                xoff[k] -= sum(adv[attach[k]:k])
        return list(zip(slots, adv, xoff, yoff))

    def _tone_forms(self, slots: List[int]) -> List[int]:
        """Every tone letter followed by another takes the form the next
        one selects; the last of a run, the form its predecessor selects."""
        nxt, last = self.face.tone_next, self.face.tone_last
        out = list(slots)
        for k in range(len(slots) - 1):
            pair = (slots[k], slots[k + 1])
            if pair in nxt:
                out[k] = nxt[pair]
                if k + 2 == len(slots) or (slots[k + 1], slots[k + 2]) not in nxt:
                    out[k + 1] = last[pair]
        return out

    def _anchor(self, a) -> Tuple[np.float32, np.float32]:
        """A GPOS anchor in 26.6 as HarfBuzz's ``get_anchor`` gives it:
        font units times the float scale, or a contour point's position."""
        if a[0] == "p":
            x, y = a[1][self.s]
            return np.float32(x), np.float32(y)
        xs, ys = self.face.hb_scale[self.s]
        return np.float32(a[1]) * xs, np.float32(a[2]) * ys

    def _box(self, glyphs):
        """Pillow's ``bounding_box_and_anchors`` (anchor "la")."""
        cbox = self.face.cbox[self.s]
        position = x_min = x_max = y_min = y_max = 0
        for slot, adv, xo, yo in glyphs:
            px = _pixel(position + xo)
            py = _pixel(yo)
            position += adv
            x_max = max(x_max, _pixel(position))
            b0, b1, b2, b3 = (int(v) for v in cbox[slot])
            x_max = max(x_max, b2 + px)
            x_min = min(x_min, b0 + px)
            y_max = max(y_max, b3 + py)
            y_min = min(y_min, b1 + py)
        return x_min, x_max, y_min, y_max

    def getbbox(self, text: str) -> Tuple[int, int, int, int]:
        """``ImageDraw.textbbox((0, 0), text, font)``."""
        x_min, x_max, y_min, y_max = self._box(self.layout(text))
        top = self.face.ascender[self.s] - y_max
        return x_min, top, x_max, top + (y_max - y_min)

    def getmask2(self, text: str) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Pillow's ``getmask2`` in mode "L": the string's [h, w] uint8
        coverage and its offset from the draw origin."""
        glyphs = self.layout(text)
        x_min, x_max, y_min, y_max = self._box(glyphs)
        h, w = y_max - y_min, x_max - x_min
        mask = np.zeros((h, w), np.uint8)
        x = -x_min * 64
        y = -y_max * 64
        for slot, adv, xo, yo in glyphs:
            px = _pixel(x + xo)
            py = _pixel(y + yo)
            bm, left, top = self.face.glyph(self.s, slot)
            gh, gw = bm.shape
            c0, r0 = px + left, -py - top
            cs, ce = max(c0, 0), min(c0 + gw, w)
            rs, re = max(r0, 0), min(r0 + gh, h)
            if ce > cs and re > rs:
                # Pillow's font_render merges overlapping glyphs as
                # "over" alphas: t + g − DIV255(t·g)
                t = mask[rs:re, cs:ce].astype(np.uint32)
                g = bm[rs - r0: re - r0, cs - c0: ce - c0].astype(np.uint32)
                tg = t * g + 128
                mask[rs:re, cs:ce] = t + g - (((tg >> 8) + tg) >> 8)
            x += adv
        return mask, (x_min, self.face.ascender[self.s] - y_max)


def blend_mask(canvas: np.ndarray, mask: np.ndarray, x: int, y: int, ink) -> None:
    """Pillow's ``fill_mask_L``: ``canvas`` (H×W or H×W×C uint8) ← ink
    through ``mask`` placed at (x, y), clipped, with Pillow's ``BLEND``."""
    h, w = canvas.shape[:2]
    mh, mw = mask.shape
    xs, ys = max(x, 0), max(y, 0)
    xe, ye = min(x + mw, w), min(y + mh, h)
    if xe <= xs or ye <= ys:
        return
    m = mask[ys - y: ye - y, xs - x: xe - x].astype(np.uint32)
    out = canvas[ys:ye, xs:xe]
    if out.ndim == 3:
        m = m[..., None]
        ink = np.asarray(ink, np.uint32)[: out.shape[2]]
    else:
        ink = np.uint32(ink)
    tmp = out.astype(np.uint32) * (255 - m) + ink * m + 128
    out[...] = ((tmp >> 8) + tmp) >> 8


def draw_text(canvas: np.ndarray, xy: Tuple[int, int], text: str, font: AtlasFont, fill) -> None:
    """``ImageDraw.Draw(Image.fromarray(canvas)).text(xy, text, font=font,
    fill=fill)`` for integer ``xy``, in place."""
    mask, (ox, oy) = font.getmask2(text)
    blend_mask(canvas, mask, int(xy[0]) + ox, int(xy[1]) + oy, fill)


class GlyphAtlas:
    """The committed atlas: faces by file name, and each character's
    Unicode script."""

    def __init__(self, meta: dict, arrays: dict):
        self.sizes = tuple(meta["sizes"])
        self.scripts = meta["script_names"]
        self.rtl_scripts = frozenset(meta["rtl_scripts"])
        self._script = dict(
            zip(arrays["script_cp"].tolist(), arrays["script_ix"].tolist())
        )
        self.faces = {
            f["file"]: AtlasFace(self, i, f, arrays) for i, f in enumerate(meta["faces"])
        }

    def script_of(self, cp: int) -> str:
        ix = self._script.get(cp)
        return _COMMON if ix is None else self.scripts[ix]

    def font(self, path: str, size: int) -> AtlasFont:
        name = os.path.basename(path)
        if name not in self.faces:
            raise LayoutUnsupported(f"no face {name!r} in the glyph atlas")
        if size not in self.sizes:
            raise LayoutUnsupported(f"no size {size} in the glyph atlas ({self.sizes})")
        return AtlasFont(self.faces[name], size, path)


@functools.lru_cache(maxsize=1)
def load_atlas() -> GlyphAtlas:
    from ..assets import load_glyph_atlas

    meta, arrays = load_glyph_atlas()
    return GlyphAtlas(meta, arrays)


class AtlasTextRenderer:
    """The port's ``PILTextRenderer``: TrueType lines measured and drawn as
    Pillow would, from the glyph atlas.

    ``pick_font`` restricts the per-sample face to those whose cmap covers
    the text and draws from ``rng`` exactly as the JAX package does;
    ``measure`` is ``draw.textbbox((0, 0), ...)`` and ``draw`` is
    ``draw.text`` onto an RGB (or grey) uint8 array in place."""

    def __init__(
        self,
        font_dir: str = DEJAVU_DIR,
        fonts: Sequence[str] = DEJAVU_FONTS,
        sizes: Sequence[int] = SIZES,
        atlas: Optional[GlyphAtlas] = None,
    ):
        atlas = atlas or load_atlas()
        self.paths = [os.path.join(font_dir, f) for f in fonts]
        self._fonts = {(p, s): atlas.font(p, s) for p in self.paths for s in sizes}
        self._cov = {p: frozenset(atlas.faces[os.path.basename(p)].cmap) for p in self.paths}
        self.sizes = tuple(sizes)

    def pick_font(self, text: str, rng: np.random.Generator) -> AtlasFont:
        cps = {ord(c) for c in text}
        ok = [p for p in self.paths if cps <= self._cov[p]]
        if not ok:  # caller should sample from a covered alphabet
            ok = [self.paths[0]]
        path = ok[int(rng.integers(len(ok)))]
        size = self.sizes[int(rng.integers(len(self.sizes)))]
        return self._fonts[(path, size)]

    def measure(self, text: str, font: AtlasFont) -> Tuple[int, int, int, int]:
        """Tight (dx0, dy0, dx1, dy1) of ``text`` drawn at origin."""
        return font.getbbox(text)

    def draw(self, canvas: np.ndarray, xy: Tuple[int, int], text: str, font: AtlasFont,
             fill=(0, 0, 0)) -> None:
        draw_text(canvas, xy, text, font, fill)


PILTextRenderer = AtlasTextRenderer
