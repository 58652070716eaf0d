"""Write ``ppocr_tpu_torch/assets/glyph_atlas.npz``: what Pillow reads
from the DejaVu faces to draw the synthetic training text.

    python scripts/make_glyph_atlas_torch.py [--check 3000] [--out PATH]

This script alone in the port imports PIL and fontTools (and Pillow's
own FreeType through ctypes); it runs where they and the faces
(``/usr/share/fonts/truetype/dejavu``) are installed, with Pillow 12.1
(raqm layout, FreeType 2.14.1). The machines that train the port read
the asset through ``ppocr_tpu_torch.assets.load_glyph_atlas`` and draw
with ``ppocr_tpu_torch.train.text_render``.

The characters are the jumbo charset (``weights/jumbo_keys.txt``) with
whatever ``build_jumbo_alphabet`` would add from DejaVuSans' cmap; each
face holds those it maps, at 24, 28, 32 and 36 px. Per glyph: its
FreeType bitmap as Pillow loads it (``FT_LOAD_DEFAULT | FT_LOAD_RENDER``)
cut to its inked rectangle, its control box in pixels
(``FT_Glyph_Get_CBox``, ``FT_GLYPH_BBOX_PIXELS``) and the advance
HarfBuzz gives it (unhinted, 26.6). Per face: the cmap, the GDEF mark
class, and the HarfBuzz lookups that act on these characters under the
default features of each script: ligatures, pair kerning (class tables
with the deltas already in 26.6 at each size, scaled as HarfBuzz's
``em_mult`` does), mark-to-base anchors (the Lao nikhahit that the Thai
shaper splits off SARA AM), and the Sans faces' contextual forms of a
run of Chao tone letters (each letter's contour glyph, chosen by its
neighbour, read from HarfBuzz for every pair and held to it on every run
of 2–4 in every script). Every character's Unicode script (fontTools'
table) goes in too, for raqm's itemisation.

Before writing, the port's renderer is held to Pillow on every
character of every face and size alone, and on ``--check`` random
strings per face and size (lengths 1–8, half drawn from the characters
that kern, ligate or bracket): ``textbbox`` and the drawn pixels must be
equal. It fails otherwise and writes nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import io
import itertools
import json
import os
import sys
import unicodedata
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ppocr_tpu_torch.train.text_render import (  # noqa: E402
    DEJAVU_DIR,
    DEJAVU_FONTS,
    SIZES,
    GlyphAtlas,
    draw_text,
)

OUT = os.path.join(REPO, "ppocr_tpu_torch", "assets", "glyph_atlas.npz")
JUMBO_KEYS = os.path.join(REPO, "weights", "jumbo_keys.txt")
# the categories build_jumbo_alphabet skips
SKIP_CATEGORIES = {"Cc", "Cf", "Cs", "Co", "Cn", "Zl", "Zp", "Zs", "Mn", "Mc", "Me"}
TONE_LETTERS = range(0x02E5, 0x02EA)
# HarfBuzz's default features for horizontal text (GSUB and GPOS), and
# those its Arabic shaper adds
DEFAULT_FEATURES = {
    "rvrn", "ccmp", "locl", "rlig", "ltra", "ltrm", "calt", "clig", "liga", "rclt",
    "abvm", "blwm", "curs", "dist", "kern", "mark", "mkmk",
}
ARABIC_FEATURES = {"stch", "isol", "fina", "fin2", "fin3", "medi", "med2", "init", "mset"}
ARABIC_SHAPER = {"Arab", "Nkoo", "Syrc", "Mong", "Phag", "Mand", "Mani", "Adlm", "Rohg"}
SPECIAL_TAGS = {"Laoo": "lao ", "Nkoo": "nko ", "Yiii": "yi  ", "Vaii": "vai ",
                "Hira": "kana", "Kana": "kana", "Zyyy": None, "Zinh": None}


# -- FreeType through ctypes: the library Pillow itself loads ----------------

import PIL  # noqa: E402
import PIL._imagingft  # noqa: E402,F401  (loads Pillow's FreeType and its dependencies)
from PIL import Image, ImageDraw, ImageFont  # noqa: E402

_ft = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                         "libfreetype-*.so*"))[0])


class _BBox(ctypes.Structure):
    _fields_ = [("xMin", ctypes.c_long), ("yMin", ctypes.c_long),
                ("xMax", ctypes.c_long), ("yMax", ctypes.c_long)]


class _SizeRequest(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("width", ctypes.c_long), ("height", ctypes.c_long),
                ("hori", ctypes.c_uint), ("vert", ctypes.c_uint)]


_LIB = ctypes.c_void_p()
assert _ft.FT_Init_FreeType(ctypes.byref(_LIB)) == 0
_ft.FT_New_Face.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
                            ctypes.POINTER(ctypes.c_void_p)]
_ft.FT_Request_Size.argtypes = [ctypes.c_void_p, ctypes.POINTER(_SizeRequest)]
_ft.FT_Load_Glyph.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int32]
_ft.FT_Outline_Get_CBox.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BBox)]
FT_LOAD_NO_HINTING, FT_LOAD_RENDER = 2, 4


def _read(addr: int, ctype):
    return ctype.from_address(addr).value


class FTFace:
    """A face at ``size`` px, requested as Pillow requests it (nominal
    height ``size·64``). Offsets are FreeType 2.14's x86-64 layout of
    ``FT_FaceRec``, ``FT_SizeRec`` and ``FT_GlyphSlotRec``."""

    def __init__(self, path: str, size: int):
        self.handle = ctypes.c_void_p()
        assert _ft.FT_New_Face(_LIB, path.encode(), 0, ctypes.byref(self.handle)) == 0
        req = _SizeRequest(0, 0, size * 64, 0, 0)
        assert _ft.FT_Request_Size(self.handle, ctypes.byref(req)) == 0
        base = self.handle.value
        self.upem = _read(base + 136, ctypes.c_ushort)
        self.slot = _read(base + 152, ctypes.c_void_p)
        size_rec = _read(base + 160, ctypes.c_void_p)
        self.x_scale = _read(size_rec + 32, ctypes.c_long)
        self.y_scale = _read(size_rec + 40, ctypes.c_long)

    def hb_scale(self):
        """hb-ft's font scale: FreeType's 16.16 scale times upem, rounded."""
        return tuple((s * self.upem + (1 << 15)) >> 16 for s in (self.x_scale, self.y_scale))

    def point(self, gid: int, index: int):
        """Outline point ``index`` of the unhinted glyph, 26.6."""
        assert _ft.FT_Load_Glyph(self.handle, gid, FT_LOAD_NO_HINTING) == 0
        n_points = _read(self.slot + 202, ctypes.c_ushort)
        assert index < n_points
        points = _read(self.slot + 208, ctypes.c_void_p)
        return [_read(points + 16 * index, ctypes.c_long), _read(points + 16 * index + 8, ctypes.c_long)]

    def glyph(self, gid: int):
        """(control box in px, bitmap [rows, width], left, top, advance 26.6)."""
        assert _ft.FT_Load_Glyph(self.handle, gid, 0) == 0
        bb = _BBox()
        _ft.FT_Outline_Get_CBox(ctypes.c_void_p(self.slot + 200), ctypes.byref(bb))
        cbox = (bb.xMin >> 6, bb.yMin >> 6, (bb.xMax + 63) >> 6, (bb.yMax + 63) >> 6)
        linear = _read(self.slot + 112, ctypes.c_long)
        assert _ft.FT_Load_Glyph(self.handle, gid, FT_LOAD_RENDER) == 0
        s = self.slot
        rows, width = _read(s + 152, ctypes.c_uint), _read(s + 156, ctypes.c_uint)
        pitch, buf = _read(s + 160, ctypes.c_int), _read(s + 168, ctypes.c_void_p)
        left, top = _read(s + 192, ctypes.c_int), _read(s + 196, ctypes.c_int)
        bm = np.zeros((rows, width), np.uint8)
        if rows and width:
            raw = np.frombuffer(ctypes.string_at(buf, rows * abs(pitch)), np.uint8)
            bm = raw.reshape(rows, abs(pitch))[:, :width].copy()
        return cbox, bm, left, top, (linear + (1 << 9)) >> 10


_hb = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                         "libharfbuzz-*.so*"))[0])
for _name, _res, _args in (
    ("hb_blob_create_from_file", ctypes.c_void_p, [ctypes.c_char_p]),
    ("hb_face_create", ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_uint]),
    ("hb_font_create", ctypes.c_void_p, [ctypes.c_void_p]),
    ("hb_buffer_create", ctypes.c_void_p, []),
    ("hb_buffer_destroy", None, [ctypes.c_void_p]),
    ("hb_buffer_add_utf8", None, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint,
                                  ctypes.c_int]),
    ("hb_buffer_set_script", None, [ctypes.c_void_p, ctypes.c_uint]),
    ("hb_buffer_set_direction", None, [ctypes.c_void_p, ctypes.c_int]),
    ("hb_buffer_guess_segment_properties", None, [ctypes.c_void_p]),
    ("hb_script_from_string", ctypes.c_uint, [ctypes.c_char_p, ctypes.c_int]),
    ("hb_shape", None, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]),
    ("hb_buffer_get_glyph_infos", ctypes.c_void_p, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]),
    ("hb_script_get_horizontal_direction", ctypes.c_int, [ctypes.c_uint]),
):
    getattr(_hb, _name).restype = _res
    getattr(_hb, _name).argtypes = _args
_HB_FONTS = {}
HB_DIRECTION_LTR, HB_DIRECTION_RTL = 4, 5


def rtl_script(iso: str) -> bool:
    """Is ``iso`` a script HarfBuzz shapes right to left (then reversing a
    left-to-right run's glyphs within each cluster, and its kern pairs)?"""
    code = _hb.hb_script_from_string(iso.encode(), 4)
    return _hb.hb_script_get_horizontal_direction(code) == HB_DIRECTION_RTL


def reversed_run(iso: str, text: str) -> bool:
    """HarfBuzz's ``hb_ensure_native_direction`` for a left-to-right run:
    a right-to-left script's run is shaped reversed unless it holds a
    decimal digit and no letter."""
    cats = [unicodedata.category(c) for c in text]
    return rtl_script(iso) and not ("Nd" in cats and not any(c[0] == "L" for c in cats))


def hb_glyphs(path: str, text: str, iso: str):
    """The glyph ids Pillow's HarfBuzz shapes ``text`` into as one
    left-to-right run of script ``iso``."""
    if path not in _HB_FONTS:
        blob = _hb.hb_blob_create_from_file(path.encode())
        _HB_FONTS[path] = _hb.hb_font_create(_hb.hb_face_create(blob, 0))
    buf = _hb.hb_buffer_create()
    data = text.encode()
    _hb.hb_buffer_add_utf8(buf, data, len(data), 0, len(data))
    _hb.hb_buffer_set_script(buf, _hb.hb_script_from_string(iso.encode(), 4))
    _hb.hb_buffer_set_direction(buf, HB_DIRECTION_LTR)
    _hb.hb_buffer_guess_segment_properties(buf)
    _hb.hb_shape(_HB_FONTS[path], buf, None, 0)
    n = ctypes.c_uint()
    infos = _hb.hb_buffer_get_glyph_infos(buf, ctypes.byref(n))
    raw = (ctypes.c_uint32 * (5 * n.value)).from_address(infos)
    out = [int(raw[5 * i]) for i in range(n.value)]
    _hb.hb_buffer_destroy(buf)
    return out


# -- the characters -----------------------------------------------------------


def ink_alone(font, ch: str) -> bool:
    """Does ``ch`` drawn alone leave ink (build_jumbo_alphabet's test)?"""
    img = Image.new("L", (120, 90), 255)
    ImageDraw.Draw(img).text((30, 25), ch, font=font, fill=0)
    return bool((np.asarray(img) < 128).any())


def characters(sans_cmap):
    """(the atlas's characters, the Sans candidates that draw no ink)."""
    jumbo = [line.rstrip("\r\n") for line in open(JUMBO_KEYS, encoding="utf-8")
             if line.rstrip("\r\n")]
    font = ImageFont.truetype(os.path.join(DEJAVU_DIR, "DejaVuSans.ttf"), 32)
    built, noink = [], []
    for cp in sorted(sans_cmap):
        ch = chr(cp)
        if cp < 0x21 or unicodedata.category(ch) in SKIP_CATEGORIES:
            continue
        if unicodedata.bidirectional(ch) in ("R", "AL", "AN"):
            continue
        (built if ink_alone(font, ch) else noink).append(cp)
    return sorted(set(map(ord, jumbo)) | set(built)), noink


# -- the font tables ---------------------------------------------------------


def ot_script_tag(iso: str):
    return SPECIAL_TAGS.get(iso, iso.lower())


def lookups_for(table, iso: str):
    """Lookup indices HarfBuzz applies for script ``iso`` (default
    language system), in index order."""
    records = {r.ScriptTag: r.Script for r in table.ScriptList.ScriptRecord}
    tag = ot_script_tag(iso)
    script = None
    for t in ([tag] if tag else []) + ["DFLT", "dflt", "latn"]:
        if t in records:
            script = records[t]
            break
    if script is None or script.DefaultLangSys is None:
        return []
    feats = DEFAULT_FEATURES | (ARABIC_FEATURES if iso in ARABIC_SHAPER else set())
    ls = script.DefaultLangSys
    idx = list(ls.FeatureIndex)
    if ls.ReqFeatureIndex != 0xFFFF:
        idx.append(ls.ReqFeatureIndex)
    out = set()
    for i in idx:
        rec = table.FeatureList.FeatureRecord[i]
        if rec.FeatureTag in feats or i == ls.ReqFeatureIndex:
            out.update(rec.Feature.LookupListIndex)
    return sorted(out)


def subtables(lookup):
    for st in lookup.SubTable:
        yield st.ExtSubTable if lookup.LookupType in (7, 9) else st


def face_tables(tt, path, chars, scripts_of, fts):
    """The lookups of one face that act on ``chars``: the ligatures, kern
    subtables, mark-to-base attachments and decompositions, the plan of
    each script, and the glyphs they need."""
    cmap = tt.getBestCmap()
    order = tt.getGlyphOrder()
    gid = {n: i for i, n in enumerate(order)}
    gdef = tt["GDEF"].table.GlyphClassDef.classDefs
    gsub, gpos = tt["GSUB"].table, tt["GPOS"].table
    covered = [cp for cp in chars if cp in cmap]
    glyphs = {gid[cmap[cp]] for cp in covered}
    scripts = sorted({scripts_of[cp] for cp in covered} | {"Zyyy"})
    # what HarfBuzz's shapers split a character into in a run of each
    # script: the Thai shaper's SARA AM → NIKHAHIT + SARA AA, and the USE
    # shaper's canonical decompositions of common characters (≠ → = + ̸)
    decompose = {}
    for iso in scripts:
        for cp in covered:
            if scripts_of[cp] not in (iso, "Zyyy", "Zinh"):
                continue
            out = hb_glyphs(path, chr(cp), iso)
            if reversed_run(iso, chr(cp)):
                out = out[::-1]  # stored in logical order
            if out != [gid[cmap[cp]]]:
                decompose.setdefault(iso, {})[cp] = out
                glyphs.update(out)
    tone = tone_forms(path, cmap, gid, scripts)
    if tone:
        glyphs.update(g for _, _, g in tone["next"] + tone["last"])
    plans, ligatures, kern, markbase = {}, {}, {}, {}

    def anchor(a, g):
        """A GPOS anchor: ["u", x, y] in font units, or for a contour-point
        anchor (format 2) ["p", [[x, y] 26.6 at each size]], the point of
        the unhinted outline as hb-ft reads it."""
        if a is None:
            return None
        if a.Format == 2:
            return ["p", [ft.point(g, a.AnchorPoint) for ft in fts]]
        assert a.Format == 1 or (a.XDeviceTable is None and a.YDeviceTable is None)
        return ["u", a.XCoordinate, a.YCoordinate]
    for iso in scripts:
        plan = {"liga": [], "kern": [], "markbase": []}
        for li in lookups_for(gsub, iso):
            lk = gsub.LookupList.Lookup[li]
            if lk.LookupType == 4:
                rules = []
                for st in subtables(lk):
                    for first, ligs in st.ligatures.items():
                        for lig in ligs:
                            rules.append([gid[first], [gid[c] for c in lig.Component], gid[lig.LigGlyph]])
                rules = [r for r in rules if r[0] in glyphs and all(c in glyphs for c in r[1])]
                if rules:
                    ligatures[str(li)] = rules
                    plan["liga"].append(str(li))
                    glyphs.update(r[2] for r in rules)
        for li in lookups_for(gpos, iso):
            lk = gpos.LookupList.Lookup[li]
            if lk.LookupType == 2:
                sts = list(subtables(lk))
                assert all(st.Format == 2 and st.ValueFormat1 == 4 and st.ValueFormat2 == 0
                           for st in sts), "only class-pair XAdvance kerning is laid out"
                kern[str(li)] = sts
                plan["kern"].append(str(li))
            elif lk.LookupType == 4:
                tables = []
                for st in subtables(lk):
                    marks = [[gid[g], rec.Class, anchor(rec.MarkAnchor, gid[g])]
                             for g, rec in zip(st.MarkCoverage.glyphs, st.MarkArray.MarkRecord)
                             if gid[g] in glyphs]
                    bases = [[gid[g], [anchor(a, gid[g]) for a in rec.BaseAnchor]]
                             for g, rec in zip(st.BaseCoverage.glyphs, st.BaseArray.BaseRecord)
                             if gid[g] in glyphs]
                    tables.append({"marks": marks, "bases": bases})
                if any(t["marks"] for t in tables):
                    markbase[str(li)] = tables
                    plan["markbase"].append(str(li))
        if rtl_script(iso):
            assert not plan["liga"] and not plan["markbase"], f"{iso}: only kerning is laid out"
        plans[iso] = plan
    is_mark = {g for g in glyphs if gdef.get(order[g]) == 3}
    return dict(cmap=cmap, glyphs=sorted(glyphs), is_mark=is_mark, plans=plans,
                ligatures=ligatures, kern=kern, markbase=markbase,
                tone=tone, decompose=decompose, gid=gid)


def tone_forms(path, cmap, gid, scripts):
    """The contextual forms HarfBuzz gives a run of tone letters, as
    {"next": [[a, b, form of a before b]], "last": [[a, b, form of b, last
    after a]], "scripts": [...]} in glyph ids, or None where no script
    changes them. The run is laid out in the script's own direction: a
    right-to-left script's run is reversed, given its forms, and reversed
    back. Every run of 2–4 letters in every script is held to the rule."""
    letters = [cp for cp in TONE_LETTERS if cp in cmap]
    g = {cp: gid[cmap[cp]] for cp in letters}
    nxt, last = {}, {}
    for a, b in itertools.product(letters, repeat=2):
        out = hb_glyphs(path, chr(a) + chr(b), "Latn")
        nxt[g[a], g[b]], last[g[a], g[b]] = out
    if all(nxt[k] == k[0] and last[k] == k[1] for k in nxt):
        return None

    def forms(run):
        out = list(run)
        for k in range(len(run) - 1):
            out[k] = nxt[run[k], run[k + 1]]
        out[-1] = last[run[-2], run[-1]]
        return out

    applies = []
    for iso in scripts:
        on = None
        for n in (2, 3, 4):
            for run in itertools.product(letters, repeat=n):
                text = "".join(map(chr, run))
                got = hb_glyphs(path, text, iso)
                ids = [g[cp] for cp in run]
                want = forms(ids[::-1])[::-1] if reversed_run(iso, text) else forms(ids)
                now = got == want
                assert now or got == ids, f"{iso} {text!r}: {got}"
                assert on in (None, now), f"{iso}: the forms apply to some runs only"
                on = now
        if on:
            applies.append(iso)
    return {"next": [[a, b, f] for (a, b), f in sorted(nxt.items())],
            "last": [[a, b, f] for (a, b), f in sorted(last.items())], "scripts": applies}


def kern_arrays(sts, slots, gid_names, fts):
    """Per subtable: class 1 of each slot (-1 where not covered), class 2,
    and the 26.6 deltas [S, C1, C2] at each size."""
    out = []
    for st in sts:
        cov = set(st.Coverage.glyphs)
        c1 = np.full(len(slots), -1, np.int16)
        c2 = np.zeros(len(slots), np.int16)
        for i, g in enumerate(slots):
            name = gid_names[g]
            if name in cov:
                c1[i] = st.ClassDef1.classDefs.get(name, 0)
            c2[i] = st.ClassDef2.classDefs.get(name, 0)
        vals = np.array([[rec.Value1.XAdvance or 0 for rec in row.Class2Record]
                         for row in st.Class1Record], np.int64)
        deltas = []
        for ft in fts:
            x_scale = ft.hb_scale()[0]
            x_mult = (x_scale << 16) // ft.upem
            deltas.append((vals * x_mult + 32768) >> 16)
        out.append((c1, c2, np.stack(deltas).astype(np.int32)))
    return out


def build(chars_noink):
    from fontTools.ttLib import TTFont
    from fontTools.unicodedata import script as unicode_script

    chars, noink = chars_noink
    scripts_of = {cp: unicode_script(chr(cp)) for cp in chars}
    script_names = sorted(set(scripts_of.values()))
    arrays = {
        "script_cp": np.array(sorted(scripts_of), np.uint32),
        "script_ix": np.array([script_names.index(scripts_of[cp]) for cp in sorted(scripts_of)],
                              np.uint8),
    }
    meta = {"sizes": list(SIZES), "script_names": script_names, "faces": [],
            "rtl_scripts": [iso for iso in script_names if rtl_script(iso)]}
    for fi, name in enumerate(DEJAVU_FONTS):
        path = os.path.join(DEJAVU_DIR, name)
        tt = TTFont(path)
        fts = [FTFace(path, s) for s in SIZES]
        t = face_tables(tt, path, chars, scripts_of, fts)
        slots = t["glyphs"]
        p = f"f{fi}/"
        cps = np.array(sorted(t["cmap"]), np.uint32)
        arrays[p + "cmap_cp"] = cps
        arrays[p + "cmap_gid"] = np.array([t["gid"][t["cmap"][int(c)]] for c in cps], np.uint16)
        arrays[p + "gids"] = np.array(slots, np.uint16)
        arrays[p + "is_mark"] = np.array([g in t["is_mark"] for g in slots], np.uint8)
        adv = np.zeros((len(SIZES), len(slots)), np.int32)
        cbox = np.zeros((len(SIZES), len(slots), 4), np.int16)
        ink = np.zeros((len(SIZES), len(slots), 4), np.int16)
        ink_off = np.zeros((len(SIZES), len(slots)), np.int64)
        pix = []
        n_pix = 0
        for si, ft in enumerate(fts):
            for k, g in enumerate(slots):
                box, bm, left, top, advance = ft.glyph(g)
                adv[si, k] = advance
                cbox[si, k] = box
                rows = np.nonzero(bm.any(axis=1))[0]
                cols = np.nonzero(bm.any(axis=0))[0]
                if rows.size:
                    r0, r1, c0, c1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
                    crop = bm[r0:r1, c0:c1]
                    ink[si, k] = (left + c0, top - r0, c1 - c0, r1 - r0)
                    ink_off[si, k] = n_pix
                    pix.append(crop.ravel())
                    n_pix += crop.size
        arrays[p + "adv"], arrays[p + "cbox"], arrays[p + "ink"] = adv, cbox, ink
        arrays[p + "ink_off"] = ink_off
        arrays[p + "pix"] = np.concatenate(pix) if pix else np.zeros(0, np.uint8)
        slot_of = {g: i for i, g in enumerate(slots)}
        names = tt.getGlyphOrder()
        for lk, sts in t["kern"].items():
            for ti, (c1, c2, delta) in enumerate(kern_arrays(sts, slots, names, fts)):
                arrays[f"{p}kern{lk}_{ti}_c1"] = c1
                arrays[f"{p}kern{lk}_{ti}_c2"] = c2
                arrays[f"{p}kern{lk}_{ti}_delta"] = delta
        pil = [ImageFont.truetype(path, s) for s in SIZES]
        meta["faces"].append({
            "file": name,
            "upem": fts[0].upem,
            "hb_scale": [list(ft.hb_scale()) for ft in fts],
            "ascender_px": [int(f.getmetrics()[0]) for f in pil],
            "scripts": t["plans"],
            "default_script_plan": t["plans"]["Zyyy"],
            "ligatures": t["ligatures"],
            "kern": {lk: len(sts) for lk, sts in t["kern"].items()},
            "markbase": t["markbase"],
            "tone": t["tone"],
            "decompose": {iso: {str(cp): gs for cp, gs in d.items()}
                          for iso, d in t["decompose"].items()},
            "noink_cps": noink if name == "DejaVuSans.ttf" else [],
        })
        print(f"{name}: {len(slots)} glyphs, {n_pix} ink bytes a size set, "
              f"kern lookups {sorted(t['kern'])}, ligatures {sorted(t['ligatures'])}, "
              f"markbase {sorted(t['markbase'])}", flush=True)
    return meta, arrays


# -- the check against Pillow -------------------------------------------------


def pil_mask(font, text):
    core, offset = font.getmask2(text, "L")
    return np.asarray(Image.Image()._new(core)), tuple(offset)


def check(atlas: GlyphAtlas, n_random: int, seed: int = 0) -> int:
    """Hold the atlas renderer to Pillow; returns the number of strings."""
    from ppocr_tpu_torch.train.text_render import LayoutUnsupported

    rng = np.random.default_rng(seed)
    n = 0
    for name, face in atlas.faces.items():
        path = os.path.join(DEJAVU_DIR, name)
        chars = [chr(cp) for cp in sorted(face.cmap) if face.cmap[cp] in face.slot_of
                 and cp in atlas._script]
        interesting = [c for c in chars if _interesting(face, c)]
        # every run of 2–3 tone letters, alone and between neighbours of
        # each script that lays them out in its own way
        tones = [c for c in map(chr, TONE_LETTERS) if c in chars]
        around = ["", "a", "1"] + [next((c for c in chars if atlas.script_of(ord(c)) == iso), "")
                                   for iso in sorted(atlas.rtl_scripts | {"Nkoo", "Tfng"})]
        tone_runs = [x + "".join(run) + y for n in (2, 3) for run in itertools.product(tones, repeat=n)
                     for x in around for y in ("", "b")]
        for size in atlas.sizes:
            ours = atlas.font(path, size)
            pil = ImageFont.truetype(path, size)
            texts = list(chars) + tone_runs
            for _ in range(n_random):
                pool = interesting if rng.random() < 0.5 else chars
                k = int(rng.integers(1, 9))
                texts.append("".join(pool[int(i)] for i in rng.integers(len(pool), size=k)))
            for text in texts:
                try:
                    got_box = ours.getbbox(text)
                except LayoutUnsupported:
                    if text in tone_runs:
                        raise
                    continue
                want_box = pil.getbbox(text)
                got_mask, got_off = ours.getmask2(text)
                want_mask, want_off = pil_mask(pil, text)
                if (tuple(got_box) != tuple(want_box) or got_off != want_off
                        or got_mask.shape != want_mask.shape
                        or not np.array_equal(got_mask, want_mask)):
                    raise SystemExit(
                        f"{name} {size}px {text!r} ({[hex(ord(c)) for c in text]}): box "
                        f"{got_box} vs {want_box}, offset {got_off} vs {want_off}, mask "
                        f"{got_mask.shape} vs {want_mask.shape}")
                n += 1
            # the blend into an image, clipped at its edges
            for text in texts[-50:]:
                canvas = np.full((40, 60, 3), 255, np.uint8)
                canvas[::7] = 90
                xy = (int(rng.integers(-20, 50)), int(rng.integers(-20, 30)))
                img = Image.fromarray(canvas.copy())
                ImageDraw.Draw(img).text(xy, text, font=pil, fill=(0, 0, 0))
                try:
                    draw_text(canvas, xy, text, ours, (0, 0, 0))
                except LayoutUnsupported:
                    continue
                if not np.array_equal(canvas, np.asarray(img)):
                    raise SystemExit(f"{name} {size}px draw of {text!r} at {xy} differs")
        print(f"{name}: held to Pillow on {len(texts)} strings at each size", flush=True)
    return n


def _interesting(face, ch: str) -> bool:
    """Characters whose layout depends on their neighbours: kerned,
    ligated, decomposed, bracketing or common-script ones."""
    from ppocr_tpu_torch.train.text_render import _PAIR_INDEX

    cp = ord(ch)
    slot = face.slot_of[face.cmap[cp]]
    kerned = any(int(c1[slot]) >= 0 or int(c2[slot]) > 0
                 for sts in face.kern.values() for c1, c2, _ in sts)
    liga = any(slot in table or any(slot in comps for rules in table.values()
                                     for comps, _ in rules)
               for table in face.ligatures.values())
    # split in some script's run, or of a script whose shaper splits some
    script = face.atlas.script_of(cp)
    split = (any(cp in d for d in face.decompose.values()) or script in face.decompose
             or script in face.atlas.rtl_scripts)
    # a tone letter, and every seventh common-script character, a spread
    # of those
    return (kerned or liga or split or cp in _PAIR_INDEX or cp in TONE_LETTERS
            or face.atlas.script_of(cp) == "Zyyy" and cp % 7 == 0)


def write(meta, arrays, out):
    """An npz (deflate level 9, fixed timestamps: the same atlas gives the
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
    p.add_argument("--check", type=int, default=3000,
                   help="random strings per face and size held to Pillow")
    p.add_argument("--out", default=OUT)
    args = p.parse_args()
    from fontTools.ttLib import TTFont

    sans = TTFont(os.path.join(DEJAVU_DIR, "DejaVuSans.ttf")).getBestCmap()
    meta, arrays = build(characters(sans))
    n = check(GlyphAtlas(meta, arrays), args.check)
    write(meta, arrays, args.out)
    print(f"held to Pillow on {n} strings; wrote {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
