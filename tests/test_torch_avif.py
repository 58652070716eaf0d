"""The port's AVIF decoder (``utils/imcodec.py`` for the ISOBMFF boxes as
libavif 1.4.2 reads them and cv2's hand-over, ``csrc/av1.cpp`` for the AV1
stream, libaom 3.14.1's intra syntax) against ``cv2.imdecode(buf,
IMREAD_COLOR)`` and ``cv2.imread`` (OpenCV 5.0 with libavif and libaom
built in): the same ``None`` or not, and 0 differing pixels.

The files come from cv2's own ``.avif`` writer at quality 100 (lossless:
4:4:4, identity matrix, full range; an alpha item for four channels, a
monochrome stream for one), at every speed, sizes from 1x1 to a few
hundred samples, noise, photo-like gradients and text (where libaom turns
on palette and IntraBC); from Pillow's writer (libavif 1.3: tiles,
sequences, lossy and non-identity files); and from the box writer here
(``avif_file``: missing, misplaced and damaged boxes, essential flags,
``iloc`` versions, construction methods and extents, brands, alpha items).
Then cut, XOR-ed and mutated files (``mutations``, also the fuzz's), and
files read by path.

What cv2 decodes and the port does not yet is named by
``imcodec.AVIF_UNPORTED``: one log line, before any pixel is decoded.
"""

import io
import logging
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.utils import imcodec
from test_torch_tiff import answers, compare, cv2_decode, port_decode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- images ------------------------------------------------------------------------------


def noise(h, w, c, seed):
    shape = (h, w, c) if c > 1 else (h, w)
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def smooth(h, w, c, seed):
    """Photo-like: gradients, edges and a little noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    out = []
    for k in range(max(c, 1)):
        a, b, p = rs.uniform(0.05, 0.4, 3)
        out.append(127 + 80 * np.sin(a * xx + p) * np.cos(b * yy) + 30 * ((xx + 2 * yy + 7 * k) % 23 > 11))
    img = np.clip(np.stack(out, -1) + rs.randint(-3, 4, (h, w, max(c, 1))), 0, 255).astype(np.uint8)
    return img if c > 1 else img[..., 0]


def text(h, w, c, seed):
    """Screen content: lines of black text on white, every fourth blue
    (libaom turns palette and IntraBC on for few colours)."""
    rs = np.random.RandomState(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    y, k = 20, 0
    while y < h + 10:
        colour = (160, 40, 0) if k % 4 == 3 else (0, 0, 0)
        cv2.putText(img, "The quick brown fox 0123456789", (4 - int(rs.randint(0, 3)), y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, colour, 1)
        y, k = y + 22, k + 1
    if c == 4:
        return np.dstack([img, np.where(img[..., :1] > 200, 255, 128).astype(np.uint8)])
    return img if c == 3 else img[..., 0]


def gradient(h, w, seed):
    """A 4x4 random image resized (bicubic) with noise of ±3: where libaom
    picks its 4-way and A/B partitions at slow speeds."""
    rs = np.random.RandomState(seed)
    base = cv2.resize((rs.rand(4, 4, 3) * 255).astype(np.uint8), (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(base.astype(int) + rs.randint(-3, 4, base.shape), 0, 255).astype(np.uint8)


KINDS = {"noise": noise, "smooth": smooth, "text": text}


def cv2_avif(img, speed=6, quality=100, depth=None) -> bytes:
    params = [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_SPEED, speed]
    if depth:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", img, params)
    assert ok
    return buf.tobytes()


def pil_avif(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(buf, "AVIF", **kw)
    return buf.getvalue()


# -- the box writer ------------------------------------------------------------------------


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)


def ispe(w, h):
    return full_box(b"ispe", 0, 0, struct.pack(">II", w, h))


def pixi(*depths):
    return full_box(b"pixi", 0, 0, bytes([len(depths), *depths]))


def colr(cp=2, tc=2, mc=0, full_range=1, reserved=0):
    return box(b"colr", b"nclx" + struct.pack(">HHHB", cp, tc, mc, (full_range << 7) | reserved))


def av1c(b1=0x20, b2=0x00, b0=0x81):
    return box(b"av1C", bytes([b0, b1, b2, 0]))


def auxc(urn=b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"):
    return full_box(b"auxC", 0, 0, urn + b"\0")


def hdlr(kind=b"pict"):
    return full_box(b"hdlr", 0, 0, b"\0" * 4 + kind + b"\0" * 12 + b"\0")


COLOR_PROPS = lambda w, h: [(ispe(w, h), 0), (pixi(8, 8, 8), 0), (av1c(), 1), (colr(), 0)]
ALPHA_PROPS = lambda w, h: [(ispe(w, h), 0), (pixi(8), 0), (av1c(0x00, 0x1C), 1), (auxc(), 0)]


def avif_file(color: bytes, alpha: bytes = None, *, w, h, color_props=None, alpha_props=None, major=b"avif",
              compat=(b"avif", b"mif1", b"miaf"), iloc_version=0, idat=False, split=0, pitm=1, iref=None,
              extra_items=(), ipma_flags=0, order=None, before_meta=b"", offset_size=4, base_offset=0,
              infe_types=(b"av01", b"av01"), method=None, alpha_first=False) -> bytes:
    """A still AVIF of one colour item (id 1), an optional alpha item (id 2,
    ``auxl`` to 1) and ``extra_items`` ((id, type, data, props)), with the
    boxes and their order as asked."""
    items = [(1, infe_types[0], color, COLOR_PROPS(w, h) if color_props is None else color_props)]
    if alpha is not None:
        items.append((2, infe_types[1], alpha, ALPHA_PROPS(w, h) if alpha_props is None else alpha_props))
    items += list(extra_items)
    props, assoc = [], {}
    for item_id, _, _, plist in items:
        for p, essential in plist:
            props.append(p)
            assoc.setdefault(item_id, []).append((len(props), essential))
    entries = b""
    for item_id in sorted(assoc):
        entries += struct.pack(">HB", item_id, len(assoc[item_id]))
        for index, essential in assoc[item_id]:
            entries += (struct.pack(">H", (essential << 15) | index) if ipma_flags & 1
                        else bytes([(essential << 7) | index]))
    iprp = box(b"iprp", box(b"ipco", b"".join(props)) + full_box(b"ipma", 0, ipma_flags,
                                                                 struct.pack(">I", len(assoc)) + entries))
    infes = b"".join(full_box(b"infe", 2, 0, struct.pack(">HH", i, 0) + t + b"item\0") for i, t, _, _ in items)
    iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(items)) + infes)
    if iref is None:
        iref = full_box(b"iref", 0, 0, box(b"auxl", struct.pack(">HHH", 2, 1, 1))) if alpha is not None else b""
    datas = [d for _, _, d, _ in items]
    stored = datas[::-1] if alpha_first else datas

    def iloc(offsets):
        fmt = {4: ">I", 8: ">Q"}
        body = bytes([(offset_size << 4) | 4, (4 if base_offset else 0) << 4])
        body += struct.pack(">H" if iloc_version < 2 else ">I", len(items))
        for (item_id, _, data, _), off in zip(items, offsets):
            body += struct.pack(">H" if iloc_version < 2 else ">I", item_id)
            if iloc_version:
                body += struct.pack(">H", (1 if idat else 0) if method is None else method)
            body += struct.pack(">H", 0)
            if base_offset:
                body += struct.pack(">I", base_offset)
                off = max(off - base_offset, 0)  # the first pass only sizes the box
            cuts = [(0, len(data))] if not split else [(0, split), (split, len(data) - split)]
            body += struct.pack(">H", len(cuts))
            for start, length in cuts:
                body += struct.pack(fmt[offset_size], off + start) + struct.pack(">I", length)
        return full_box(b"iloc", iloc_version, 0, body)

    ftyp = box(b"ftyp", major + b"\0\0\0\0" + b"".join(compat))

    def meta(offsets):
        parts = {"hdlr": hdlr(), "pitm": full_box(b"pitm", 0, 0, struct.pack(">H", pitm)), "iloc": iloc(offsets),
                 "iinf": iinf, "iref": iref, "iprp": iprp, "idat": box(b"idat", b"".join(datas)) if idat else b""}
        return full_box(b"meta", 0, 0, b"".join(parts[k] for k in (order or list(parts))))

    def offsets_from(start):
        at, out = start, {}
        for d in stored:
            out[id(d)] = at
            at += len(d)
        return [out[id(d)] for d in datas]

    if idat:
        return ftyp + before_meta + meta(offsets_from(0))
    head = len(ftyp) + len(before_meta) + len(meta([0] * len(datas))) + 8
    return ftyp + before_meta + meta(offsets_from(head)) + box(b"mdat", b"".join(stored))


def item_data(data: bytes, want: int = 1) -> bytes:
    """An item's bytes by the file's iloc (version 0, 4-byte offsets and
    lengths, no base offset, as cv2 writes it)."""
    at = data.index(b"iloc") + 4
    assert data[at] == 0 and data[at + 4] == 0x44
    count = struct.unpack(">H", data[at + 6:at + 8])[0]
    p = at + 8
    for _ in range(count):
        item_id, _, n = struct.unpack(">HHH", data[p:p + 6])
        p += 6
        chunks = []
        for _ in range(n):
            off, length = struct.unpack(">II", data[p:p + 8])
            chunks.append(data[off:off + length])
            p += 8
        if item_id == want:
            return b"".join(chunks)
    raise KeyError(want)


def read_answers(data: bytes, tmp_path) -> str:
    path = os.path.join(tmp_path, "x.avif")
    with open(path, "wb") as f:
        f.write(data)
    logging.disable(logging.WARNING)
    try:
        return compare(cv2.imread(path, cv2.IMREAD_COLOR), imcodec.read_image(path))
    finally:
        logging.disable(logging.NOTSET)


# -- cv2's lossless files ------------------------------------------------------------------------

SIZES = [(1, 1), (1, 9), (2, 3), (5, 7), (8, 8), (9, 16), (16, 9), (17, 33), (31, 64), (64, 64), (65, 47),
         (100, 37), (128, 128), (150, 221)]


@pytest.mark.parametrize("channels", [3, 4, 1])
@pytest.mark.parametrize("size", SIZES)
def test_cv2s_lossless_files_decode_as_cv2(size, channels, tmp_path):
    """Every size and channel count, with a content and a speed that vary
    with the case (slow speeds on the small sizes only): equal to cv2 by
    ``imdecode`` and ``imread``, and to the source image."""
    h, w = size
    k = SIZES.index(size) * 3 + (3, 4, 1).index(channels)
    kind = list(KINDS)[k % 3]
    speed = k % 11 if h * w <= 64 * 64 else 6 + k % 5
    img = KINDS[kind](h, w, channels, seed=k)
    data = cv2_avif(img, speed)
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"
    got = port_decode(data)
    src = img if channels == 3 else (img[..., :3] if channels == 4 else np.repeat(img[..., None], 3, -1))
    assert (got == src).all()


@pytest.mark.parametrize("speed", range(11))
@pytest.mark.parametrize("kind", list(KINDS))
def test_every_speed_decodes_as_cv2(kind, speed):
    img = KINDS[kind](40, 72, 3, seed=speed + 40)
    assert answers(cv2_avif(img, speed)) == "equal"


# -- tool coverage ------------------------------------------------------------------------------


def coverage_corpus() -> dict:
    """Files that between them reach every tool of the intra syntax."""
    out = {}
    for speed in (0, 2, 4, 6, 8):
        out[f"text_{speed}"] = cv2_avif(text(64, 128, 3, speed), speed)
        out[f"smooth_{speed}"] = cv2_avif(smooth(48, 64, 3, speed), speed)
    for seed in range(4):
        out[f"noise_{seed}"] = cv2_avif(noise(40, 56, 3, seed), 2 + seed)
    out["gradient_a"] = cv2_avif(gradient(96, 96, 1003), 2)
    out["gradient_b"] = cv2_avif(gradient(64, 128, 1009), 2)
    out["ibc"] = cv2_avif(text(128, 256, 3, 7), 6)
    out["two_tiles"] = cv2_avif(noise(8, 4160, 3, 9), 10)
    return out


def decode_stats(stream: bytes) -> np.ndarray:
    status, info, _ = native.av1_info(stream)
    assert status == 0
    stats = np.zeros(native.AV1_STATS_SIZE, np.int32)
    status, _, reason = native.av1_decode(stream, info, stats)
    assert status == 0, reason
    return stats


def test_every_tool_of_the_intra_syntax_is_reached():
    """Each partition type, each luma mode with non-zero angle deltas, CFL,
    palette for Y and for UV (with colours from the cache), filter intra,
    IntraBC, the intra edge filter and upsampling, and a frame of two
    tiles: each counted in a decode that equals cv2's."""
    total = np.zeros(native.AV1_STATS_SIZE, np.int64)
    corpus = coverage_corpus()
    for name, data in corpus.items():
        assert answers(data) == "equal", name
        total += decode_stats(item_data(data))
    s = native.AV1_STATS
    partitions = total[s["partition"][0]:s["partition"][1]]
    y_modes = total[s["y_mode"][0]:s["y_mode"][1]]
    uv_modes = total[s["uv_mode"][0]:s["uv_mode"][1]]
    assert (partitions > 0).all(), partitions
    assert (y_modes > 0).all(), y_modes
    assert uv_modes[13] > 0  # CFL
    for tool in ("angle_delta", "palette_y", "palette_uv", "palette_cache", "filter_intra", "intrabc",
                 "edge_filter", "edge_upsample"):
        assert total[s[tool]] > 0, tool
    assert total[s["tiles"]] == len(corpus) + 1  # the 8x4160 frame has two


def test_pillows_four_tiles_decode_as_cv2():
    """Pillow's lossless 4:4:4 stream in 2x2 tiles, its YUV taken as
    identity-matrix samples: every tile's CDFs start afresh."""
    img = smooth(128, 160, 3, 11)
    stream = item_data(pil_avif(img, quality=100, subsampling="4:4:4", tile_rows=1, tile_cols=1, speed=6))
    assert decode_stats(stream)[native.AV1_STATS["tiles"]] == 4
    assert answers(avif_file(stream, w=160, h=128)) == "equal"


# -- the container --------------------------------------------------------------------------------


def _streams():
    color = item_data(cv2_avif(noise(8, 12, 3, 0)))
    rgba = cv2_avif(noise(8, 12, 4, 1))
    mono = item_data(cv2_avif(noise(8, 12, 1, 2)))
    return color, item_data(rgba, 1), item_data(rgba, 2), mono


def ipma_patched(data: bytes, association: int) -> bytes:
    """The colour item's second property association (its pixi) set to
    ``association``: 0x00 (index 0, not associated) or 0x80 (index 0
    marked essential)."""
    at = data.index(b"ipma") + 4 + 4 + 4 + 2 + 1
    return data[:at + 1] + bytes([association]) + data[at + 2:]


def container_cases() -> dict:
    """name → (file, whether cv2 decodes it)."""
    color, c4, a4, mono = _streams()
    bad_alpha = bytearray(a4)
    bad_alpha[len(a4) // 2] ^= 0xFF
    bad_alpha = bytes(bad_alpha)
    small_alpha = item_data(cv2_avif(noise(4, 6, 4, 3)), 2)
    f = lambda **kw: avif_file(color, w=12, h=8, **kw)
    props = lambda *extra, skip=(): [p for p in COLOR_PROPS(12, 8) if p[0][4:8] not in skip] + list(extra)
    alpha = lambda **kw: avif_file(c4, a4, w=12, h=8, **kw)
    base = f()
    cases = {
        "rebuilt": (base, True),
        "no_pixi": (f(color_props=props(skip=(b"pixi",))), True),
        "pixi_one_plane": (f(color_props=props((pixi(8), 0), skip=(b"pixi",))), True),
        "pixi_depth_10": (f(color_props=props((pixi(10, 10, 10), 0), skip=(b"pixi",))), False),
        "pixi_mixed_depths": (f(color_props=props((pixi(8, 10, 8), 0), skip=(b"pixi",))), False),
        "no_colr": (f(color_props=props(skip=(b"colr",))), True),
        "colr_icc": (f(color_props=props((box(b"colr", b"prof" + b"icc"), 0), skip=(b"colr",))), True),
        "colr_unknown_type": (base.replace(b"nclx", b"zzzz"), True),
        "colr_reserved_bits": (f(color_props=props((colr(reserved=0x6D), 0), skip=(b"colr",))), False),
        "no_ispe": (f(color_props=props(skip=(b"ispe",))), False),
        "ispe_zero": (avif_file(color, w=0, h=8), False),
        "ispe_huge": (avif_file(color, w=40000, h=8), False),
        "ispe_version_1": (base.replace(b"ispe\x00", b"ispe\x01", 1), False),
        "no_av1c": (f(color_props=props(skip=(b"av1C",))), False),
        "av1c_monochrome": (f(color_props=props((av1c(0x20, 0x10), 1), skip=(b"av1C",))), True),
        "av1c_420": (f(color_props=props((av1c(0x00, 0x0C), 1), skip=(b"av1C",))), True),
        "av1c_not_essential": (f(color_props=props((av1c(), 0), skip=(b"av1C",))), True),
        "av1c_marker_0": (base.replace(b"av1C\x81", b"av1C\x01", 1), False),
        "av1c_version_2": (base.replace(b"av1C\x81", b"av1C\x82", 1), False),
        "irot_essential": (f(color_props=props((box(b"irot", b"\x01"), 1))), True),
        "irot_not_essential": (f(color_props=props((box(b"irot", b"\x01"), 0))), False),
        "irot_reserved_bits": (f(color_props=props((box(b"irot", b"\x05"), 1))), False),
        "imir_essential": (f(color_props=props((box(b"imir", b"\x01"), 1))), True),
        "clap_essential": (f(color_props=props((box(b"clap", struct.pack(">8I", 8, 1, 6, 1, 0, 1, 0, 1)), 1))),
                           True),
        "clap_invalid": (f(color_props=props((box(b"clap", struct.pack(">8I", 20, 1, 6, 1, 0, 1, 0, 1)), 1))),
                         True),
        "clap_short": (f(color_props=props((box(b"clap", b"\0" * 20), 1))), False),
        "unknown_essential": (f(color_props=props((box(b"zzzz", b"ab"), 1))), False),
        "unknown_not_essential": (f(color_props=props((box(b"zzzz", b"ab"), 0))), True),
        "a1lx_essential": (f(color_props=props((box(b"a1lx", b"\0" * 7), 1))), False),
        "major_mif1": (f(major=b"mif1"), True),
        "major_mif1_no_avif": (f(major=b"mif1", compat=(b"mif1", b"miaf")), False),
        "only_major_brand": (f(compat=()), True),
        "major_avis_no_moov": (f(major=b"avis"), False),
        "brands_avis_avif_no_moov": (f(major=b"mif1", compat=(b"avis", b"avif")), False),
        "brand_cut": (f(compat=(b"avi",)), False),
        "pitm_other_item": (f(pitm=2), False),
        "no_pitm": (f(order=["hdlr", "iloc", "iinf", "iref", "iprp"]), False),
        "two_pitm": (f(order=["hdlr", "pitm", "pitm", "iloc", "iinf", "iref", "iprp"]), False),
        "hdlr_not_first": (f(order=["pitm", "hdlr", "iloc", "iinf", "iref", "iprp"]), False),
        "hdlr_vide": (base.replace(b"pict", b"vide", 1), False),
        "iprp_first_after_hdlr": (f(order=["hdlr", "iprp", "pitm", "iloc", "iinf", "iref"]), True),
        "no_iinf": (f(order=["hdlr", "pitm", "iloc", "iref", "iprp"]), False),
        "no_iprp": (f(order=["hdlr", "pitm", "iloc", "iinf", "iref"]), False),
        "no_iloc": (f(order=["hdlr", "pitm", "iinf", "iref", "iprp"]), False),
        "item_type_mime": (f(infe_types=(b"mime", b"av01")), False),
        "meta_version_1": (base.replace(b"meta\x00", b"meta\x01", 1), False),
        "meta_flags": (base.replace(b"meta\x00\x00\x00\x00", b"meta\x00\x00\x00\x01", 1), True),
        "iloc_version_1": (f(iloc_version=1), True),
        "iloc_version_2": (f(iloc_version=2), True),
        "iloc_idat": (f(iloc_version=1, idat=True), True),
        "iloc_method_2": (f(iloc_version=1, method=2), False),
        "iloc_two_extents": (f(split=5), True),
        "iloc_8_byte_offsets": (f(offset_size=8), True),
        "iloc_base_offset": (f(base_offset=40), True),
        "ipma_15_bit_indices": (f(ipma_flags=1), True),
        "ipma_index_0": (ipma_patched(base, 0x00), True),
        "ipma_essential_index_0": (ipma_patched(base, 0x80), False),
        "free_box_before_ftyp": (box(b"free", b"xx") + base, False),
        "meta_at_500": (f(before_meta=box(b"free", b"\0" * (500 - 28 - 8))), True),
        "meta_at_501": (f(before_meta=box(b"free", b"\0" * (501 - 28 - 8))), False),
        # no nclx: the signature check reads the colour item, here past 500 bytes
        "no_nclx_data_past_500": (avif_file(c4, a4, w=12, h=8, color_props=props(skip=(b"colr",)), alpha_first=True,
                                            before_meta=box(b"free", b"\0" * 40)), False),
        "no_nclx_data_before_500": (avif_file(c4, a4, w=12, h=8, color_props=props(skip=(b"colr",))), True),
        "trailing_junk": (base + b"junk" * 3, True),
        "trailing_zeros": (base + b"\0" * 8, True),
        "mdat_size_0": (base[:len(base) - len(color) - 8] + b"\0\0\0\0mdat" + color, True),
        "extra_item_without_ispe": (f(extra_items=[(3, b"av01", color, [(av1c(), 1)])]), False),
        "thumbnail_without_ispe": (f(extra_items=[(3, b"av01", color, [(av1c(), 1)])],
                                     iref=full_box(b"iref", 0, 0, box(b"thmb", struct.pack(">HHH", 3, 1, 1)))), True),
        "alpha": (alpha(), True),
        "alpha_damaged": (avif_file(c4, bad_alpha, w=12, h=8), False),
        "alpha_cut": (avif_file(c4, a4[:len(a4) // 2], w=12, h=8), False),
        "alpha_without_auxc_damaged": (avif_file(c4, bad_alpha, w=12, h=8, alpha_props=ALPHA_PROPS(12, 8)[:3]), True),
        "alpha_other_urn_damaged": (avif_file(c4, bad_alpha, w=12, h=8,
                                              alpha_props=ALPHA_PROPS(12, 8)[:3] + [(auxc(b"urn:x"), 0)]), True),
        "alpha_with_monochrome_av1c": (avif_file(c4, a4, w=12, h=8, color_props=COLOR_PROPS(12, 8)[:2] + [
            (av1c(0x20, 0x10), 1)]), False),
        "iref_to_item_0": (alpha(iref=full_box(b"iref", 0, 0, box(b"auxl", struct.pack(">HHH", 2, 1, 0)))), False),
        "iloc_reserved_bits": (f(iloc_version=1, method=0x101), False),
        "alpha_hevc_urn_damaged": (avif_file(c4, bad_alpha, w=12, h=8, alpha_props=ALPHA_PROPS(12, 8)[:3] + [
            (auxc(b"urn:mpeg:hevc:2015:auxid:1"), 0)]), False),
        "alpha_without_ispe": (alpha(alpha_props=ALPHA_PROPS(12, 8)[1:]), True),
        "alpha_other_ispe": (alpha(alpha_props=[(ispe(6, 4), 0)] + ALPHA_PROPS(12, 8)[1:]), False),
        "alpha_without_av1c": (alpha(alpha_props=[ALPHA_PROPS(12, 8)[i] for i in (0, 1, 3)]), False),
        "alpha_pixi_10": (alpha(alpha_props=[(ispe(12, 8), 0), (pixi(10), 0)] + ALPHA_PROPS(12, 8)[2:]), False),
        "alpha_unknown_essential": (alpha(alpha_props=ALPHA_PROPS(12, 8) + [(box(b"zzzz", b""), 1)]), True),
        "alpha_smaller_stream": (avif_file(c4, small_alpha, w=12, h=8), True),
        "alpha_no_props": (alpha(alpha_props=[]), False),
        "mono": (avif_file(mono, w=12, h=8, color_props=[(ispe(12, 8), 0), (pixi(8), 0), (av1c(0x00, 0x1C), 1),
                                                         (colr(2, 2, 2), 0)]), True),
        "mono_limited_range": (avif_file(mono, w=12, h=8, color_props=[(ispe(12, 8), 0), (pixi(8), 0),
                                                                       (av1c(0x00, 0x1C), 1), (colr(2, 2, 2, 0), 0)]),
                               True),
        "mono_stream_as_colour": (avif_file(mono, w=12, h=8, color_props=[(ispe(12, 8), 0), (pixi(8), 0),
                                                                          (av1c(0x00, 0x00), 1), (colr(2, 2, 2), 0)]),
                                  True),
    }
    return cases


CONTAINERS = container_cases()


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_boxes_and_items_answer_as_cv2(name, tmp_path):
    data, decodes = CONTAINERS[name]
    assert (cv2_decode(data) is not None) == decodes
    assert answers(data) in ("none", "equal")
    assert read_answers(data, tmp_path) in ("none", "equal")


def test_the_container_cases_decode_where_they_should():
    got = [answers(d) for d, _ in CONTAINERS.values()]
    assert got.count("equal") >= 35 and got.count("none") >= 30


# -- damage ----------------------------------------------------------------------------------


def mutations(data: bytes, n: int, seed: int) -> list:
    """``n`` damaged copies: cuts, one or two bytes XOR-ed in the boxes, in
    the AV1 headers (the first 40 bytes of the media data) or anywhere, a
    bit flipped in the tile data, bytes set to 0, 0xFF, 0x80, 1 or 0x7F,
    and four random bytes in the media data."""
    rs = np.random.RandomState(seed)
    mdat = data.rindex(b"mdat") + 4 if b"mdat" in data else len(data) // 2
    out = []
    for _ in range(n):
        d = bytearray(data)
        kind = rs.randint(6)
        if kind == 0:
            d = d[:rs.randint(1, len(d))]
        elif kind == 1:
            for _ in range(rs.randint(1, 3)):
                d[rs.randint(mdat)] ^= rs.randint(1, 256)
        elif kind == 2:
            for _ in range(rs.randint(1, 3)):
                d[rs.randint(mdat, min(len(d), mdat + 40))] ^= rs.randint(1, 256)
        elif kind == 3:
            d[rs.randint(mdat, len(d))] ^= 1 << rs.randint(8)
        elif kind == 4:
            d[rs.randint(len(d))] = rs.choice([0x00, 0xFF, 0x80, 0x01, 0x7F])
        else:
            at = rs.randint(mdat, len(d))
            d[at:at + 4] = bytes(rs.randint(0, 256, 4).tolist())
        out.append(bytes(d))
    return out


def fuzz_bases() -> dict:
    """Small files of each kind the fuzz changes."""
    big_text = text(128, 256, 3, 3)
    return {
        "noise": cv2_avif(noise(24, 40, 3, 1)),
        "text": cv2_avif(text(64, 128, 3, 2), 6),
        "smooth": cv2_avif(smooth(30, 40, 3, 3), 2),
        "alpha": cv2_avif(noise(20, 28, 4, 4)),
        "grey": cv2_avif(noise(20, 28, 1, 5)),
        "intrabc": cv2_avif(big_text, 6),
        "idat": CONTAINERS["iloc_idat"][0],
        "two_extents": CONTAINERS["iloc_two_extents"][0],
    }


# -- top-level boxes of size 0 ------------------------------------------------------------------
# A box of size 0 runs to the end of its file. cv2's signature check parses
# the first 500 bytes (a file under 500 bytes padded with spaces by
# imdecode's findDecoder) with libavif's IO size hint at 1e9, so a meta of
# size 0 runs to the window's end there: its parse fails on the mdat header
# the window cuts, or on the padding, unless the window ends where a box
# ends. libavif's own full parse takes all of these (the mdat as a child of
# the meta).


def _zero_size(data: bytes, kind: bytes) -> bytes:
    """``data`` with the size of its first top-level ``kind`` box set to 0."""
    pos = 0
    while data[pos + 4:pos + 8] != kind:
        pos += struct.unpack(">I", data[pos:pos + 4])[0]
    return data[:pos] + b"\0\0\0\0" + data[pos + 4:]


def size_zero_files() -> dict:
    """Files with a top-level box of size 0: the meta (cv2's 3.9 kB
    lossless file, after a free box of each size, ending around the
    window's end, a file under 500 bytes and one of 500), the mdat, a
    trailing free box, a free box before the meta, the ftyp."""
    stream, small = item_data(cv2_avif(smooth(32, 48, 3, 30))), item_data(cv2_avif(smooth(8, 8, 3, 1)))
    free = lambda n: box(b"free", bytes(n - 8)) if n else b""
    base = avif_file(stream, w=48, h=32)
    ftyp_len = struct.unpack(">I", base[:4])[0]
    meta_len = struct.unpack(">I", base[ftyp_len:ftyp_len + 4])[0]
    out = {"meta": _zero_size(base, b"meta")}
    for n in (16, 240, 440, 480, 492, 600):
        out[f"meta_after_free_{n}"] = _zero_size(avif_file(stream, w=48, h=32, before_meta=free(n)), b"meta")
    for k in (-8, -1, 0, 1, 8):
        padded = avif_file(stream, w=48, h=32, iref=free(AVIF_WINDOW - ftyp_len - meta_len + k))
        out[f"meta_ending_at_{AVIF_WINDOW + k}"] = _zero_size(padded, b"meta")
    small_file = avif_file(small, w=8, h=8)
    out["meta_in_a_file_under_500"] = _zero_size(small_file, b"meta")
    out["meta_in_a_file_of_500"] = _zero_size(avif_file(small, w=8, h=8, iref=free(AVIF_WINDOW - len(small_file))),
                                              b"meta")
    out["mdat"] = _zero_size(base, b"mdat")
    out["free_trailing"] = base + b"\0\0\0\0free" + bytes(20)
    out["free_before_meta"] = avif_file(stream, w=48, h=32, before_meta=b"\0\0\0\0free")
    out["ftyp"] = _zero_size(base, b"ftyp")
    return out


AVIF_WINDOW = 500  # cv2's AVIF_SIGNATURE_SIZE
SIZE_ZERO = size_zero_files()
# what cv2 5.0 answers (None: its signature check fails, or the file is bad)
SIZE_ZERO_DECODED = {"meta_ending_at_500", "meta_in_a_file_of_500", "mdat", "free_trailing"}


@pytest.mark.parametrize("name", list(SIZE_ZERO))
def test_a_top_level_box_of_size_0_answers_as_cv2(name):
    data = SIZE_ZERO[name]
    assert (cv2_decode(data) is not None) == (name in SIZE_ZERO_DECODED)
    assert answers(data) == ("equal" if name in SIZE_ZERO_DECODED else "none")


BASES = fuzz_bases()
# a meta box of size 0 that ends where the signature window ends: cv2 takes it
BASES["meta_size_0"] = SIZE_ZERO["meta_ending_at_500"]


def box_offsets(data: bytes) -> list:
    """Every box's start within the file (top-level, meta's and iprp's)."""
    out = []

    def walk(a, b, depth):
        while a + 8 <= b:
            size, kind = struct.unpack(">I4s", data[a:a + 8])
            size = size or b - a
            out.append(a)
            if kind in (b"meta",) and depth < 3:
                walk(a + 12, min(b, a + size), depth + 1)
            elif kind in (b"iprp", b"ipco", b"iinf", b"iref", b"dinf") and depth < 3:
                walk(a + (14 if kind == b"iinf" else 12 if kind == b"iref" else 8), min(b, a + size), depth + 1)
            if size < 8:
                break
            a += size

    walk(0, len(data), 0)
    return out


@pytest.mark.parametrize("name", list(BASES))
def test_every_cut_at_a_box_and_stepped_cuts_answer_as_cv2(name):
    data = BASES[name]
    cuts = {at + k for at in box_offsets(data) for k in (0, 1, 4, 8)}
    cuts |= set(np.linspace(1, len(data) - 1, 40).astype(int).tolist())
    got = [answers(data[:k]) for k in sorted(cuts) if 0 < k < len(data)]
    assert set(got) <= {"none", "equal", "known"}, got


@pytest.mark.parametrize("name", ["noise", "alpha", "grey", "idat"])
def test_every_box_byte_xored_answers_as_cv2(name):
    """Each byte before the media data (the boxes) and of the AV1 item's
    first 48 bytes (OBU headers, the sequence header, the frame header)
    XOR-ed with 0x01, 0x10 and 0xFF."""
    data = BASES[name]
    mdat = data.rindex(b"mdat") + 4 if b"mdat" in data else data.index(b"idat") + 4
    got = []
    for i in list(range(mdat)) + list(range(mdat, min(len(data), mdat + 48))):
        for x in (0x01, 0x10, 0xFF):
            d = bytearray(data)
            d[i] ^= x
            got.append(answers(bytes(d)))
    assert set(got) <= {"none", "equal", "known"}, sorted(set(got))


@pytest.mark.parametrize("name", list(BASES))
def test_mutated_files_answer_as_cv2(name):
    got = [answers(d) for d in mutations(BASES[name], 300, seed=list(BASES).index(name) + 7)]
    assert set(got) <= {"none", "equal", "known"}, sorted(set(got))
    assert got.count("equal") >= 5


def test_damaged_files_by_path_answer_as_cv2_imread(tmp_path):
    datas = [d for i, data in enumerate(BASES.values()) for d in mutations(data, 10, seed=i + 400)]
    assert {read_answers(d, tmp_path) for d in datas} <= {"none", "equal"}


# -- refusals and the build ---------------------------------------------------------------------


def _grid() -> bytes:
    """A 'grid' primary item of two cv2 tiles, which cv2 decodes."""
    left, right = (item_data(cv2_avif(smooth(64, 64, 3, k))) for k in (20, 21))
    grid = bytes([0, 0, 0, 1]) + struct.pack(">HH", 128, 64)
    tile_props = lambda: [(ispe(64, 64), 0), (pixi(8, 8, 8), 0), (av1c(), 1)]
    return avif_file(grid, w=128, h=64, color_props=[(ispe(128, 64), 0), (colr(), 0)], infe_types=(b"grid",),
                     extra_items=[(2, b"av01", left, tile_props()), (3, b"av01", right, tile_props())],
                     iref=full_box(b"iref", 0, 0, box(b"dimg", struct.pack(">HHHH", 1, 2, 2, 3))))


def _sequence() -> bytes:
    """Pillow's lossless 4:4:4 sequence of two frames, once refused."""
    img = smooth(32, 48, 3, 30)
    frames = [Image.fromarray(img), Image.fromarray(255 - img)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], quality=100, subsampling="4:4:4")
    return buf.getvalue()


def _refusals() -> dict:
    img = smooth(32, 48, 3, 30)
    color, c4, a4, _ = _streams()
    prem = full_box(b"iref", 0, 0, box(b"auxl", struct.pack(">HHH", 2, 1, 1)) + box(b"prem", struct.pack(">HHH", 1, 1, 2)))
    # subsampled chroma, every matrix and both ranges are decoded since
    # (tests/test_torch_avif_chroma.py, test_torch_avif_colour.py), and so
    # are the deblocking filter and CDEF (test_torch_avif_deblock.py,
    # test_torch_avif_cdef.py), loop restoration
    # (test_torch_avif_restoration.py; the files once refused for them:
    # FILTERED below), film grain and superres (test_torch_avif_grain.py,
    # test_torch_avif_superres.py; GRAINED below), and image sequences'
    # first frames (test_torch_avif_sequence.py, which holds the refusal of
    # inter and intra-only frames; SEQUENCE below): a frame is refused now
    # only for what ROADMAP A14.7c ports
    return {
        "10-bit": (cv2_avif(img.astype(np.uint16) * 4, depth=10), "10/12-bit samples (ROADMAP A14.7c)"),
        "grid": (_grid(), "grids (ROADMAP A14.7c)"),
        "scaled": (avif_file(color, w=13, h=8), "a frame scaled to its ispe size (ROADMAP A14.7c)"),
        "prem": (avif_file(c4, a4, w=12, h=8, iref=prem), "premultiplied alpha (prem) (ROADMAP A14.7c)"),
        "a1op": (avif_file(color, w=12, h=8, color_props=COLOR_PROPS(12, 8) + [(box(b"a1op", b"\x01"), 1)]),
                 "layered images (a1op, lsel) (ROADMAP A14.7c)"),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("name", list(REFUSALS))
def test_what_cv2_decodes_and_the_port_does_not_gives_none_and_one_log_line_naming_it(name, caplog):
    data, reason = REFUSALS[name]
    assert cv2_decode(data) is not None
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is None
    lines = [r.getMessage() for r in caplog.records if r.name == "ppocr_tpu_torch.utils.imcodec"]
    assert len(lines) == 1 and lines[0].startswith("AVIF payload not decoded") and reason in lines[0], lines
    assert answers(data) == "known"


def _filtered() -> dict:
    """Files refused until their deblocking filter, CDEF and loop
    restoration were decoded."""
    img = smooth(32, 48, 3, 30)
    return {
        # Pillow's 4:4:4 q40 file at speed 4 restores chroma (Wiener)
        "restoration": pil_avif(smooth(64, 96, 3, 30), quality=40, subsampling="4:4:4", speed=4),
        # Pillow's speed-6 q80 4:4:4 stream turns deblocking on (levels 2/2)
        "lossy": avif_file(item_data(pil_avif(img, quality=80, subsampling="4:4:4", speed=6)), w=48, h=32),
        # cv2's q90 4:2:0 file runs deblocking (level 1)
        "420": cv2_avif(img, quality=90),
        # Pillow's default file (4:2:0, matrix 2) runs deblocking
        "matrix": pil_avif(img),
    }


FILTERED = _filtered()


def _grained() -> dict:
    """Files refused until film grain and superres were decoded."""
    img = smooth(32, 48, 3, 30)
    grain = pil_avif(img, quality=60, subsampling="4:2:0", speed=6,
                     advanced=[("enable-cdef", "0"), ("enable-restoration", "0"), ("loopfilter-control", "0"),
                               ("film-grain-test", "1")])
    return {
        # a 4:2:0 frame with film grain, in a limited-range container
        "limited": avif_file(item_data(grain), w=48, h=32, color_props=[(ispe(48, 32), 0), (pixi(8, 8, 8), 0),
                                                                         (av1c(0x00, 0x0C), 1), (colr(1, 13, 6, 0), 0)]),
    }


GRAINED = _grained()
SEQUENCE = _sequence()


def test_what_was_refused_as_a_sequence_decodes_as_cv2(tmp_path):
    assert answers(SEQUENCE) == "equal"
    assert read_answers(SEQUENCE, tmp_path) == "equal"


@pytest.mark.parametrize("name", list(GRAINED))
def test_what_was_refused_for_superres_and_film_grain_decodes_as_cv2(name, tmp_path):
    data = GRAINED[name]
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"
    stats = decode_stats(item_data(data))
    assert stats[native.AV1_STATS["grain"][0]:native.AV1_STATS["grain"][1]].all()


@pytest.mark.parametrize("name", list(FILTERED))
def test_what_was_refused_for_its_in_loop_filters_decodes_as_cv2(name, tmp_path):
    data = FILTERED[name]
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"
    stats = decode_stats(item_data(data))
    assert stats[native.AV1_STATS["lf_edges"][0]:native.AV1_STATS["lf_edges"][1]].sum() > 0
    if name == "restoration":
        assert stats[native.AV1_STATS["lr_units"][0]:native.AV1_STATS["lr_units"][1]].reshape(3, 3)[1:, 1].all()


def test_what_the_port_does_not_decode_is_pinned():
    assert imcodec.AVIF_UNPORTED == {
        "10/12-bit samples": "A14.7c", "grids": "A14.7c", "inter and intra-only frames": "A14.7c",
        "layered images (a1op, lsel)": "A14.7c", "a frame scaled to its ispe size": "A14.7c",
        "premultiplied alpha (prem)": "A14.7c"}
    # the refusal of inter and intra-only frames is held in test_torch_avif_sequence.py
    assert {reason.split(" (ROADMAP")[0] for _, reason in REFUSALS.values()} == (
        set(imcodec.AVIF_UNPORTED) - {"inter and intra-only frames"})
    assert imcodec.sniff_format(BASES["noise"]) == imcodec.sniff_format(CONTAINERS["major_mif1"][0]) == "avif"
    assert not imcodec.FORMAT_NAMES


def test_an_avif_decode_raises_when_its_decoder_cannot_be_built(monkeypatch):
    """A missing compiler is not a bad image: the decode raises and never
    falls back."""

    def no_compiler(source=None):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(native, "_av1_lib", None)
    monkeypatch.setattr(native, "build", no_compiler)
    with pytest.raises(RuntimeError, match="compiler"):
        imcodec.decode_image(BASES["noise"])


def test_the_tables_are_libaoms_byte_for_byte():
    """``csrc/av1_tables.h`` is what ``scripts/make_av1_tables_torch.py``
    takes from the cv2 wheel's libaom 3.14.1 today."""
    run = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_av1_tables_torch.py"), "--check"],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "reproduced byte for byte" in run.stdout


# -- what the card decodes, and the fuzz ----------------------------------------------------------


def written_cases() -> dict:
    """A spread of the cases above for ``assets/image_cases.npz`` (the card
    has no cv2 to make or decode them): cv2's files of each size, channel
    count and speed, the tool corpus, the container cases, and cut and
    mutated files; none that the port names as not decoded."""
    cases = {}
    for k, (h, w) in enumerate(SIZES[:11]):
        channels = (3, 4, 1)[k % 3]
        cases[f"cv2_{h}x{w}_{channels}"] = cv2_avif(list(KINDS.values())[k % 3](h, w, channels, k), k % 11)
    for name, data in coverage_corpus().items():
        if name != "two_tiles" and len(data) < 40_000:
            cases[f"tools_{name}"] = data
    cases.update({f"box_{k}": v for k, (v, _) in CONTAINERS.items()})
    for i, (name, data) in enumerate(BASES.items()):
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 6, seed=i + 900))})
        cases[f"{name}_cut"] = data[: len(data) * 2 // 3]
    return {k: v for k, v in cases.items() if answers(v) != "known"}


def scene_payload(scene: np.ndarray) -> dict:
    """A serving scene as the smoke run's AVIF timing input and request:
    cv2's lossless file at its default speed."""
    return {"scene0_avif": cv2_avif(scene)}


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's files: ``n`` mutations of each base and every cut
    of the smaller ones."""
    files = []
    for i, data in enumerate(BASES.values()):
        files += mutations(data, n, seed=10000 * round_ + i)
        if len(data) < 4000:
            files += [data[:k] for k in range(1, len(data))]
    return files


def test_the_smoke_cases_and_payloads_decode_as_cv2():
    cases = {**written_cases(), **scene_payload(smooth(64, 96, 3, 5))}
    got = [answers(d) for d in cases.values()]
    assert set(got) <= {"none", "equal", "known"} and got.count("equal") >= 60


# -- the full header forms ------------------------------------------------------------------------


class Bits:
    """An MSB-first bit writer."""

    def __init__(self):
        self.bits = []

    def f(self, value: int, n: int):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def uvlc(self, value: int):
        n = (value + 1).bit_length() - 1
        return self.f(0, n).f(1, 1).f(value + 1 - (1 << n), n)

    def trailing(self) -> bytes:
        out = self.bits + [1] + [0] * ((8 - (len(self.bits) + 1) % 8) % 8)
        return bytes(int("".join(map(str, out[i:i + 8])), 2) for i in range(0, len(out), 8))


def bits_of(data: bytes) -> list:
    return [(b >> (7 - i)) & 1 for b in data for i in range(8)]


def uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def obu(kind: int, payload: bytes, ext=None) -> bytes:
    head = bytes([(kind << 3) | (4 if ext is not None else 0) | 2])
    if ext is not None:
        head += bytes([(ext[0] << 5) | (ext[1] << 3)])
    return head + uleb(len(payload)) + payload


def split_obus(stream: bytes) -> list:
    out, at = [], 0
    while at < len(stream):
        kind, ext = (stream[at] >> 3) & 15, (stream[at] >> 2) & 1
        at += 1 + ext
        size, shift = 0, 0
        while True:
            size |= (stream[at] & 0x7F) << shift
            shift += 7
            at += 1
            if not stream[at - 1] & 0x80:
                break
        out.append((kind, stream[at:at + size]))
        at += size
    return out


def full_headers(stream: bytes, *, timing=None, decoder_model=None, display_delay=None, ops=(0,), levels=None,
                 frame_ids=None, order_hint_bits=0, still=1, extra=b"", ext=None) -> bytes:
    """A still stream of cv2's (reduced still-picture header) rewritten with
    the full sequence and frame header forms: timing info (``timing``:
    equal_picture_interval, num_ticks), a decoder model (``decoder_model``:
    buffer delay length, removal time length, presentation time length,
    per-op (delay, delay, low delay) or None), initial display delays, the
    operating points ``ops`` (their idc) and ``levels``, frame ids of
    ``frame_ids`` bits (chosen so that the frame header grows by whole
    bytes when None is not given) and order hints. The tile data is kept
    as it was; ``extra`` OBUs go between the sequence header and the frame."""
    obus = split_obus(stream)
    seq = bits_of(next(p for k, p in obus if k == 1))
    frame = next(p for k, p in obus if k == 6)
    assert seq[4] == 1, "not a reduced still-picture header"
    pos = 10  # profile, still, reduced, seq_level_idx
    wb, hb = int("".join(map(str, seq[pos:pos + 4])), 2) + 1, int("".join(map(str, seq[pos + 4:pos + 8])), 2) + 1
    size_bits = seq[pos:pos + 8 + wb + hb]
    pos += 8 + wb + hb
    sb_tools = seq[pos:pos + 3]  # use_128x128, enable_filter_intra, enable_intra_edge_filter
    pos += 3
    end = len(seq) - 1 - seq[::-1].index(1)  # the trailing one bit
    rest = seq[pos:end]  # enable_superres, cdef, restoration, color_config, film_grain_params_present
    assert rest[0] == 0, "superres"
    w = Bits().f(int("".join(map(str, seq[:3])), 2), 3).f(still, 1).f(0, 1)
    w.f(timing is not None, 1)
    if timing is not None:
        equal, ticks = timing
        w.f(1, 32).f(30, 32).f(equal, 1)
        if equal:
            w.uvlc(ticks)
        w.f(decoder_model is not None, 1)
        if decoder_model is not None:
            delay_len, removal_len, presentation_len, _ = decoder_model
            w.f(delay_len - 1, 5).f(1, 32).f(removal_len - 1, 5).f(presentation_len - 1, 5)
    w.f(display_delay is not None, 1)
    w.f(len(ops) - 1, 5)
    for i, idc in enumerate(ops):
        level = (levels or [0] * len(ops))[i]
        w.f(idc, 12).f(level, 5)
        if level > 7:
            w.f(0, 1)
        if decoder_model is not None:
            per_op = decoder_model[3]
            w.f(per_op is not None, 1)
            if per_op is not None:
                w.f(per_op[0], decoder_model[0]).f(per_op[1], decoder_model[0]).f(per_op[2], 1)
        if display_delay is not None:
            w.f(1, 1).f(display_delay, 4)
    w.bits += size_bits
    # frame_id_numbers_present_flag: the length gives the frame header whole bytes
    fb = bits_of(frame)
    sct = fb[1]
    head = 2 + sct  # disable_cdf_update, allow_screen_content_tools, force_integer_mv
    grow = 4 + 1 + order_hint_bits + (0 if fb[0] else 1)
    if timing is not None and decoder_model is not None:
        grow += (0 if timing[0] else decoder_model[2]) + 1 + (decoder_model[1] if decoder_model[3] else 0)
    id_len = frame_ids if frame_ids is not None else (-grow) % 8 or 8
    if frame_ids is None and id_len < 3:
        id_len += 8
    grow += id_len
    assert grow % 8 == 0 or frame_ids is not None, grow  # a given length may misalign a file refused anyway
    w.f(1, 1).f(id_len - 3, 4).f(0, 3)  # delta_frame_id_length id_len - 1, additional 1
    w.bits += sb_tools
    w.f(0, 4)  # interintra, masked, warped, dual filter
    w.f(order_hint_bits > 0, 1)
    if order_hint_bits:
        w.f(0, 2)  # jnt_comp, ref_frame_mvs
    w.f(1, 1).f(1, 1)  # choose screen content tools, choose integer mv
    if order_hint_bits:
        w.f(order_hint_bits - 1, 3)
    w.bits += rest
    f = Bits().f(0, 1).f(0, 2).f(1, 1)  # show_existing_frame, KEY_FRAME, show_frame
    if timing is not None and decoder_model is not None and not timing[0]:
        f.f(5, decoder_model[2])  # frame_presentation_time
    f.bits += fb[:head]
    f.f(3, id_len).f(0, 1).f(0, order_hint_bits)  # current_frame_id, frame_size_override_flag, order_hint
    if timing is not None and decoder_model is not None:
        f.f(decoder_model[3] is not None, 1)
        if decoder_model[3] is not None:
            f.f(7, decoder_model[1])
    render = fb[head]
    assert render == 0
    f.f(0, 1)
    tail = head + 1
    if sct:
        f.f(fb[tail], 1)  # allow_intrabc
        tail += 1
    if not fb[0]:
        f.f(1, 1)  # disable_frame_end_update_cdf
    f.bits += fb[tail:]
    f.bits += [0] * (-len(f.bits) % 8)
    new_frame = bytes(int("".join(map(str, f.bits[i:i + 8])), 2) for i in range(0, len(f.bits), 8))
    return obu(2, b"", ext) + obu(1, w.trailing(), ext) + extra + obu(6, new_frame, ext)


def header_variants() -> dict:
    color = item_data(cv2_avif(smooth(24, 40, 3, 60)))
    text_stream = item_data(cv2_avif(text(64, 96, 3, 61), 6))
    hdr_cll = obu(5, uleb(1) + b"\x01\x02\x03\x04" + b"\x80")
    t35 = obu(5, uleb(4) + b"\xb5\x00\x3c\x01\x80")
    timecode = obu(5, uleb(5) + Bits().f(0, 5).f(1, 1).f(0, 2).f(3, 9).f(1, 17).f(0, 5).trailing())
    return {
        "full_plain": full_headers(color),
        "full_screen_content": full_headers(text_stream),
        "timing_equal_interval": full_headers(color, timing=(1, 5)),
        "timing": full_headers(color, timing=(0, 0)),
        "decoder_model": full_headers(color, timing=(0, 0), decoder_model=(10, 12, 6, (3, 4, 1))),
        "decoder_model_no_op_params": full_headers(color, timing=(1, 0), decoder_model=(10, 12, 6, None)),
        "display_delay": full_headers(color, display_delay=4),
        "display_delay_over_10": full_headers(color, display_delay=12),
        "two_operating_points": full_headers(color, ops=(0x101, 0x103), levels=(8, 9)),
        "level_4_2": full_headers(color, levels=(10,)),
        "level_7_0": full_headers(color, levels=(20,)),
        "level_31": full_headers(color, levels=(31,)),
        "timing_level_31": full_headers(color, timing=(1, 0), levels=(31,)),
        "num_ticks_2_32_minus_1": full_headers(color, timing=(1, 2 ** 32 - 1)),
        "order_hints": full_headers(color, order_hint_bits=7),
        "not_still": full_headers(color, still=0),
        "frame_id_17_bits": full_headers(color, frame_ids=17, order_hint_bits=7),
        "padding_obu": full_headers(color, extra=obu(15, b"\x12\x34\x80")),
        "padding_without_trailing": full_headers(color, extra=obu(15, b"\x12\x34")),
        "metadata_hdr_cll": full_headers(color, extra=hdr_cll),
        "metadata_t35": full_headers(color, extra=t35),
        "metadata_timecode": full_headers(color, extra=timecode),
        "metadata_short_cll": full_headers(color, extra=obu(5, uleb(1) + b"\x01\x80")),
        "reserved_obu": full_headers(color, extra=obu(9, b"\x01")),
        "reserved_obu_zeros": full_headers(color, extra=obu(9, b"\x00\x00")),
        "redundant_frame_header_before_the_frame": full_headers(color, extra=obu(7, b"")),
        "extension_headers": full_headers(color, ops=(0x101,), ext=(0, 0)),
        "obus_outside_the_operating_point": full_headers(color, ops=(0x101,), ext=(0, 0),
                                                         extra=obu(15, b"\x12", (1, 1))),
        "trailing_zero_bytes": full_headers(color) + b"\0\0\0",
        "second_temporal_unit_padding": full_headers(color) + obu(2, b"") + obu(15, b"\x80"),
    }


HEADERS = header_variants()


@pytest.mark.parametrize("name", list(HEADERS))
def test_the_full_sequence_and_frame_header_forms_decode_as_cv2(name):
    """cv2's tile data under sequence and frame headers written in their
    full forms (timing info, decoder model, operating points and levels,
    frame ids, order hints) and with other OBUs beside the frame: the
    header layer's rules, held to libaom's answer."""
    stream = HEADERS[name]
    h, w = (64, 96) if name == "full_screen_content" else (24, 40)
    assert answers(avif_file(stream, w=w, h=h)) in ("none", "equal")


def test_the_header_forms_decode_where_they_should():
    got = {name: answers(avif_file(s, w=96 if name == "full_screen_content" else 40,
                                   h=64 if name == "full_screen_content" else 24)) for name, s in HEADERS.items()}
    assert sum(a == "equal" for a in got.values()) >= 15, got


# libaom's encoder options through Pillow's libavif (lossless 4:4:4 streams,
# taken as identity-matrix samples): what cv2's own writer never sets
ENCODER_OPTIONS = {
    "no_cdf_update": [("cdf-update-mode", "0")],
    "cdf_update_selective": [("cdf-update-mode", "2")],
    "no_cfl": [("enable-cfl-intra", "0")],
    "no_filter_intra_no_smooth": [("enable-filter-intra", "0"), ("enable-smooth-intra", "0")],
    "no_angle_delta": [("enable-angle-delta", "0")],
    "no_intra_edge_filter": [("enable-intra-edge-filter", "0")],
    "max_partition_8": [("max-partition-size", "8")],
    "superblock_128": [("sb-size", "128")],
    "reduced_tx_set": [("reduced-tx-type-set", "1")],
    "tiles_2x4": [("tile-rows", "1"), ("tile-columns", "2")],
    "screen_content": [("tune-content", "screen")],
    "screen_content_2_tiles": [("tune-content", "screen"), ("tile-columns", "1")],
    "screen_content_6_tiles": [("tune-content", "screen"), ("tile-columns", "2"), ("tile-rows", "1")],
}


@pytest.mark.parametrize("name", list(ENCODER_OPTIONS))
def test_libaoms_encoder_options_decode_as_cv2(name):
    """Screen content turns palette and IntraBC on, in several tiles too
    (a displacement stays inside its tile, the palette cache does not
    reach across a tile's edge)."""
    screen = name.startswith("screen_content")
    h, w = (128, 320) if screen else (64, 96)
    img = text(h, w, 3, 72) if screen else smooth(h, w, 3, 71)
    stream = item_data(pil_avif(img, quality=100, subsampling="4:4:4", speed=6, advanced=ENCODER_OPTIONS[name]))
    assert answers(avif_file(stream, w=w, h=h)) == "equal"
    if screen:
        assert decode_stats(stream)[native.AV1_STATS["palette_y"]] > 0
