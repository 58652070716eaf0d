"""The port's CCITT fax TIFFs (``utils/imcodec.py`` with ``csrc/tiff.cpp``:
compressions 2, CCITT RLE; 3, G3 (T.4, 1D and 2D); 4, G4 (T.6); 32771,
CCITT RLEW) against ``cv2.imdecode(buf, IMREAD_COLOR)`` and ``cv2.imread``
(OpenCV 5.0, libtiff 4.7): the same ``None`` or not, and 0 differing pixels.

The files come from PIL's libtiff and from a small Modified Huffman, Modified
READ and MMR coder here (``fax_rows``), which writes what libtiff does not:
RLEW, EOLs with and without fill bits, no EOL before the first row, RTC and
EOFB present or absent, codes of the uncompressed mode, codes not in any
table and rows whose runs overflow or fall short of the width. The coder is
plugged into ``test_torch_tiff.tiff_bytes``, so every layout of that writer
(strips, partial tiles, both byte orders, BigTIFF, dropped or overridden
tags) holds here too. Then damaged and cut files, and files read by path.
"""

import io
import logging
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch.utils import imcodec
from test_torch_tiff import (answers, assert_all_equal_cv2, compare, cv2_decode, garbled, port_decode, small_enough,
                             tiff_bytes)

# -- the coder ----------------------------------------------------------------

WHITE_TERM = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
              "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
              "00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
              "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 "
              "01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
              "00110011 00110100").split()
BLACK_TERM = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
              "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
              "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
              "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 "
              "000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
              "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
              "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 000000101011 "
              "000000101100 000001011010 000001100110 000001100111").split()
WHITE_MAKEUP = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
                "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
                "010011000 010011001 010011010 011000 010011011").split()  # 64, 128, ..., 1728
BLACK_MAKEUP = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
                "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 "
                "0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 "
                "0000001010100 0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()
EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 000000010110 "
              "000000010111 000000011100 000000011101 000000011110 000000011111").split()  # 1792-2560, both colours
EOL = "000000000001"
MODES = {"P": "0001", "H": "001", 0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010", -3: "0000010"}
UNCOMPRESSED_2D = "0000001111"  # the extension code that enters uncompressed mode (T.4 4.2.3)
UNCOMPRESSED_1D = "000000001111"


def run_code(n: int, black: bool) -> str:
    """One run: make-up codes (2560 as often as needed), then the
    terminating code."""
    out = ""
    while n >= 2560:
        out += EXT_MAKEUP[-1]
        n -= 2560
    if n >= 64:
        k = n // 64
        out += EXT_MAKEUP[k - 28] if k > 27 else (BLACK_MAKEUP if black else WHITE_MAKEUP)[k - 1]
    return out + (BLACK_TERM if black else WHITE_TERM)[n % 64]


def changes(row: np.ndarray) -> list:
    """The changing elements: where a pixel differs from the one before it
    (white before the first), then the width twice (imaginary ones)."""
    prev = np.concatenate([[0], row[:-1]])
    return list(np.flatnonzero(row != prev)) + [len(row), len(row)]


def mh_row(row: np.ndarray, extra: int = 0) -> str:
    """Modified Huffman: white and black runs in turn, white first;
    ``extra`` lengthens the last run past the width."""
    runs = np.diff([0] + changes(row)[:-2] + [len(row)])
    runs[-1] += extra
    return "".join(run_code(int(n), k % 2 == 1) for k, n in enumerate(runs))


def mr_row(row: np.ndarray, ref: np.ndarray, vertical: bool = True) -> str:
    """Modified READ (T.4 4.2): pass, vertical and horizontal modes against
    ``ref``; ``vertical`` False codes every change horizontally."""
    w = len(row)
    a_ch, b_ch = changes(row), changes(ref)
    out, a0, colour = "", -1, 0

    def after(ch, x, col=None, grid=None):
        for c in ch:
            if c > x and (col is None or c >= w or grid[c] == col):
                return c
        return w

    while a0 < w:
        a1 = after(a_ch, a0)
        a2 = after(a_ch, a1)
        b1 = after(b_ch, a0, 1 - colour, ref)
        b2 = after(b_ch, b1)
        if b2 < a1:
            out += MODES["P"]
            a0 = b2
        elif vertical and abs(a1 - b1) <= 3:
            out += MODES[a1 - b1]
            a0, colour = a1, 1 - colour
        else:
            out += MODES["H"] + run_code(a1 - max(a0, 0), colour == 1) + run_code(a2 - a1, colour == 0)
            a0 = a2
    return out


def fax_rows(block: np.ndarray, kind: str, fill_bits=False, first_eol=True, rtc=True, eofb=True, k=2,
             fill_order=1, extra=None, bad=None, uncompressed=None, vertical=True, short=None) -> bytes:
    """A block [rows, columns] of 0 (white) and 1 (black) coded as ``kind``:
    "rle" (each row on a byte), "rlew" (on 16 bits), "g3" (T.4 1D: an EOL
    before each row, ``fill_bits`` to end each EOL on a byte, ``first_eol``,
    ``rtc``: six EOLs at the end), "g3_2d" (each EOL then a tag bit; every
    ``k``-th row 1D) or "g4" (T.6, ``eofb`` at the end). ``fill_order`` 2
    stores each byte's bits backwards. Damage, by row: ``extra`` {row: n}
    lengthens a 1D row's last run by n, ``short`` {row: n} drops the
    last n pixels' runs, ``bad`` {row: bits} puts ``bits`` (a code in no
    table) at the row's start, ``uncompressed`` (rows) starts them with the
    code that enters uncompressed mode."""
    bits = []
    ref = np.zeros(block.shape[1], np.uint8)
    extra, bad, short, uncompressed = extra or {}, bad or {}, short or {}, uncompressed or ()
    eol = lambda n: ("0" * ((-(n + 12)) % 8) if fill_bits else "") + EOL  # noqa: E731
    for y, row in enumerate(block.astype(np.uint8)):
        coded = row[: len(row) - short[y]] if y in short else row
        one_d = kind in ("rle", "rlew", "g3") or (kind == "g3_2d" and y % k == 0)
        body = mh_row(coded, extra.get(y, 0)) if one_d else mr_row(coded, ref, vertical)
        if y in uncompressed:
            body = (UNCOMPRESSED_1D if one_d else UNCOMPRESSED_2D) + body
        body = bad.get(y, "") + body
        n = sum(map(len, bits))
        if kind in ("g3", "g3_2d"):
            bits.append((eol(n) if (y or first_eol) else "") + ("" if kind == "g3" else "1" if one_d else "0"))
        bits.append(body)
        n = sum(map(len, bits))
        if kind == "rle":
            bits.append("0" * (-n % 8))
        elif kind == "rlew":
            bits.append("0" * (-n % 16))
        ref = row
    if kind in ("g3", "g3_2d") and rtc:
        bits.append("".join(eol(0) + ("1" if kind == "g3_2d" else "") for _ in range(6)))
    if kind == "g4" and eofb:
        bits.append(EOL + EOL)
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    data = np.packbits(np.frombuffer(s.encode(), np.uint8) - 48)
    if fill_order == 2:
        data = np.unpackbits(data).reshape(-1, 8)[:, ::-1]
        data = np.packbits(data.reshape(-1))
    return data.tobytes()


COMPRESSION = {"rle": 2, "rlew": 32771, "g3": 3, "g3_2d": 3, "g4": 4}


def fax_tiff(img: np.ndarray, kind: str, photometric=0, fill_order=1, extra_tags=(), options=None, **kw) -> bytes:
    """A 1-bit TIFF of ``img`` [H, W] (0 white, 1 black in the coded runs)
    coded as ``kind`` by ``fax_rows``; ``kw`` goes to ``tiff_bytes`` (its
    layout) or to ``fax_rows`` (the coding). T4Options are 1 for "g3_2d"
    unless ``options`` says otherwise."""
    coding = {k: kw.pop(k) for k in list(kw) if k in ("fill_bits", "first_eol", "rtc", "eofb", "k", "extra", "bad",
                                                       "uncompressed", "vertical", "short")}
    tags = list(extra_tags)
    if fill_order != 1:
        tags.append((266, (3, [fill_order])))
    opt = options if options is not None else (1 if kind == "g3_2d" else None)
    if opt is not None:
        tags.append((293 if kind == "g4" else 292, (4, [opt])))
    return tiff_bytes(np.asarray(img)[..., None], bits=1, photometric=photometric, compression=COMPRESSION[kind],
                      extra=tuple(tags), encode=lambda b: fax_rows(b[..., 0], kind, fill_order=fill_order, **coding),
                      **kw)


def page(h, w, seed) -> np.ndarray:
    """Text-like black marks on white: horizontal strokes, blocks and noise,
    so that every mode, short and long runs and make-up codes occur."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    for _ in range(max(1, h * w // 60)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y : y + rng.integers(1, 4), x : x + rng.integers(1, 9)] = 1
    img[rng.integers(0, h, max(1, h // 6))] ^= 1  # rows nearly all black
    img[:, rng.integers(0, w)] = 1
    return img


def pil_fax(img: np.ndarray, compression: str, info=None) -> bytes:
    """PIL's libtiff file of ``img`` (1 black) as "group4", "group3" or
    "tiff_ccitt"; ``info``: tags for libtiff (292: T4Options)."""
    buf = io.BytesIO()
    Image.fromarray((1 - img).astype(np.uint8) * 255).convert("1").save(buf, "TIFF", compression=compression,
                                                                        tiffinfo=info or {})
    return buf.getvalue()


# -- the kinds ----------------------------------------------------------------


def fax_cases() -> dict:
    """name → file."""
    cases = {}
    img = page(23, 37, seed=1)  # 37: a width that is not a multiple of 8
    for kind in COMPRESSION:
        for phot in (0, 1):
            for fo in (1, 2):
                for lname, layout in (("strips", dict(rows=5)), ("tiles", dict(tile=(32, 16))),
                                      ("onestrip", {})):
                    cases[f"{kind}_phot{phot}_fill{fo}_{lname}"] = fax_tiff(img, kind, photometric=phot, fill_order=fo,
                                                                            **layout)
        for order in "<>":
            for big in (False, True):
                cases[f"{kind}_{'be' if order == '>' else 'le'}_{'big' if big else 'classic'}"] = fax_tiff(
                    page(19, 70, seed=2), kind, order=order, big=big, rows=7)
        wide = page(9, 3000, seed=3)  # runs past 2560: the extended make-up codes, repeated
        wide[4, 5:2900] = 1
        cases[f"{kind}_wide_runs"] = fax_tiff(wide, kind, rows=4)
        cases[f"{kind}_no_bytecounts"] = fax_tiff(img, kind, drop=(279,))
        cases[f"{kind}_bytecount_zero"] = fax_tiff(img, kind, override={279: (4, [0])})
        cases[f"{kind}_bytecount_too_long"] = fax_tiff(img, kind, override={279: (4, [100000])})
        cases[f"{kind}_bytecount_short"] = fax_tiff(img, kind, override={279: (4, [20])})
        cases[f"{kind}_palette"] = fax_tiff(img, kind, photometric=3, extra_tags=(
            (320, (3, [65535, 0, 0, 30000, 12345, 65535])),))
        cases[f"{kind}_orientation6"] = fax_tiff(img, kind, rows=4, extra_tags=((274, (3, [6])),))
        for bits in (2, 4, 8):  # libtiff's fax codecs take 1-bit samples only
            cases[f"{kind}_{bits}bit"] = tiff_bytes(np.zeros((6, 9, 1)), bits=bits, photometric=1,
                                                    compression=COMPRESSION[kind],
                                                    encode=lambda b: fax_rows(b[..., 0] % 2, kind))
        cases[f"{kind}_rgb"] = tiff_bytes(np.zeros((6, 9, 3)), bits=1, compression=COMPRESSION[kind],
                                          encode=lambda b: fax_rows(b[..., 0], kind))
        cases[f"{kind}_2_samples_planar"] = tiff_bytes(np.zeros((6, 9, 2)), bits=1, photometric=1, planar=2,
                                                       compression=COMPRESSION[kind],
                                                       extra=((338, (3, [2])),),
                                                       encode=lambda b: fax_rows(b[..., 0], kind))
        cases[f"{kind}_no_photometric"] = fax_tiff(img, kind, drop=(262,))
        # damage by row: a code in no table, runs past the width, a short row,
        # the uncompressed mode's code
        cases[f"{kind}_bad_code"] = fax_tiff(img, kind, rows=12, bad={3: "000000000000111", 15: "0000000011111"})
        cases[f"{kind}_runs_past_width"] = fax_tiff(img, kind, rows=12, k=1000, extra={2: 5, 9: 40, 17: 1})
        cases[f"{kind}_short_rows"] = fax_tiff(img, kind, rows=12, short={4: 3, 13: 20})
        cases[f"{kind}_uncompressed_codes"] = fax_tiff(img, kind, rows=12, uncompressed=(5, 14))
    # G3's own: fill bits, no first EOL, no RTC, T4Options and its other bits,
    # every 2D row and every 4th row 1D, horizontal mode only
    for kind in ("g3", "g3_2d"):
        for fb in (False, True):
            for first in (False, True):
                for rtc in (False, True):
                    cases[f"{kind}_fill{int(fb)}_first{int(first)}_rtc{int(rtc)}"] = fax_tiff(
                        img, kind, fill_bits=fb, first_eol=first, rtc=rtc, rows=10)
    for opt in (0, 1, 2, 3, 4, 5, 6, 7, 0x10001, 0xFFFFFFFF):
        kind = "g3_2d" if opt & 1 else "g3"
        cases[f"g3_options{opt}"] = fax_tiff(img, kind, options=opt, fill_bits=bool(opt & 4))
    cases["g3_2d_options0"] = fax_tiff(img, "g3_2d", options=0)  # 2D rows read as 1D
    cases["g3_options1_1d_rows"] = fax_tiff(img, "g3", options=1)  # no tag bit: every row off by one
    cases["g3_2d_options_short_type"] = fax_tiff(img, "g3_2d", extra_tags=((292, (3, [1])),), options=None)
    cases["g3_2d_options_two_values"] = fax_tiff(img, "g3_2d", extra_tags=((292, (4, [1, 1])),), options=None)
    cases["g3_2d_options_ascii"] = fax_tiff(img, "g3_2d", extra_tags=((292, (2, b"1\0")),), options=None)
    cases["g3_2d_options_on_g4"] = fax_tiff(img, "g4", extra_tags=((292, (4, [1])),))
    cases["g3_2d_k4"] = fax_tiff(page(30, 45, seed=4), "g3_2d", k=4, rows=15)
    cases["g3_2d_every_row_2d"] = fax_tiff(page(30, 45, seed=5), "g3_2d", k=1000)
    cases["g3_2d_horizontal_only"] = fax_tiff(page(30, 45, seed=6), "g3_2d", vertical=False)
    # G4's own: T6Options (bit 1: uncompressed mode), EOFB or not, horizontal
    # mode only, a tiled page
    for opt in (0, 2, 0xFFFFFFFF):
        for eofb in (False, True):
            cases[f"g4_options{opt}_eofb{int(eofb)}"] = fax_tiff(img, "g4", options=opt, eofb=eofb)
    cases["g4_options_on_g3"] = fax_tiff(img, "g3", extra_tags=((293, (4, [2])),))
    cases["g4_horizontal_only"] = fax_tiff(page(30, 45, seed=7), "g4", vertical=False)
    cases["g4_tiles_page"] = fax_tiff(page(70, 90, seed=8), "g4", tile=(48, 32))
    # RLEW's rows on 16-bit words from the start of each strip: strips of odd
    # byte counts
    cases["rlew_odd_strips"] = fax_tiff(page(21, 13, seed=9), "rlew", rows=1)
    # the run arrays' bounds (libtiff sizes them for the width + 1, rounded
    # up to 32, twice that for 2D coding; a row that fills one is not
    # painted and ends the block): j 1D runs of 0 white and 1 black, or k 2D
    # horizontal codes of 0 and 0 after ten of 0 and 1, on each side of it
    def bits_tiff(w, compression, coded, *tags):
        coded += "0" * (-len(coded) % 8)
        data = np.packbits(np.frombuffer(coded.encode(), np.uint8) - 48).tobytes()
        return tiff_bytes(np.zeros((1, w, 1)), bits=1, photometric=0, compression=compression, extra=tags,
                          encode=lambda b: data)

    for w, j in ((64, 47), (64, 48), (100, 63), (100, 64)):
        coded = (run_code(0, False) + run_code(1, True)) * j + run_code(w - j, False)
        cases[f"rle_{j}_zigzag_runs_{w}"] = bits_tiff(w, 2, coded)
    for w, k in ((64, 85), (64, 86), (100, 117), (100, 118)):
        h = MODES["H"]
        coded = (h + run_code(0, False) + run_code(1, True)) * 10 + (h + run_code(0, False) + run_code(0, True)) * k
        coded += h + run_code(w - 10, False) + run_code(0, True)
        cases[f"g4_{k}_still_horizontal_{w}"] = bits_tiff(w, 4, coded)
        cases[f"g3_2d_{k}_still_horizontal_{w}"] = bits_tiff(w, 3, EOL + "0" + coded, (292, (4, [1])))
    # PIL's libtiff
    for comp, info in (("group4", {}), ("group3", {}), ("group3", {292: 1}), ("group3", {292: 5}),
                       ("tiff_ccitt", {})):
        name = f"pil_{comp}" + "".join(f"_{k}_{v}" for k, v in info.items())
        cases[name] = pil_fax(page(40, 57, seed=10), comp, info)
    return cases


_CACHE = {}


def fax_cases_cached() -> dict:
    if not _CACHE:
        _CACHE.update(fax_cases())
    return _CACHE


FAX_CASES = list(fax_cases())


@pytest.mark.parametrize("name", FAX_CASES)
def test_fax_kinds_answer_as_cv2(name):
    assert answers(fax_cases_cached()[name]) in ("none", "equal")


def test_fax_kinds_decode_their_pixels():
    """Undamaged files decode to their image: black where a run was black,
    MinIsWhite and MinIsBlack alike, and every PIL file. Not RLEW: libtiff
    ends each row by keeping the bits it has read ahead when they make 16 or
    more and skipping a byte when the next is at an odd address, so rows
    aligned on 16 bits in the data are read from elsewhere; cv2 gives that
    image and so does the port."""
    img = page(23, 37, seed=1)
    rlew = fax_cases_cached()["rlew_phot0_fill2_tiles"]
    assert answers(rlew) == "equal" and (port_decode(rlew)[..., 0] != np.where(img == 1, 0, 255)).any()
    for name in ("rle", "g3", "g3_2d", "g4"):
        for phot in (0, 1):
            got = port_decode(fax_cases_cached()[f"{name}_phot{phot}_fill2_tiles"])
            want = np.where(img == (1 if phot == 0 else 0), 0, 255)
            assert got is not None and (got[..., 0] == want).all() and (got == got[..., :1]).all(), (name, phot)
    for name in ("pil_group4", "pil_group3", "pil_group3_292_5", "pil_tiff_ccitt"):
        assert (port_decode(fax_cases_cached()[name])[..., 0] == np.where(page(40, 57, seed=10), 0, 255)).all()


# -- by path ------------------------------------------------------------------

BY_PATH = ["g4_phot0_fill1_strips", "g4_phot1_fill2_tiles", "g3_phot0_fill2_onestrip", "g3_2d_phot1_fill1_tiles",
           "rle_phot0_fill2_strips", "rlew_phot0_fill1_strips", "rlew_odd_strips", "g4_no_bytecounts",
           "g3_2d_bad_code", "pil_group4", "pil_group3_292_5"]


def odd_offsets(data: bytes) -> bytes:
    """``data`` with each strip moved to an odd offset at the file's end."""
    d = imcodec._TiffDir(data)
    typ, count, at = d.entries[273]
    offs, cnts = d.ints(273), d.ints(279)
    out = bytearray(data)
    fmt = d.e + ("Q" if typ == 16 else "I")
    for k, (off, cnt) in enumerate(zip(offs, cnts)):
        if len(out) % 2 == 0:
            out += b"\0"
        struct.pack_into(fmt, out, at + k * struct.calcsize(fmt), len(out))
        out += data[off : off + cnt]
    return bytes(out)


@pytest.mark.parametrize("name", BY_PATH + ["rlew_odd_offsets", "rlew_odd_offsets_fill2"])
def test_a_fax_tiff_read_by_path_answers_as_cv2_imread(name, tmp_path):
    """``cv2.imread`` maps the file: libtiff's fax codecs then read the map,
    whatever the FillOrder, and RLEW aligns its rows on the mapped address,
    so a strip at an odd offset reads otherwise than through ``imdecode``'s
    buffer."""
    if name.startswith("rlew_odd_offsets"):
        data = odd_offsets(fax_tiff(page(21, 13, seed=9), "rlew", rows=5, fill_order=2 if "fill2" in name else 1))
    else:
        data = fax_cases_cached()[name]
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    logging.disable(logging.WARNING)
    try:
        got = imcodec.read_image(str(path))
    finally:
        logging.disable(logging.NOTSET)
    assert compare(cv2.imread(str(path), cv2.IMREAD_COLOR), got) in ("none", "equal")
    assert answers(data) in ("none", "equal")


def test_rlew_at_an_odd_offset_reads_otherwise_by_path(tmp_path):
    """The probe behind the rule: cv2.imdecode and cv2.imread disagree on
    the same RLEW file whose strips start at odd offsets, and the port gives
    each its answer."""
    data = odd_offsets(fax_tiff(page(21, 13, seed=9), "rlew", rows=5))
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    streamed, mapped = cv2_decode(data), cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert streamed is not None and mapped is not None and (streamed != mapped).any()
    assert (port_decode(data) == streamed).all() and (port_decode(data, mapped=True) == mapped).all()


# -- damaged and cut ----------------------------------------------------------

GARBLED = ["rle_phot0_fill1_strips", "rlew_phot1_fill2_strips", "g3_phot0_fill1_strips", "g3_2d_phot0_fill2_tiles",
           "g4_phot0_fill1_strips", "g4_phot1_fill2_tiles", "g4_le_big", "g3_2d_be_classic", "pil_group4",
           "pil_group3", "pil_group3_292_5", "pil_tiff_ccitt", "g3_fill1_first0_rtc0", "g4_options2_eofb0"]


@pytest.mark.parametrize("name", GARBLED)
def test_garbled_and_cut_fax_tiffs_answer_as_cv2(name):
    """60 seeded files per kind with 1–3 bytes changed anywhere past the
    magic (those that come to declare more than 4 Mpixels are dropped), then
    40 cuts."""
    data = fax_cases_cached()[name]
    datas = garbled(data, 60, seed=GARBLED.index(name) + 40) + [data[:k] for k in
                                                                   range(4, len(data), max(1, len(data) // 40))]
    assert_all_equal_cv2([x for x in datas if small_enough(x)], f"garbled {name}")


def damaged(data: bytes, n: int, seed: int):
    """``n`` copies of ``data`` with 1–3 bytes of the strips flipped, zeroed
    or set at random (the directory left alone)."""
    d = imcodec._TiffDir(data)
    spans = [(o, o + c) for o, c in zip(d.ints(273 if 273 in d.entries else 324),
                                          d.ints(279 if 279 in d.entries else 325))]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            lo, hi = spans[rng.integers(0, len(spans))]
            at = rng.integers(lo, hi)
            bad[at] = (bad[at] ^ 0xFF, 0, rng.integers(0, 256))[rng.integers(0, 3)]
        out.append(bytes(bad))
    return out


@pytest.mark.parametrize("kind", list(COMPRESSION))
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_damaged_fax_strips_and_tiles_answer_as_cv2(kind, layout):
    """150 files with 1–3 bytes of the coded rows flipped, zeroed or set:
    a code in no table ends its row, the rows after an error in 2D coding
    follow the damaged reference, and the end of a block's data keeps what
    was decoded."""
    blocks = dict(rows=8) if layout == "strips" else dict(tile=(32, 16))
    data = fax_tiff(page(40, 50, seed=11), kind, **blocks)
    assert_all_equal_cv2(damaged(data, 150, seed=len(kind) + len(layout)), f"damaged {kind} {layout}")


def test_a_g4_strip_whose_second_half_is_0xff_keeps_the_rows_before_it():
    """The scene's G4 strips from PIL, the second half of the first strip
    filled with 0xFF: cv2 keeps the rows it decoded before the damage, and
    so does the port."""
    from ppocr_tpu_torch import assets

    scene = assets.load_scenes()["serving"][0]
    data = pil_fax((cv2.cvtColor(scene, cv2.COLOR_BGR2GRAY) <= 128).astype(np.uint8), "group4")
    d = imcodec._TiffDir(data)
    off, cnt = d.ints(273)[0], d.ints(279)[0]
    bad = bytearray(data)
    bad[off + cnt // 2 : off + cnt] = b"\xff" * (cnt - cnt // 2)
    want, got = cv2_decode(bytes(bad)), port_decode(bytes(bad))
    assert compare(want, got) == "equal"
    assert 500 < (want == cv2_decode(data)).all(axis=(1, 2)).sum() < 768


def test_every_cut_and_zeroed_tail_of_a_fax_strip_answers_as_cv2():
    """A G4, a G3 2D and an RLE strip whose byte count ends at every byte
    (the rows decoded before the end stay), whose tail is zeroed from every
    byte on, and a file cut inside the strip, which lies after the directory
    (the strip cannot be read: ``None``)."""
    from test_torch_tiff import _with_strips

    for kind in ("g4", "g3_2d", "rle"):
        coded = fax_rows(page(30, 41, seed=12), kind)

        def tiff(count):
            head = tiff_bytes(np.zeros((1, 1, 1)), bits=1, photometric=0, compression=COMPRESSION[kind],
                              extra=((292, (4, [1])),) if kind == "g3_2d" else (),
                              override={256: (4, [41]), 257: (4, [30]), 278: (4, [30]), 279: (4, [count])})
            return _with_strips(head, [coded])

        data = tiff(len(coded))
        off = len(data) - len(coded)
        datas = [data[:k] for k in range(off, len(data))]
        datas += [data[:off] + coded[:k] + bytes(len(coded) - k) for k in range(len(coded))]
        datas += [tiff(k) for k in range(1, len(coded))]
        assert_all_equal_cv2(datas, f"cut {kind}")
        assert cv2_decode(data[: off + len(coded) // 2]) is None and answers(data) == "equal"


# -- the rules, as numbers ----------------------------------------------------


def test_fax_probes_of_cv2_rules():
    """libtiff's fax rules, held as numbers: the fax codecs take 1-bit
    samples only (cv2 gives None otherwise); FillOrder 2 reads each byte's
    bits backwards; G3 finds the first EOL before the first row and a file
    without it is white; T4Options bit 0 chooses 2D rows, its other bits and
    T6Options change nothing; a missing StripByteCounts is estimated from
    the file's size."""
    c = fax_cases_cached()
    for kind in COMPRESSION:
        for bits in (2, 4, 8):
            assert cv2_decode(c[f"{kind}_{bits}bit"]) is None and port_decode(c[f"{kind}_{bits}bit"]) is None
    img = page(23, 37, seed=1)
    want = np.where(img == 1, 0, 255)
    for kind in ("rle", "g3", "g3_2d", "g4"):
        assert (port_decode(c[f"{kind}_no_bytecounts"])[..., 0] == want).all(), kind
    for opt in (0, 2, 4, 6):
        assert (port_decode(c[f"g3_options{opt}"])[..., 0] == want).all(), opt
    for opt in (0, 2):
        assert (port_decode(c[f"g4_options{opt}_eofb1"])[..., 0] == want).all(), opt
    assert (port_decode(c["g3_2d_options0"]) == cv2_decode(c["g3_2d_options0"])).all()
    assert not (port_decode(c["g3_2d_options0"])[..., 0] == want).all()


# -- through the services -------------------------------------------------------


def test_fax_requests_get_the_jax_services_answer(tmp_path):
    """The scene thresholded to 1 bit as PIL's G4 TIFF sent as data and as
    its G3 2D TIFF sent by path: the JAX service (cv2 decodes) and the
    port's service answer with the same words, fused and staged. Both
    services are built with no request timeout: the test is about the
    answer."""
    import asyncio
    import base64
    import dataclasses
    import json

    import torch

    from ppocr_tpu.serve.service import OCRIPCService as JaxService
    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.serve import OCRIPCService
    from test_torch_goldens import assert_words_match, jax_config
    from test_torch_serve import small_config

    scene = assets.load_scenes()["parity"][0]
    black = (cv2.cvtColor(scene, cv2.COLOR_BGR2GRAY) <= 128).astype(np.uint8)
    g4, g3 = pil_fax(black, "group4"), pil_fax(black, "group3", {292: 5})
    for data in (g4, g3):
        assert answers(data) == "equal"
    path = tmp_path / "scene.tif"
    path.write_bytes(g3)
    assert (cv2.imread(str(path)) == imcodec.read_image(str(path))).all()
    lines = [json.dumps({"command": "recognize", "image_data": base64.b64encode(g4).decode()}).encode(),
             json.dumps({"command": "recognize", "image_path": str(path)}).encode()]
    model_dir = str(assets.make_jumbo_model_dir(tmp_path / "jumbo"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several test processes at once
    try:
        for changes in ({}, {"fast_path": False}):
            cfg = small_config(**changes)
            jax_svc = JaxService(model_dir, socket_path=str(tmp_path / "j.sock"),
                                 config=jax_config(dataclasses.asdict(cfg)), request_timeout_ms=0)
            svc = OCRIPCService(model_dir=model_dir, socket_path=str(tmp_path / "p.sock"), config=cfg, device="cpu",
                                request_timeout_ms=0)
            for line in lines:
                want, got = (asyncio.run(s.process_request(line)) for s in (jax_svc, svc))
                assert want["success"] and got["success"] and got["words"], (changes, got, want)
                assert_words_match(got.pop("words"), want.pop("words"), 2e-3)
                for r in (want, got):  # the times
                    r.pop("processing_time_ms", None)
                    r.pop("stage_times", None)
                assert got == want, (changes, got, want)
    finally:
        torch.set_num_threads(threads)
