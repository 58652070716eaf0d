"""The port's lossless WebP (``utils/imcodec.py`` with ``csrc/webp.cpp``)
against ``cv2.imdecode(buf, IMREAD_COLOR)`` and ``cv2.imread`` (OpenCV 5.0
and its bundled libwebp): the same ``None`` or not, and 0 differing pixels.

The files come from cv2's encoder (lossless by default), from PIL's
``lossless=True`` at every method, and from a VP8L bitstream writer here
(``vp8l_bytes``), which writes what the encoders never emit: each predictor
mode alone (14 and 15 too), each colour cache size, simple and one-symbol
codes, several prefix-code groups, every repeat code, code-length limits,
over-subscribed and incomplete codes, copies out of range, a transform
given twice, a bad signature or version. The RIFF writer (``riff``,
``vp8x``, ``anmf``, ``exif``) wraps them in the simple format, the extended
format with metadata chunks and EXIF orientations, and animations. Then
cut, garbled and XOR-ed files, and files read by path. Lossy (``VP8 ``)
WebPs are ``tests/test_torch_webp_lossy.py``'s.
"""

import io
import logging
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch.utils import imcodec
from test_torch_image_formats import garbled
from test_torch_tiff import answers, compare, cv2_decode, port_decode

# -- the RIFF writer -----------------------------------------------------------


def chunk(tag: bytes, payload: bytes, pad: bool = True) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if pad and len(payload) & 1 else b"")


def riff(body: bytes, delta: int = 0) -> bytes:
    """``body`` under a RIFF header whose size is ``delta`` off the truth."""
    return b"RIFF" + struct.pack("<I", 4 + len(body) + delta) + b"WEBP" + body


def le24(v: int) -> bytes:
    return v.to_bytes(3, "little")


def vp8x(w: int, h: int, flags: int = 0) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags) + le24(w - 1) + le24(h - 1))


def anim(bgcolor: int = 0xFF0000FF, loops: int = 0) -> bytes:
    return chunk(b"ANIM", struct.pack("<IH", bgcolor, loops))


def anmf(x: int, y: int, w: int, h: int, bits: int, frame: bytes, duration: int = 100) -> bytes:
    """An animation frame at (x, y) (even), of ``frame``'s chunks; ``w``, ``h``
    are the ANMF fields (the bitstream's own size is the one libwebp uses)."""
    return chunk(b"ANMF", le24(x // 2) + le24(y // 2) + le24(w - 1) + le24(h - 1) + le24(duration) + bytes([bits])
                 + frame)


def exif(orientation: int, prefix: bytes = b"", order: str = "II") -> bytes:
    """A TIFF header and IFD0 holding one orientation entry."""
    e = "<" if order == "II" else ">"
    return prefix + order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1) + struct.pack(
        e + "HHIHH", 0x112, 3, 1, orientation, 0) + b"\0\0\0\0"


def exif_ifd(entries) -> bytes:
    """A little-endian TIFF header and IFD0 of (tag, type, count, 4 value
    bytes) entries."""
    out = struct.pack("<2sHI", b"II", 42, 8) + struct.pack("<H", len(entries))
    for tag, kind, count, value in entries:
        out += struct.pack("<HHI", tag, kind, count) + value
    return out + b"\0\0\0\0"


def still(stream: bytes) -> bytes:
    return riff(chunk(b"VP8L", stream))


def stream_of(webp: bytes) -> bytes:
    """The VP8L payload of a simple-format file."""
    assert webp[12:16] == b"VP8L", webp[12:16]
    return webp[20 : 20 + struct.unpack("<I", webp[16:20])[0]]


# -- the VP8L writer -------------------------------------------------------------

CODE_LENGTH_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]
# the spec's 120 short distances (dx, dy), distance code k + 1 for entry k
PLANE = [(0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3),
         (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4), (-1, 4),
         (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3),
         (5, 0), (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4), (3, 5), (-3, 5),
         (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5),
         (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5),
         (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7), (7, 3),
         (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
         (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7),
         (-7, 7), (8, 6), (8, 7)]


class Bits:
    """Least significant bit first."""

    def __init__(self):
        self.acc = self.n = 0

    def put(self, value: int, n: int):
        self.acc |= (int(value) & ((1 << n) - 1)) << self.n
        self.n += n

    def bytes(self) -> bytes:
        return self.acc.to_bytes((self.n + 7) // 8, "little")


def complete_lengths(symbols, size: int) -> list:
    """A complete prefix code over ``symbols`` (lengths k - 1 and k); one
    symbol gets length 1, which libwebp reads as a code of no bits."""
    symbols = sorted(set(symbols))
    lengths = [0] * size
    m = len(symbols)
    k = max(1, (m - 1).bit_length())
    short = (1 << k) - m if m > 1 else 0
    for i, s in enumerate(symbols):
        lengths[s] = k - 1 if i < short else k
    if m == 1:
        lengths[symbols[0]] = 1
    return lengths


def codes_of(lengths) -> dict:
    """symbol → (bits to put, count): canonical codes, sent from their most
    significant bit, which is how libwebp's bit-reversed tables read them."""
    out, code, prev = {}, 0, 0
    for length, s in sorted((length, s) for s, length in enumerate(lengths) if length):
        code <<= length - prev
        out[s] = (int(format(code, f"0{length}b")[::-1], 2), length)
        code, prev = code + 1, length
    if len(out) == 1:
        out = {s: (0, 0) for s in out}
    return out


def length_tokens(lengths, repeats: bool = True):
    """Code lengths as code-length symbols (16: the previous non-zero length
    3–6 times; 17, 18: zeros 3–10, 11–138), (symbol, extra bits, value)."""
    out, i, prev = [], 0, 8
    while i < len(lengths):
        v = lengths[i]
        run = 1
        while i + run < len(lengths) and lengths[i + run] == v:
            run += 1
        if repeats and v == 0 and run >= 11:
            n = min(run, 138)
            out.append((18, 7, n - 11))
        elif repeats and v == 0 and run >= 3:
            n = min(run, 10)
            out.append((17, 3, n - 3))
        elif repeats and v and v == prev and run >= 3:
            n = min(run, 6)
            out.append((16, 2, n - 3))
        else:
            n = 1
            out.append((v, 0, 0))
            prev = v if v else prev
        i += n
    return out


def put_code(b: Bits, lengths, simple=None, repeats=True, trim=True, max_symbol=None):
    """A prefix code: ``simple`` (one or two symbols) or normal, its code
    lengths written with the repeat codes (``repeats``) and cut after the
    last non-zero one (``trim``: ``max_symbol`` counts the tokens)."""
    if simple is not None:
        b.put(1, 1)
        b.put(len(simple) - 1, 1)
        b.put(simple[0] > 1, 1)
        b.put(simple[0], 8 if simple[0] > 1 else 1)
        if len(simple) == 2:
            b.put(simple[1], 8)
        return
    b.put(0, 1)
    last = max((i for i, v in enumerate(lengths) if v), default=-1)
    tokens = length_tokens(lengths[: last + 1] if trim else lengths, repeats)
    if trim and last + 1 < len(lengths) and len(tokens) < 2:  # max_symbol is 2 at least
        tokens.append((0, 0, 0))
    cl = complete_lengths({t[0] for t in tokens}, 19)
    num = max(4, max(i for i in range(19) if cl[CODE_LENGTH_ORDER[i]]) + 1)
    b.put(num - 4, 4)
    for i in range(num):
        b.put(cl[CODE_LENGTH_ORDER[i]], 3)
    cl_codes = codes_of(cl)
    if max_symbol is None and trim and last + 1 < len(lengths):
        max_symbol = len(tokens)
    if max_symbol is None:
        b.put(0, 1)
    else:
        b.put(1, 1)
        k = next(k for k in range(8) if max_symbol - 2 < 1 << (2 + 2 * k))
        b.put(k, 3)
        b.put(max_symbol - 2, 2 + 2 * k)
    for sym, nbits, extra in tokens:
        b.put(*cl_codes[sym])
        if nbits:
            b.put(extra, nbits)


def prefix_value(v: int):
    """A length or distance ≥ 1 → (symbol, extra bits, extra value)."""
    x = v - 1
    if x < 4:
        return x, 0, 0
    h = x.bit_length() - 1
    second = (x >> (h - 1)) & 1
    return 2 * h + second, h - 1, x & ((1 << (h - 1)) - 1)


def tokens_of(argb: np.ndarray, cache_bits: int = 0, lz77: bool = True):
    """Pixels → literals ("L", argb), copies ("C", length, distance code)
    from the pixel to the left or the row above, colour cache hits ("K",
    key)."""
    h, w = argb.shape
    flat = [int(v) for v in argb.reshape(-1)]
    cache = [0] * (1 << cache_bits) if cache_bits else None
    out, i = [], 0

    def insert(v):
        if cache is not None:
            cache[((0x1E35A7BD * v) & 0xFFFFFFFF) >> (32 - cache_bits)] = v

    while i < len(flat):
        best = None
        if lz77:
            for dist, code in ((1, 2), (w, 1)):
                if i >= dist:
                    n = 0
                    while i + n < len(flat) and n < 4096 and flat[i + n] == flat[i + n - dist]:
                        n += 1
                    if n >= 3 and (best is None or n > best[0]):
                        best = (n, code)
        if best:
            out.append(("C", best[0], best[1]))
            for k in range(best[0]):
                insert(flat[i + k])
            i += best[0]
            continue
        v = flat[i]
        key = ((0x1E35A7BD * v) & 0xFFFFFFFF) >> (32 - cache_bits) if cache_bits else None
        if cache is not None and cache[key] == v:
            out.append(("K", key))
        else:
            out.append(("L", v))
        insert(v)
        i += 1
    return out


def put_image(b: Bits, argb: np.ndarray, cache_bits=0, cache_field=None, meta=None, top=False, lz77=True,
              tokens=None, simple=(), bad=None, repeats=True, trim=True, max_symbol=None):
    """An entropy-coded image: the colour cache field, the meta prefix codes
    (top level; ``meta`` (bits, group index per block)), the prefix codes of
    each group and the pixels. ``tokens`` replaces the pixels' own;
    ``simple``: the alphabets (0–4) written as simple codes; ``bad``
    ("over" or "incomplete") spoils the green code of group 0."""
    h, w = argb.shape
    if cache_field is not None or cache_bits:
        b.put(1, 1)
        b.put(cache_bits if cache_field is None else cache_field, 4)
    else:
        b.put(0, 1)
    if top:
        if meta is None:
            b.put(0, 1)
        else:
            bits, groups = meta
            b.put(1, 1)
            b.put(bits - 2, 3)
            put_image(b, (np.asarray(groups, np.uint32) << 8), lz77=False)
    toks = tokens if tokens is not None else tokens_of(argb, cache_bits, lz77)
    mbits, mgroups = meta if meta is not None else (0, np.zeros((1, 1), np.int64))
    mgroups = np.asarray(mgroups)
    ngroups = int(mgroups.max()) + 1
    sizes = [280 + (1 << cache_bits if cache_bits else 0), 256, 256, 256, 40]
    used = [[set() for _ in range(5)] for _ in range(ngroups)]
    placed, col, row = [], 0, 0
    for t in toks:  # each token's group, as the decoder finds it
        g = int(mgroups[row >> mbits, col >> mbits]) if meta is not None else 0
        placed.append((g, t))
        if t[0] == "L":
            v = t[1]
            used[g][0].add((v >> 8) & 255)
            used[g][1].add((v >> 16) & 255)
            used[g][2].add(v & 255)
            used[g][3].add(v >> 24)
            n = 1
        elif t[0] == "K":
            used[g][0].add(280 + t[1])
            n = 1
        else:
            used[g][0].add(256 + prefix_value(t[1])[0])
            used[g][4].add(prefix_value(t[2])[0])
            n = t[1]
        col += n
        row += col // w
        col %= w
    tables = []
    for g in range(ngroups):
        group = []
        for j in range(5):
            symbols = used[g][j] or {0}
            lengths = complete_lengths(symbols, sizes[j])
            if bad and g == 0 and j == 0:
                first = min(symbols)
                lengths[first] = max(1, lengths[first] - 1) if bad == "over" else lengths[first] + 1
                if bad == "over" and len(symbols) == 1:
                    lengths[(first + 1) % sizes[0]] = 1
                    lengths[(first + 2) % sizes[0]] = 1
            if j in simple and len(symbols) <= 2 and max(symbols) < 256:
                put_code(b, lengths, simple=sorted(symbols))
            else:
                put_code(b, lengths, repeats=repeats, trim=trim, max_symbol=max_symbol)
            group.append(codes_of(lengths))
        tables.append(group)
    for g, t in placed:
        c = tables[g]
        if t[0] == "L":
            v = t[1]
            b.put(*c[0][(v >> 8) & 255])
            b.put(*c[1][(v >> 16) & 255])
            b.put(*c[2][v & 255])
            b.put(*c[3][v >> 24])
        elif t[0] == "K":
            b.put(*c[0][280 + t[1]])
        else:
            for j, v in ((0, t[1]), (4, t[2])):
                sym, nbits, extra = prefix_value(v)
                b.put(*c[j][(256 if j == 0 else 0) + sym])
                b.put(extra, nbits)


def vp8l_bytes(w, h, argb, transforms=(), alpha=0, version=0, signature=0x2F, **kw) -> bytes:
    """A VP8L bitstream: the header, the transforms (("predictor", bits,
    modes), ("cross", bits, codes), ("green",), ("index", palette), or
    ("raw", type) for a bare type field), then ``argb`` ([rows, coded
    width] uint32, the image as coded, after the transforms) by
    ``put_image``."""
    b = Bits()
    b.put(signature, 8)
    b.put(w - 1, 14)
    b.put(h - 1, 14)
    b.put(alpha, 1)
    b.put(version, 3)
    for t in transforms:
        b.put(1, 1)
        if t[0] == "raw":
            b.put(t[1], 2)
            continue
        b.put({"predictor": 0, "cross": 1, "green": 2, "index": 3}[t[0]], 2)
        if t[0] in ("predictor", "cross"):
            b.put(t[1] - 2, 3)
            data = np.asarray(t[2], np.uint32)
            put_image(b, data << 8 if t[0] == "predictor" else data)
        elif t[0] == "index":
            palette = np.asarray(t[1], np.uint32).reshape(1, -1)
            b.put(palette.size - 1, 8)
            put_image(b, palette)
    b.put(0, 1)
    put_image(b, np.asarray(argb, np.uint32), top=True, **kw)
    return b.bytes()


def argb_noise(h, w, seed, alpha=True, levels=256):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, levels, (h, w, 4)).astype(np.uint32)
    if not alpha:
        v[..., 3] = 255
    return (v[..., 3] << 24) | (v[..., 2] << 16) | (v[..., 1] << 8) | v[..., 0]


def runs(h, w, seed):
    """Pixels with runs along rows and repeats down columns: copies and
    cache hits to write."""
    rng = np.random.default_rng(seed)
    base = argb_noise(h, w // 3 + 1, seed, levels=4)
    img = np.repeat(base, 3, axis=1)[:, :w]
    img[1::2] = img[0::2][: img[1::2].shape[0]]
    flip = rng.random((h, w)) < 0.1
    return np.where(flip, argb_noise(h, w, seed + 1), img).astype(np.uint32)


# -- encoder cases -----------------------------------------------------------------


def kind_image(kind: str, seed: int) -> np.ndarray:
    """BGR or BGRA uint8 of a named kind."""
    rng = np.random.default_rng(seed)
    h, w = {"1x1": (1, 1), "1xN": (1, 37), "Nx1": (29, 1)}.get(kind, (19, 27))
    if kind.startswith("palette"):
        n = int(kind[7:])
        pal = rng.integers(0, 256, (n, 3), np.uint8)
        idx = rng.integers(0, n, (h, w))
        idx[0, :n] = np.arange(min(n, w)) if n <= w else idx[0, :n]
        return pal[idx]
    if kind == "grey":
        return np.repeat(rng.integers(0, 256, (h, w, 1), np.uint8), 3, axis=2)
    if kind == "bgra":
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        img[..., 3] = rng.choice([0, 1, 128, 254, 255], (h, w))
        return img
    if kind == "smooth":
        y, x = np.mgrid[:h, :w]
        return np.stack([(3 * x + y) % 256, (x * y) % 256, (5 * y) % 256], axis=2).astype(np.uint8)
    return rng.integers(0, 256, (h, w, 3), np.uint8)


KINDS = ["colour", "grey", "bgra", "smooth", "palette2", "palette3", "palette4", "palette5", "palette16",
         "palette17", "palette256", "1x1", "1xN", "Nx1"]
ENCODERS = ["cv2", "cv2_q100"] + [f"pil_m{m}" for m in range(7)] + ["pil_exact", "pil_q0"]


def encode(img: np.ndarray, encoder: str) -> bytes:
    if encoder.startswith("cv2"):
        params = [cv2.IMWRITE_WEBP_QUALITY, 101] if encoder == "cv2_q100" else []
        return cv2.imencode(".webp", img, params)[1].tobytes()
    rgb = img[..., [2, 1, 0, 3]] if img.shape[2] == 4 else img[..., ::-1]
    opts = {"pil_exact": {"exact": True, "method": 4}, "pil_q0": {"quality": 0, "method": 6}}.get(encoder)
    if opts is None:
        m = int(encoder[5:])
        opts = {"method": m, "quality": (0, 25, 50, 75, 100, 60, 90)[m]}
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "WEBP", lossless=True, **opts)
    return buf.getvalue()


def read_answers(data: bytes, tmp_path) -> str:
    path = tmp_path / "x.webp"
    path.write_bytes(data)
    logging.disable(logging.WARNING)
    try:
        return compare(cv2.imread(str(path)), imcodec.read_image(str(path)))
    finally:
        logging.disable(logging.NOTSET)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("encoder", ENCODERS)
def test_encoded_webps_answer_as_cv2(kind, encoder, tmp_path):
    """cv2's and PIL's lossless files decode to cv2's pixels, by
    ``decode_image`` and by ``read_image``; BGR input comes back exactly."""
    img = kind_image(kind, KINDS.index(kind))
    data = encode(img, encoder)
    assert data[12:16] in (b"VP8L", b"VP8X"), data[12:16]
    got = port_decode(data)
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"
    if img.shape[2] == 3:
        assert (got == img).all()
    elif encoder == "pil_exact":  # alpha dropped, not blended: the BGR as stored
        assert (got == img[..., :3]).all()


# -- written bitstreams ---------------------------------------------------------------


def distance_stream(code: int) -> bytes:
    """Eight rows and 8 pixels of literals on a 13x12 image, then a copy of
    20 under distance code ``code`` (past 120: distance code - 120)."""
    w, h = 13, 12
    lit = [("L", 0xFF000000 + 0x10203 * k) for k in range(w)]
    return vp8l_bytes(w, h, np.zeros((h, w), np.uint32), tokens=lit * 8 + lit[:8] + [("C", 20, code)]
                      + [("L", 0xFF0000FF)] * (w * h - 8 * w - 28))


def written_cases() -> dict:
    """name → a simple-format file around a written VP8L stream."""
    cases = {}
    h, w = 9, 13
    res = argb_noise(h, w, 1)
    for mode in range(16):  # each predictor mode alone, over 4x4 blocks
        modes = np.full((3, 4), mode)
        cases[f"predictor_mode{mode}"] = vp8l_bytes(w, h, res, [("predictor", 2, modes)])
    modes = np.random.default_rng(2).integers(0, 16, (2, 2))
    cases["predictor_mixed_bits3"] = vp8l_bytes(w, h, res, [("predictor", 3, modes)])
    cases["predictor_bits9_width1"] = vp8l_bytes(1, h, argb_noise(h, 1, 3), [("predictor", 9, [[11]])])
    cases["predictor_width2_modes"] = vp8l_bytes(2, 5, argb_noise(5, 2, 3), [("predictor", 2, [[13], [5]])])
    codes = argb_noise(2, 2, 4)
    cases["cross_colour"] = vp8l_bytes(w, h, res, [("cross", 3, codes)])
    cases["cross_colour_bits2"] = vp8l_bytes(w, h, res, [("cross", 2, argb_noise(3, 4, 5))])
    cases["subtract_green"] = vp8l_bytes(w, h, res, [("green",)])
    for n in (1, 2, 3, 4, 5, 16, 17, 256):  # colour indexing: 8, 4, 2 or 1 pixels a coded pixel
        bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
        cw = (w + (1 << bits) - 1) >> bits
        packed = np.random.default_rng(n).integers(0, 256, (h, cw)).astype(np.uint32) << 8
        cases[f"index_{n}colours"] = vp8l_bytes(w, h, packed, [("index", argb_noise(1, n, n))])
    # an index past the palette: transparent black (the 256-entry table)
    cases["index_past_palette"] = vp8l_bytes(w, h, np.full((h, w), 200 << 8, np.uint32),
                                             [("index", argb_noise(1, 20, 6))])
    cases["index_then_predictor"] = vp8l_bytes(w, h, argb_noise(h, 7, 7),  # the predictor on the packed width
                                               [("index", argb_noise(1, 5, 8)), ("predictor", 2, np.full((3, 2), 11))])
    cases["all_four"] = vp8l_bytes(w, h, argb_noise(h, 7, 9), [
        ("green",), ("predictor", 2, np.full((3, 4), 12)), ("cross", 2, argb_noise(3, 4, 10)),
        ("index", argb_noise(1, 9, 11))])
    for kind in ("predictor", "cross", "green", "index"):  # a transform given twice
        t = {"predictor": ("predictor", 2, np.zeros((3, 4))), "cross": ("cross", 2, np.zeros((3, 4))),
             "green": ("green",), "index": ("index", argb_noise(1, 20, 12))}[kind]
        cases[f"twice_{kind}"] = vp8l_bytes(w, h, res, [t, t])
    pix = runs(h, w, 13)
    for bits in range(0, 13):  # the colour cache: 1..11 read, 0 and 12 refused
        cases[f"cache_bits{bits}"] = vp8l_bytes(w, h, pix, cache_bits=min(bits, 11) if 0 < bits <= 11 else 0,
                                                cache_field=bits)
    cases["no_cache"] = vp8l_bytes(w, h, pix)
    cases["cache_no_lz77"] = vp8l_bytes(w, h, pix, cache_bits=4, lz77=False)
    two = np.where(np.random.default_rng(14).random((h, w)) < 0.5, 0xFF102030, 0xFF405060).astype(np.uint32)
    cases["simple_one_symbol"] = vp8l_bytes(w, h, np.full((h, w), 0xFF010203, np.uint32), simple=(0, 1, 2, 3, 4),
                                            lz77=False)
    cases["simple_two_symbols"] = vp8l_bytes(w, h, two, simple=(0, 1, 2, 3, 4), lz77=False)
    cases["simple_first_symbol_1bit"] = vp8l_bytes(w, h, np.full((h, w), 0xFF000100, np.uint32), simple=(0,),
                                                   lz77=False)
    cases["one_used_symbol_normal"] = vp8l_bytes(w, h, np.full((h, w), 0x80FF7F01, np.uint32), lz77=False)
    cases["no_repeat_codes"] = vp8l_bytes(w, h, pix, repeats=False)
    # green 0..99 in order: a run of equal lengths (16), short and long
    # runs of zeros (17, 18) in the code lengths
    ramp = (0xFF000000 | (np.arange(100, dtype=np.uint32) << 8)).reshape(4, 25)
    cases["every_repeat_code"] = vp8l_bytes(25, 4, ramp, lz77=False)
    cases["untrimmed_lengths"] = vp8l_bytes(w, h, pix, trim=False)
    rng = np.random.default_rng(15)
    for bits, groups in ((2, rng.integers(0, 4, (3, 4))), (3, rng.integers(0, 3, (2, 2))), (2, np.eye(3, 4))):
        cases[f"meta_bits{bits}_{int(groups.max()) + 1}groups"] = vp8l_bytes(w, h, pix, meta=(bits, groups))
    cases["meta_unused_group"] = vp8l_bytes(w, h, pix, meta=(2, np.full((3, 4), 2)))
    cases["meta_groups_past_pixels"] = vp8l_bytes(3, 2, argb_noise(2, 3, 16), meta=(9, [[9]]))
    cases["meta_with_cache"] = vp8l_bytes(w, h, pix, meta=(2, rng.integers(0, 3, (3, 4))), cache_bits=3)
    cases["over_subscribed"] = vp8l_bytes(w, h, pix, bad="over")
    cases["incomplete"] = vp8l_bytes(w, h, pix, bad="incomplete")
    cases["version1"] = vp8l_bytes(w, h, res, version=1)
    cases["version7"] = vp8l_bytes(w, h, res, version=7)
    cases["signature_2e"] = vp8l_bytes(w, h, res, signature=0x2E)
    lit = [("L", 0xFF000000 + k) for k in range(w)]
    cases["copy_before_first"] = vp8l_bytes(w, h, res, tokens=[("C", 3, 2)] + lit * h)
    cases["copy_past_last"] = vp8l_bytes(w, h, res, tokens=lit * (h - 1) + lit[:5] + [("C", 20, 2)])
    cases["copy_to_the_last"] = vp8l_bytes(w, h, res, tokens=lit * (h - 1) + lit[:5] + [("C", w - 5, 2)])
    cases["copy_row_above_overlapping"] = vp8l_bytes(w, h, res, tokens=lit + [("C", w * (h - 1), 1)])
    for code in (1, 4, 30, 97, 120, 121, 130, 400):  # the distance map, and distances past it
        cases[f"distance_code{code}"] = distance_stream(code)
    # a distance under 1 is taken as 1: (-1, 1) on a one-pixel-wide image
    cases["distance_below_1"] = vp8l_bytes(1, 6, res, tokens=[("L", 0xFF112233), ("C", 5, 4)])
    cases["long_copy_4096"] = vp8l_bytes(64, 80, res, tokens=[("L", 0xFF445566), ("C", 4096, 2), ("C", 1023, 2)])
    full = vp8l_bytes(w, h, res)
    cases["trailing_garbage"] = still(full + bytes(range(40)))
    # the chunk's padding byte is read as data, and so is what follows the
    # chunk: a stream cut by one byte reads the pad, by two it ends first
    cases["cut_by_one_byte_reads_the_pad"] = still(full[:-1])
    cases["cut_by_two_bytes"] = still(full[:-2])
    cases["cut_by_two_bytes_reads_the_next_chunk"] = riff(chunk(b"VP8L", full[:-2]) + chunk(b"ABCD", b"\xff" * 6))
    tiny = vp8l_bytes(1, 1, np.full((1, 1), 0xFF123456, np.uint32), simple=(0, 1, 2, 3, 4))
    cases["under_8_bytes"] = still(tiny)  # read as 64 bits, zero-padded
    cases["under_8_bytes_needing_more"] = still(vp8l_bytes(2, 2, argb_noise(2, 2, 17))[:6])
    cases["max_symbol_2_before_the_only_length"] = vp8l_bytes(w, h, np.full((h, w), 0xFF000000, np.uint32),
                                                              lz77=False, max_symbol=2)
    cases["max_symbol_past_alphabet"] = vp8l_bytes(w, h, pix, max_symbol=300)
    return {k: v if v[:4] == b"RIFF" else still(v) for k, v in cases.items()}


WRITTEN = written_cases()
REFUSED = {"twice_predictor", "twice_cross", "twice_green", "twice_index", "cache_bits0", "cache_bits12",
           "over_subscribed", "incomplete", "version1", "version7", "signature_2e", "copy_before_first",
           "copy_past_last", "distance_code400", "cut_by_two_bytes", "under_8_bytes_needing_more",
           "max_symbol_2_before_the_only_length", "max_symbol_past_alphabet"}


@pytest.mark.parametrize("name", list(WRITTEN))
def test_written_vp8l_streams_answer_as_cv2(name):
    """Each libwebp rule on a stream written for it: the port gives cv2's
    pixels or its ``None``."""
    data = WRITTEN[name]
    assert answers(data) in ("none", "equal")


def test_written_streams_reach_both_answers():
    """The written cases decode but for the ones written to be refused, and
    the port's pixels hold two rules libwebp has by construction."""
    refused = {n for n, d in WRITTEN.items() if cv2_decode(d) is None}
    assert refused == REFUSED
    # predictor modes 14 and 15 predict from black, as mode 0 does
    m0, m14, m15 = (port_decode(WRITTEN[f"predictor_mode{m}"]) for m in (0, 14, 15))
    assert (m0 == m14).all() and (m0 == m15).all()
    # an index past the palette is transparent black
    assert (port_decode(WRITTEN["index_past_palette"]) == 0).all()


def test_every_distance_code_answers_as_cv2():
    """The 120 short distances (dy * width + dx) and the long ones past them."""
    for code in range(1, 140):
        assert answers(still(distance_stream(code))) == "equal", code


# -- containers --------------------------------------------------------------------


def frame_image(seed: int, h: int = 10, w: int = 16, alpha: bool = False):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4 if alpha else 3), np.uint8)
    if alpha:
        img[..., 3] = rng.choice([0, 1, 255], (h, w))
    return img


def pil_stream(img: np.ndarray) -> bytes:
    """The VP8L payload of PIL's ``exact`` file of a BGR or BGRA image (the
    colour under alpha 0 kept)."""
    data = encode(img, "pil_exact")
    at = data.index(b"VP8L") + 8
    return data[at : at + struct.unpack("<I", data[at - 4 : at])[0]]


def container_cases() -> dict:
    """name → a file; the probes of cv2 5.0's libwebp are named probe<N>_."""
    img = frame_image(1)
    v = chunk(b"VP8L", stream_of(encode(img, "cv2")))
    exif6 = chunk(b"EXIF", exif(6))
    cases = {
        "probe1_cv2_default": encode(img, "cv2"),
        "probe1_grey": encode(np.repeat(img[..., :1], 3, axis=2), "cv2"),
        "probe1_palette": encode(kind_image("palette16", 1), "cv2"),
        "probe2_bgra_exact_alpha_dropped": riff(chunk(b"VP8L", pil_stream(frame_image(2, alpha=True)))),
        "probe2_bgra_cv2_alpha0_zeroed": encode(frame_image(2, alpha=True), "cv2"),
        "probe3_vp8x_iccp_vp8l": riff(vp8x(16, 10, 0x20) + chunk(b"ICCP", b"\0" * 21) + v),
        "probe3_vp8x_vp8l_exif": riff(vp8x(16, 10, 0x08) + v + chunk(b"EXIF", exif(1))),
        "probe3_orientation6_turns_10x16": riff(vp8x(16, 10, 0x08) + v + exif6),
        "probe3_canvas_wider": riff(vp8x(17, 10) + v),
        "probe3_canvas_taller": riff(vp8x(16, 11) + v),
        "probe5_31_bytes": encode(img, "cv2")[:31],
        "probe5_32_bytes": encode(img, "cv2")[:32],
        "probe5_cut_by_one": encode(img, "cv2")[:-1],
        "probe5_trailing_bytes": encode(img, "cv2") + bytes(range(100)),
        "probe5_riff_size_plus100": riff(v, 100),
        "probe5_riff_size_minus10": riff(v, -10),
    }
    for delta in (-2, -1, 1, 2):
        cases[f"riff_size_{delta:+d}"] = riff(v, delta)
    for flags in (0, 0x10, 0x3C, 0x01, 0x40, 0x80, 0x0108):
        cases[f"vp8x_flags_{flags:#x}_exif6"] = riff(vp8x(16, 10, flags | 0x08) + v + exif6)
    for o in range(1, 9):
        for order in ("II", "MM"):
            for prefix in (b"", b"Exif\0\0"):
                name = f"exif_orientation{o}_{order}{'_exif_prefix' if prefix else ''}"
                cases[name] = riff(vp8x(16, 10, 0x08) + v + chunk(b"EXIF", exif(o, prefix, order)))
    orientation = (0x112, 3, 1, struct.pack("<HH", 6, 0))
    for name, entry in (  # an entry before the orientation whose value cv2's ExifReader reads
            ("make_in_range", (0x10F, 2, 3, b"ab\0\0")),
            ("make_past_the_end", (0x10F, 2, 100, struct.pack("<I", 5000))),
            ("make_offset_in_size_past", (0x10F, 2, 40, struct.pack("<I", 20))),
            ("make_short_count_200", (0x10F, 2, 200, struct.pack("<I", 8))),
            ("xresolution_past_the_end", (0x11A, 5, 1, struct.pack("<I", 5000))),
            ("xresolution_in_range", (0x11A, 5, 1, struct.pack("<I", 8))),
            ("white_point_past_the_end", (0x13E, 5, 2, struct.pack("<I", 30))),
            ("reference_black_white_past_the_end", (0x214, 5, 6, struct.pack("<I", 10))),
            ("resolution_unit", (0x128, 3, 1, struct.pack("<I", 2))),
            ("copyright_past_the_end", (0x8298, 2, 50, struct.pack("<I", 9999))),
            ("exif_ifd_pointer_past_the_end", (0x8769, 4, 1, struct.pack("<I", 9999))),
            ("unknown_tag_past_the_end", (0x100, 4, 100, struct.pack("<I", 5000)))):
        cases[f"exif_{name}_then_orientation6"] = riff(vp8x(16, 10, 0x08) + v + chunk(b"EXIF", exif_ifd(
            [entry, orientation])))
    cases["exif_orientation9"] = riff(vp8x(16, 10, 0x08) + v + chunk(b"EXIF", exif(9)))
    cases["exif_order_XY_read_big_endian"] = riff(vp8x(16, 10, 0x08) + v
                                                  + chunk(b"EXIF", b"XY" + exif(6, order="MM")[2:]))
    cases["exif_cut_inside_ifd"] = riff(vp8x(16, 10, 0x08) + v + chunk(b"EXIF", exif(6)[:19]))
    cases["exif_flag_unset"] = riff(vp8x(16, 10) + v + exif6)
    cases["exif_before_image"] = riff(vp8x(16, 10, 0x08) + exif6 + v)
    cases["exif_two_chunks_first_wins"] = riff(vp8x(16, 10, 0x08) + v + exif6 + chunk(b"EXIF", exif(1)))
    cases["exif_in_simple_format"] = riff(v + exif6)
    cases["exif_after_chunk_past_riff"] = riff(vp8x(16, 10, 0x08) + v + exif6 + b"ABCD" + struct.pack("<I", 99))
    cases["exif_riff_cuts_it"] = riff(vp8x(16, 10, 0x08) + v + exif6, -2)
    cases["xmp_iccp_exif"] = riff(vp8x(16, 10, 0x2C) + chunk(b"ICCP", b"icc") + v + chunk(b"XMP ", b"<x/>") + exif6)
    cases["unknown_chunks_odd_padded"] = riff(vp8x(16, 10, 0x08) + chunk(b"ABCD", b"123") + v + chunk(b"WXYZ", b"1")
                                              + exif6)
    cases["odd_chunk_unpadded"] = riff(vp8x(16, 10) + chunk(b"ABCD", b"123", pad=False) + v)
    cases["second_vp8x"] = riff(vp8x(16, 10, 0x08) + v + vp8x(16, 10) + exif6)
    cases["second_vp8l"] = riff(vp8x(16, 10, 0x08) + v + v + exif6)
    cases["alph_before_vp8l"] = riff(vp8x(16, 10, 0x18) + chunk(b"ALPH", b"\0\0") + v + exif6)
    cases["vp8x_size_12"] = riff(chunk(b"VP8X", struct.pack("<I", 8) + le24(15) + le24(9) + b"\0\0") + v)
    cases["vp8x_no_image"] = riff(vp8x(16, 10, 0x08) + exif6)
    cases["simple_unknown_chunk_first"] = riff(chunk(b"ABCD", b"1234") + v)
    cases["bare_vp8l_stream"] = stream_of(encode(img, "cv2"))
    cases["bare_vp8l_chunk"] = v
    cases["vp8l_chunk_past_riff"] = riff(chunk(b"VP8L", stream_of(encode(img, "cv2")))[:-8])
    # animations: the first frame on a zero canvas
    f = chunk(b"VP8L", stream_of(encode(img, "cv2")))
    fa = chunk(b"VP8L", pil_stream(frame_image(3, alpha=True)))

    def animation(frames, w=24, h=18, flags=0x02, before=b"", after=b"", an=None):
        return riff(vp8x(w, h, flags) + before + (anim() if an is None else an) + b"".join(frames) + after)

    cases["probe4_first_frame_at_offset"] = animation([anmf(2, 4, 16, 10, 0, f)])
    cases["probe4_background_alpha0_ignored"] = animation([anmf(2, 4, 16, 10, 0, f)], an=anim(0x00FFFFFF))
    cases["probe4_background_alpha255_ignored"] = animation([anmf(2, 4, 16, 10, 0, f)], an=anim(0xFFFFFFFF))
    for bits in range(4):
        cases[f"probe4_alpha_pixels_bits{bits}"] = animation([anmf(4, 2, 16, 10, bits, fa)])
    cases["anim_canvas_equal_frame"] = animation([anmf(0, 0, 16, 10, 0, f)], 16, 10)
    cases["anim_anmf_size_fields_ignored"] = animation([anmf(2, 4, 3, 5, 0, f)])
    cases["anim_frame_past_canvas"] = animation([anmf(10, 4, 16, 10, 0, f)])
    cases["anim_two_frames"] = animation([anmf(2, 4, 16, 10, 0, f), anmf(0, 0, 16, 10, 0, fa)])
    cases["anim_second_frame_past_canvas"] = animation([anmf(2, 4, 16, 10, 0, f), anmf(10, 0, 16, 10, 0, f)])
    cases["anim_no_anim_chunk"] = animation([anmf(2, 4, 16, 10, 0, f)], an=b"")
    cases["anim_no_frames"] = animation([])
    cases["anim_chunks_without_the_flag"] = animation([anmf(2, 4, 16, 10, 0, f)], flags=0)
    cases["anim_exif_orientation6"] = animation([anmf(2, 4, 16, 10, 0, f)], flags=0x0A, after=exif6)
    cases["anim_exif_flag_unset"] = animation([anmf(2, 4, 16, 10, 0, f)], after=exif6)
    cases["anim_unknown_chunk_after_frame"] = animation([anmf(2, 4, 16, 10, 0, f + chunk(b"ABCD", b"xy"))])
    cases["anim_unknown_chunk_before_frame"] = animation([anmf(2, 4, 16, 10, 0, chunk(b"ABCD", b"xy") + f)])
    cases["anim_image_outside_frames"] = animation([anmf(2, 4, 16, 10, 0, f)], after=f)
    cases["anim_alph_before_vp8l"] = animation([anmf(2, 4, 16, 10, 0, chunk(b"ALPH", b"\0\0") + f)])
    cases["anim_corrupt_frame"] = animation([anmf(2, 4, 16, 10, 0, chunk(b"VP8L", stream_of(encode(img, "cv2"))[:60]))])
    cases["anim_frame_reads_no_further_than_its_chunk"] = animation([anmf(2, 4, 16, 10, 0, chunk(
        b"VP8L", stream_of(encode(img, "cv2"))[:-2]) + chunk(b"ABCD", bytes(range(200))))])
    cases["anim_riff_size_minus2"] = riff(animation([anmf(2, 4, 16, 10, 0, f)])[12:], -2)
    return cases


CONTAINERS = container_cases()


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_webp_containers_answer_as_cv2(name, tmp_path):
    """The simple and extended formats, EXIF orientations, animations'
    first frames and the container's size rules, by ``decode_image`` and by
    ``read_image``."""
    data = CONTAINERS[name]
    assert answers(data) in ("none", "equal")
    assert read_answers(data, tmp_path) in ("none", "equal")


def test_the_probes_of_cv2s_webp_rules():
    """What the named cases show, stated."""
    img = frame_image(1)
    dec = {name: port_decode(CONTAINERS[name]) for name in CONTAINERS}
    assert (dec["probe1_cv2_default"] == img).all()
    assert (dec["probe2_bgra_exact_alpha_dropped"] == frame_image(2, alpha=True)[..., :3]).all()
    assert (dec["probe3_orientation6_turns_10x16"] == np.rot90(img, -1)).all()
    for name in ("probe3_canvas_wider", "probe5_31_bytes", "probe5_32_bytes", "probe5_cut_by_one",
                 "probe5_riff_size_plus100", "probe5_riff_size_minus10", "anim_frame_past_canvas", "anim_no_frames"):
        assert dec[name] is None, name
    assert (dec["probe5_trailing_bytes"] == img).all()
    first = dec["probe4_first_frame_at_offset"]
    assert first.shape == (18, 24, 3) and (first[4:14, 2:18] == img).all() and first.sum() == img.sum()
    assert (dec["probe4_background_alpha0_ignored"] == first).all()
    for bits in range(4):  # copied as they are, alpha 0 or 1 included: the first frame is a key frame
        got = dec[f"probe4_alpha_pixels_bits{bits}"]
        assert (got[2:12, 4:20] == frame_image(3, alpha=True)[..., :3]).all()
    assert (dec["anim_exif_orientation6"] == np.rot90(first, -1)).all()
    assert (dec["exif_orientation6_MM"] == np.rot90(img, -1)).all()
    assert (dec["exif_orientation6_II_exif_prefix"] == img).all()  # the prefix hides the TIFF header
    # ExifReader reads a string's or rationals' bytes before it reaches the
    # orientation: one past the payload ends the parse
    assert dec["exif_make_in_range_then_orientation6"].shape == (16, 10, 3)
    assert dec["exif_make_past_the_end_then_orientation6"].shape == (10, 16, 3)
    assert dec["exif_unknown_tag_past_the_end_then_orientation6"].shape == (16, 10, 3)


def test_every_cut_of_a_webp_answers_as_cv2():
    """Each prefix of a simple file, of an extended file with EXIF and of an
    animation."""
    for name in ("probe1_cv2_default", "exif_orientation6_II", "probe4_first_frame_at_offset"):
        data = CONTAINERS[name]
        bad = [k for k in range(1, len(data) + 1) if answers(data[:k]) not in ("none", "equal")]
        assert not bad, (name, bad[:10])


GARBLED = ["probe1_cv2_default", "probe2_bgra_exact_alpha_dropped", "xmp_iccp_exif", "probe4_alpha_pixels_bits2",
           "anim_two_frames"]


@pytest.mark.parametrize("name", GARBLED + ["written_all_four", "written_meta_with_cache", "written_index_2colours",
                                            "encoded_palette17"])
def test_garbled_webps_answer_as_cv2(name):
    """300 seeded copies with 1–3 bytes set at random past "RIFF": many still
    decode, to libwebp's pixels."""
    kind, case = name.split("_", 1)
    if kind == "written":
        data = WRITTEN[case]
    elif kind == "encoded":
        data = encode(kind_image(case, 0), "pil_m6")
    else:
        data = CONTAINERS[name]
    seed = (GARBLED + ["written_all_four"]).index(name) if name in GARBLED else len(name)
    outcomes = [answers(d) for d in garbled(data, 300, seed=seed, first=4)]
    bad = [(i, a) for i, a in enumerate(outcomes) if a not in ("none", "equal", "known")]
    assert not bad, f"{len(bad)} of 300 differ from cv2, e.g. {bad[:8]}"
    assert outcomes.count("equal") > 15  # damage past the header mostly decodes


def test_xor_0x55_into_each_byte_answers_as_cv2():
    """The probe of damaged VP8L data: 0x55 XOR-ed into each byte of a file
    of about 1,240 bytes in turn, from byte 30 on. Most damage decodes to
    some image, which must be libwebp's."""
    data = encode(frame_image(5, 19, 33), "cv2")
    assert 1000 < len(data) < 3000
    outcomes = []
    for at in range(30, len(data)):
        bad = bytearray(data)
        bad[at] ^= 0x55
        outcomes.append(answers(bytes(bad)))
    differ = [(i + 30, a) for i, a in enumerate(outcomes) if a not in ("none", "equal")]
    assert not differ, differ
    assert outcomes.count("equal") > outcomes.count("none")


# -- lossy files, once refused --------------------------------------------------------


def lossy_cases() -> dict:
    img = frame_image(6)
    buf = io.BytesIO()
    Image.fromarray(frame_image(6, alpha=True)[..., [2, 1, 0, 3]]).save(buf, "WEBP", quality=80)
    q90 = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes()
    frame = q90[12:]
    return {"vp8": q90, "vp8x_alph_vp8": buf.getvalue(),
            "animation_of_vp8": riff(vp8x(24, 18, 0x02) + anim() + anmf(2, 4, 16, 10, 0, frame))}


@pytest.mark.parametrize("name", ["vp8", "vp8x_alph_vp8", "animation_of_vp8"])
def test_a_lossy_webp_is_the_named_known_difference(name, caplog):
    """A lossy (``VP8 ``) WebP, once the known difference, decodes to cv2's
    pixels with no log line: a still image, one with ALPH, an animation's
    first frame. No WebP is refused for its kind."""
    data = lossy_cases()[name]
    assert cv2_decode(data) is not None
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is not None
    assert not caplog.records
    assert answers(data) == "equal"
    assert not hasattr(imcodec, "WEBP_UNPORTED")
    assert not imcodec.FORMAT_NAMES  # AVIF is decoded since (tests/test_torch_avif.py)


def test_every_webp_refusal_logs_one_line_naming_it(caplog):
    for name, data in list(CONTAINERS.items()) + [(f"written {n}", WRITTEN[n]) for n in sorted(REFUSED)]:
        caplog.clear()
        with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
            got = imcodec.decode_image(data)
        if got is None:
            assert len(caplog.records) == 1 and "WebP" in caplog.records[0].getMessage(), name


def test_a_webp_raises_when_its_decoder_cannot_be_built(monkeypatch):
    """A missing compiler is not a bad image: the decode raises and never
    falls back."""
    from ppocr_tpu_torch.ops import native

    def no_compiler(source=None):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(native, "_webp_lib", None)
    monkeypatch.setattr(native, "build", no_compiler)
    with pytest.raises(RuntimeError, match="compiler"):
        imcodec.decode_image(CONTAINERS["probe1_cv2_default"])


# -- mutations, for the committed cases and the fuzz runs -------------------------------


def chunk_offsets(data: bytes) -> list:
    """The offsets of the chunk headers, at the top level and inside ANMF."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        out.append(pos)
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        if data[pos : pos + 4] == b"ANMF":
            inner = pos + 24
            while inner + 8 <= min(len(data), pos + 8 + size):
                out.append(inner)
                inner += 8 + struct.unpack("<I", data[inner + 4 : inner + 8])[0]
                inner += inner & 1
        pos += 8 + size + (size & 1)
    return out


def mutations(data: bytes, n: int, seed: int) -> list:
    """``n`` changed copies of a WebP file: its RIFF size or a chunk's size
    moved, VP8X flags or canvas changed, ANMF fields changed, bits flipped
    or the file cut inside the VP8L data, or 1–3 bytes set at random; in a
    lossy file also (``vp8_mutation``) a token partition's size or the
    first partition's moved, the frame header's bits flipped, bits flipped
    in the first partition or in the token partitions, the VP8 data cut
    (the chunk and RIFF sizes moved with it where the chunk ends the file),
    or the ALPH header byte changed."""
    rng = np.random.default_rng(seed)
    heads = chunk_offsets(data)
    vp8l = [p for p in heads if data[p : p + 4] == b"VP8L"]
    vp8 = [p for p in heads if data[p : p + 4] == b"VP8 "]
    alph = [p for p in heads if data[p : p + 4] == b"ALPH"]
    out = []
    for _ in range(n):
        bad = bytearray(data)
        kind = rng.integers(0, 12 if vp8 else 7)
        if kind >= 7:
            out.append(vp8_mutation(data, int(kind) - 7, int(rng.choice(vp8)), alph, rng))
            continue
        if kind == 0:
            size = struct.unpack("<I", data[4:8])[0]
            bad[4:8] = struct.pack("<I", max(0, size + int(rng.integers(-12, 13))) if rng.random() < 0.8
                                   else int(rng.integers(0, 1 << 32)))
        elif kind == 1 and heads:
            at = int(rng.choice(heads))
            size = struct.unpack("<I", data[at + 4 : at + 8])[0]
            bad[at + 4 : at + 8] = struct.pack("<I", max(0, size + int(rng.integers(-9, 10))) if rng.random() < 0.8
                                               else int(rng.integers(0, 1 << 32)))
        elif kind == 2 and data[12:16] == b"VP8X":
            if rng.random() < 0.5:
                bad[20] = int(rng.integers(0, 256))
            else:
                at = 24 + 3 * int(rng.integers(0, 2))
                v = int.from_bytes(data[at : at + 3], "little") + int(rng.integers(-3, 4))
                bad[at : at + 3] = (v % (1 << 24)).to_bytes(3, "little")
        elif kind == 3 and b"ANMF" in data:
            at = data.index(b"ANMF") + 8 + int(rng.integers(0, 16))
            bad[at] = int(rng.integers(0, 256)) if rng.random() < 0.5 else (bad[at] + int(rng.integers(-2, 3))) % 256
        elif kind == 4 and vp8l:
            at = int(rng.choice(vp8l)) + 8
            end = min(len(data), at + struct.unpack("<I", data[at - 4 : at])[0])
            for _ in range(int(rng.integers(1, 4))):
                k = int(rng.integers(at, max(at + 1, end)))
                if k < len(bad):
                    bad[k] ^= 1 << int(rng.integers(0, 8))
        elif kind == 5 and vp8l:
            at = int(rng.choice(vp8l)) + 8
            bad = bad[: int(rng.integers(at, len(data) + 1))]
        else:
            for at in rng.integers(4, len(bad), rng.integers(1, 4)):
                bad[at] = int(rng.integers(0, 256))
        out.append(bytes(bad))
    return out


def vp8_mutation(data: bytes, kind: int, at: int, alph: list, rng) -> bytes:
    """One change of a lossy file's VP8 chunk at ``at`` (or its ALPH chunk)."""
    bad = bytearray(data)
    start = at + 8
    size = struct.unpack("<I", data[at + 4 : start])[0]
    end = min(len(data), start + size)
    first = int.from_bytes(data[start : start + 3], "little") >> 5
    if kind == 0:  # the first partition's size, or a token partition's
        if rng.random() < 0.3:
            tag = int.from_bytes(data[start : start + 3], "little")
            moved = max(0, first + int(rng.integers(-4, 5))) if rng.random() < 0.8 else int(rng.integers(0, 1 << 19))
            bad[start : start + 3] = ((tag & 31) | (moved << 5)).to_bytes(3, "little")
        else:
            k = start + 10 + first + 3 * int(rng.integers(0, 7))
            if k + 3 <= len(bad):
                v = int.from_bytes(bad[k : k + 3], "little") + int(rng.integers(-6, 7))
                bad[k : k + 3] = (v % (1 << 24) if rng.random() < 0.8 else int(rng.integers(0, 1 << 24))).to_bytes(
                    3, "little")
    elif kind in (1, 2, 3):  # the frame header, the first partition, the token partitions
        lo, hi = ((start, start + 10), (start + 10, start + 10 + first), (start + 10 + first, end))[kind - 1]
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(lo, max(lo + 1, hi)))
            if k < len(bad):
                bad[k] ^= 1 << int(rng.integers(0, 8))
    elif kind == 4:  # a cut; where the chunk ends the file, its size and the RIFF's follow
        k = int(rng.integers(start, len(data) + 1))
        bad = bad[:k]
        if end + (size & 1) >= len(data) and rng.random() < 0.7:
            bad[at + 4 : start] = struct.pack("<I", k - start)
            bad += b"\0" * ((k - start) & 1)
            bad[4:8] = struct.pack("<I", len(bad) - 8)
    elif alph:  # the ALPH header byte
        k = int(rng.choice(alph)) + 8
        if k < len(bad):
            bad[k] = int(rng.integers(0, 256)) if rng.random() < 0.5 else bad[k] ^ (1 << int(rng.integers(0, 8)))
    else:
        bad[int(rng.integers(4, len(bad)))] = int(rng.integers(0, 256))
    return bytes(bad)


def fuzz_bases() -> dict:
    """The files the fuzz runs change: every container case, the written
    streams that decode, an encoded file of each kind, and the lossy bases
    of ``tests/test_torch_webp_lossy.py``."""
    import test_torch_webp_lossy as lossy

    bases = {f"container_{k}": v for k, v in CONTAINERS.items() if len(v) >= 32}
    bases.update({f"written_{k}": v for k, v in WRITTEN.items() if k not in REFUSED})
    bases.update({f"encoded_{k}": encode(kind_image(k, i), ("cv2", "pil_m6", "pil_exact")[i % 3])
                  for i, k in enumerate(KINDS)})
    bases.update({f"lossy_{k}": v for k, v in lossy.lossy_fuzz_bases().items()})
    return bases


def test_mutated_webps_answer_as_cv2():
    """40 mutations of each fuzz base (the fuzz runs take hundreds)."""
    outcomes = {}
    for i, (name, data) in enumerate(fuzz_bases().items()):
        for d in mutations(data, 40, seed=i):
            a = answers(d)
            outcomes[a] = outcomes.get(a, 0) + 1
            assert a in ("none", "equal", "known"), (name, a)
    assert outcomes["equal"] > 1000 and outcomes["none"] > 1000, outcomes


def test_the_repeat_code_case_writes_every_repeat_code():
    """``every_repeat_code``'s green code lengths use 16, 17 and 18."""
    lengths = complete_lengths(range(100), 280)
    assert {t[0] for t in length_tokens(lengths[:100])} >= {16} and {t[0] for t in length_tokens([0] * 5 + [3])} >= {
        17} and {t[0] for t in length_tokens([0] * 40 + [3])} >= {18}
    assert port_decode(WRITTEN["every_repeat_code"]) is not None and answers(WRITTEN["every_repeat_code"]) == "equal"
