"""The port's lossy WebP (``utils/imcodec.py`` with ``csrc/vp8.cpp``, its
lossless alpha planes through ``csrc/webp.cpp``) against
``cv2.imdecode(buf, IMREAD_COLOR)`` and ``cv2.imread`` (OpenCV 5.0 and its
bundled libwebp): the same ``None`` or not, and 0 differing pixels.

The files come from cv2's encoder (qualities 1 to 100, with and without a
fourth channel, so that ALPH chunks come from cv2 too), from PIL's (libwebp
1.6: every method, alpha qualities, ``exact``) and from the VP8 key-frame
writer here (``vp8_bytes``: a boolean encoder, the frame and picture
headers, random intra modes and coefficient tokens), which writes what the
encoders never emit: 2, 4 and 8 token partitions and partition sizes past
the data, segments with absolute and delta quantisers and filter levels,
the simple filter, filter level 0, every sharpness, the loop filter deltas,
no skip probability, the colour space, clamping and scale bits, quantiser
deltas at their clips, coefficients past int16, frame tags libwebp refuses;
and the ALPH chunks of ``alph_bytes`` (raw under each filter, lossless from
``tests/test_torch_webp.py``'s VP8L writer, pre-processing and reserved
bits, bad methods). Then cut, XOR-ed and mutated files, animations' first
frames and files read by path. The probes of libwebp's own rules are named
``probe_*`` and stated in their tests.
"""

import io
import re
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch import assets
from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.utils import imcodec
from test_torch_tiff import answers, cv2_decode, port_decode
from test_torch_webp import anim, anmf, chunk, exif, read_answers, riff, vp8l_bytes, vp8x

# -- RFC 6386's tables, as csrc/vp8.cpp holds them ------------------------------------
# (a wrong entry there would write streams that cv2 reads otherwise)


def c_table(name: str, shape) -> np.ndarray:
    text = native.VP8_SOURCE.read_text()
    body = re.search(rf"{name}\[[^=]*= \{{([^}}]*)\}}", text).group(1)
    return np.array([int(v) for v in body.split(",") if v.strip()]).reshape(shape)


UPDATE_PROBA = c_table("kCoeffsUpdateProba", (4, 8, 3, 11))
PROBA0 = c_table("kCoeffsProba0", (4, 8, 3, 11))
BMODES_PROBA = c_table("kBModesProba", (10, 10, 9))
BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
CAT = [(173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
       (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129)]
# libwebp's 4x4 modes: DC TM VE HE RD VR LD VL HD HU, as (bit, probability
# index) down the tree; 16x16 and chroma modes DC 0, TM 1, V 2, H 3
BMODE_CODES = {0: [(0, 0)], 1: [(1, 0), (0, 1)], 2: [(1, 0), (1, 1), (0, 2)]}
for _m, _tail in ((3, [(0, 3), (0, 4)]), (4, [(0, 3), (1, 4), (0, 5)]), (5, [(0, 3), (1, 4), (1, 5)]),
                  (6, [(1, 3), (0, 6)]), (7, [(1, 3), (1, 6), (0, 7)]), (8, [(1, 3), (1, 6), (1, 7), (0, 8)]),
                  (9, [(1, 3), (1, 6), (1, 7), (1, 8)])):
    BMODE_CODES[_m] = [(1, 0), (1, 1), (1, 2)] + _tail
YMODE_CODES = {0: [(0, 156), (0, 163)], 2: [(0, 156), (1, 163)], 3: [(1, 156), (0, 128)], 1: [(1, 156), (1, 128)]}
UVMODE_CODES = {0: [(0, 142)], 2: [(1, 142), (0, 114)], 3: [(1, 142), (1, 114), (0, 183)],
                1: [(1, 142), (1, 114), (1, 183)]}

# -- the VP8 writer -------------------------------------------------------------------


class BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder; ``bytes`` flushes it as
    libvpx does (32 bits of probability 1/2)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def put(self, bit, prob: int):
        split = 1 + (((self.range - 1) * int(prob)) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):  # carry
                k = len(self.out) - 1
                while self.out[k] == 255:
                    self.out[k] = 0
                    k -= 1
                self.out[k] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def signed(self, v: int, n: int):  # VP8GetSignedValue: magnitude, then sign
        self.literal(abs(v), n)
        self.put(v < 0, 128)

    def optional(self, v, n: int):  # a flag, then the signed value where it is not None
        self.put(v is not None, 128)
        if v is not None:
            self.signed(v, n)

    def bytes(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.out)


def put_tree(enc: BoolEncoder, codes, probs=None):
    for bit, p in codes:
        enc.put(bit, p if probs is None else probs[p])


def put_large(enc: BoolEncoder, v: int, p):
    """GetLargeValue's tree for a token of magnitude v ≥ 2."""
    if v <= 4:
        enc.put(0, p[3])
        enc.put(v > 2, p[4])
        if v > 2:
            enc.put(v - 3, p[5])
    elif v <= 10:
        enc.put(1, p[3])
        enc.put(0, p[6])
        enc.put(v > 6, p[7])
        if v <= 6:
            enc.put(v - 5, 159)
        else:
            enc.put((v - 7) >> 1, 165)
            enc.put((v - 7) & 1, 145)
    else:
        enc.put(1, p[3])
        enc.put(1, p[6])
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        enc.put(cat >> 1, p[8])
        enc.put(cat & 1, p[9 + (cat >> 1)])
        extra = v - (3 + (8 << cat))
        for k, prob in enumerate(CAT[cat]):
            enc.put((extra >> (len(CAT[cat]) - 1 - k)) & 1, prob)


def put_block(enc: BoolEncoder, coefs, first: int, probs, ctx: int, trailing: bool) -> int:
    """One block's coefficients (zigzag order, positions first..15) as
    GetCoeffs reads them; ``trailing``: zero tokens to the end in place of
    the end-of-block token. Returns what GetCoeffs returns."""
    last = max([n + 1 for n in range(first, 16) if coefs[n]], default=first)
    n, p = first, probs[first][ctx]
    while n < 16:
        if n >= last and not trailing:
            enc.put(0, p[0])
            return n
        enc.put(1, p[0])
        while not coefs[n]:
            enc.put(0, p[1])
            n += 1
            if n == 16:
                return 16
            p = probs[n][0]
        enc.put(1, p[1])
        v = abs(int(coefs[n]))
        enc.put(v > 1, p[2])
        if v > 1:
            put_large(enc, v, p)
        enc.put(coefs[n] < 0, 128)
        n += 1
        p = probs[n][2 if v > 1 else 1]
    return 16


def random_coefs(rng, first: int, big: float) -> np.ndarray:
    """A block's quantised coefficients: mostly none or a few small ones,
    now and then large ones (every token category)."""
    c = np.zeros(16, np.int64)
    if rng.random() < 0.35:
        return c
    last = int(rng.integers(first, 16))
    for n in range(first, last + 1):
        if rng.random() < 0.6 or n == last:
            r = rng.random()
            v = int(rng.integers(1, 3)) if r > 0.25 else int(rng.integers(3, 11)) if r > 0.05 + big else int(
                rng.integers(11, 2115 if rng.random() < 0.5 else 67))
            c[n] = v if rng.random() < 0.5 else -v
    return c


def vp8_bytes(w: int, h: int, seed: int = 0, *, q: int = 40, deltas=(None,) * 5, segments=None, simple=False,
              level=20, sharpness=0, lf_deltas=None, parts=1, part_sizes=None, skip_proba=128, colorspace=0,
              clamp=0, scale=(0, 0), profile=0, show=1, key=True, proba_updates=0.05, i4x4=0.5, bmodes=None,
              trailing=0.05, big=0.0, first_size=None) -> bytes:
    """A VP8 key frame of random intra modes and tokens (the RFC's bitstream,
    read as libwebp reads it). ``deltas``: the five quantiser deltas (y1 DC,
    y2 DC, y2 AC, uv DC, uv AC; None for none); ``segments``: None, or a
    dict of ``update_map``, ``probs`` (3, None each for 255), ``data``
    (None, or ``absolute``, ``quant`` and ``filter``, 4 each, None for 0);
    ``lf_deltas``: None, "kept" (deltas on, not updated), or ``ref`` and
    ``mode`` (4 each, None for kept); ``parts``: 1, 2, 4 or 8 token
    partitions, ``part_sizes`` the sizes written for all but the last
    (None: their own); ``skip_proba`` None for no skip flags; ``bmodes``:
    the 4x4 modes to draw from; ``big``: the share of large tokens;
    ``first_size``: the first partition's size written in the frame tag."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    p0 = BoolEncoder()
    p0.put(colorspace, 128)
    p0.put(clamp, 128)
    p0.put(segments is not None, 128)
    update_map = bool(segments and segments.get("update_map"))
    seg_probs = [255, 255, 255]
    if segments is not None:
        p0.put(update_map, 128)
        data = segments.get("data")
        p0.put(data is not None, 128)
        if data is not None:
            p0.put(data["absolute"], 128)
            for v in data["quant"]:
                p0.optional(v, 7)
            for v in data["filter"]:
                p0.optional(v, 6)
        if update_map:
            for k, v in enumerate(segments.get("probs", (None,) * 3)):
                p0.put(v is not None, 128)
                if v is not None:
                    p0.literal(v, 8)
                    seg_probs[k] = v
    p0.put(simple, 128)
    p0.literal(level, 6)
    p0.literal(sharpness, 3)
    p0.put(lf_deltas is not None, 128)
    if lf_deltas is not None:
        p0.put(lf_deltas != "kept", 128)
        if lf_deltas != "kept":
            for v in tuple(lf_deltas["ref"]) + tuple(lf_deltas["mode"]):
                p0.optional(v, 6)
    p0.literal({1: 0, 2: 1, 4: 2, 8: 3}[parts], 2)
    p0.literal(q, 7)
    for v in deltas:
        p0.optional(v, 4)
    p0.put(0, 128)  # refresh_entropy_probs, which libwebp ignores
    bands = PROBA0.copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    upd = rng.random() < proba_updates
                    p0.put(upd, UPDATE_PROBA[t, b, c, p])
                    if upd:
                        bands[t, b, c, p] = int(rng.integers(0, 256))
                        p0.literal(int(bands[t, b, c, p]), 8)
    p0.put(skip_proba is not None, 128)
    if skip_proba is not None:
        p0.literal(skip_proba, 8)
    probs = [[bands[t, BANDS[n]] for n in range(17)] for t in range(4)]
    tokens = [BoolEncoder() for _ in range(parts)]
    intra_t = np.zeros(4 * mb_w, np.int64)
    top_nz = np.zeros((mb_w, 9), np.int64)  # 4 y, 2 u, 2 v, the y2 dc
    for mb_y in range(mb_h):
        intra_l = np.zeros(4, np.int64)
        left_nz = np.zeros(9, np.int64)
        t = tokens[mb_y & (parts - 1)]
        for mb_x in range(mb_w):
            segment = int(rng.integers(0, 4)) if update_map else 0
            if update_map:
                p0.put(segment >= 2, seg_probs[0])
                p0.put(segment & 1, seg_probs[2 if segment >= 2 else 1])
            skip = skip_proba is not None and rng.random() < 0.2
            if skip_proba is not None:
                p0.put(skip, skip_proba)
            is_i4x4 = rng.random() < i4x4
            p0.put(not is_i4x4, 145)
            top = intra_t[4 * mb_x : 4 * mb_x + 4]
            if not is_i4x4:
                ymode = int(rng.integers(0, 4))
                put_tree(p0, YMODE_CODES[ymode])
                top[:] = ymode
                intra_l[:] = ymode
            else:
                for y in range(4):
                    for x in range(4):
                        mode = int(rng.choice(bmodes if bmodes is not None else 10))
                        put_tree(p0, BMODE_CODES[mode], BMODES_PROBA[top[x], intra_l[y]])
                        top[x] = intra_l[y] = mode
            put_tree(p0, UVMODE_CODES[int(rng.integers(0, 4))])
            tnz, lnz = top_nz[mb_x], left_nz
            if skip:
                tnz[:8] = lnz[:8] = 0
                if not is_i4x4:
                    tnz[8] = lnz[8] = 0
                continue
            first = 0
            if not is_i4x4:
                nz = put_block(t, random_coefs(rng, 0, big), 0, probs[1], tnz[8] + lnz[8], rng.random() < trailing)
                tnz[8] = lnz[8] = nz > 0
                first = 1
            for y in range(4):
                for x in range(4):
                    nz = put_block(t, random_coefs(rng, first, big), first, probs[0 if first else 3],
                                   tnz[x] + lnz[y], rng.random() < trailing)
                    tnz[x] = lnz[y] = nz > first
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        nz = put_block(t, random_coefs(rng, 0, big), 0, probs[2], tnz[ch + x] + lnz[ch + y],
                                       rng.random() < trailing)
                        tnz[ch + x] = lnz[ch + y] = nz > 0
    first_part = p0.bytes()
    coded = [t.bytes() for t in tokens]
    sizes = part_sizes if part_sizes is not None else [len(c) for c in coded[:-1]]
    tag = (0 if key else 1) | (profile << 1) | (show << 4) | ((len(first_part) if first_size is None else first_size)
                                                            << 5)
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", w | (scale[0] << 14), h | (scale[1] << 14))
            + first_part + b"".join(s.to_bytes(3, "little") for s in sizes) + b"".join(coded))


def still(frame: bytes, alpha=None, flags=None, w=None, h=None) -> bytes:
    """A lossy still: the simple format, or VP8X (+ ALPH) + VP8 where an
    ALPH payload or VP8X flags are given."""
    if alpha is None and flags is None:
        return riff(chunk(b"VP8 ", frame))
    w = w or struct.unpack("<H", frame[6:8])[0] & 0x3FFF
    h = h or struct.unpack("<H", frame[8:10])[0] & 0x3FFF
    return riff(vp8x(w, h, 0x10 if flags is None else flags) + (b"" if alpha is None else chunk(b"ALPH", alpha))
                + chunk(b"VP8 ", frame))


# -- the ALPH writer --------------------------------------------------------------------


def alpha_filtered(plane: np.ndarray, filt: int) -> np.ndarray:
    """filters_utils.c's forward filters (0 none, 1 horizontal, 2 vertical, 3
    gradient): the deltas the unfilters turn back into ``plane``."""
    p = plane.astype(np.int64)
    out = p.copy()
    if filt == 0:
        return plane.copy()
    out[0, 1:] = p[0, 1:] - p[0, :-1]
    out[1:, 0] = p[1:, 0] - p[:-1, 0]
    if filt == 1:
        out[1:, 1:] = p[1:, 1:] - p[1:, :-1]
    elif filt == 2:
        out[1:, 1:] = p[1:, 1:] - p[:-1, 1:]
    else:
        out[1:, 1:] = p[1:, 1:] - np.clip(p[1:, :-1] + p[:-1, 1:] - p[:-1, :-1], 0, 255)
    return (out & 255).astype(np.uint8)


def alph_bytes(plane: np.ndarray, method: int = 0, filt: int = 0, pre: int = 0, reserved: int = 0,
               coding: str = "plain") -> bytes:
    """An ALPH payload for ``plane``: the header byte, then the filtered
    plane raw (method 0) or as a VP8L stream without its header (method 1;
    ``coding`` "index": colour indexing alone, libwebp's 8-bit path)."""
    head = bytes([method | (filt << 2) | (pre << 4) | (reserved << 6)])
    deltas = alpha_filtered(plane, filt)
    if method != 1:
        return head + deltas.tobytes()
    h, w = plane.shape
    if coding == "index":
        levels = np.unique(deltas)
        idx = np.searchsorted(levels, deltas).astype(np.uint32)
        bits = 0 if len(levels) > 16 else 1 if len(levels) > 4 else 2 if len(levels) > 2 else 3
        per = 1 << bits
        packed = np.zeros((h, (w + per - 1) // per), np.uint32)
        for k in range(per):
            col = idx[:, k::per]
            packed[:, : col.shape[1]] |= col << (k * (8 >> bits))
        stream = vp8l_bytes(w, h, packed << 8, [("index", 0xFF000000 | (levels.astype(np.uint32) << 8))])
    else:
        stream = vp8l_bytes(w, h, 0xFF000000 | (deltas.astype(np.uint32) << 8))
    return head + stream[5:]  # the VP8L header is 40 bits


# -- encoder cases ------------------------------------------------------------------------

SIZES = {"1x1": (1, 1), "15x17": (15, 17), "16x16": (16, 16), "17x33": (17, 33), "100x37": (100, 37)}
QUALITIES = (1, 10, 50, 75, 90, 100)


def noise_image(h: int, w: int, seed: int, channels: int) -> np.ndarray:
    """Smooth shapes under noise, so that every quality codes something; a
    fourth channel of few levels."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([(3 * x + y) % 256, (x * y) % 256, (5 * y + 2 * x) % 256], axis=2)
    img = np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
    if channels == 4:
        img = np.concatenate([img, rng.choice([0, 1, 100, 254, 255], (h, w, 1)).astype(np.uint8)], axis=2)
    return img


def cv2_lossy(img: np.ndarray, q: int) -> bytes:
    data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])[1].tobytes()
    assert b"VP8 " in data and b"VP8L" not in data, data[12:40]
    return data


def encoded_image(size: str, index: int, channels: int) -> np.ndarray:
    if size.startswith("scene"):
        img = assets.load_scenes()["parity"][int(size[5:])]
        if channels == 4:
            grey = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            img = np.concatenate([img, (grey // 64 * 85)[..., None]], axis=2)
        return img
    h, w = SIZES[size]
    return noise_image(h, w, index, channels)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("size", list(SIZES) + ["scene0", "scene1"])
def test_cv2s_lossy_webps_answer_as_cv2(size, q, channels):
    """cv2's encoder at every quality up to 100 (lossy), BGR and BGRA (VP8X +
    ALPH + VP8), odd sizes and the 192×192 parity scenes."""
    data = cv2_lossy(encoded_image(size, list(SIZES).index(size) if size in SIZES else 9, channels), q)
    assert b"ALPH" in data or channels == 3 or size == "1x1"
    assert answers(data) == "equal"


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
@pytest.mark.parametrize("method", range(7))
def test_pils_lossy_webps_answer_as_cv2(method, alpha_quality, exact):
    """PIL's libwebp 1.6 at every method, with alpha quality 0, 50 and 100
    (100 sets no pre-processing; below it the levels are quantised and the
    header says so) and ``exact``."""
    img = noise_image(37, 45, method, 4)
    buf = io.BytesIO()
    Image.fromarray(img[..., [2, 1, 0, 3]]).save(buf, "WEBP", quality=15 * method, method=method,
                                                 alpha_quality=alpha_quality, exact=exact)
    data = buf.getvalue()
    alph = data.index(b"ALPH") + 8
    assert (data[alph] >> 4) & 3 == (alpha_quality < 100), data[alph]
    assert answers(data) == "equal"


# -- written frames ------------------------------------------------------------------------


def written_cases() -> dict:
    """name → a file around a written VP8 frame (and ALPH chunk)."""
    c = {}
    w, h = 40, 35
    c["plain"] = vp8_bytes(w, h, 1)
    for parts in (2, 4, 8):
        c[f"partitions_{parts}"] = vp8_bytes(w, 70, parts, parts=parts)
    # partition sizes past the data are clipped: the later ones start
    # where the data ends (and an empty one read by a row refuses the file)
    c["partition_size_past_the_data"] = vp8_bytes(w, h, 2, parts=2, part_sizes=[1 << 20])
    c["partitions_4_sizes_past_the_data"] = vp8_bytes(w, 70, 3, parts=4, part_sizes=[40, 1 << 23, 5])
    c["partitions_8_unread_empty"] = vp8_bytes(w, h, 4, parts=8)  # their sizes changed by _fill
    c["partition_sizes_short_by_one"] = vp8_bytes(w, 70, 5, parts=4)
    for absolute in (0, 1):
        data = {"absolute": absolute, "quant": (10, -5, 127 if absolute else 60, None) if absolute else (
            30, -40, 100, None), "filter": (5, None, -3 if absolute else -63, 63)}
        for update_map in (False, True):
            c[f"segments_absolute{absolute}_map{int(update_map)}"] = vp8_bytes(
                w, h, 6 + absolute, q=50, segments={"update_map": update_map, "probs": (120, None, 30), "data": data})
    c["segments_no_data"] = vp8_bytes(w, h, 8, segments={"update_map": True, "probs": (None, 200, None)})
    c["segments_quant_negative_absolute"] = vp8_bytes(w, h, 9, segments={"update_map": True, "data": {
        "absolute": 1, "quant": (-20, -127, 0, 5), "filter": (None,) * 4}})
    c["simple_filter"] = vp8_bytes(w, h, 10, simple=True, level=30)
    c["simple_filter_segments"] = vp8_bytes(w, h, 11, simple=True, level=10, segments={
        "update_map": True, "data": {"absolute": 0, "quant": (None,) * 4, "filter": (30, -10, 50, None)}})
    # a level of 0 turns the filter off, whatever the segments' levels
    c["level0_segments_strong"] = vp8_bytes(w, h, 12, level=0, segments={
        "update_map": True, "data": {"absolute": 1, "quant": (None,) * 4, "filter": (40, 50, 63, 20)}})
    c["level0"] = vp8_bytes(w, h, 13, level=0)
    for s in range(8):
        c[f"sharpness{s}"] = vp8_bytes(w, h, 14 + s, level=45 if s % 2 else 12, sharpness=s)
    c["lf_deltas"] = vp8_bytes(w, h, 22, level=25, lf_deltas={"ref": (10, -5, None, 3), "mode": (-8, None, 2, 9)})
    c["lf_deltas_to_zero"] = vp8_bytes(w, h, 23, level=5, lf_deltas={"ref": (-20, None, None, None),
                                                                        "mode": (0, None, None, None)})
    c["lf_deltas_kept"] = vp8_bytes(w, h, 24, level=25, lf_deltas="kept")
    c["lf_deltas_past_63"] = vp8_bytes(w, h, 25, level=60, lf_deltas={"ref": (20, None, None, None),
                                                                         "mode": (30, None, None, None)})
    c["no_skip_proba"] = vp8_bytes(w, h, 26, skip_proba=None)
    c["skip_proba_0"] = vp8_bytes(w, h, 27, skip_proba=0)
    c["colorspace_clamp_scale_bits"] = vp8_bytes(w, h, 28, colorspace=1, clamp=1, scale=(3, 2))
    for q, deltas in (("0_deltas_below", (-15, -15, -15, -15, -15)), ("127_deltas_above", (15, 15, 15, 15, 15)),
                      ("120_uv_dc_clip_117", (None, None, None, 15, None)), ("0_y2_ac_floor_8", (None, None, 0, None,
                                                                                                     None))):
        c[f"quant_{q}"] = vp8_bytes(w, h, 29, q=int(q.split("_")[0]), deltas=deltas)
    c["all_i16"] = vp8_bytes(w, h, 30, i4x4=0.0)
    c["all_i4x4"] = vp8_bytes(w, h, 31, i4x4=1.0)
    # the 4x4 modes that read the top-right pixels, on every macroblock
    c["top_right_modes"] = vp8_bytes(50, 50, 32, i4x4=1.0, bmodes=[6, 7])
    c["top_right_one_column"] = vp8_bytes(9, 50, 33, i4x4=1.0, bmodes=[6, 7, 2])
    c["coefficients_past_int16"] = vp8_bytes(w, h, 34, q=127, deltas=(15, 15, 15, 15, 15), big=0.4)
    c["large_tokens"] = vp8_bytes(w, h, 35, q=20, big=0.3)
    c["every_probability_updated"] = vp8_bytes(w, h, 36, proba_updates=1.0)
    c["trailing_zero_tokens"] = vp8_bytes(w, h, 37, trailing=1.0)
    for wh in ((1, 1), (1, 29), (31, 1), (17, 17), (33, 47)):  # odd sizes: the upsampler's edges
        c[f"size_{wh[0]}x{wh[1]}"] = vp8_bytes(*wh, 38 + wh[0])
    for profile in (1, 3, 4, 7):
        c[f"profile{profile}"] = vp8_bytes(w, h, 40, profile=profile)
    c["not_shown"] = vp8_bytes(w, h, 41, show=0)
    c["not_a_key_frame"] = vp8_bytes(w, h, 42, key=False)
    c["first_partition_past_the_data"] = vp8_bytes(w, h, 43, first_size=1 << 18)
    c["first_partition_short"] = vp8_bytes(w, h, 44, first_size=3)
    return c


def _fill(cases: dict) -> dict:
    """The frames whose partition sizes depend on their own coding."""
    f = cases["partitions_8_unread_empty"]
    # 35 rows are 3 macroblock rows: partitions 3..6 are empty, and none reads them
    first = (int.from_bytes(f[:3], "little") >> 5) + 10
    sizes = [int.from_bytes(f[first + 3 * k : first + 3 * k + 3], "little") for k in range(7)]
    assert sizes[3:] != [0] * 4
    body = f[first + 21 :]
    parts = [body[sum(sizes[:k]) : sum(sizes[: k + 1])] for k in range(7)] + [body[sum(sizes):]]
    kept = parts[:3] + [b""] * 4 + [parts[7]]
    written = b"".join(len(p).to_bytes(3, "little") for p in kept[:7])
    cases["partitions_8_unread_empty"] = f[:first] + written + b"".join(kept)
    f = cases["partition_sizes_short_by_one"]
    first = (int.from_bytes(f[:3], "little") >> 5) + 10
    sizes = [int.from_bytes(f[first + 3 * k : first + 3 * k + 3], "little") for k in range(3)]
    cases["partition_sizes_short_by_one"] = f[:first] + b"".join((s - 1).to_bytes(3, "little") for s in sizes) + f[
        first + 9 :]
    return cases


def alpha_cases() -> dict:
    """name → a VP8X + ALPH + VP8 file (or another container) of a written
    frame and alpha plane."""
    w, h = 21, 19
    frame = vp8_bytes(w, h, 50)
    rng = np.random.default_rng(51)
    plane = np.clip(np.add.outer(np.arange(h) * 9, np.arange(w) * 5) + rng.integers(-30, 31, (h, w)), 0, 255).astype(
        np.uint8)
    few = rng.choice([0, 60, 255], (h, w)).astype(np.uint8)
    c = {}
    for filt in range(4):
        c[f"raw_filter{filt}"] = still(frame, alph_bytes(plane, 0, filt))
        c[f"lossless_filter{filt}"] = still(frame, alph_bytes(plane, 1, filt))
        c[f"lossless_8bit_filter{filt}"] = still(frame, alph_bytes(few, 1, filt, coding="index"))
    c["pre_processing_set"] = still(frame, alph_bytes(plane, 0, 1, pre=1))
    c["pre_processing_2"] = still(frame, alph_bytes(plane, 0, 1, pre=2))
    c["pre_processing_3_lossless"] = still(frame, alph_bytes(plane, 1, 0, pre=3))
    c["reserved_bits_1"] = still(frame, alph_bytes(plane, 0, 0, reserved=1))
    c["reserved_bits_2"] = still(frame, alph_bytes(plane, 1, 2, reserved=2))
    c["method_2"] = still(frame, alph_bytes(plane, 2, 0))
    c["method_3"] = still(frame, alph_bytes(plane, 3, 1))
    c["empty"] = still(frame, b"")
    c["header_only"] = still(frame, b"\x00")
    c["raw_one_byte_short"] = still(frame, alph_bytes(plane)[:-1])
    c["raw_longer"] = still(frame, alph_bytes(plane) + b"\x07" * 9)
    lossless = alph_bytes(plane, 1, 3)
    c["lossless_cut_in_half"] = still(frame, lossless[: len(lossless) // 2])
    c["lossless_bad_code"] = still(frame, lossless[:1] + b"\xff\xff" + lossless[3:])
    c["no_alpha_flag"] = still(frame, alph_bytes(plane, 0, 2), flags=0)
    c["no_alpha_flag_bad_alph"] = still(frame, alph_bytes(plane, 2, 0), flags=0)
    c["alpha_flag_no_alph"] = still(frame, None, flags=0x10)
    # the last ALPH chunk before the image is the one decoded; one after it is ignored
    c["two_alph_last_bad"] = riff(vp8x(w, h, 0x10) + chunk(b"ALPH", alph_bytes(plane)) + chunk(b"ALPH", b"\x03\x00")
                                  + chunk(b"VP8 ", frame))
    c["two_alph_first_bad"] = riff(vp8x(w, h, 0x10) + chunk(b"ALPH", b"\x03\x00") + chunk(b"ALPH", alph_bytes(plane))
                                   + chunk(b"VP8 ", frame))
    c["bad_alph_after_the_image"] = riff(vp8x(w, h, 0x10) + chunk(b"VP8 ", frame) + chunk(b"ALPH", b"\x03\x00"))
    c["alph_in_the_simple_format"] = riff(chunk(b"ALPH", alph_bytes(plane)) + chunk(b"VP8 ", frame))
    c["exif_orientation6"] = riff(vp8x(w, h, 0x18) + chunk(b"ALPH", alph_bytes(plane)) + chunk(b"VP8 ", frame)
                                  + chunk(b"EXIF", exif(6)))
    return c


def animation_cases() -> dict:
    """name → an animation whose first frame is VP8, with or without ALPH,
    under the VP8X alpha flag or not."""
    fw, fh = 21, 19
    frame = chunk(b"VP8 ", vp8_bytes(fw, fh, 60))
    plane = np.random.default_rng(61).integers(0, 256, (fh, fw)).astype(np.uint8)
    good, bad = chunk(b"ALPH", alph_bytes(plane, 0, 3)), chunk(b"ALPH", alph_bytes(plane, 2, 0))

    def animation(frames, flags=0x02, w=32, h=30, after=b""):
        return riff(vp8x(w, h, flags) + anim() + b"".join(frames) + after)

    c = {}
    for flags in (0x02, 0x12):
        tag = "alpha_flag" if flags & 0x10 else "no_alpha_flag"
        c[f"{tag}_vp8"] = animation([anmf(4, 6, fw, fh, 0, frame)], flags)
        c[f"{tag}_alph_vp8"] = animation([anmf(4, 6, fw, fh, 0, good + frame)], flags)
        c[f"{tag}_bad_alph"] = animation([anmf(4, 6, fw, fh, 0, bad + frame)], flags)
    c["two_frames"] = animation([anmf(0, 0, fw, fh, 0, good + frame), anmf(2, 2, fw, fh, 2, frame)], 0x12)
    c["frame_past_the_canvas"] = animation([anmf(14, 6, fw, fh, 0, frame)])
    c["exif_orientation8"] = animation([anmf(4, 6, fw, fh, 0, frame)], 0x0A, after=chunk(b"EXIF", exif(8)))
    c["cut_frame"] = animation([anmf(4, 6, fw, fh, 0, chunk(b"VP8 ", vp8_bytes(fw, fh, 60)[:-40]))])
    return c


WRITTEN = {**{k: still(v) for k, v in _fill(written_cases()).items()},
           **{f"alpha_{k}": v for k, v in alpha_cases().items()},
           **{f"animation_{k}": v for k, v in animation_cases().items()}}
REFUSED = {"profile4", "profile7", "not_shown", "not_a_key_frame", "first_partition_past_the_data",
           "first_partition_short", "partition_size_past_the_data", "partitions_4_sizes_past_the_data",
           "alpha_pre_processing_2", "alpha_pre_processing_3_lossless", "alpha_reserved_bits_1",
           "alpha_reserved_bits_2", "alpha_method_2", "alpha_method_3", "alpha_empty", "alpha_header_only",
           "alpha_raw_one_byte_short", "alpha_lossless_cut_in_half", "alpha_lossless_bad_code",
           "alpha_no_alpha_flag_bad_alph", "alpha_two_alph_last_bad", "alpha_alph_in_the_simple_format",
           "animation_no_alpha_flag_bad_alph", "animation_alpha_flag_bad_alph", "animation_frame_past_the_canvas",
           "animation_cut_frame"}


@pytest.mark.parametrize("name", list(WRITTEN))
def test_written_vp8_frames_answer_as_cv2(name, tmp_path):
    """Each libwebp rule on a frame written for it, by ``decode_image`` and
    by ``read_image``."""
    data = WRITTEN[name]
    assert answers(data) in ("none", "equal")
    assert read_answers(data, tmp_path) in ("none", "equal")


def test_written_frames_reach_both_answers():
    """The written cases decode but for the ones written to be refused."""
    refused = {n for n, d in WRITTEN.items() if cv2_decode(d) is None}
    assert refused == REFUSED


def test_probe_partition_sizes_past_the_data_are_clipped():
    """ParsePartitions clips a size past the data: the partitions after it
    are empty, which refuses the file only where a row reads one (or none is
    left for the last); the first partition's own size is not clipped."""
    dec = {n: port_decode(WRITTEN[n]) for n in ("partition_size_past_the_data", "partitions_4_sizes_past_the_data",
                                                 "partitions_8_unread_empty", "first_partition_past_the_data")}
    assert dec["partitions_8_unread_empty"] is not None
    assert dec["partitions_4_sizes_past_the_data"] is None and dec["first_partition_past_the_data"] is None
    # one size past the data on two partitions: the second is empty and row 1 reads it
    assert dec["partition_size_past_the_data"] is None


def test_probe_the_filter_level_and_the_alph_rules():
    """A frame level of 0 filters nothing, whatever the segments say; an
    ALPH chunk is decoded with or without the VP8X alpha flag (a bad one
    refuses the file either way, in a still image and in an animation's
    frame), pre-processing 1 changes no pixel, the filters 0..3 are all
    valid (two bits: none is out of range), and the values never reach the
    BGR output."""
    level0 = port_decode(WRITTEN["level0_segments_strong"])
    unfiltered = vp8_bytes(40, 35, 12, level=0, segments={"update_map": True, "data": {
        "absolute": 1, "quant": (None,) * 4, "filter": (0, 0, 0, 0)}})
    assert (level0 == port_decode(still(unfiltered))).all()
    bgr = port_decode(still(vp8_bytes(21, 19, 50)))
    for name in ("raw_filter0", "raw_filter3", "lossless_filter2", "lossless_8bit_filter1", "pre_processing_set",
                 "no_alpha_flag", "alpha_flag_no_alph", "raw_longer"):
        assert (port_decode(WRITTEN[f"alpha_{name}"]) == bgr).all(), name
    for name in ("no_alpha_flag_bad_alph", "method_2", "reserved_bits_1", "empty", "header_only"):
        assert cv2_decode(WRITTEN[f"alpha_{name}"]) is None, name
    assert cv2_decode(WRITTEN["animation_no_alpha_flag_bad_alph"]) is None


def pil_alpha(data: bytes) -> np.ndarray:
    return np.array(Image.open(io.BytesIO(data)).convert("RGBA"))[..., 3]


@pytest.mark.parametrize("name", ["raw_filter0", "raw_filter1", "raw_filter2", "raw_filter3", "lossless_filter0",
                                  "lossless_filter3", "lossless_8bit_filter1", "lossless_8bit_filter2",
                                  "pre_processing_set", "raw_longer"])
def test_the_alpha_plane_is_libwebps(name):
    """The unfiltered plane (``want_alpha``) against PIL's libwebp on the
    same file: each filter's row-0 and column-0 rules, raw and lossless
    (the 8-bit path too)."""
    data = WRITTEN[f"alpha_{name}"]
    w, h, _, _, pos, alpha = imcodec._webp_headers(data, full=True)
    status, bgr, plane = native.vp8_decode(data[pos:], w, h, data[alpha[0] : sum(alpha)], want_alpha=True)
    assert status == 0 and (plane == pil_alpha(data)).all()


def test_probe_the_8bit_alpha_path_lets_the_data_end_with_the_last_pixel():
    """A lossless plane of colour indexing alone (no cache, one-symbol red,
    blue and alpha codes) is read by DecodeAlphaData, which accepts data
    that ends inside the last pixel's code; the same cut under any other
    coding (DecodeImageData) refuses the file."""
    w, h = 21, 19
    frame = vp8_bytes(w, h, 50)
    plane = np.random.default_rng(70).choice([0, 255], (h, w)).astype(np.uint8)
    plane[-1, -1] = 128  # the last pixel's level: its own, longer code
    ok8 = bad32 = 0
    for coding in ("index", "plain"):
        payload = alph_bytes(plane, 1, 0, coding=coding)
        for cut in range(1, 4):
            data = still(frame, payload[:-cut])
            assert answers(data) in ("none", "equal"), (coding, cut)
            if coding == "index":
                ok8 += cv2_decode(data) is not None
            else:
                bad32 += cv2_decode(data) is None
    assert ok8 >= 1 and bad32 == 3


def test_probe_eof_at_libwebps_load_points():
    """Every cut of a frame's VP8 payload, the RIFF and chunk sizes written
    to match (an odd cut is padded with a zero byte, which the decoder
    reads): the partitions end where libwebp's loads (56 bits while 8 bytes
    remain, then a byte at a time, eof on the first load past the end) end
    them. Whether a cut decodes depends on the bits read in its place, which
    steer the boolean decoder's shifts: of the 40x35 frame's last 19 cuts,
    the ones at 18, 2 and 0 bytes short decode and the rest refuse."""
    for frame in (vp8_bytes(40, 35, 80), vp8_bytes(40, 70, 81, parts=2), cv2_lossy(noise_image(19, 33, 82, 3), 60)):
        if frame[:4] == b"RIFF":
            frame = frame[20 : 20 + struct.unpack("<I", frame[16:20])[0]]
        outcomes = [answers(still(frame[:k])) for k in range(10, len(frame) + 1)]
        assert set(outcomes) <= {"none", "equal"} and outcomes[-1] == "equal"
        assert outcomes.count("none") > len(outcomes) - 20
    frame = vp8_bytes(40, 35, 80)
    decoded = [len(frame) - k for k in range(19) if port_decode(still(frame[: len(frame) - k])) is not None]
    assert decoded == [len(frame), len(frame) - 2, len(frame) - 18]


def test_probe_the_quantiser_clips():
    """VP8ParseQuant clips each index after its delta (the uv DC one at 117)
    and floors the y2 AC step at 8: frames whose indices clip alike decode
    alike, as cv2 decodes them."""
    for a, b in (((127, (None, None, None, 15, None)), (127, (None, None, None, -10, None))),
                 ((0, (None, None, 0, None, None)), (0, (None, None, 1, None, None))),
                 ((3, (-15, -15, None, -15, -15)), (3, (-3, -3, None, -3, -3)))):
        da, db = (still(vp8_bytes(40, 35, 29, q=q, deltas=d)) for q, d in (a, b))
        assert answers(da) == answers(db) == "equal"
        assert (port_decode(da) == port_decode(db)).all()


def test_probe_4x4_blocks_read_libwebps_top_right_pixels():
    """Every block predicted by LD or VL (which read the four pixels above
    and right): the row's last macroblock replicates its top row's last
    pixel, the blocks below the first sub-row take the macroblock's top-right
    pixels, the frame's first row 127."""
    for name in ("top_right_modes", "top_right_one_column", "all_i4x4"):
        assert answers(WRITTEN[name]) == "equal", name


def test_probe_the_x86_transform_on_coefficients_past_int16():
    """Dequantised coefficients that wrap int16 (libwebp stores them so),
    inverse-transformed in Transform_SSE2's wrapping 16-bit lanes: cv2's
    pixels, which TransformOne_C's 32-bit arithmetic would not give."""
    for name in ("coefficients_past_int16", "large_tokens"):
        assert answers(WRITTEN[name]) == "equal", name


def test_probe_the_fancy_upsampler_on_odd_sizes():
    """UpsampleRgbLinePair's packed u/v averaging, its first and last
    columns and rows, one pass over the whole frame against libwebp's
    batches of rows: odd and even widths and heights, 1 pixel wide or
    high, several macroblock rows."""
    for name in ("size_1x1", "size_1x29", "size_31x1", "size_17x17", "size_33x47", "plain"):
        assert answers(WRITTEN[name]) == "equal", name
    for h, w in ((1, 2), (2, 1), (2, 2), (3, 5), (48, 49), (49, 48)):
        assert answers(cv2_lossy(noise_image(h, w, h * w, 3), 80)) == "equal", (h, w)


def test_a_lossy_webp_raises_when_its_decoder_cannot_be_built(monkeypatch):
    """A missing compiler is not a bad image: the decode raises and never
    falls back."""

    def no_compiler(source=None):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(native, "_webp_lib", None)
    monkeypatch.setattr(native, "build", no_compiler)
    with pytest.raises(RuntimeError, match="compiler"):
        imcodec.decode_image(WRITTEN["plain"])


# -- damage --------------------------------------------------------------------------------


def small_files() -> dict:
    img = noise_image(19, 33, 90, 4)
    return {"vp8": cv2_lossy(img[..., :3], 70), "vp8_alph": cv2_lossy(img, 70)}


@pytest.mark.parametrize("name", ["vp8", "vp8_alph"])
def test_every_cut_and_xor_of_a_lossy_webp_answers_as_cv2(name):
    """Each prefix of the file, and 0x55 XOR-ed into each of its bytes past
    the RIFF tag: most damage decodes to some image, which must be
    libwebp's."""
    data = small_files()[name]
    assert 400 < len(data) < 1500
    cuts = [answers(data[:k]) for k in range(1, len(data) + 1)]
    assert set(cuts) <= {"none", "equal"} and cuts[-1] == "equal"
    outcomes = []
    for at in range(4, len(data)):
        bad = bytearray(data)
        bad[at] ^= 0x55
        outcomes.append(answers(bytes(bad)))
    differ = [(i + 4, a) for i, a in enumerate(outcomes) if a not in ("none", "equal")]
    assert not differ, differ
    assert outcomes.count("equal") > outcomes.count("none")


def test_mutated_lossy_webps_answer_as_cv2():
    """``tests/test_torch_webp.py``'s mutations of the lossy fuzz bases,
    its VP8 kinds among them (partition sizes, frame tag and header bits,
    flips in partition 0 and the token partitions, cuts, ALPH header
    bytes)."""
    from test_torch_webp import mutations

    outcomes = {}
    for i, (name, data) in enumerate(lossy_fuzz_bases().items()):
        for d in mutations(data, 30, seed=i + 500):
            a = answers(d)
            outcomes[a] = outcomes.get(a, 0) + 1
            assert a in ("none", "equal"), (name, a)
    assert outcomes["equal"] > 150 and outcomes["none"] > 60, outcomes


def lossy_fuzz_bases() -> dict:
    """The lossy files the fuzz runs change: cv2's and PIL's, written frames
    of several partitions and segments, ALPH chunks of each method, an
    animation."""
    img = noise_image(30, 41, 95, 4)
    buf = io.BytesIO()
    Image.fromarray(img[..., [2, 1, 0, 3]]).save(buf, "WEBP", quality=40, method=6, alpha_quality=60)
    bases = {"cv2_q30": cv2_lossy(img[..., :3], 30), "cv2_q90_alph": cv2_lossy(img, 90), "pil_alph": buf.getvalue()}
    for name in ("partitions_4", "segments_absolute0_map1", "simple_filter", "lf_deltas", "no_skip_proba",
                 "coefficients_past_int16", "alpha_raw_filter3", "alpha_lossless_filter1",
                 "alpha_lossless_8bit_filter2", "animation_alpha_flag_alph_vp8"):
        bases[f"written_{name}"] = WRITTEN[name]
    return bases


# -- by path, and the request ------------------------------------------------------------------


def test_lossy_files_read_by_path_answer_as_cv2(tmp_path):
    for data in (cv2_lossy(noise_image(19, 33, 91, 3), 50), cv2_lossy(noise_image(19, 33, 92, 4), 50),
                 WRITTEN["animation_alpha_flag_alph_vp8"], WRITTEN["alpha_exif_orientation6"]):
        assert read_answers(data, tmp_path) == "equal"


def test_every_lossy_refusal_logs_one_line_naming_it(caplog):
    for name in sorted(REFUSED):
        caplog.clear()
        with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
            assert imcodec.decode_image(WRITTEN[name]) is None
        assert len(caplog.records) == 1 and "WebP" in caplog.records[0].getMessage(), name
