"""Lossy 8-bit 4:4:4 and monochrome AVIF (``csrc/av1.cpp``'s transform
syntax, coefficients of every size, dequantisation with quantiser
matrices and delta q, the inverse transforms, prediction at the transform
size) against ``cv2.imdecode(buf, IMREAD_COLOR)`` and ``cv2.imread``
(OpenCV 5.0 over libavif 1.4.2 and libaom 3.14.1): the same ``None`` or
not, and 0 differing pixels.

The streams come from Pillow 12.1's AVIF writer (libavif 1.3) with
libaom's in-loop filters turned off (``enable-cdef=0``,
``enable-restoration=0``, ``loopfilter-control=0``), 4:4:4, wrapped in
this suite's container with an identity ``colr`` (Pillow's own files
carry a matrix the port does not take yet, ROADMAP A14.7b): speeds 0 to
9, q 30 to 95, sizes from 1x1 to 200x300, noise, photo-like, gradient
and text content, and the encoder options that change the stream
(quantiser matrices, delta q, screen content with IntraBC and its var-tx
trees, the reduced and DCT-only type sets, square-only transforms, no
64-sample transforms, 128x128 superblocks, tiles). cv2's own monochrome files at q95 and up
leave the filters off too (deblocking and CDEF: ``tests/test_torch_avif_deblock.py``,
``test_torch_avif_cdef.py``); loop restoration in
``tests/test_torch_avif_restoration.py``, beside the others here. Each inverse
transform is held through ``ctypes`` against libaom's x86 functions,
which the decoder replays: ``av1_lowbd_inv_txfm2d_add_ssse3`` and, where
libaom dispatches it on this CPU, ``_avx2``. libaom's C one
(``av1_inv_txfm2d_add_*_c``) saturates differently where damaged
coefficients overflow 16 bits.

    python -m pytest tests/test_torch_avif_lossy.py -q
"""

import collections
import ctypes
import functools
import importlib.util
import os
import re

import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.utils import imcodec
from test_torch_avif import (Bits, av1c, avif_file, colr, cv2_avif, decode_stats, gradient, ispe, item_data,
                             mutations, noise, obu, pil_avif, pixi, read_answers, smooth, text)
from test_torch_tiff import answers, cv2_decode, port_decode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS_OFF = [("enable-cdef", "0"), ("enable-restoration", "0"), ("loopfilter-control", "0")]
CONTENT = {"noise": lambda h, w, s: noise(h, w, 3, s), "smooth": lambda h, w, s: smooth(h, w, 3, s),
           "gradient": gradient, "text": lambda h, w, s: text(h, w, 3, s)}


def bands(h, w, period, axis, seed):
    """Flat bands of ``period`` samples across ``axis`` with a faint ramp:
    libaom's slowest speed codes them in 64x32 or 32x64 blocks."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    band = (yy if axis == 0 else xx) // period
    img = rs.randint(30, 220, (band.max() + 1, 3))[band] + 0.15 * (xx + yy)[..., None] + rs.randint(-1, 2, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def lossy_stream(img, q, speed, options=(), **kw) -> bytes:
    """Pillow's lossy 4:4:4 AV1 stream with the in-loop filters off."""
    return item_data(pil_avif(img, quality=q, subsampling="4:4:4", speed=speed, advanced=FILTERS_OFF + list(options),
                              **kw))


def lossy_avif(img, q, speed, options=(), **kw) -> bytes:
    """That stream in an identity-matrix, full-range container."""
    h, w = img.shape[:2]
    return avif_file(lossy_stream(img, q, speed, options, **kw), w=w, h=h)


# libavif 1.4.2 of cv2's wheel, through ctypes: its own writer with an
# identity matrix, so a 4:4:4 frame holds the image's G, B and R planes as
# they are (Pillow's writer converts to BT.601 first)
@functools.lru_cache(maxsize=None)
def _libavif():
    import glob

    import cv2

    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    lib = ctypes.CDLL(sorted(glob.glob(os.path.join(libs, "libavif-*.so.16*")))[0])
    lib.avifVersion.restype = ctypes.c_char_p
    assert lib.avifVersion() == b"1.4.2", lib.avifVersion()
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
    lib.avifImageDestroy.argtypes = [vp]
    lib.avifEncoderCreate.restype = vp
    lib.avifEncoderDestroy.argtypes = [vp]
    lib.avifEncoderSetCodecSpecificOption.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
    lib.avifEncoderWrite.argtypes = [vp, vp, ctypes.POINTER(_RWData)]
    lib.avifRWDataFree.argtypes = [ctypes.POINTER(_RWData)]
    return lib


class _RWData(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t)]


def libavif_avif(bgr: np.ndarray, quality: int, speed: int, options=FILTERS_OFF, matrix: int = 0,
                 full_range: int = 1) -> bytes:
    """A lossy 4:4:4 AVIF of ``bgr`` from libavif's ``avifEncoderWrite``:
    identity matrix (or ``matrix``), BT.709 primaries, sRGB transfer, full
    range (or limited), the Y, U and V planes set to G, B and R. avif.h's
    layouts, checked on the objects' defaults: avifImage's range at 16,
    planes at 24 and their row bytes at 48, its CICP at 104; avifEncoder's
    speed at 8 and quality at 32."""
    lib = _libavif()
    h, w = bgr.shape[:2]
    img = lib.avifImageCreate(w, h, 8, 1)  # AVIF_PIXEL_FORMAT_YUV444
    assert np.frombuffer(ctypes.string_at(img, 16), "<u4").tolist() == [w, h, 8, 1]
    assert np.frombuffer(ctypes.string_at(img + 104, 6), "<u2").tolist() == [2, 2, 2]  # unspecified
    assert np.frombuffer(ctypes.string_at(img + 16, 4), "<u4")[0] == 1  # AVIF_RANGE_FULL
    ctypes.memmove(img + 104, np.array([1, 13, matrix], "<u2").tobytes(), 6)
    ctypes.memmove(img + 16, np.array([full_range], "<u4").tobytes(), 4)
    enc = lib.avifEncoderCreate()
    try:
        assert lib.avifImageAllocatePlanes(img, 1) == 0  # AVIF_PLANES_YUV
        for i, plane in enumerate((bgr[..., 1], bgr[..., 0], bgr[..., 2])):
            at = int(np.frombuffer(ctypes.string_at(img + 24 + 8 * i, 8), "<u8")[0])
            stride = int(np.frombuffer(ctypes.string_at(img + 48 + 4 * i, 4), "<u4")[0])
            for y in range(h):
                ctypes.memmove(at + y * stride, np.ascontiguousarray(plane[y]).ctypes.data, w)
        assert np.frombuffer(ctypes.string_at(enc + 8, 4), "<i4")[0] == -1  # AVIF_SPEED_DEFAULT
        assert np.frombuffer(ctypes.string_at(enc + 32, 4), "<i4")[0] == -1  # AVIF_QUALITY_DEFAULT
        ctypes.memmove(enc + 8, np.array([speed], "<i4").tobytes(), 4)
        ctypes.memmove(enc + 32, np.array([quality], "<i4").tobytes(), 4)
        for key, value in options:
            assert lib.avifEncoderSetCodecSpecificOption(enc, key.encode(), value.encode()) == 0
        out = _RWData()
        assert lib.avifEncoderWrite(enc, img, ctypes.byref(out)) == 0
        data = ctypes.string_at(out.data, out.size)
        lib.avifRWDataFree(ctypes.byref(out))
        return data
    finally:
        lib.avifImageDestroy(img)
        lib.avifEncoderDestroy(enc)


# -- Pillow's streams: speed, size, content and quality --------------------------------------

SIZES = [(1, 1), (7, 5), (65, 129), (200, 300)]
SPEEDS = [0, 4, 6, 9]


def _spread() -> dict:
    """name → (content, h, w, q, speed, options): every speed at every size
    (speed 0 only up to 65x129), the content and the quality turning with
    the case, and the superblock size."""
    out = {}
    for i, (h, w) in enumerate(SIZES):
        for j, speed in enumerate(SPEEDS):
            if speed == 0 and h * w > 65 * 129:
                continue
            kind = list(CONTENT)[(i + j) % 4]
            q = (30, 50, 70, 95)[(i + 2 * j) % 4]
            sb = "128" if (i + j) % 2 else "64"
            out[f"{kind}_{h}x{w}_q{q}_speed{speed}_sb{sb}"] = (kind, h, w, q, speed, (("sb-size", sb),))
    return out


SPREAD = _spread()


@functools.lru_cache(maxsize=None)
def spread_file(name: str) -> bytes:
    kind, h, w, q, speed, options = SPREAD[name]
    return lossy_avif(CONTENT[kind](h, w, 7 + len(name)), q, speed, options)


@pytest.mark.parametrize("name", list(SPREAD))
def test_pillows_lossy_streams_decode_as_cv2(name, tmp_path):
    data = spread_file(name)
    assert answers(data) == "equal"
    if SPREAD[name][1] >= 65:
        assert read_answers(data, tmp_path) == "equal"


@pytest.mark.parametrize("kind,q,speed", [("smooth", 30, 4), ("text", 60, 6), ("gradient", 90, 9)])
def test_libavifs_own_lossy_files_decode_as_cv2(kind, q, speed):
    """libavif 1.4.2's writer (the one cv2 links) with an identity matrix:
    its own container and sequence header."""
    img = CONTENT[kind](72, 120, q)
    data = libavif_avif(img, q, speed)
    assert answers(data) == "equal"
    assert np.abs(port_decode(data).astype(int) - img).mean() < 12


# -- libaom's encoder options -----------------------------------------------------------------

# option → (content, q, speed, libaom options, (h, w), seed): each changes
# the stream (the test holds its tool counters against the same image's
# without it). Screen content codes IntraBC blocks, whose var-tx trees and
# inter type sets reach the flipped types; these two seeds reach all five.
OPTIONS = {
    "quantiser_matrices": ("smooth", 40, 6, [("enable-qm", "1"), ("qm-min", "0"), ("qm-max", "15")], (96, 160), 0),
    "quantiser_matrices_4_to_10": ("text", 60, 6, [("enable-qm", "1"), ("qm-min", "4"), ("qm-max", "10")], (96, 160),
                                   0),
    "delta_q": ("smooth", 50, 6, [("deltaq-mode", "2")], (96, 160), 0),
    "screen_content_q40": ("text", 40, 6, [("tune-content", "screen")], (128, 256), 41),
    "screen_content_q60": ("text", 60, 6, [("tune-content", "screen")], (128, 256), 61),
    "screen_content_q70": ("text", 70, 6, [("tune-content", "screen")], (128, 256), 70),
    "screen_content_q90": ("text", 90, 6, [("tune-content", "screen")], (200, 300), 91),
    "reduced_tx_set": ("text", 60, 6, [("tune-content", "screen"), ("reduced-tx-type-set", "1")], (96, 160), 0),
    "intra_dct_only": ("noise", 40, 6, [("use-intra-dct-only", "1")], (96, 160), 0),
    "square_transforms": ("noise", 60, 4, [("enable-rect-tx", "0")], (96, 160), 0),
    "no_64_transforms": ("gradient", 30, 4, [("enable-tx64", "0")], (128, 192), 2),  # where 64x64 ones are coded
    "tiles_2x2": ("smooth", 70, 6, [("tile-columns", "1"), ("tile-rows", "1")], (96, 160), 0),
    "superblock_128": ("gradient", 30, 4, [("sb-size", "128")], (96, 160), 0),
}


@functools.lru_cache(maxsize=None)
def option_streams(name: str) -> tuple:
    """(the file with the option, its stream, the stream without it: the
    other options of a screen-content case kept)."""
    kind, q, speed, options, (h, w), seed = OPTIONS[name]
    img = CONTENT[kind](h, w, seed)
    stream = lossy_stream(img, q, speed, options)
    base = [o for o in options if o[0] == "tune-content"] if name == "reduced_tx_set" else []
    return avif_file(stream, w=w, h=h), stream, lossy_stream(img, q, speed, base)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_libaoms_encoder_options_decode_as_cv2(name):
    data, stream, default = option_streams(name)
    assert answers(data) == "equal"
    assert (decode_stats(stream) != decode_stats(default)).any(), "the option does not change the stream"


# -- the 64-sample rectangles, monochrome and alpha ---------------------------------------

@functools.lru_cache(maxsize=None)
def rectangle_64_files() -> dict:
    """Flat bands at speed 0 with partitions of 32 and up: 64x32 and 32x64
    blocks, whose transforms have a side of 64."""
    return {axis: lossy_avif(bands(128, 128, 32, axis, 7), 40, 0, [("min-partition-size", "32")])
            for axis in (0, 1)}


def test_the_64_sample_rectangles_decode_as_cv2():
    for axis, data in rectangle_64_files().items():
        assert answers(data) == "equal", axis


@functools.lru_cache(maxsize=None)
def mono_and_alpha_files() -> dict:
    rgba = noise(24, 40, 4, 5)
    out = {f"cv2_mono_q{q}_speed{s}": cv2_avif(smooth(40, 56, 1, q + s), s, q) for q, s in ((95, 6), (98, 9), (90, 4))}
    for q in (50, 90):
        both = pil_avif(rgba, quality=q, subsampling="4:4:4", speed=6, advanced=FILTERS_OFF)
        out[f"alpha_q{q}"] = avif_file(item_data(both, 1), item_data(both, 2), w=40, h=24)
    return out


def test_lossy_monochrome_and_alpha_decode_as_cv2(tmp_path):
    """cv2's monochrome files at q90 (speed 4) to q98 and Pillow's RGBA
    files (a lossy alpha item beside a lossy colour item)."""
    for name, data in mono_and_alpha_files().items():
        assert answers(data) == "equal", name
        assert read_answers(data, tmp_path) == "equal", name
        stream = item_data(data, 2 if name.startswith("alpha") else 1)
        assert native.av1_info(stream)[1][native.AV1_INFO.index("base_q_idx")] > 0, name


# -- the 1:4 rectangles of 64, written here ------------------------------------------------------
# libaom's all-intra encoder never picks a 16x64 or 64x16 block, so the
# frames with those transforms come from this writer: libaom's entropy
# encoder (entenc.c) over the default CDFs of ``csrc/av1_tables.h``, CDF
# updates off, and headers of its own.

@functools.lru_cache(maxsize=None)
def c_tables() -> dict:
    """The arrays of ``csrc/av1_tables.h`` by name."""
    with open(os.path.join(ROOT, "ppocr_tpu_torch", "csrc", "av1_tables.h")) as f:
        src = f.read()
    out = {}
    for m in re.finditer(r"static const \w+ (\w+)((?:\[\d+\])+) = \{(.*?)\};", src, re.S):
        dims = [int(d) for d in re.findall(r"\d+", m.group(2))]
        out[m.group(1)] = np.array([int(v) for v in m.group(3).split(",") if v.strip()]).reshape(dims)
    return out


class SymbolWriter:
    """libaom's od_ec_enc: od_ec_encode_q15 on an inverted CDF row,
    od_ec_encode_bool_q15 at 16384 (aom_write_bit), od_ec_enc_done with
    its carry propagation."""

    def __init__(self):
        self.low, self.rng, self.cnt, self.pre = 0, 0x8000, -9, []

    def symbol(self, s: int, icdf, n: int):
        s = int(s)
        fl, fh = (int(icdf[s - 1]) if s > 0 else 32768), int(icdf[s])
        low, r = self.low, self.rng
        if fl < 32768:
            u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (n - s)
            v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - 1 - s)
            low, r = low + r - u, u - v
        else:
            r -= ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - 1 - s)
        self._normalize(low, r)

    def bit(self, val: int):
        v = ((self.rng >> 8) * (16384 >> 6) >> 1) + 4
        self._normalize(self.low + (self.rng - v if val else 0), v if val else self.rng - v)

    def _normalize(self, low: int, r: int):
        d = 16 - r.bit_length()
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.pre.append(low >> c)
                low &= m
                c -= 8
                m >>= 8
            self.pre.append(low >> c)
            s = c + d - 24
            low &= m
        self.low, self.rng, self.cnt = low << d, r << d, s

    def done(self) -> bytes:
        c, m = self.cnt, 0x3FFF
        e = ((self.low + m) & ~m) | (m + 1)
        s, pre = 10 + c, list(self.pre)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while s > 0:
                pre.append(e >> (c + 16))
                e &= n
                s, c, n = s - 8, c - 8, n >> 8
        out, carry = bytearray(len(pre)), 0
        for i in range(len(pre) - 1, -1, -1):
            carry += pre[i]
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)


TX_16X64, TX_64X16 = 17, 18


def write_coefficients(w: SymbolWriter, qc: int, t: int, coefs: dict, dc_ctx: int) -> int:
    """One DCT_DCT luma block of TX_16X64 or TX_64X16 (coded as 16x32 /
    32x16): ``coefs`` {scan index: (level 1 or 2, sign)}. Returns the sum
    of the levels (the block's cul_level before its clip)."""
    T = c_tables()
    cw, ch = (32, 16) if t == TX_64X16 else (16, 32)
    bhl, stride = ch.bit_length() - 1, ch + 4
    scan = T["scan_data"][T["scan_start"][t][0]:][:cw * ch]
    nz = T["nz_map_ctx_offset_data"][T["nz_map_ctx_offset_start"][t]:]
    eob = max(coefs) + 1
    starts = T["eob_group_start"].tolist()
    eob_pt = max(i for i, g in enumerate(starts) if g <= eob)
    w.symbol(eob_pt - 1, T["eob_multi512_cdfs"][qc][0][0], 10)
    bits, extra = int(T["eob_offset_bits"][eob_pt]), eob - starts[eob_pt]
    if bits:
        w.symbol((extra >> (bits - 1)) & 1, T["eob_extra_cdfs"][qc][3][0][eob_pt - 3], 2)
        for i in range(1, bits):
            w.bit((extra >> (bits - 1 - i)) & 1)
    levels = np.zeros((cw + 4) * stride, int)
    at = lambda pos: (pos >> bhl) * stride + (pos & (ch - 1))
    for c in range(eob - 1, -1, -1):
        pos, level = int(scan[c]), coefs.get(c, (0, 0))[0]
        if c == eob - 1:
            ctx = 0 if c == 0 else 1 if c <= cw * ch // 8 else 2 if c <= cw * ch // 4 else 3
            w.symbol(level - 1, T["coeff_base_eob_cdfs"][qc][3][0][ctx], 3)
        else:
            mag = sum(min(levels[at(pos) + o], 3) for o in (1, stride, stride + 1, 2 * stride, 2))
            ctx = 0 if pos == 0 else min((mag + 1) >> 1, 4) + int(nz[pos])
            w.symbol(level, T["coeff_base_cdfs"][qc][3][0][ctx], 4)
        levels[at(pos)] = level
    for c in sorted(coefs):
        if c == 0:
            w.symbol(coefs[c][1], T["dc_sign_cdfs"][qc][0][dc_ctx], 2)
        else:
            w.bit(coefs[c][1])
    return sum(level for level, _ in coefs.values())


def written_frame(coefs: list, q: int, subsampled: bool = False) -> bytes:
    """A 128x64 4:4:4 key frame (reduced still-picture header, sRGB
    identity colours; ``subsampled``: 4:2:0, BT.601 in full range) of two
    superblocks: VERT_4 into 16x64 blocks, HORZ_4 into 64x16 ones, each
    DC_PRED with luma coefficients ``coefs[k]`` and all-zero chroma
    (16x32 and 32x16 transforms, 8x32 and 32x8 in 4:2:0),
    TX_MODE_LARGEST, base_q_idx ``q``."""
    T = c_tables()
    qc = 0 if q <= 20 else 1 if q <= 60 else 2 if q <= 120 else 3
    seq = Bits().f(0 if subsampled else 1, 3).f(1, 1).f(1, 1).f(8, 5)  # profile, still, reduced header, level 4.0
    seq.f(6, 4).f(5, 4).f(127, 7).f(63, 6)  # 128 x 64 in 7 and 6 bits
    seq.f(0, 3).f(0, 3)  # 64x64 superblocks, no filter intra or edge filter; no superres, CDEF, restoration
    if subsampled:  # 8 bits, colour, BT.709 / sRGB / BT.601, full range, sample position 0, one uv delta, no grain
        seq.f(0, 1).f(0, 1).f(1, 1).f(1, 8).f(13, 8).f(6, 8).f(1, 1).f(0, 2).f(0, 1).f(0, 1)
    else:
        seq.f(0, 1).f(1, 1).f(1, 8).f(13, 8).f(0, 8).f(0, 1).f(0, 1)  # 8 bits, sRGB identity, one uv delta, no grain
    head = Bits().f(1, 1).f(0, 1).f(0, 1)  # CDF updates off, no screen content tools, render size
    head.f(1, 1).f(0, 1)  # uniform tiles, one tile column
    head.f(q, 8).f(0, 4).f(0, 2)  # base_q_idx, no dc / ac deltas, no qmatrix; no segmentation, no delta q
    head.f(0, 16)  # loop filter levels 0, sharpness 0, no deltas
    head.f(0, 2)  # TX_MODE_LARGEST, the full transform sets
    head.bits += [0] * (-len(head.bits) % 8)
    w = SymbolWriter()
    ctx = {p: np.zeros((2, 32), int) for p in range(3)}  # above / left entropy contexts in 4-sample units
    # the chroma transforms: TX_16X32 / TX_32X16 (txs_ctx 3, the plane's
    # block larger: 10), or in 4:2:0 TX_8X32 / TX_32X8 (txs_ctx 2, as large: 7)
    chroma_ctx, chroma_base = (2, 7) if subsampled else (3, 10)
    sign_of = lambda v: (0, -1, 1)[v >> 3]
    k = 0
    for sb, partition in ((0, 9), (1, 8)):
        w.symbol(partition, T["partition_cdf"][12], 10)
        for i in range(4):
            w.symbol(0, T["skip_cdf"][0], 2)
            w.symbol(0, T["kf_y_mode_cdf"][0][0], 13)
            w.symbol(0, T["uv_mode_cdf"][0][0], 13)  # no CFL above 32x32
            if sb == 0:
                cols, rows = range(4 * i, 4 * i + 4), range(16)
                chroma = ([(range(2 * i, 2 * i + 2), range(8))] if subsampled
                          else [(cols, range(0, 8)), (cols, range(8, 16))])
            else:
                cols, rows = range(16, 32), range(4 * i, 4 * i + 4)
                chroma = ([(range(8, 16), range(2 * i, 2 * i + 2))] if subsampled
                          else [(range(16, 24), rows), (range(24, 32), rows)])
            dc = sum(sign_of(ctx[0][0][c]) for c in cols) + sum(sign_of(ctx[0][1][r]) for r in rows)
            w.symbol(0, T["txb_skip_cdfs"][qc][3][0], 2)
            cul = write_coefficients(w, qc, TX_16X64 if sb == 0 else TX_64X16, coefs[k], 1 if dc < 0 else 2 if dc else 0)
            byte = min(cul, 7) | ((8 if coefs[k][0][1] else 16) if 0 in coefs[k] else 0)
            ctx[0][0][list(cols)], ctx[0][1][list(rows)] = byte, byte
            k += 1
            for p in (1, 2):
                for ccols, crows in chroma:  # all zero
                    base = ctx[p][0][list(ccols)].any() + ctx[p][1][list(crows)].any()
                    w.symbol(1, T["txb_skip_cdfs"][qc][chroma_ctx][chroma_base + base], 2)
    frame = bytes(int("".join(map(str, head.bits[i:i + 8])), 2) for i in range(0, len(head.bits), 8)) + w.done()
    return obu(1, seq.trailing()) + obu(6, frame)


def written_file(seed: int, subsampled: bool = False) -> bytes:
    rs = np.random.RandomState(seed)
    coefs = []
    for _ in range(8):
        at = sorted(set(rs.randint(0, 40, rs.randint(1, 30)).tolist()) | {0})
        coefs.append({c: (int(rs.randint(1, 3)), int(rs.randint(0, 2))) for c in at})
    frame = written_frame(coefs, int(rs.randint(1, 256)), subsampled)
    if not subsampled:
        return avif_file(frame, w=128, h=64)
    props = [(ispe(128, 64), 0), (pixi(8, 8, 8), 0), (av1c(0x00, 0x0C), 1), (colr(1, 13, 6, 1), 0)]
    return avif_file(frame, w=128, h=64, color_props=props)


@pytest.mark.parametrize("seed", range(4))
def test_written_frames_of_16x64_and_64x16_transforms_decode_as_cv2(seed):
    data = written_file(seed)
    assert answers(data) == "equal"
    s = native.AV1_STATS["tx_size"][0]
    assert (decode_stats(item_data(data))[[s + TX_16X64, s + TX_64X16]] == 4).all()


# -- the tools reached ---------------------------------------------------------------------------

def coverage() -> np.ndarray:
    total = np.zeros(native.AV1_STATS_SIZE, np.int64)
    streams = [item_data(spread_file(n)) for n in SPREAD] + [option_streams(n)[1] for n in OPTIONS]
    streams += [item_data(d) for d in rectangle_64_files().values()] + [item_data(written_file(0))]
    for s in streams:
        total += decode_stats(s)
    return total


def test_every_transform_size_and_type_and_the_quantiser_tools_are_reached():
    """Between them the cases above code every square and rectangular
    transform size (16x64 and 64x16 in the written frames), all 16
    transform types (the flipped ones in IntraBC blocks), quantiser
    matrices, delta q and var-tx splits."""
    total = coverage()
    s = native.AV1_STATS
    sizes = dict(zip(native.AV1_TX_SIZES, total[s["tx_size"][0]:s["tx_size"][1]].tolist()))
    assert all(n > 0 for n in sizes.values()), sizes
    types = total[s["tx_type"][0]:s["tx_type"][1]]
    assert (types > 0).all(), types
    for tool in ("qm", "delta_q", "vartx_split", "residual", "intrabc", "golomb"):
        assert total[s[tool]] > 0, tool


# -- the inverse transforms against libaom's own ---------------------------------------------

def _libaom():
    spec = importlib.util.spec_from_file_location("make_av1_tables_torch",
                                                  os.path.join(ROOT, "scripts", "make_av1_tables_torch.py"))
    tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tables)
    lib = tables.Library(tables.default_lib())
    lib.function("av1_rtcd", None)()  # libaom's run-time CPU dispatch
    lib.function("aom_dsp_rtcd", None)()
    return lib


@functools.lru_cache(maxsize=None)
def libaom():
    """(the library, its C 2-D inverse transforms, the x86 ones this CPU
    runs by ISA, the ISA libaom dispatches)."""
    lib = _libaom()
    i32p, u8p, u16p = (ctypes.POINTER(t) for t in (ctypes.c_int32, ctypes.c_uint8, ctypes.c_uint16))
    c = {t: lib.function(f"av1_inv_txfm2d_add_{name}_c", None, i32p, u16p, ctypes.c_int, ctypes.c_uint8, ctypes.c_int)
         for t, name in enumerate(native.AV1_TX_SIZES)}
    value, _ = lib.sym("av1_inv_txfm_add")
    target = int(np.frombuffer(ctypes.string_at(lib.base + value, 8), "<u8")[0]) - lib.base
    dispatched = next(n for n, found in lib.syms.items() if n.startswith("av1_inv_txfm_add_")
                      for v, _ in found if v == target)
    isa = dispatched.rsplit("_", 1)[1]
    assert isa in ("avx2", "ssse3"), f"libaom dispatches {dispatched}: the decoder replays its x86 path"
    simd = {name: lib.function(f"av1_lowbd_inv_txfm2d_add_{name}", None, i32p, u8p, ctypes.c_int, ctypes.c_uint8,
                               ctypes.c_uint8, ctypes.c_int)
            for name in ("ssse3", "avx2")[:2 if isa == "avx2" else 1]}  # SSSE3 is there wherever AVX2 is
    orders = lib.pointers("av1_scan_orders", 19 * 16 * 2)[::2]
    return lib, c, simd, isa, orders


def _aligned(a: np.ndarray) -> np.ndarray:
    buf = np.zeros(a.size + 16, a.dtype)
    at = (-buf.ctypes.data % 64) // a.itemsize
    out = buf[at:at + a.size]
    out[:] = a
    return out


def transform_types(w: int, h: int) -> list:
    """The types a size takes: DCT only with a side of 64, DCT and identity
    with one of 32 (inter blocks), all 16 below."""
    return [0] if max(w, h) == 64 else [0, 9] if max(w, h) == 32 else list(range(16))


@pytest.mark.parametrize("tx_size", range(19), ids=list(native.AV1_TX_SIZES))
def test_each_inverse_transform_is_libaoms(tx_size):
    """Random, sparse and extreme (±32768) coefficients up to a random eob
    along the type's scan: the decoder's transform equals libaom's SSSE3
    and, where this CPU runs it, AVX2 function (16-bit lanes that
    saturate), to the pixel; libaom's C function parts from them."""
    lib, c_fn, simd, isa, orders = libaom()
    w, h = (int(v) for v in native.AV1_TX_SIZES[tx_size].split("x"))
    cw, ch = min(w, 32), min(h, 32)
    rs = np.random.RandomState(tx_size)
    saturated = 0
    for tx_type in transform_types(w, h):
        scan = lib.object(orders[tx_size * 16 + tx_type], "<i2")
        for trial in range(24):
            eob = cw * ch if trial % 3 == 0 else rs.randint(1, cw * ch + 1)
            kind = trial % 4
            if kind == 0:
                values = rs.randint(-600, 601, eob) * (rs.rand(eob) < 0.3)
            elif kind == 1:
                values = rs.randint(-32768, 32768, eob)
            elif kind == 2:
                values = rs.randint(-32768, 32768, eob) * (rs.rand(eob) < 0.1)
            else:
                values = rs.choice([-32768, 32767, 0, 20000, -20000], eob)
            coef = np.zeros(cw * ch, np.int32)
            coef[scan[:eob]] = values
            pred = rs.randint(0, 256, (h, w)).astype(np.uint8)
            want_c = pred.astype(np.uint16)
            c_fn[tx_size](_aligned(coef).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          want_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), w, tx_type, 8)
            got = pred.copy()
            native.av1_inverse_transform(coef, tx_size, tx_type, got)
            for name, fn in simd.items():
                want = pred.copy()
                fn(_aligned(coef).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                   want.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, tx_type, tx_size, eob)
                assert (got == want).all(), (name, tx_type, trial)
                if name == isa:
                    saturated += (want_c != want).any()
    if max(w, h) > 4:
        assert saturated, "no case where libaom's two paths part"


def test_a_transform_out_of_range_is_refused():
    with pytest.raises(ValueError, match="no transform"):
        native.av1_inverse_transform(np.zeros(16, np.int32), 0, 16, np.zeros((4, 4), np.uint8))


# -- loop restoration beside the other in-loop filters ------------------------------------------

@functools.lru_cache(maxsize=None)
def filter_files() -> dict:
    """Speed-0 frames that run loop restoration (U and V), beside
    deblocking, beside CDEF, or alone (deblocking and CDEF alone:
    ``tests/test_torch_avif_deblock.py``, ``test_torch_avif_cdef.py``;
    restoration: ``tests/test_torch_avif_restoration.py``). Without CDEF
    libaom restores by its "optimized" path, which reads the frame's rows
    where the other saves them before CDEF: the same rows."""
    img = smooth(64, 96, 3, 90)
    on = {"deblocking": [("enable-cdef", "0"), ("enable-restoration", "1")],
          "cdef": [("enable-cdef", "1"), ("loopfilter-control", "0"), ("enable-restoration", "1")],
          "restoration": [("enable-cdef", "0"), ("loopfilter-control", "0"), ("enable-restoration", "1")]}
    out = {}
    for name, options in on.items():
        stream = item_data(pil_avif(img, quality=40, subsampling="4:4:4", speed=0, advanced=options))
        out[name] = avif_file(stream, w=96, h=64)
    return out


@pytest.mark.parametrize("name", ["deblocking", "cdef", "restoration"])
def test_a_frame_that_runs_loop_restoration_with_or_without_the_other_filters_decodes_as_cv2(name, caplog):
    """Loop restoration with the other filters or alone: cv2's pixels, no
    log line, and each filter asked for runs."""
    data = filter_files()[name]
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is not None
    assert not [r for r in caplog.records if r.name == "ppocr_tpu_torch.utils.imcodec"]
    assert answers(data) == "equal"
    stats = decode_stats(item_data(data))
    s = native.AV1_STATS
    assert stats[s["lr_units"][0]:s["lr_units"][1]].reshape(3, 3)[:, 1:].sum() > 0
    assert (stats[s["lf_edges"][0]:s["lf_edges"][1]].sum() > 0) == (name == "deblocking")
    assert (stats[s["cdef_y"]] + stats[s["cdef_uv"]] > 0) == (name == "cdef")


# -- damage ----------------------------------------------------------------------------------------

def fuzz_bases() -> dict:
    """Small lossy files the fuzz changes: noise, quantiser matrices,
    screen content (IntraBC, var-tx, flipped types), delta q, alpha, and a
    written frame of 16x64 and 64x16 transforms."""
    rgba = noise(20, 28, 4, 4)
    both = pil_avif(rgba, quality=60, subsampling="4:4:4", speed=6, advanced=FILTERS_OFF)
    return {
        "lossy_noise": lossy_avif(noise(24, 40, 3, 1), 50, 6),
        "lossy_qm": lossy_avif(smooth(48, 64, 3, 2), 40, 2, [("enable-qm", "1"), ("qm-min", "2"), ("qm-max", "9")]),
        "lossy_screen": lossy_avif(text(64, 128, 3, 3), 60, 6, [("tune-content", "screen")]),
        "lossy_delta_q": lossy_avif(smooth(64, 96, 3, 4), 50, 6, [("deltaq-mode", "2")]),
        "lossy_alpha": avif_file(item_data(both, 1), item_data(both, 2), w=28, h=20),
        "lossy_written_16x64_64x16": written_file(5),
    }


@functools.lru_cache(maxsize=None)
def bases() -> dict:
    return fuzz_bases()


@pytest.mark.parametrize("name", ["lossy_noise", "lossy_qm", "lossy_screen", "lossy_delta_q", "lossy_alpha",
                                  "lossy_written_16x64_64x16"])
def test_mutated_lossy_files_answer_as_cv2(name):
    got = collections.Counter(answers(d) for d in mutations(bases()[name], 300, seed=len(name) + 31))
    assert set(got) <= {"none", "equal", "known"}, got
    assert got["equal"] >= 5


def test_every_header_byte_of_a_lossy_file_xored_answers_as_cv2():
    """The AV1 item's first 48 bytes (OBU headers, the sequence header, the
    frame header with its quantisers and tx mode) XOR-ed with 0x01, 0x10
    and 0xFF."""
    data = bases()["lossy_qm"]
    mdat = data.rindex(b"mdat") + 4
    got = collections.Counter()
    for i in range(mdat, min(len(data), mdat + 48)):
        for x in (0x01, 0x10, 0xFF):
            d = bytearray(data)
            d[i] ^= x
            got[answers(bytes(d))] += 1
    assert set(got) <= {"none", "equal", "known"}, got


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's lossy files: ``n`` mutations of each base."""
    return [m for i, data in enumerate(bases().values()) for m in mutations(data, n, seed=10000 * round_ + i + 500)]


# -- what the card decodes ---------------------------------------------------------------------

def written_cases() -> dict:
    """For ``assets/image_cases.npz``: a spread of the streams above (not
    the noise at 200x300, whose decode takes 170 kB there), the 64-sample
    rectangles, monochrome and alpha, and mutated and cut lossy files."""
    cases = {f"lossy_{k}": spread_file(k) for k in list(SPREAD)[::2] if not k.startswith("noise_200x300")}
    cases.update({f"lossy_option_{k}": option_streams(k)[0] for k in OPTIONS})
    cases.update({f"lossy_rect64_{k}": v for k, v in rectangle_64_files().items()})
    cases.update({f"lossy_{k}": v for k, v in mono_and_alpha_files().items()})
    cases.update({f"lossy_written_16x64_64x16_{seed}": written_file(seed) for seed in range(2)})
    for i, (name, data) in enumerate(bases().items()):
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 4, seed=i + 950))})
        cases[f"{name}_cut"] = data[: len(data) * 3 // 4]
    return {k: v for k, v in cases.items() if answers(v) != "known"}


def scene_payload(scene: np.ndarray) -> dict:
    """The serving scene as a lossy 4:4:4 AVIF with the filters off:
    libavif's own file (q90, speed 6, identity matrix), the smoke's timed
    payload and request."""
    return {"scene0_avif_lossy": libavif_avif(scene, 90, 6)}


def test_the_written_cases_and_the_payload_decode_as_cv2():
    cases = {**written_cases(), **scene_payload(smooth(64, 96, 3, 5))}
    got = collections.Counter(answers(d) for d in cases.values())
    assert set(got) <= {"none", "equal"} and got["equal"] >= 25, got
    assert port_decode(cases["scene0_avif_lossy"]) is not None
