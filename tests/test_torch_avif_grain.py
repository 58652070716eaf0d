"""libaom 3.14.1's film grain in ``csrc/av1.cpp`` (``av1_add_film_grain``
and ``add_film_grain_run`` of grain_synthesis.c on the frame as the decoder
outputs it) against ``cv2.imdecode(buf, IMREAD_COLOR)`` (OpenCV 5.0 over
libavif 1.4.2 and libaom 3.14.1): the same ``None`` or not, and 0 differing
pixels.

The files: Pillow's with each of libaom's 16 ``film-grain-test`` vectors
in 4:2:0 and 4:4:4, at an odd and an even size (the grain stream in a
limited-range container, once refused, is ``test_torch_avif.GRAINED``);
and real streams whose grain
parameters this file rewrites (the uncompressed header re-packed up to
``film_grain_params``, its last field before ``byte_alignment``; the
sequence header's ``film_grain_params_present`` set where it was not):
random parameters in 4:2:0, 4:2:2 and 4:4:4, chroma scaled from luma,
monochrome, the identity matrix with the clip to the restricted range,
no luma points, each AR lag (0-3) with random coefficients, overlap on
and off, odd sizes. Each grain changes cv2's pixels (against the same
stream with ``apply_grain`` 0). The synthesis equals libaom's
``add_film_grain_run``, called through ``ctypes`` on random planes and
parameters, whose ``aom_film_grain_t`` layout is checked against the
library's ``film_grain_test_vectors``.

    python -m pytest tests/test_torch_avif_grain.py -q
"""

import collections
import ctypes
import functools
import struct

import cv2
import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from test_torch_avif import (Bits, av1c, avif_file, bits_of, colr, cv2_avif, decode_stats, ispe, item_data, mutations,
                             noise, obu, pil_avif, pixi, smooth, split_obus, text)
from test_torch_avif_lossy import FILTERS_OFF, _libaom, libavif_avif
from test_torch_tiff import answers, cv2_decode, port_decode

S = native.AV1_STATS
F = native.AV1_GRAIN_FIELDS
# Pillow's subsampling → (ss_x, ss_y, the av1C's profile byte and subsampling byte)
LAYOUTS = {"4:2:0": (1, 1, 0x00, 0x0C), "4:2:2": (1, 0, 0x40, 0x08), "4:4:4": (0, 0, 0x20, 0x00)}


# -- libaom's parameters ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def grain_vectors() -> np.ndarray:
    """libaom's ``film_grain_test_vectors`` (the encoder's
    ``film-grain-test`` 1-16): [16, AV1_GRAIN_SIZE] int32."""
    lib = _libaom()
    value, size = lib.sym("film_grain_test_vectors")
    assert size == 16 * 4 * native.AV1_GRAIN_SIZE, size
    return np.frombuffer(lib.data[value:value + size], "<i4").reshape(16, native.AV1_GRAIN_SIZE).copy()


def field(g: np.ndarray, name: str):
    at, n = F[name]
    v = g[at:at + n]
    return int(v[0]) & (0xFFFF if name == "random_seed" else -1) if n == 1 else v


def put(g: np.ndarray, name: str, value):
    at, n = F[name]
    g[at:at + n] = value


def random_grain(rs, ss_x: int, ss_y: int, mono: bool = False, **fixed) -> np.ndarray:
    """Parameters a stream may carry, drawn over their coded ranges
    (``fixed`` {field: value} set after; a point count fixed alone draws
    that many points)."""
    g = np.zeros(native.AV1_GRAIN_SIZE, np.int32)
    put(g, "apply_grain", 1)
    put(g, "update_parameters", 1)
    put(g, "bit_depth", 8)
    put(g, "random_seed", int(rs.randint(0, 1 << 16)))

    def points(name, most):
        n = int(rs.randint(0, most + 1))
        n = fixed.get(f"num_{name}_points", n)
        xs = np.sort(rs.choice(256, n, replace=False))
        pts = np.zeros((most, 2), np.int32)
        pts[:n, 0], pts[:n, 1] = xs, rs.randint(0, 256, n)
        put(g, f"scaling_points_{name}", pts.reshape(-1))
        put(g, f"num_{name}_points", n)

    points("y", 14)
    points("cb", 10)
    points("cr", 10)
    put(g, "chroma_scaling_from_luma", int(rs.rand() < 0.2))
    put(g, "scaling_shift", int(rs.randint(8, 12)))
    put(g, "ar_coeff_lag", int(rs.randint(0, 4)))
    put(g, "ar_coeffs_y", rs.randint(-128, 128, 24))
    put(g, "ar_coeffs_cb", rs.randint(-128, 128, 25))
    put(g, "ar_coeffs_cr", rs.randint(-128, 128, 25))
    put(g, "ar_coeff_shift", int(rs.randint(6, 10)))
    put(g, "grain_scale_shift", int(rs.randint(0, 4)))
    for name, bits in (("mult", 8), ("luma_mult", 8), ("offset", 9)):
        put(g, f"cb_{name}", int(rs.randint(0, 1 << bits)))
        put(g, f"cr_{name}", int(rs.randint(0, 1 << bits)))
    put(g, "overlap_flag", int(rs.randint(0, 2)))
    put(g, "clip_to_restricted_range", int(rs.randint(0, 2)))
    for name, value in fixed.items():
        put(g, name, value)
    return coded(g, ss_x, ss_y, mono)


def coded(g: np.ndarray, ss_x: int, ss_y: int, mono: bool) -> np.ndarray:
    """What av1_read_film_grain_params reads back of ``g`` in a frame of
    that layout: the fields it does not read are 0 (one plane of 4:2:0 with
    points and the other without gets points in both)."""
    g = g.copy()
    num_y = field(g, "num_y_points")
    if mono:
        put(g, "chroma_scaling_from_luma", 0)
    csfl = field(g, "chroma_scaling_from_luma")
    if mono or csfl or (ss_x == 1 and ss_y == 1 and num_y == 0):
        put(g, "num_cb_points", 0)
        put(g, "num_cr_points", 0)
    elif ss_x == 1 and ss_y == 1 and (field(g, "num_cb_points") == 0) != (field(g, "num_cr_points") == 0):
        for name in ("cb", "cr"):
            if not field(g, f"num_{name}_points"):
                put(g, f"num_{name}_points", 1)
    for name, most in (("y", 14), ("cb", 10), ("cr", 10)):
        pts = field(g, f"scaling_points_{name}").reshape(most, 2)
        pts[field(g, f"num_{name}_points"):] = 0
    lag = field(g, "ar_coeff_lag")
    npl = 2 * lag * (lag + 1)
    npc = npl + (num_y > 0)
    field(g, "ar_coeffs_y")[npl if num_y else 0:] = 0
    for name in ("cb", "cr"):
        on = field(g, f"num_{name}_points") or csfl
        field(g, f"ar_coeffs_{name}")[npc if on else 0:] = 0
        if not field(g, f"num_{name}_points"):
            for k in ("mult", "luma_mult", "offset"):
                put(g, f"{name}_{k}", 0)
    return g


def grain_bits(g: np.ndarray, ss_x: int, ss_y: int, mono: bool) -> list:
    """film_grain_params() of a shown key frame (update_grain implied)."""
    b = Bits().f(field(g, "apply_grain"), 1)
    if not field(g, "apply_grain"):
        return b.bits
    b.f(field(g, "random_seed"), 16)
    num_y = field(g, "num_y_points")
    b.f(num_y, 4)
    for x, y in field(g, "scaling_points_y").reshape(14, 2)[:num_y]:
        b.f(int(x), 8).f(int(y), 8)
    csfl = field(g, "chroma_scaling_from_luma")
    if not mono:
        b.f(csfl, 1)
    if not (mono or csfl or (ss_x == 1 and ss_y == 1 and num_y == 0)):
        for name in ("cb", "cr"):
            n = field(g, f"num_{name}_points")
            b.f(n, 4)
            for x, y in field(g, f"scaling_points_{name}").reshape(10, 2)[:n]:
                b.f(int(x), 8).f(int(y), 8)
    lag = field(g, "ar_coeff_lag")
    b.f(field(g, "scaling_shift") - 8, 2).f(lag, 2)
    npl = 2 * lag * (lag + 1)
    npc = npl + (num_y > 0)
    if num_y:
        for v in field(g, "ar_coeffs_y")[:npl]:
            b.f(int(v) + 128, 8)
    for name in ("cb", "cr"):
        if field(g, f"num_{name}_points") or csfl:
            for v in field(g, f"ar_coeffs_{name}")[:npc]:
                b.f(int(v) + 128, 8)
    b.f(field(g, "ar_coeff_shift") - 6, 2).f(field(g, "grain_scale_shift"), 2)
    for name in ("cb", "cr"):
        if field(g, f"num_{name}_points"):
            b.f(field(g, f"{name}_mult"), 8).f(field(g, f"{name}_luma_mult"), 8).f(field(g, f"{name}_offset"), 9)
    return b.f(field(g, "overlap_flag"), 1).f(field(g, "clip_to_restricted_range"), 1).bits


def _to_bytes(bits: list) -> bytes:
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def regrained(stream: bytes, g: np.ndarray) -> bytes:
    """The stream with the frame's film_grain_params replaced by ``g``
    (``film_grain_params_present`` set in its sequence header), the tile
    data kept as it was."""
    status, info, why = native.av1_info(stream)
    assert status == 0, why
    at = dict(zip(native.AV1_INFO, info.tolist()))
    ss_x, ss_y, mono = at["ss_x"], at["ss_y"], bool(at["mono"])
    out = b""
    for kind, payload in split_obus(stream):
        if kind == 1:
            seq = bits_of(payload)
            end = len(seq) - 1 - seq[::-1].index(1)  # the trailing one bit
            seq[end - 1] = 1  # film_grain_params_present
            payload = _to_bytes(seq[:end] + [1])
        elif kind == 6:
            head = bits_of(payload)[:at["grain_bit"]] + grain_bits(g, ss_x, ss_y, mono)
            payload = _to_bytes(head) + payload[(at["header_bits"] + 7) // 8:]
        else:
            assert kind == 2, kind  # a temporal delimiter; a frame header OBU of its own is not written here
        out += obu(kind, payload)
    return out


def contained(stream: bytes, w: int, h: int, layout: str = "4:4:4", mono: bool = False, matrix: int = 1,
              full_range: int = 1) -> bytes:
    """The stream in a file whose av1C matches its layout, BT.709 primaries
    and sRGB transfer, the matrix and range asked for."""
    _, _, b1, b2 = LAYOUTS[layout]
    if mono:
        b1, b2 = 0x00, 0x1C
    return avif_file(stream, w=w, h=h, color_props=[(ispe(w, h), 0), (pixi(*([8] * (1 if mono else 3))), 0),
                                                    (av1c(b1, b2), 1), (colr(1, 13, matrix, full_range), 0)])


def replaced(data: bytes, stream: bytes) -> bytes:
    """The file with its colour item's stream (the last bytes of its mdat,
    as Pillow writes it) replaced: the iloc length and the mdat size
    follow."""
    old = item_data(data)
    at = data.index(old)
    assert data.count(old) == 1 and at + len(old) == len(data)
    length = struct.pack(">II", at, len(old))
    assert data.count(length) == 1
    out = bytearray(data[:at] + stream)
    out[data.index(length) + 4:data.index(length) + 8] = struct.pack(">I", len(stream))
    mdat = data.index(b"mdat") - 4
    out[mdat:mdat + 4] = struct.pack(">I", len(out) - mdat)
    return bytes(out)


def grain_off(g: np.ndarray) -> np.ndarray:
    off = np.zeros_like(g)
    put(off, "bit_depth", 8)
    return off


# -- the synthesis against libaom's ----------------------------------------------------------------

def test_aom_film_grain_t_is_libaoms_layout():
    """The 16 test vectors parse as parameters of 8-bit grain in the
    layout of ``AV1_GRAIN_FIELDS``: each field in its range, the scaling
    points rising, and the first vector's values as grain_test_vectors.h
    gives them."""
    vecs = grain_vectors()
    for g in vecs:
        assert field(g, "apply_grain") == 1 and field(g, "update_parameters") in (0, 1) and field(g, "bit_depth") == 8
        assert 8 <= field(g, "scaling_shift") <= 11 and 0 <= field(g, "ar_coeff_lag") <= 3
        assert 6 <= field(g, "ar_coeff_shift") <= 9 and 0 <= field(g, "grain_scale_shift") <= 3
        for name, most in (("y", 14), ("cb", 10), ("cr", 10)):
            n = field(g, f"num_{name}_points")
            pts = field(g, f"scaling_points_{name}").reshape(most, 2)
            assert 0 <= n <= most and (np.diff(pts[:n, 0]) > 0).all()
            assert ((pts >= 0) & (pts < 256)).all()
        for name in ("y", "cb", "cr"):
            assert ((field(g, f"ar_coeffs_{name}") >= -128) & (field(g, f"ar_coeffs_{name}") < 128)).all()
        assert field(g, "overlap_flag") in (0, 1) and field(g, "clip_to_restricted_range") in (0, 1)
    first = vecs[0]
    assert field(first, "num_y_points") == 14 and field(first, "scaling_points_y")[:4].tolist() == [16, 0, 25, 136]
    assert field(first, "num_cb_points") == 8 and field(first, "num_cr_points") == 9
    assert (field(first, "scaling_shift"), field(first, "ar_coeff_lag"), field(first, "ar_coeff_shift")) == (11, 2, 8)
    assert field(first, "ar_coeffs_y")[:12].tolist() == [0, 0, -58, 0, 0, 0, -76, 100, -43, 0, -51, 82]
    assert [field(first, k) for k in ("cb_mult", "cb_luma_mult", "cb_offset", "cr_mult", "cr_luma_mult",
                                      "cr_offset")] == [247, 192, 18, 229, 192, 54]
    assert (field(first, "overlap_flag"), field(first, "clip_to_restricted_range"), field(first, "random_seed")) == \
        (0, 1, 45231)
    assert {field(g, "overlap_flag") for g in vecs} == {0, 1}


@functools.lru_cache(maxsize=None)
def grain_run():
    lib = _libaom()
    vp, i = ctypes.c_void_p, ctypes.c_int
    return lib.function("add_film_grain_run", i, vp, vp, vp, vp, i, i, i, i, i, i, i, i)


@pytest.mark.parametrize("overlap", [0, 1], ids=["no_overlap", "overlap"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_grain_is_libaoms_add_film_grain_run(layout, overlap):
    """Random parameters (the test vectors and draws over every field's
    coded range) on random planes of even sizes from 2x2 to 118x158, with
    and without the identity matrix: the noised planes equal libaom's to
    the sample."""
    ss_x, ss_y = LAYOUTS[layout][:2]
    rs = np.random.RandomState(list(LAYOUTS).index(layout) * 2 + overlap)
    run = grain_run()
    for trial in range(60):
        if trial < 16:
            g = coded(grain_vectors()[trial], ss_x, ss_y, False)
            put(g, "overlap_flag", overlap)
        else:
            g = random_grain(rs, ss_x, ss_y, overlap_flag=overlap)
        h, w = 2 * int(rs.randint(1, 60)), 2 * int(rs.randint(1, 80))
        planes = [rs.randint(0, 256, (h, w)).astype(np.uint8)]
        planes += [rs.randint(0, 256, (h >> ss_y, w >> ss_x)).astype(np.uint8) for _ in range(2)]
        mc_identity = trial % 2
        ours = native.av1_film_grain(g, planes, ss_x, ss_y, mc_identity)
        theirs = [p.copy() for p in planes]
        assert run(g.ctypes.data, *(p.ctypes.data for p in theirs), h, w, w, w >> ss_x, 0, ss_y, ss_x,
                   mc_identity) == 0
        for k, (a, b) in enumerate(zip(ours, theirs)):
            assert (a == b).all(), (trial, k, h, w)


def test_a_grain_call_out_of_range_is_refused():
    g = coded(grain_vectors()[0], 1, 1, False)
    planes = [np.zeros((4, 4), np.uint8), np.zeros((2, 2), np.uint8), np.zeros((2, 2), np.uint8)]
    with pytest.raises(ValueError, match="parameters"):
        native.av1_film_grain(g[:10], planes, 1, 1, False)
    bad = g.copy()
    put(bad, "ar_coeff_lag", 4)
    with pytest.raises(ValueError, match="ranges"):
        native.av1_film_grain(bad, planes, 1, 1, False)
    with pytest.raises(ValueError, match="ranges"):
        native.av1_film_grain(g, [np.zeros((3, 4), np.uint8), planes[1][:1], planes[2][:1]], 1, 1, False)


# -- Pillow's files ------------------------------------------------------------------------------------

SIZES = [(33, 47), (64, 96)]


@functools.lru_cache(maxsize=None)
def pillow_file(vector: int, subsampling: str, size: tuple) -> bytes:
    h, w = size
    img = noise(h, w, 3, vector) if vector % 2 else smooth(h, w, 3, vector)
    return pil_avif(img, quality=60, subsampling=subsampling, advanced=[("film-grain-test", str(vector))])


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("vector", range(1, 17))
def test_pillows_film_grain_files_decode_as_cv2(vector, subsampling):
    """Each of libaom's test vectors at 47x33 and 96x64: the grain the
    stream carries is the vector's (its seed aside), and cv2's pixels
    differ from those of the same stream without it."""
    ss_x, ss_y = LAYOUTS[subsampling][:2]
    for size in SIZES:
        data = pillow_file(vector, subsampling, size)
        assert answers(data) == "equal", size
        stream = item_data(data)
        stats = decode_stats(stream)
        want = coded(grain_vectors()[vector - 1], ss_x, ss_y, False)
        csfl = field(want, "chroma_scaling_from_luma")
        assert stats[S["grain"][0]:S["grain"][1]].tolist() == [int(field(want, "num_y_points") > 0),
                                                               int(field(want, "num_cb_points") > 0 or csfl),
                                                               int(field(want, "num_cr_points") > 0 or csfl)]
        assert stats[S["grain_odd"]] == (size == (33, 47))
        plain = replaced(data, regrained(stream, grain_off(want)))
        assert answers(plain) == "equal"
        assert (cv2_decode(plain) != cv2_decode(data)).any() or not stats[S["grain"][0]:S["grain"][1]].any()


# -- rewritten grain -------------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def base_stream(layout: str, h: int = 48, w: int = 64, kind: str = "smooth") -> bytes:
    """Pillow's q60 stream of that layout (the in-loop filters off or on by
    the kind) and no grain of its own."""
    img = {"smooth": smooth, "noise": noise, "text": text}[kind](h, w, 3, h + w)
    return item_data(pil_avif(img, quality=60, subsampling=layout, speed=6))


def rewritten(layout: str, g: np.ndarray, h: int = 48, w: int = 64, kind: str = "smooth", matrix: int = 1,
              full_range: int = 1) -> bytes:
    return contained(regrained(base_stream(layout, h, w, kind), g), w, h, layout, matrix=matrix,
                     full_range=full_range)


def _check(data: bytes, g_off_data: bytes = None):
    assert answers(data) == "equal"
    if g_off_data is not None:
        assert answers(g_off_data) == "equal"
        assert (cv2_decode(data) != cv2_decode(g_off_data)).any()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_random_grain_rewritten_into_each_layout_decodes_as_cv2(layout):
    """Random parameters of every field, at even and odd sizes; Pillow's
    BT.601 matrix, full and limited range."""
    ss_x, ss_y = LAYOUTS[layout][:2]
    rs = np.random.RandomState(11 + list(LAYOUTS).index(layout))
    for trial in range(8):
        g = random_grain(rs, ss_x, ss_y)
        h, w = ((48, 64), (33, 47), (17, 90), (70, 31))[trial % 4]
        kind = ("smooth", "noise", "text")[trial % 3]
        _check(rewritten(layout, g, h, w, kind, matrix=6, full_range=trial % 2))


@pytest.mark.parametrize("layout", ["4:2:0", "4:4:4"])
def test_chroma_scaled_from_luma_decodes_as_cv2(layout):
    ss_x, ss_y = LAYOUTS[layout][:2]
    rs = np.random.RandomState(21 + ss_x)
    for overlap in (0, 1):
        g = random_grain(rs, ss_x, ss_y, chroma_scaling_from_luma=1, overlap_flag=overlap, num_y_points=6,
                         scaling_points_y=np.r_[[0, 40, 50, 90, 100, 120, 160, 200, 200, 255, 255, 100],
                                                np.zeros(16, int)])
        data = rewritten(layout, g, 40, 56, matrix=6)
        _check(data, rewritten(layout, grain_off(g), 40, 56, matrix=6))
        assert decode_stats(item_data(data))[S["grain_from_luma"]] == 1


@functools.lru_cache(maxsize=None)
def grey_stream(h: int, w: int) -> bytes:
    """cv2's monochrome q60 stream of a grey image (no film grain in its
    sequence)."""
    grey = cv2.cvtColor(smooth(h, w, 3, 5), cv2.COLOR_BGR2GRAY)
    return item_data(cv2_avif(grey, 6, 60))


@pytest.mark.parametrize("size", [(48, 64), (31, 45)], ids=["even", "odd"])
def test_monochrome_grain_decodes_as_cv2(size):
    """cv2's grey stream given ``film_grain_params_present`` and luma
    grain (chroma points are not coded in a monochrome frame)."""
    h, w = size
    rs = np.random.RandomState(31 + h)
    for overlap in (0, 1):
        g = random_grain(rs, 1, 1, mono=True, overlap_flag=overlap, num_y_points=3,
                         scaling_points_y=np.r_[[20, 60, 120, 90, 250, 40], np.zeros(22, int)])
        stream = regrained(grey_stream(h, w), g)
        data = contained(stream, w, h, mono=True, matrix=6)
        _check(data, contained(regrained(grey_stream(h, w), grain_off(g)), w, h, mono=True, matrix=6))


@pytest.mark.parametrize("clip", [0, 1], ids=["unclipped", "clipped"])
def test_the_identity_matrix_with_the_clip_decodes_as_cv2(clip):
    """libavif's own 4:4:4 identity-matrix stream: under the clip to the
    restricted range chroma keeps luma's bounds (16-235, mc_identity)."""
    img = text(48, 64, 3, 7)
    stream = item_data(libavif_avif(img, 60, 6, FILTERS_OFF))
    assert native.av1_info(stream)[1][8] == 0
    rs = np.random.RandomState(41 + clip)
    for trial in range(3):
        g = random_grain(rs, 0, 0, clip_to_restricted_range=clip, scaling_shift=8, num_y_points=2,
                         scaling_points_y=np.r_[[0, 255, 255, 255], np.zeros(24, int)], num_cb_points=2,
                         num_cr_points=2, scaling_points_cb=np.r_[[0, 255, 255, 255], np.zeros(16, int)],
                         scaling_points_cr=np.r_[[0, 255, 255, 255], np.zeros(16, int)])
        data = avif_file(regrained(stream, g), w=64, h=48)
        _check(data, avif_file(regrained(stream, grain_off(g)), w=64, h=48))
        got = port_decode(data)
        if clip:  # BGR of the identity matrix holds Y in G and V, U in R, B
            assert got.min() >= 16 and got.max() <= 235
        assert decode_stats(item_data(data))[S["grain_clip"]] == clip


@pytest.mark.parametrize("layout", ["4:2:0", "4:4:4"])
def test_no_luma_points_decodes_as_cv2(layout):
    """No luma scaling: in 4:2:0 no chroma either (its points are not
    coded), in 4:4:4 chroma alone."""
    ss_x, ss_y = LAYOUTS[layout][:2]
    rs = np.random.RandomState(51 + ss_x)
    for trial in range(3):
        g = random_grain(rs, ss_x, ss_y, num_y_points=0, chroma_scaling_from_luma=0, num_cb_points=4,
                         num_cr_points=3, scaling_points_cb=np.r_[[0, 120, 80, 200, 160, 60, 255, 255],
                                                                  np.zeros(12, int)],
                         scaling_points_cr=np.r_[[10, 255, 100, 30, 240, 180], np.zeros(14, int)])
        data = rewritten(layout, g, 40, 72, "noise", matrix=6)
        stats = decode_stats(item_data(data))[S["grain"][0]:S["grain"][1]]
        assert stats.tolist() == ([0, 0, 0] if ss_x else [0, 1, 1])
        _check(data, rewritten(layout, grain_off(g), 40, 72, "noise", matrix=6) if not ss_x else None)


@pytest.mark.parametrize("lag", range(4))
def test_each_ar_lag_decodes_as_cv2(lag):
    """Random AR coefficients of each lag, in 4:2:0 and 4:4:4, the
    chroma filters with and without luma's input."""
    rs = np.random.RandomState(61 + lag)
    for layout in ("4:2:0", "4:4:4"):
        ss_x, ss_y = LAYOUTS[layout][:2]
        for trial in range(3):
            g = random_grain(rs, ss_x, ss_y, ar_coeff_lag=lag, num_y_points=int(rs.randint(0, 3)) * 4)
            data = rewritten(layout, g, 40, 56, "noise", matrix=6)
            _check(data)
            assert decode_stats(item_data(data))[S["grain_ar_lag"][0] + lag] == 1


def test_a_seed_of_each_stripe_and_the_overlap_across_many_blocks_decode_as_cv2():
    """A 200x136 frame: seven 32-row stripes and seven block columns, with
    and without overlap."""
    for overlap in (0, 1):
        g = coded(grain_vectors()[3], 1, 1, False)
        put(g, "overlap_flag", overlap)
        put(g, "random_seed", 4321 + overlap)
        _check(rewritten("4:2:0", g, 200, 136, "text", matrix=6),
               rewritten("4:2:0", grain_off(g), 200, 136, "text", matrix=6) if overlap else None)


def test_grain_over_a_frame_of_every_in_loop_filter_decodes_as_cv2():
    """cv2's default (deblocked, CDEF) stream and Pillow's restoring one,
    regrained."""
    from test_torch_avif_deblock import serving_scene

    scene = np.ascontiguousarray(serving_scene(0)[:96, :160])
    for stream in (item_data(cv2_avif(scene, 6, 50)),
                   item_data(pil_avif(scene, quality=40, subsampling="4:2:0", speed=4,
                                      advanced=[("enable-restoration", "1")]))):
        g = coded(grain_vectors()[5], 1, 1, False)
        put(g, "overlap_flag", 1)
        info = native.av1_info(stream)[1]
        data = contained(regrained(stream, g), 160, 96, "4:2:0", matrix=int(info[8]), full_range=int(info[9]))
        _check(data)


# -- the tools reached --------------------------------------------------------------------------------------

def test_every_grain_tool_is_reached():
    """Between them the files noise each plane, run each AR lag, overlap,
    scale chroma from luma, clip, and extend odd sizes."""
    total = np.zeros(native.AV1_STATS_SIZE, np.int64)
    for data in list(fuzz_bases().values()) + [pillow_file(v, s, z) for v in (1, 7, 12) for s in ("4:2:0", "4:4:4")
                                                 for z in SIZES]:
        total += decode_stats(item_data(data))
    assert (total[S["grain"][0]:S["grain"][1]] > 0).all()
    assert (total[S["grain_ar_lag"][0]:S["grain_ar_lag"][1]] > 0).all()
    for tool in ("grain_overlap", "grain_from_luma", "grain_clip", "grain_odd"):
        assert total[S[tool]] > 0, tool


def test_film_grain_has_its_stage_time():
    stream = item_data(pillow_file(5, "4:2:0", (64, 96)))
    ms = np.zeros(6)
    status, _, _ = native.av1_decode(stream, native.av1_info(stream)[1], stage_ms=ms)
    assert status == 0 and (ms >= 0).all() and ms[5] > 0 and ms[4] == 0


# -- damage ----------------------------------------------------------------------------------------------

def fuzz_bases() -> dict:
    """Small grain files the fuzz changes: Pillow's vectors 1 and 4 (with
    overlap) in 4:2:0 and 4:4:4 at odd sizes, a 4:2:2 stream regrained with
    every AR lag's neighbours, chroma from luma, and cv2's monochrome."""
    rs = np.random.RandomState(71)
    g422 = random_grain(rs, 1, 0, ar_coeff_lag=3, overlap_flag=1)
    gcsfl = random_grain(rs, 1, 1, chroma_scaling_from_luma=1, ar_coeff_lag=1, num_y_points=5,
                         scaling_points_y=np.r_[[0, 30, 60, 90, 120, 150, 180, 210, 240, 250], np.zeros(18, int)])
    gmono = random_grain(rs, 1, 1, mono=True, num_y_points=2, overlap_flag=1, clip_to_restricted_range=1,
                         scaling_points_y=np.r_[[0, 200, 255, 100], np.zeros(24, int)])
    return {
        "grain_420_vector_1": pil_avif(smooth(25, 39, 3, 1), quality=60, subsampling="4:2:0",
                                       advanced=[("film-grain-test", "1")]),
        "grain_444_vector_4": pil_avif(noise(27, 33, 3, 4), quality=60, subsampling="4:4:4",
                                       advanced=[("film-grain-test", "4")]),
        "grain_422_lag_3": rewritten("4:2:2", g422, 34, 45, "text", matrix=6),
        "grain_420_from_luma": rewritten("4:2:0", gcsfl, 40, 40, "noise", matrix=6),
        "grain_mono": contained(regrained(grey_stream(31, 45), gmono), 45, 31, mono=True, matrix=6),
    }


@functools.lru_cache(maxsize=None)
def bases() -> dict:
    return fuzz_bases()


def test_the_fuzz_bases_carry_grain():
    for name, data in bases().items():
        assert answers(data) == "equal", name
        assert decode_stats(item_data(data))[S["grain"][0]:S["grain"][1]].any(), name


@pytest.mark.parametrize("name", list(fuzz_bases()))
def test_mutated_grain_files_answer_as_cv2(name):
    got = collections.Counter(answers(d) for d in mutations(bases()[name], 150, seed=len(name) + 331))
    assert set(got) <= {"none", "equal", "known"}, got
    assert got["equal"] >= 5


def test_every_grain_parameter_bit_flipped_answers_as_cv2():
    """Each bit of film_grain_params in a 4:2:0 and a 4:4:4 stream, flipped:
    a point out of order or past its count, a 4:2:0 plane with points and
    the other without, shifted fields."""
    for data in (bases()["grain_420_vector_1"], bases()["grain_444_vector_4"]):
        stream = item_data(data)
        info = dict(zip(native.AV1_INFO, native.av1_info(stream)[1].tolist()))
        frame_at = stream.index(bytes([(6 << 3) | 2])) + 1
        while stream[frame_at] & 0x80:
            frame_at += 1
        frame_at += 1
        got = collections.Counter()
        for bit in range(info["grain_bit"], info["header_bits"]):
            b = bytearray(stream)
            b[frame_at + bit // 8] ^= 0x80 >> (bit % 8)
            got[answers(data.replace(stream, bytes(b)))] += 1
        assert set(got) <= {"none", "equal"} and got["equal"] > 0, got


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's grain files: ``n`` mutations of each base."""
    return [m for i, data in enumerate(bases().values()) for m in mutations(data, n, seed=10000 * round_ + i + 2300)]


# -- what the card decodes ----------------------------------------------------------------------------

def written_cases() -> dict:
    """For ``assets/image_cases.npz``: Pillow's files of each test vector in
    4:2:0 at the odd size and a few in 4:4:4, the rewritten bases, and
    mutated and cut grain files."""
    cases = {f"grain_pillow_420_vector_{v}": pillow_file(v, "4:2:0", (33, 47)) for v in range(1, 17)}
    cases.update({f"grain_pillow_444_vector_{v}": pillow_file(v, "4:4:4", (33, 47)) for v in (2, 9, 16)})
    for i, (name, data) in enumerate(bases().items()):
        cases[name] = data
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 2, seed=i + 2990))})
        cases[f"{name}_cut"] = data[: len(data) * 3 // 4]
    return {k: v for k, v in cases.items() if answers(v) != "known"}


# the smoke's request: Pillow's 4:2:0 q60 file of the first serving scene with
# libaom's test vector 4 (luma and chroma points, overlap on)
SMOKE_VECTOR = 4


def scene_payload(scene: np.ndarray) -> dict:
    """The serving scene as Pillow's 4:2:0 q60 AVIF with film-grain-test
    ``SMOKE_VECTOR``: the smoke's grain payload and request."""
    return {"scene0_avif_grain": pil_avif(scene, quality=60, subsampling="4:2:0",
                                          advanced=[("film-grain-test", str(SMOKE_VECTOR))])}


def test_the_smoke_vector_has_luma_and_chroma_points_and_overlap():
    g = grain_vectors()[SMOKE_VECTOR - 1]
    assert field(g, "num_y_points") and field(g, "num_cb_points") and field(g, "num_cr_points")
    assert field(g, "overlap_flag") == 1


def test_the_written_cases_and_the_payload_decode_as_cv2(tmp_path):
    from test_torch_avif import read_answers
    from test_torch_avif_deblock import serving_scene

    got = collections.Counter(answers(d) for d in written_cases().values())
    assert set(got) <= {"none", "equal"} and got["equal"] >= 20, got
    data = scene_payload(serving_scene(0))["scene0_avif_grain"]
    assert answers(data) == "equal" and read_answers(data, tmp_path) == "equal"
    assert decode_stats(item_data(data))[S["grain"][0]:S["grain"][1]].all()
