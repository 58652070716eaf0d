"""libavif 1.4.2's YUV to BGR as cv2 5.0 asks for it (``avifImageYUVToRGB``
into an 8-bit BGR image with ``avifRGBImageSetDefaults``' settings):
``native.avif_yuv_to_bgr`` (``csrc/avif_yuv.cpp``) against the library of
the cv2 wheel, called here through ``ctypes``, on random planes of every
layout (4:4:4, 4:2:2, 4:2:0, 4:0:0) and odd sizes, for every matrix
coefficient value and both ranges, and against ``cv2.imdecode`` on files
whose ``colr`` box names each matrix and range.

libavif converts through the libyuv it is built with (version 1924, inside
``libavif-*.so.16``) where libyuv has constants for the matrix: BT.709,
BT.601 and unspecified, BT.2020 NCL, and chroma-derived NCL over the
primaries of one of these. Its chroma is then upsampled by libyuv's
bilinear filters (``I420ToRGB24MatrixFilter`` equals libavif's output to
the byte, ``I420ToRGB24Matrix``, nearest, does not). The other matrices go
through libavif's float path; the ones it refuses (3, 8 in limited range,
10, 11, 13, 14, 16 and up, identity with subsampled chroma) give ``None``.

    python -m pytest tests/test_torch_avif_colour.py -q
"""

import ctypes
import functools
import os
import re

import cv2
import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from test_torch_avif import av1c, avif_file, colr, ispe, item_data, pil_avif, pixi, smooth
from test_torch_avif_lossy import FILTERS_OFF, _libavif, libavif_avif
from test_torch_tiff import answers, cv2_decode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"444": (1, 0, 0), "422": (2, 1, 0), "420": (3, 1, 1), "400": (4, 1, 1)}  # avifPixelFormat, ss_x, ss_y
MATRICES = list(range(18)) + [100, 255]
PRIMARIES = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 22, 100]


@functools.lru_cache(maxsize=None)
def library():
    lib = _libavif()
    vp = ctypes.c_void_p
    lib.avifRGBImageSetDefaults.argtypes = [vp, vp]
    lib.avifImageYUVToRGB.argtypes = [vp, vp]
    lib.avifImageYUVToRGB.restype = ctypes.c_int
    return lib


def _u32(at: int, off: int) -> int:
    return int(np.frombuffer(ctypes.string_at(at + off, 4), "<u4")[0])


def _put(at: int, off: int, value: int, fmt: str = "<u4"):
    ctypes.memmove(at + off, np.array([value], fmt).tobytes(), np.dtype(fmt).itemsize)


def libavif_bgr(planes: list, layout: str, matrix: int, full: int, primaries: int = 2):
    """``avifImageYUVToRGB`` of the planes into BGR: [H, W, 3] or None
    where it fails. avif.h's layouts: avifImage's yuvRange at 16, planes at
    24, row bytes at 48, CICP at 104; avifRGBImage's format at 12, pixels
    at 48 and rowBytes at 56 (its size and depth checked on the defaults)."""
    lib = library()
    fmt = LAYOUTS[layout][0]
    h, w = planes[0].shape
    img = lib.avifImageCreate(w, h, 8, fmt)
    try:
        assert lib.avifImageAllocatePlanes(img, 1) == 0
        _put(img, 16, full)
        ctypes.memmove(img + 104, np.array([primaries, 2, matrix], "<u2").tobytes(), 6)
        for i, p in enumerate(planes):
            at, stride = int(np.frombuffer(ctypes.string_at(img + 24 + 8 * i, 8), "<u8")[0]), _u32(img, 48 + 4 * i)
            for r in range(p.shape[0]):
                ctypes.memmove(at + r * stride, np.ascontiguousarray(p[r]).ctypes.data, p.shape[1])
        rgb = ctypes.create_string_buffer(64)
        a = ctypes.addressof(rgb)
        lib.avifRGBImageSetDefaults(a, img)
        assert (_u32(a, 0), _u32(a, 4), _u32(a, 8), _u32(a, 16), _u32(a, 24)) == (w, h, 8, 0, 0)  # AUTOMATIC, libyuv
        _put(a, 12, 3)  # AVIF_RGB_FORMAT_BGR
        out = np.zeros((h, w, 3), np.uint8)
        _put(a, 48, out.ctypes.data, "<u8")
        _put(a, 56, 3 * w)
        return out if lib.avifImageYUVToRGB(img, a) == 0 else None
    finally:
        lib.avifImageDestroy(img)


def random_planes(rs, h: int, w: int, layout: str) -> list:
    _, ss_x, ss_y = LAYOUTS[layout]
    y = rs.randint(0, 256, (h, w)).astype(np.uint8)
    if layout == "400":
        return [y]
    shape = ((h + ss_y) >> ss_y, (w + ss_x) >> ss_x)
    return [y] + [rs.randint(0, 256, shape).astype(np.uint8) for _ in range(2)]


def port_bgr(planes: list, layout: str, matrix: int, full: int, primaries: int = 2):
    _, ss_x, ss_y = LAYOUTS[layout]
    return native.avif_yuv_to_bgr(planes, ss_x, ss_y, matrix, primaries, full)


@pytest.mark.parametrize("full", [0, 1])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_conversion_is_libavifs(layout, full):
    """Random planes of sizes 1x1 to 24x24 (and some of one value), every
    matrix value (the chroma-derived one over several primaries): the same
    pixels as libavif, or ``None`` where it refuses."""
    rs = np.random.RandomState(LAYOUTS[layout][0] * 2 + full)
    compared = refused = 0
    for trial in range(40):
        h, w = (int(v) for v in rs.randint(1, 25, 2))
        planes = random_planes(rs, h, w, layout)
        if trial % 5 == 0:
            planes[0][:] = rs.randint(0, 256)
        for matrix in MATRICES:
            primaries = int(PRIMARIES[rs.randint(len(PRIMARIES))]) if matrix == 12 else 2
            want = libavif_bgr(planes, layout, matrix, full, primaries)
            got = port_bgr(planes, layout, matrix, full, primaries)
            assert (want is None) == (got is None), (h, w, matrix, primaries)
            if want is not None:
                assert (want == got).all(), (h, w, matrix, primaries, np.abs(want.astype(int) - got).max())
                compared += 1
            else:
                refused += 1
    assert compared > 0 and refused > 0


@pytest.mark.parametrize("layout", ["420", "422", "444"])
def test_every_value_pair_converts_as_libavif(layout):
    """A frame whose luma and chroma run over every value (a 256x256 luma
    ramp, chroma ramps across and down): BT.601, BT.709, BT.2020 (libyuv)
    and SMPTE 240, FCC and YCgCo (the float path), in both ranges."""
    _, ss_x, ss_y = LAYOUTS[layout]
    yy, xx = np.mgrid[:256, :256]
    y = ((yy * 7 + xx * 13) % 256).astype(np.uint8)
    cu = np.ascontiguousarray(xx[::1 << ss_y, ::1 << ss_x].astype(np.uint8))
    cv = np.ascontiguousarray(yy[::1 << ss_y, ::1 << ss_x].astype(np.uint8))
    for matrix in (1, 6, 9, 7, 4, 8):
        for full in (0, 1):
            want = libavif_bgr([y, cu, cv], layout, matrix, full)
            got = port_bgr([y, cu, cv], layout, matrix, full)
            assert (want is None) == (got is None) and (want is None or (want == got).all()), (matrix, full)


def test_libavif_converts_through_libyuvs_bilinear_filter():
    """The proof of the path: for the matrices libyuv has, libavif's output
    is libyuv's ``I420ToRGB24MatrixFilter`` (bilinear) with that matrix's
    constants, not libyuv's nearest conversion (``I420ToRGB24Matrix``)."""
    lib = library()
    rs = np.random.RandomState(5)
    h, w = 13, 21
    y, u, v = random_planes(rs, h, w, "420")
    for (matrix, full), name in {(1, 0): "H709", (1, 1): "F709", (6, 0): "I601", (6, 1): "JPEG", (9, 0): "2020",
                                 (9, 1): "V2020"}.items():
        constants = ctypes.addressof(ctypes.c_uint8.in_dll(lib, f"kYuv{name}Constants"))
        outs = {}
        for filt in (None, 1):
            out = np.zeros((h, w, 3), np.uint8)
            f = lib.I420ToRGB24MatrixFilter if filt else lib.I420ToRGB24Matrix
            f.restype = ctypes.c_int
            args = [y.ctypes.data, w, u.ctypes.data, u.shape[1], v.ctypes.data, v.shape[1], out.ctypes.data, 3 * w,
                    constants, w, h] + ([filt] if filt else [])
            assert f(*[ctypes.c_void_p(a) if k in (0, 2, 4, 6, 8) else a for k, a in enumerate(args)]) == 0
            outs[filt] = out
        want = libavif_bgr([y, u, v], "420", matrix, full)
        assert (want == outs[1]).all() and (want != outs[None]).any(), name
        assert (port_bgr([y, u, v], "420", matrix, full) == want).all(), name


def test_the_libyuv_constants_are_the_librarys():
    """``csrc/avif_yuv.cpp``'s YG, YB, UB, UG, VG and VR of each matrix are
    the ``kYuv*Constants`` of the libyuv inside libavif (UB at most 128 on
    x86)."""
    with open(os.path.join(ROOT, "ppocr_tpu_torch", "csrc", "avif_yuv.cpp")) as f:
        src = f.read()
    found = {m.group(1): [int(v) for v in m.group(2).split(",")]
             for m in re.finditer(r"const YuvConstants k(\w+) = \{([-\d, ]+)\};", src)}
    assert set(found) == {"I601", "JPEG", "H709", "F709", "2020", "V2020"}
    lib = library()
    for name, (yg, yb, ub, ug, vg, vr) in found.items():
        at = ctypes.addressof(ctypes.c_uint8.in_dll(lib, f"kYuv{name}Constants"))
        raw = np.frombuffer(ctypes.string_at(at, 144), np.uint8)
        i16 = np.frombuffer(ctypes.string_at(at + 96, 48), "<i2")
        assert (raw[0], raw[1], raw[32], raw[33], raw[64], raw[65]) == (ub, 0, ug, vg, 0, vr), name
        assert (i16[0], i16[16]) == (yg, yb), name


def test_the_primaries_are_libavifs():
    """The chroma-derived matrix takes libavif's primaries table (BT.709's
    for any value it does not list)."""
    lib = library()
    lib.avifColorPrimariesGetValues.argtypes = [ctypes.c_int, ctypes.c_void_p]
    with open(os.path.join(ROOT, "ppocr_tpu_torch", "csrc", "avif_yuv.cpp")) as f:
        src = f.read()
    body = src[src.index("const float kPrimaries"):src.index("};", src.index("const float kPrimaries"))]
    rows = [np.array([float(v.rstrip("f")) for v in row.split(",")], np.float32)
            for row in re.findall(r"\{([-\d.f, ]+)\}", body)]
    listed = {1: 0, 4: 1, 5: 2, 6: 3, 7: 3, 8: 4, 9: 5, 10: 6, 11: 7, 12: 8, 22: 9}
    for cp in range(256):
        want = np.zeros(8, np.float32)
        lib.avifColorPrimariesGetValues(cp, want.ctypes.data)
        assert (rows[listed.get(cp, 0)] == want).all(), cp


# -- files: the colr box, the sequence header and cv2 ---------------------------------------------

@functools.lru_cache(maxsize=None)
def streams() -> dict:
    """A lossy 4:2:0 stream and a lossless 4:4:4 one of Pillow's (no colour
    description in the sequence header), and a 4:2:0 and a monochrome one
    of cv2's (BT.709 primaries, sRGB transfer, BT.601 matrix, full range
    in the sequence header)."""
    img = smooth(30, 46, 3, 3)
    return {"420": item_data(pil_avif(img, quality=80, subsampling="4:2:0", speed=6, advanced=FILTERS_OFF)),
            "444": item_data(pil_avif(img, quality=100, subsampling="4:4:4", speed=6)),
            "cv2_420": item_data(cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, 95])[1].tobytes()),
            "mono": item_data(cv2.imencode(".avif", img[..., 1], [cv2.IMWRITE_AVIF_QUALITY, 95])[1].tobytes())}


def in_container(stream: bytes, nclx=None, mono_av1c: bool = False, subsampling: str = "420") -> bytes:
    """``stream`` as a 46x30 file whose colr box is ``nclx`` (primaries,
    transfer, matrix, full range), or has none."""
    flags = {"420": 0x0C, "444": 0x00, "422": 0x08}[subsampling] | (0x10 if mono_av1c else 0)
    props = [(ispe(46, 30), 0), (pixi(*([8] if mono_av1c else [8, 8, 8])), 0), (av1c(0x20, flags), 1)]
    if nclx is not None:
        props.append((colr(*nclx), 0))
    return avif_file(stream, w=46, h=30, color_props=props)


@pytest.mark.parametrize("full", [0, 1])
@pytest.mark.parametrize("matrix", range(16))
def test_every_matrix_and_range_decodes_as_cv2(matrix, full):
    """A 4:2:0 and a 4:4:4 stream under a colr box of each matrix and
    range: cv2's pixels, or ``None`` where libavif refuses the matrix
    (identity with 4:2:0 among them)."""
    for layout in ("420", "444"):
        data = in_container(streams()[layout], (1, 13, matrix, full), subsampling=layout)
        want = cv2_decode(data)
        assert answers(data) in ("equal", "none"), (layout, matrix, full)
        refused = matrix in (3, 10, 11, 13, 14) or (matrix == 8 and not full) or (matrix == 0 and layout == "420")
        assert (want is None) == refused, (layout, matrix, full)


@pytest.mark.parametrize("primaries", [0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22, 200])
def test_chroma_derived_matrices_decode_as_cv2(primaries):
    """Matrix 12 over each primaries value, in both ranges: libyuv's
    constants for BT.709 (and unspecified), BT.601 and BT.2020 primaries,
    libavif's coefficients from the primaries for the others."""
    for full in (0, 1):
        assert answers(in_container(streams()["420"], (primaries, 13, 12, full))) == "equal", full


def test_the_colr_box_overrides_the_sequence_header():
    """cv2's stream says BT.601 in full range in its sequence header; a colr
    box that says BT.709 in limited range wins, and without a colr box the
    sequence header's values hold (the two decodes differ)."""
    stream = streams()["cv2_420"]
    info = dict(zip(native.AV1_INFO, native.av1_info(stream)[1].tolist()))
    assert (info["color_primaries"], info["transfer"], info["matrix"], info["color_range"]) == (1, 13, 6, 1)
    over = in_container(stream, (1, 13, 1, 0))
    plain = in_container(stream)
    assert answers(over) == answers(plain) == "equal"
    assert (cv2_decode(over) != cv2_decode(plain)).any()


def test_the_sequence_headers_limited_range_and_matrix_hold_without_a_colr_box():
    """libavif's own writer in limited range with BT.709 (sequence header
    and colr box agreeing), then the same stream with no colr box, and one
    whose colr box says full range BT.601."""
    img = smooth(30, 46, 3, 8)
    data = libavif_avif(img, 90, 6, matrix=1, full_range=0)
    stream = item_data(data)
    info = dict(zip(native.AV1_INFO, native.av1_info(stream)[1].tolist()))
    assert (info["matrix"], info["color_range"]) == (1, 0)
    assert answers(data) == "equal"
    for nclx in (None, (1, 13, 6, 1), (1, 13, 1, 0)):
        assert answers(in_container(stream, nclx, subsampling="444")) == "equal", nclx


@pytest.mark.parametrize("matrix", [0, 1, 2, 3, 8, 9])
def test_a_monochrome_frame_converts_as_libavif(matrix):
    """cv2's monochrome stream under a colour av1C: libavif converts its
    4:0:0 frame (the luma table of the range, each value to all three
    channels; identity allowed), or refuses the matrix. Under a monochrome
    av1C cv2 takes the Y plane as it is, whatever the range."""
    stream = streams()["mono"]
    for full in (0, 1):
        colour = in_container(stream, (1, 13, matrix, full))
        assert answers(colour) in ("equal", "none"), full
        assert (cv2_decode(colour) is None) == (matrix in (3,) or (matrix == 8 and not full)), full
        assert answers(in_container(stream, (1, 13, matrix, full), mono_av1c=True)) == "equal", full
