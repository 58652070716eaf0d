"""libaom 3.14.1's CDEF in ``csrc/av1.cpp`` (av1_cdef_frame: a strength
index per 64x64 unit, read at its first block that does not skip; each
8x8 block with a 4x4 unit that does not skip; luma's direction and
variance, chroma taking luma's direction) against ``cv2.imdecode(buf,
IMREAD_COLOR)`` (OpenCV 5.0 over libavif 1.4.2 and libaom 3.14.1): the
same ``None`` or not, and 0 differing pixels.

The files: Pillow's with ``enable-cdef=1`` (chroma strengths too) in
4:4:4, 4:2:2 and 4:2:0; cv2's at q60 to q80, which code a strength index
per unit (``cdef_bits`` > 0); and frames of ``filtered_frame``
(``tests/test_torch_avif_deblock.py``): two index bits, 128x128
superblocks with four units each, a unit whose blocks all skip, strengths
for luma or chroma alone. The direction search (``cdef_find_dir``) and
the filter (``cdef_filter_8_{0,1,2,3}``) equal libaom's C and AVX2
functions through ``ctypes``. A coverage test reads the decoder's
counters: every deblocking length in each plane, CDEF's filtered and
skipped blocks and its units without an index.

    python -m pytest tests/test_torch_avif_cdef.py -q
"""

import ctypes
import functools

import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from test_torch_avif import avif_file, cv2_avif, decode_stats, item_data, noise, pil_avif, smooth, text
from test_torch_avif_deblock import filtered_frame, lf_edges, scene_crop
from test_torch_avif_lossy import _libaom
from test_torch_tiff import answers, port_decode

S = native.AV1_STATS
CDEF_VERY_LARGE = 30000
CDEF_BSTRIDE = 144  # libaom's: (128 + 2 * CDEF_HBORDER) aligned to 8


# -- Pillow's and cv2's files ------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def pillow_cdef_file(subsampling: str, kind: str) -> bytes:
    img = noise(64, 96, 3, 1) if kind == "noise" else smooth(64, 96, 3, 1)
    return pil_avif(img, quality=20 if kind == "noise" else 50, subsampling=subsampling,
                    advanced=[("enable-cdef", "1")])


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_pillows_cdef_files_decode_as_cv2(subsampling, kind):
    """Pillow with ``enable-cdef=1``: luma strengths, and on noise chroma
    ones (the chroma block 4x8 in 4:2:2, 4x4 in 4:2:0, luma's direction
    remapped in 4:2:2)."""
    data = pillow_cdef_file(subsampling, kind)
    assert answers(data) == "equal"
    stats = decode_stats(item_data(data))
    assert stats[S["cdef_y"]] > 0 and (stats[S["cdef_uv"]] > 0 or kind == "smooth")


@pytest.mark.parametrize("q", [60, 70, 80])
def test_cv2s_files_with_a_strength_index_per_unit_decode_as_cv2(q):
    for speed in (4, 6):
        data = cv2_avif(scene_crop(), speed, q)
        assert answers(data) == "equal"
        assert decode_stats(item_data(data))[S["cdef_bits"]] == 1


# -- written frames ----------------------------------------------------------------------------------

# (damping, bits, strengths (y, uv) as coded: primary * 4 + secondary)
WRITTEN = {
    "one_strength": dict(cdef=(5, 0, [(9, 6)])),
    "two_index_bits": dict(cdef=(4, 2, [(9, 6), (0, 3), (62, 0), (7, 17)])),
    "superblock_128": dict(sb128=True, cdef=(6, 2, [(9, 6), (0, 3), (62, 0), (7, 17)])),
    "skipped_unit": dict(skipped_unit=(1, 2), cdef=(5, 1, [(9, 6), (13, 13)])),
    "skipped_unit_sb128": dict(sb128=True, skipped_unit=(0, 3), cdef=(3, 1, [(21, 2), (40, 41)])),
    "chroma_only": dict(cdef=(5, 0, [(0, 22)])),
    "secondary_only": dict(cdef=(6, 1, [(3, 1), (2, 2)])),
}


@functools.lru_cache(maxsize=None)
def written_stream(name: str, seed: int) -> bytes:
    return filtered_frame(seed, **WRITTEN[name])


@pytest.mark.parametrize("name", list(WRITTEN))
def test_written_frames_decode_as_cv2(name):
    """Each against the same blocks with CDEF off in the sequence: the
    pixels change, and the port gives cv2's."""
    for seed in range(2):
        stream = written_stream(name, seed)
        data = avif_file(stream, w=256, h=128)
        assert answers(data) == "equal", seed
        kw = {k: v for k, v in WRITTEN[name].items() if k != "cdef"}
        assert (port_decode(data) != port_decode(avif_file(filtered_frame(seed, **kw), w=256, h=128))).any(), seed
        if name.startswith("skipped_unit"):
            assert decode_stats(stream)[S["cdef_unset"]] >= 1


# -- the direction search and the filter against libaom's ---------------------------------------------

def _aligned(n: int, dtype, fill) -> np.ndarray:
    buf = np.full(n + 64, fill, dtype)
    at = (-buf.ctypes.data % 64) // buf.itemsize
    return buf[at:at + n]


@functools.lru_cache(maxsize=None)
def cdef_functions() -> dict:
    lib = _libaom()
    u16p, i32p, ip = ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int)
    out = {}
    for isa in ("c", "avx2"):
        out["find_dir", isa] = lib.function(f"cdef_find_dir_{isa}", ctypes.c_int, u16p, ctypes.c_int, i32p, ctypes.c_int)
        out["find_dir_dual", isa] = lib.function(f"cdef_find_dir_dual_{isa}", None, u16p, u16p, ctypes.c_int, i32p, i32p,
                                                 ctypes.c_int, ip, ip)
        for k in range(4):
            out[k, isa] = lib.function(f"cdef_filter_8_{k}_{isa}", None, ctypes.c_void_p, ctypes.c_int, u16p,
                                       *[ctypes.c_int] * 8)
    return out


def _block(rs, kind: int) -> np.ndarray:
    """8x8 samples: noise, an oriented ramp, or near-flat."""
    if kind == 0:
        return rs.randint(0, 256, (8, 8)).astype(np.uint16)
    if kind == 1:
        yy, xx = np.mgrid[:8, :8]
        a = rs.uniform(0, np.pi)
        img = 128 + 110 * np.sin(0.9 * (np.cos(a) * xx + np.sin(a) * yy) + rs.rand() * 6)
        return np.clip(img + rs.randint(-3, 4, (8, 8)), 0, 255).astype(np.uint16)
    return np.clip(rs.randint(0, 256) + rs.randint(0, 2, (8, 8)), 0, 255).astype(np.uint16)


def test_the_direction_search_is_libaoms():
    """Direction and variance of noise, ramps at every angle and flat
    blocks: libaom's C and AVX2 functions, one block and two at a time."""
    fns = cdef_functions()
    rs = np.random.RandomState(5)
    i32, ii = ctypes.c_int32, ctypes.c_int
    u16p = ctypes.POINTER(ctypes.c_uint16)
    dirs = set()
    for trial in range(1500):
        a, b = _block(rs, trial % 3), _block(rs, (trial + 1) % 3)
        want = [native.av1_cdef_find_dir(a), native.av1_cdef_find_dir(b)]
        dirs.add(want[0][0])
        buf = _aligned(8 * 16 * 2, np.uint16, 0).reshape(16, 16)
        buf[:8, :8], buf[8:, 8:] = a, b
        for isa in ("c", "avx2"):
            var = i32()
            got = fns["find_dir", isa](buf.ctypes.data_as(u16p), 16, ctypes.byref(var), 0)
            assert (got, var.value) == want[0], (isa, trial)
            v1, v2, d1, d2 = i32(), i32(), ii(), ii()
            second = ctypes.cast(buf.ctypes.data + 2 * (8 * 16 + 8), u16p)
            fns["find_dir_dual", isa](buf.ctypes.data_as(u16p), second, 16, ctypes.byref(v1), ctypes.byref(v2), 0,
                                      ctypes.byref(d1), ctypes.byref(d2))
            assert [(d1.value, v1.value), (d2.value, v2.value)] == want, (isa, trial)
    assert dirs == set(range(8))


@pytest.mark.parametrize("size", [(8, 8), (4, 8), (4, 4)], ids=["8x8", "4x8", "4x4"])
def test_the_filter_is_libaoms(size):
    """Every strength pair (0 included: the four variants), direction and
    damping, with samples outside the frame (CDEF_VERY_LARGE) on any side:
    libaom's C and AVX2 functions, to the sample."""
    bw, bh = size
    fns = cdef_functions()
    rs = np.random.RandomState(bw * 10 + bh)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    for trial in range(2500):
        pri = 0 if trial % 7 == 0 else int(rs.randint(0, 16))
        sec = (0, 1, 2, 4)[trial % 4]
        direction, damping = int(rs.randint(0, 8)), int(rs.randint(2, 7))
        src = rs.randint(0, 256, (bh + 4, bw + 4)) if trial % 3 == 0 else \
            np.clip(rs.randint(0, 256) + rs.randint(-12, 13, (bh + 4, bw + 4)), 0, 255)
        src = src.astype(np.uint16)
        for side, cut in ((0, np.s_[:2]), (1, np.s_[-2:]), (2, np.s_[:, :2]), (3, np.s_[:, -2:])):
            if (trial >> side) % 5 == 0:
                src[cut] = CDEF_VERY_LARGE
        want = native.av1_cdef_filter(src, pri, sec, direction, damping, damping, bw, bh)
        k = (sec == 0) | ((pri == 0) << 1)
        for isa in ("c", "avx2"):
            # libaom's source: rows CDEF_BSTRIDE apart, each block 16-byte aligned
            big = _aligned(CDEF_BSTRIDE * (bh + 8), np.uint16, CDEF_VERY_LARGE).reshape(bh + 8, CDEF_BSTRIDE)
            big[2:bh + 6, 6:bw + 10] = src
            out = _aligned(8 * 8 + 64, np.uint8, 0)
            fns[k, isa](out.ctypes.data, 8, ctypes.cast(big.ctypes.data + 2 * (4 * CDEF_BSTRIDE + 8), u16p), pri, sec,
                        direction, damping, damping, 0, bw, bh)
            assert (out[:8 * bh].reshape(bh, 8)[:, :bw] == want).all(), (isa, trial, pri, sec, direction, damping)


# -- the tools reached -------------------------------------------------------------------------------

def test_every_filter_length_in_each_plane_and_both_cdef_paths_are_reached():
    """Between them cv2's and Pillow's files and the written frames deblock
    with every length a plane takes (luma 4, 8 and 14; chroma 4 and 6),
    filter luma and chroma blocks with CDEF, pass over 8x8 blocks whose
    units all skip and over a unit without an index, and code the index
    (cdef_bits > 0)."""
    streams = [item_data(cv2_avif(text(64, 96, 3, 2), 6, 60)), item_data(cv2_avif(scene_crop(), 6, 70))]
    streams += [item_data(pillow_cdef_file(s, "noise")) for s in ("4:4:4", "4:2:2", "4:2:0")]
    streams += [written_stream("skipped_unit", 0)]
    total = sum(decode_stats(s).astype(np.int64) for s in streams)
    edges = total[S["lf_edges"][0]:S["lf_edges"][1]].reshape(3, 4)
    lengths = dict(zip(native.AV1_LF_LENGTHS, range(4)))
    for p, want in ((0, (4, 8, 14)), (1, (4, 6)), (2, (4, 6))):
        assert all(edges[p][lengths[n]] > 0 for n in want), (p, edges[p])
        assert all(edges[p][lengths[n]] == 0 for n in native.AV1_LF_LENGTHS if n not in want), (p, edges[p])
    for tool in ("cdef_y", "cdef_uv", "cdef_skip", "cdef_unset", "cdef_bits"):
        assert total[S[tool]] > 0, tool
    assert (lf_edges(streams[0])[0] > 0).sum() == 3  # one file: all three luma lengths
