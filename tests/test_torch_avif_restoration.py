"""libaom 3.14.1's loop restoration in ``csrc/av1.cpp`` (the unit
coefficients read at each superblock; the Wiener and self-guided filters
over 64-row processing stripes, with the deblocked rows saved before CDEF
at the stripes' edges) against ``cv2.imdecode(buf, IMREAD_COLOR)``
(OpenCV 5.0 over libavif 1.4.2 and libaom 3.14.1): the same ``None`` or
not, and 0 differing pixels.

The files: cv2's of a serving-scene crop at q30 to q70 and speeds 0, 2
and 4 (Wiener on luma, 128- and 256-sample units), the scene itself at
speed 4 (the smoke's request), Pillow's defaults at speeds 0-4
(switchable units, 128x128 superblocks), its 4:2:0 noise at speed 2
(self-guided units), and its ``enable-restoration=1`` files in 4:4:4,
4:2:2 and 4:2:0 with and without CDEF and deblocking. Then frames of
``filtered_frame`` (``tests/test_torch_avif_deblock.py``) for what no
encoder here writes: self-guided luma, all 16 parameter sets (radius 0 in
either pass among them), ``lr_uv_shift`` 1, 64-sample units, both
superblock sizes, two tile columns (the references reset), loop
restoration alone, beside deblocking and beside CDEF, and every width and
height modulo 8 (its frame is the visible one, extended by 3 samples).
Each Wiener and self-guided unit equals libaom's C function and the x86
one it dispatches (``av1_wiener_convolve_add_src_{c,sse2,avx2}``,
``av1_apply_selfguided_restoration_{c,sse4_1,avx2}``) through ``ctypes``.

    python -m pytest tests/test_torch_avif_restoration.py -q
"""

import collections
import ctypes
import functools

import cv2
import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from test_torch_avif import (av1c, avif_file, colr, cv2_avif, decode_stats, ispe, item_data, mutations, noise, pil_avif,
                             pixi, read_answers, smooth, text)
from test_torch_avif_deblock import filtered_frame, lf_edges, serving_scene
from test_torch_avif_lossy import _libaom, c_tables
from test_torch_tiff import answers, port_decode

S = native.AV1_STATS
ALL_SETS = tuple(range(16))


def lr_units(stream: bytes) -> np.ndarray:
    """The restoration units of a decode: [plane, (none, wiener, sgrproj)]."""
    return decode_stats(stream)[S["lr_units"][0]:S["lr_units"][1]].reshape(3, 3)


@functools.lru_cache(maxsize=None)
def scene_crop() -> np.ndarray:
    """256x384 of the first serving scene: cv2's files of it restore luma
    at speeds 0 to 4."""
    return np.ascontiguousarray(serving_scene(0)[:256, :384])


# -- the encoders' files -----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def encoder_files() -> dict:
    """Each restoring file of the writers here (large images cut to size):
    (Y, U, V) types, unit size, superblock size in the comments."""
    img = smooth(64, 96, 3, 30)
    return {
        # WIENER, NONE, NONE; 256; 64
        "cv2_scene_q50_speed4": cv2_avif(scene_crop(), 4, 50),
        # SWITCHABLE, NONE, NONE; 256; 128
        "pillow_scene_speed0": pil_avif(scene_crop(), speed=0),
        # SWITCHABLE / WIENER, NONE, NONE; 128; 64
        "pillow_scene_speed2": pil_avif(scene_crop(), speed=2),
        "pillow_scene_speed4": pil_avif(scene_crop(), speed=4),
        # self-guided luma and chroma, switchable V: 4:2:0 noise at speed 2
        "pillow_noise_420_q50_speed2": pil_avif(noise(128, 192, 3, 1), quality=50, subsampling="4:2:0", speed=2),
        # NONE, WIENER, WIENER; 256; 64 (the refusal once pinned)
        "pillow_444_q40_speed4": pil_avif(img, quality=40, subsampling="4:4:4", speed=4),
        # WIENER, WIENER, WIENER; 128; 64
        "pillow_default_420_speed4": pil_avif(img, speed=4),
        # WIENER, NONE, NONE; 256; 64
        "cv2_noise_q50_speed4": cv2_avif(noise(64, 96, 3, 30), 4, 50),
    }


@pytest.mark.parametrize("name", list(encoder_files()))
def test_the_encoders_restoring_files_decode_as_cv2(name):
    data = encoder_files()[name]
    assert answers(data) == "equal"
    assert lr_units(item_data(data))[:, 1:].sum() > 0


def test_the_encoders_files_reach_each_type_and_both_superblock_sizes():
    units = sum(lr_units(item_data(d)) for d in encoder_files().values())
    assert (units[0, 1:] > 0).all() and (units[1:, 1:] > 0).all(), units
    sb128 = {native.av1_info(item_data(d))[1][17] for d in encoder_files().values()}
    assert sb128 == {0, 1}


@pytest.mark.parametrize("speed", [0, 2, 4])
@pytest.mark.parametrize("q", [30, 40, 50, 60, 70])
def test_cv2s_files_at_each_quality_and_slow_speed_decode_as_cv2(q, speed):
    """Luma restored (Wiener; self-guided too at q70 speed 0)."""
    data = cv2_avif(scene_crop(), speed, q)
    assert answers(data) == "equal"
    assert lr_units(item_data(data))[0, 1:].sum() > 0


def test_cv2s_speed_4_file_of_the_serving_scene_decodes_as_cv2(tmp_path):
    """cv2's default quality (50) at speed 4: the smoke's request."""
    data = scene_payload(serving_scene(0))["scene0_avif_restored"]
    assert answers(data) == "equal" and read_answers(data, tmp_path) == "equal"
    units = lr_units(item_data(data))
    assert units[0, 1] > 0 and units[1:, 1:].sum() == 0


RESTORATION_ON = [("enable-restoration", "1")]


@pytest.mark.parametrize("cdef", [0, 1], ids=["cdef_off", "cdef_on"])
@pytest.mark.parametrize("deblock", [0, 1], ids=["deblock_off", "deblock_on"])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_pillows_restoring_files_decode_as_cv2(subsampling, deblock, cdef):
    """``enable-restoration=1`` at speed 4 with CDEF and the deblocking
    filter on or off: libaom restores by its "optimized" path where CDEF
    is off, which reads the same rows."""
    data = pil_avif(text(64, 96, 3, 1), quality=30, subsampling=subsampling, speed=4,
                    advanced=RESTORATION_ON + [("enable-cdef", str(cdef)), ("loopfilter-control", str(deblock))])
    assert answers(data) == "equal"
    stream = item_data(data)
    stats = decode_stats(stream)
    assert lr_units(stream)[:, 1:].sum() > 0
    assert (lf_edges(stream).sum() > 0) == bool(deblock)
    assert (stats[S["cdef_y"]] + stats[S["cdef_uv"]] > 0) == bool(cdef)


# -- frames written here ------------------------------------------------------------------------------


def _props(w: int, h: int, subsampling: str) -> list:
    """The container's properties: 4:4:4 identity (the writer's profile 1),
    or 4:2:0 BT.709 in full range (profile 0)."""
    if subsampling == "4:4:4":
        return None
    return [(ispe(w, h), 0), (pixi(8, 8, 8), 0), (av1c(0x00, 0x0C), 1), (colr(1, 13, 1, 1), 0)]


def written(seed: int, *, w: int = 256, h: int = 128, visible=None, subsampling: str = "4:4:4", **kw) -> bytes:
    vw, vh = visible or (w, h)
    frame = filtered_frame(seed, w=w, h=h, visible=visible, subsampling=subsampling, **kw)
    return avif_file(frame, w=vw, h=vh, color_props=_props(vw, vh, subsampling))


# lr as (lr_type of Y, U, V as coded: 0 NONE, 1 SWITCHABLE, 2 WIENER, 3
# SGRPROJ; lr_unit_shift; lr_uv_shift; self-guided sets in turn)
WRITTEN = {
    "sgrproj_every_set": dict(lr=((3, 3, 3), 0, 0, ALL_SETS)),
    "sgrproj_luma_radius_0": dict(lr=((3, 0, 0), 0, 0, (10, 11, 12, 13, 14, 15))),
    "wiener_unit_128": dict(lr=((2, 2, 2), 1, 0, ALL_SETS)),
    "switchable_unit_256": dict(lr=((1, 1, 1), 2, 0, ALL_SETS), h=384),
    "switchable_unit_64": dict(lr=((1, 1, 1), 0, 0, ALL_SETS[::-1])),
    "sb128_unit_128": dict(sb128=True, lr=((1, 2, 3), 0, 0, ALL_SETS)),
    "sb128_unit_256": dict(sb128=True, lr=((3, 1, 1), 1, 0, ALL_SETS), w=384, h=384),
    "420_uv_shift_1": dict(subsampling="4:2:0", lr=((1, 1, 1), 0, 1, ALL_SETS)),
    "420_uv_shift_1_unit_128": dict(subsampling="4:2:0", lr=((2, 3, 1), 1, 1, ALL_SETS), h=256),
    "420_uv_shift_0": dict(subsampling="4:2:0", lr=((0, 1, 3), 1, 0, ALL_SETS)),
    "420_sb128_uv_shift_1": dict(subsampling="4:2:0", sb128=True, lr=((1, 1, 1), 0, 1, ALL_SETS)),
    "two_tiles": dict(tile_cols_log2=1, lr=((1, 1, 1), 0, 0, ALL_SETS)),
    "two_tiles_sb128": dict(tile_cols_log2=1, sb128=True, lr=((1, 1, 1), 0, 0, ALL_SETS)),
    "restoration_alone": dict(levels=(0, 0, 0, 0), lr=((1, 1, 1), 0, 0, ALL_SETS)),
    "with_cdef": dict(cdef=(5, 2, [(9, 6), (0, 3), (62, 0), (7, 17)]), lr=((1, 1, 1), 0, 0, ALL_SETS)),
    "with_cdef_alone": dict(levels=(0, 0, 0, 0), cdef=(4, 1, [(40, 20), (13, 9)]), lr=((1, 3, 2), 0, 0, ALL_SETS)),
}


@functools.lru_cache(maxsize=None)
def written_file(name: str, seed: int) -> bytes:
    return written(seed, **WRITTEN[name])


@pytest.mark.parametrize("name", list(WRITTEN))
def test_written_frames_decode_as_cv2(name):
    """Each frame against cv2, and against the same blocks without loop
    restoration: it changes the pixels."""
    for seed in range(2):
        data = written_file(name, seed)
        assert answers(data) == "equal", seed
        kw = {k: v for k, v in WRITTEN[name].items() if k != "lr"}
        assert (port_decode(data) != port_decode(written(seed, **kw))).any(), seed


# every width and height modulo 8 (a frame of the same blocks, visible up to
# 7 samples short of the 8-sample grid), in 4:4:4 and 4:2:0
EDGES = [(256 - k, 128 - (k * 3) % 8) for k in range(8)]


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("visible", EDGES, ids=[f"{w}x{h}" for w, h in EDGES])
def test_every_width_and_height_modulo_8_decodes_as_cv2(visible, subsampling):
    data = written(5, visible=visible, subsampling=subsampling, lr=((1, 1, 1), 0, int(subsampling == "4:2:0"),
                                                                  ALL_SETS))
    assert answers(data) == "equal"


# -- the filters against libaom's -------------------------------------------------------------------------

def _dispatched(lib, name: str) -> str:
    """The function libaom's run-time dispatch put behind ``name``."""
    value, _ = lib.sym(name)
    target = int(np.frombuffer(ctypes.string_at(lib.base + value, 8), "<u8")[0]) - lib.base
    return next(n for n, found in lib.syms.items() if n.startswith(name + "_") for v, _ in found if v == target)


@functools.lru_cache(maxsize=None)
def lr_functions() -> dict:
    """{"wiener" / "sgr": {isa: libaom's function}}, and the ISA each
    dispatches."""
    lib = _libaom()
    vp, i = ctypes.c_void_p, ctypes.c_int
    wiener = {isa: lib.function(f"av1_wiener_convolve_add_src_{isa}", None, vp, ctypes.c_ssize_t, vp, ctypes.c_ssize_t,
                                vp, i, vp, i, i, i, vp) for isa in ("c", "sse2", "avx2")}
    sgr = {isa: lib.function(f"av1_apply_selfguided_restoration_{isa}", i, vp, i, i, i, i, vp, vp, i, vp, i, i)
           for isa in ("c", "sse4_1", "avx2")}
    return {"wiener": wiener, "sgr": sgr,
            "dispatched": (_dispatched(lib, "av1_wiener_convolve_add_src"),
                           _dispatched(lib, "av1_apply_selfguided_restoration"))}


def _aligned(shape, dtype, align: int = 64) -> np.ndarray:
    n = int(np.prod(shape))
    buf = np.zeros(n + align, dtype)
    at = (-buf.ctypes.data % align) // buf.itemsize
    return buf[at:at + n].reshape(shape)


def _unit_source(rs, kind: int, h: int, w: int, pad: int = 32) -> np.ndarray:
    """A processing unit with ``pad`` samples around it: noise, a flat area
    of ±1, or a step between two noisy sides."""
    shape = (h + 2 * pad, w + 2 * pad)
    if kind == 0:
        return rs.randint(0, 256, shape).astype(np.uint8)
    a = int(rs.randint(0, 256)) + rs.randint(-1 if kind == 1 else -9, 2 if kind == 1 else 10, shape)
    if kind == 2:
        a[:, pad + int(rs.randint(0, w)):] += int(rs.randint(-60, 61))
    return np.clip(a, 0, 255).astype(np.uint8)


def test_libaom_dispatches_the_x86_filters():
    wiener, sgr = lr_functions()["dispatched"]
    assert wiener.rsplit("_", 1)[1] in ("sse2", "avx2") and sgr.rsplit("_", 1)[1] in ("sse4_1", "avx2"), (wiener, sgr)


@pytest.mark.parametrize("chroma", [False, True], ids=["7_taps", "5_taps"])
def test_each_wiener_unit_is_libaoms(chroma):
    """Random taps over their whole ranges (the intermediate clamp at 0
    and 8191 reached) on noise, flat and stepped units of 16 to 64 columns
    and 1 to 64 rows: the decoder's filter equals libaom's C, SSE2 and AVX2
    functions to the sample."""
    fns = lr_functions()["wiener"]
    rs = np.random.RandomState(1 + chroma)
    params = _aligned(2, np.int32)
    params[:] = (3, 11)  # WienerConvolveParams: round_0, round_1 of 8 bits
    pad = 32
    for trial in range(160):
        w, h = 16 * int(rs.randint(1, 5)), int(rs.randint(1, 65))
        src = _unit_source(rs, trial % 3, h, w, pad)
        taps = []
        for _ in range(2):
            t = [0 if chroma else int(rs.randint(-5, 11)), int(rs.randint(-23, 9)), int(rs.randint(-17, 47))]
            taps.append(np.array(t + [-2 * sum(t)] + t[::-1], np.int16))
        ours = native.av1_wiener_filter(src[pad - 3:pad + h + 3, pad - 3:pad + w + 3], taps[0], taps[1])
        kernels = [_aligned(8, np.int16, 16) for _ in range(2)]
        for k, t in zip(kernels, taps):
            k[:7], k[7] = t, 0
        at = src.ctypes.data + pad * src.shape[1] + pad
        for isa, fn in fns.items():
            dst = np.zeros((h, w + 16), np.uint8)
            fn(at, src.shape[1], dst.ctypes.data, dst.shape[1], kernels[0].ctypes.data, 16, kernels[1].ctypes.data, 16,
               w, h, params.ctypes.data)
            assert (dst[:, :w] == ours).all(), (isa, trial, taps)


def test_each_self_guided_unit_is_libaoms():
    """Every parameter set with random weights in their coded ranges, on
    noise, flat and stepped units of 1 to 64 columns and rows (odd and
    even row counts: the r = 2 pass's alternate rows): the decoder's filter
    equals libaom's C, SSE4.1 and AVX2 functions to the sample."""
    fns = lr_functions()["sgr"]
    rs = np.random.RandomState(3)
    tmp = _aligned(2 * 406 * 398 + 64, np.int32)  # 2 * RESTORATION_UNITPELS_MAX
    radii = c_tables()["sgr_params"][:, :2].tolist()
    pad = 32
    for trial in range(320):
        ep = trial % 16
        w, h = int(rs.randint(1, 65)), int(rs.randint(1, 65))
        src = _unit_source(rs, (trial // 16) % 3, h, w, pad)
        r0, r1 = radii[ep]
        xqd = _aligned(2, np.int32, 16)
        xqd[:] = (int(rs.randint(-96, 32)) if r0 else 0, int(rs.randint(-32, 96)) if r1 else 0)
        if not r1:
            xqd[1] = min(max(128 - xqd[0], -32), 95)
        ours = native.av1_selfguided_filter(src[pad - 3:pad + h + 3, pad - 3:pad + w + 3], ep, xqd)
        at = src.ctypes.data + pad * src.shape[1] + pad
        for isa, fn in fns.items():
            dst = np.zeros((h, w + 32), np.uint8)
            assert fn(at, w, h, src.shape[1], ep, xqd.ctypes.data, dst.ctypes.data, dst.shape[1], tmp.ctypes.data,
                      8, 0) == 0
            assert (dst[:, :w] == ours).all(), (isa, trial, ep, xqd.tolist(), w, h)


def test_a_filter_call_out_of_range_is_refused():
    with pytest.raises(ValueError, match="parameter set"):
        native.av1_selfguided_filter(np.zeros((10, 10), np.uint8), 16, (0, 0))
    with pytest.raises(ValueError, match="source"):
        native.av1_wiener_filter(np.zeros((6, 10), np.uint8), np.zeros(7), np.zeros(7))


def test_the_references_each_tile_starts_from_are_libaoms():
    """``av1_reset_loop_restoration`` on a zeroed decoder context writes,
    for each of three planes, the Wiener taps (3, -7, 15) of each
    direction and the self-guided weights (-32, 31) the decoder starts each
    tile from."""
    lib = _libaom()
    xd = (ctypes.c_uint8 * (1 << 20))()
    lib.function("av1_reset_loop_restoration", None, ctypes.c_void_p, ctypes.c_int)(ctypes.addressof(xd), 3)
    raw = bytes(xd)
    wiener = np.array([3, -7, 15, -22, 15, -7, 3, 0] * 2, "<i2").tobytes()
    sgr = np.array([0, -32, 31], "<i4").tobytes()
    assert raw.count(wiener * 3) == 1 and raw.count(sgr * 3) == 1
    assert len(raw.replace(wiener * 3, b"").replace(sgr * 3, b"").strip(b"\0")) == 0


# -- the tools reached ------------------------------------------------------------------------------------

def coverage() -> np.ndarray:
    total = np.zeros(native.AV1_STATS_SIZE, np.int64)
    streams = [item_data(d) for d in encoder_files().values()]
    streams += [item_data(written_file(n, 0)) for n in WRITTEN]
    for s in streams:
        total += decode_stats(s)
    return total


def test_every_type_set_unit_size_and_the_stripe_edges_are_reached():
    """Between them the files restore by every type in each plane, every
    self-guided set, units of 32 (chroma) to 256 samples, lr_uv_shift 1,
    and stripes with and without saved rows at their edges."""
    total = coverage()
    units = total[S["lr_units"][0]:S["lr_units"][1]].reshape(3, 3)
    assert (units > 0).all(), units
    assert (total[S["lr_sgr_sets"][0]:S["lr_sgr_sets"][1]] > 0).all()
    assert (total[S["lr_unit_sizes"][0]:S["lr_unit_sizes"][1]] > 0).all()
    assert total[S["lr_uv_shift"]] > 0
    assert 0 < total[S["lr_boundary"]] < 2 * total[S["lr_stripes"]]


def test_loop_restoration_has_its_stage_time():
    stream = item_data(encoder_files()["cv2_scene_q50_speed4"])
    ms = np.zeros(4)
    status, _, _ = native.av1_decode(stream, native.av1_info(stream)[1], stage_ms=ms)
    assert status == 0 and (ms >= 0).all() and ms[3] > 0
    with pytest.raises(ValueError, match="array of 4"):
        native.av1_decode(stream, native.av1_info(stream)[1], stage_ms=np.zeros(3))


# -- damage ----------------------------------------------------------------------------------------------

def fuzz_bases() -> dict:
    """Small restoring files the fuzz changes: Pillow's self-guided luma in
    4:4:4 and Wiener luma in 4:2:0, cv2's Wiener luma with 64x64
    superblocks, Pillow's switchable units with 128x128 superblocks (speed
    0), written self-guided and switchable frames in 4:4:4 and 4:2:0 at
    both superblock sizes."""
    return {
        "restored_sgrproj_444": pil_avif(text(48, 64, 3, 2), quality=30, subsampling="4:4:4", speed=4,
                                         advanced=RESTORATION_ON),
        "restored_wiener_420": pil_avif(text(48, 64, 3, 3), quality=30, subsampling="4:2:0", speed=4,
                                        advanced=RESTORATION_ON),
        "restored_cv2_speed4": cv2_avif(np.ascontiguousarray(serving_scene(0)[64:256, 128:384]), 4, 50),
        "restored_switchable_sb128": encoder_files()["pillow_scene_speed0"],
        "restored_written_sgrproj_444": written(9, w=128, h=64, lr=((3, 3, 3), 0, 0, ALL_SETS)),
        "restored_written_switchable_420": written(10, w=128, h=64, subsampling="4:2:0", lr=((1, 1, 1), 0, 1, ALL_SETS)),
        "restored_written_sb128_420": written(11, w=128, h=128, sb128=True, subsampling="4:2:0",
                                              lr=((1, 3, 2), 0, 1, ALL_SETS)),
    }


@functools.lru_cache(maxsize=None)
def bases() -> dict:
    return fuzz_bases()


def test_the_fuzz_bases_restore():
    for name, data in bases().items():
        assert answers(data) == "equal", name
        assert lr_units(item_data(data))[:, 1:].sum() > 0, name
    assert {native.av1_info(item_data(d))[1][17] for d in bases().values()} == {0, 1}


@pytest.mark.parametrize("name", list(fuzz_bases()))
def test_mutated_restoring_files_answer_as_cv2(name):
    got = collections.Counter(answers(d) for d in mutations(bases()[name], 150, seed=len(name) + 131))
    assert set(got) <= {"none", "equal", "known"}, got
    assert got["equal"] >= 5


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's restoring files: ``n`` mutations of each base."""
    return [m for i, data in enumerate(bases().values()) for m in mutations(data, n, seed=10000 * round_ + i + 1300)]


# -- what the card decodes ----------------------------------------------------------------------------

def written_cases() -> dict:
    """For ``assets/image_cases.npz``: cv2's files of the crop at each
    quality (speed 4), Pillow's restoring files, the written frames, edge
    sizes, and mutated and cut restoring files."""
    cases = {f"restored_cv2_q{q}": cv2_avif(scene_crop(), 4, q) for q in (30, 50, 70)}
    cases.update({f"restored_{k}": v for k, v in encoder_files().items() if not k.startswith("cv2_scene")})
    cases.update({f"restored_written_{k}": written_file(k, 0) for k in WRITTEN})
    for w, h in EDGES[1::3]:
        cases[f"restored_written_{w}x{h}"] = written(5, visible=(w, h), subsampling="4:2:0", lr=((1, 1, 1), 0, 1,
                                                                                                 ALL_SETS))
    for i, (name, data) in enumerate(bases().items()):
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 3, seed=i + 1990))})
        cases[f"{name}_cut"] = data[: len(data) * 3 // 4]
    return {k: v for k, v in cases.items() if answers(v) != "known"}


def scene_payload(scene: np.ndarray) -> dict:
    """The serving scene as cv2's speed-4 AVIF at its default quality (50):
    Wiener loop restoration on luma beside deblocking and CDEF, the smoke's
    restored payload and request."""
    return {"scene0_avif_restored": cv2.imencode(".avif", scene, [cv2.IMWRITE_AVIF_SPEED, 4])[1].tobytes()}


def test_the_written_cases_decode_as_cv2():
    got = collections.Counter(answers(d) for d in written_cases().values())
    assert set(got) <= {"none", "equal"} and got["equal"] >= 30, got
