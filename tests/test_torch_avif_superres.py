"""libaom 3.14.1's superres in ``csrc/av1.cpp`` (the frame decoded,
deblocked and CDEF-filtered at its coded width, upscaled by
``av1_upscale_normative_rows`` tile column by tile column with the
normative 8-tap filter, then restored at the upscaled width from stripe
boundaries upscaled from the deblocked frame) against
``cv2.imdecode(buf, IMREAD_COLOR)`` (OpenCV 5.0 over libavif 1.4.2 and
libaom 3.14.1): the same ``None`` or not, and 0 differing pixels.

No writer here sets superres (neither Pillow's libavif nor cv2's takes
``superres-mode``), so the frames come from ``filtered_frame``
(``tests/test_torch_avif_deblock.py``): each coded denominator 9-16, 4:4:4
and 4:2:0, upscaled widths odd and even, one and two tile columns, with
and without CDEF and loop restoration (every unit size, ``lr_unit_shift``
on, both superblock sizes), a coded-lossless frame that restores
(superres makes it not all-lossless), superres enabled in the sequence
and not used, and film grain over an upscaled frame. The filter equals
libaom's ``av1_convolve_horiz_rs_c`` and the ``_sse4_1`` one it
dispatches, through ``ctypes``.

    python -m pytest tests/test_torch_avif_superres.py -q
"""

import collections
import ctypes
import functools

import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from test_torch_avif import avif_file, decode_stats, item_data, mutations
from test_torch_avif_deblock import filtered_frame, lf_edges
from test_torch_avif_lossy import _libaom
from test_torch_avif_restoration import ALL_SETS, _dispatched, _props, lr_units
from test_torch_tiff import answers, port_decode

S = native.AV1_STATS
DENOMS = range(9, 17)


def coded_width(upscaled: int, denom: int) -> int:
    """av1_calculate_scaled_superres_size."""
    return max(min(16, upscaled), (upscaled * 8 + denom // 2) // denom) if denom > 8 else upscaled


def upscaled_width(denom: int, w: int, parity: int) -> int:
    """The narrowest upscaled width of that parity whose coded width lies
    on the writer's grid of ``w`` (up to 7 samples short of it)."""
    return next(u for u in range(w - 7, 3 * w) if u % 2 == parity and w - 8 < coded_width(u, denom) <= w)


def superres_file(seed: int, denom: int, *, w: int = 256, h: int = 128, parity: int = 0, vh: int = None,
                  subsampling: str = "4:4:4", **kw) -> bytes:
    """A written frame whose coded width lies on the grid of ``w``,
    upscaled by ``denom`` (8: superres enabled and not used) to a width of
    that ``parity``, ``vh`` rows visible."""
    uw = upscaled_width(denom, w, parity)
    vh = vh or h
    frame = filtered_frame(seed, w=w, h=h, subsampling=subsampling, visible=(w, vh), superres=(denom, uw), **kw)
    return avif_file(frame, w=uw, h=vh, color_props=_props(uw, vh, subsampling))


def superres_stats(data: bytes) -> np.ndarray:
    return decode_stats(item_data(data))[S["superres"][0]:S["superres"][1]]


# -- each denominator --------------------------------------------------------------------------------

LR = ((1, 1, 1), 0, 0, ALL_SETS)


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("denom", DENOMS)
def test_each_denominator_decodes_as_cv2(denom, subsampling):
    """An upscaled width odd and one even, switchable loop restoration on
    the upscaled frame (``lr_uv_shift`` 1 in 4:2:0): the output is the
    upscaled width, and the frame is counted under its denominator."""
    for parity in (0, 1):
        data = superres_file(denom + parity, denom, parity=parity, subsampling=subsampling,
                             lr=((1, 1, 1), 0, int(subsampling == "4:2:0"), ALL_SETS))
        assert answers(data) == "equal", parity
        assert port_decode(data).shape[1] == upscaled_width(denom, 256, parity)
        counts = superres_stats(data)
        assert counts[denom - 9] == 1 and counts.sum() == 1
        assert lr_units(item_data(data))[:, 1:].sum() > 0


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("denom", [9, 11, 13, 16])
def test_two_tile_columns_decode_as_cv2(denom, subsampling):
    """Each tile column upscaled on its own, reading its neighbour's
    samples at the inner edge, the phase carried across it; with and
    without loop restoration."""
    for lr in (None, LR):
        data = superres_file(20 + denom, denom, parity=denom % 2, subsampling=subsampling, tile_cols_log2=1, lr=lr)
        assert answers(data) == "equal", lr
        assert decode_stats(item_data(data))[S["tiles"]] == 2


# with and without CDEF and loop restoration; base_q_idx 200 and deblocking
# levels (6, 5, 4, 3) unless a case says otherwise
CASES = {
    "upscaled_alone": dict(),
    "deblocking_off": dict(levels=(0, 0, 0, 0)),
    "cdef": dict(cdef=(5, 2, [(9, 6), (0, 3), (62, 0), (7, 17)])),
    "cdef_alone": dict(levels=(0, 0, 0, 0), cdef=(4, 1, [(40, 20), (13, 9)])),
    "lr_unit_64": dict(lr=((1, 1, 1), 0, 0, ALL_SETS)),
    "lr_unit_128_wiener": dict(lr=((2, 2, 2), 1, 0, ALL_SETS)),
    "lr_unit_256_sgrproj": dict(lr=((3, 3, 3), 2, 0, ALL_SETS), h=256),
    "lr_alone": dict(levels=(0, 0, 0, 0), lr=((1, 3, 2), 1, 0, ALL_SETS)),
    "cdef_lr": dict(cdef=(5, 2, [(9, 6), (0, 3), (62, 0), (7, 17)]), lr=((1, 2, 3), 2, 0, ALL_SETS), h=256),
    "sb128_lr": dict(sb128=True, lr=((1, 1, 1), 1, 0, ALL_SETS)),
    "sb128_lr_unit_256": dict(sb128=True, lr=((3, 1, 2), 1, 0, ALL_SETS), w=384, h=256),
    "420_lr_uv_shift": dict(subsampling="4:2:0", lr=((1, 1, 1), 1, 1, ALL_SETS)),
    "420_cdef_lr": dict(subsampling="4:2:0", cdef=(3, 1, [(21, 33), (6, 2)]), lr=((2, 3, 1), 0, 0, ALL_SETS)),
    "odd_height": dict(lr=((1, 1, 1), 0, 0, ALL_SETS), vh=123),
    "420_odd_height": dict(subsampling="4:2:0", lr=((1, 1, 1), 0, 1, ALL_SETS), vh=125),
}


@pytest.mark.parametrize("name", list(CASES))
def test_the_in_loop_filters_around_superres_decode_as_cv2(name):
    """Two denominators and both parities per case; each restored case
    against the same frame without loop restoration (it changes the
    pixels), and loop restoration's stripe boundaries upscaled from the
    deblocked frame where it runs."""
    kw = CASES[name]
    for denom, parity in ((10, 1), (15, 0)):
        data = superres_file(40 + denom, denom, parity=parity, **kw)
        assert answers(data) == "equal", denom
        stats = decode_stats(item_data(data))
        assert stats[S["superres"][0] + denom - 9] == 1
        if "lr" in kw:
            assert stats[S["superres_lr_rows"]] > 0
            plain = superres_file(40 + denom, denom, parity=parity, **{k: v for k, v in kw.items() if k != "lr"})
            assert (port_decode(data) != port_decode(plain)).any()
        if "cdef" in kw:
            assert stats[S["cdef_y"]] > 0


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
def test_a_coded_lossless_frame_that_restores_decodes_as_cv2(subsampling):
    """base_q_idx 0: no deblocking or CDEF, but superres keeps the frame
    from being all lossless, so its loop restoration runs on the upscaled
    frame (and changes it)."""
    for denom in (9, 12, 16):
        lr = ((1, 1, 1), 0, int(subsampling == "4:2:0"), ALL_SETS)
        data = superres_file(60 + denom, denom, parity=denom % 2, subsampling=subsampling, q=0, lr=lr)
        assert answers(data) == "equal", denom
        stream = item_data(data)
        assert lr_units(stream)[:, 1:].sum() > 0 and lf_edges(stream).sum() == 0
        plain = superres_file(60 + denom, denom, parity=denom % 2, subsampling=subsampling, q=0)
        assert answers(plain) == "equal"
        assert (port_decode(data) != port_decode(plain)).any()


def test_a_tile_column_under_128_samples_before_an_upscale_gives_none_as_cv2():
    """av1_is_min_tile_width_satisfied: two 64-sample tile columns decode
    without superres and are refused with it."""
    for denom in (8, 9, 16):
        data = superres_file(110 + denom, denom, w=128, h=64, tile_cols_log2=1, lr=LR)
        assert answers(data) == ("equal" if denom == 8 else "none"), denom


def test_superres_enabled_and_not_used_decodes_as_cv2():
    """The sequence enables superres, the frame codes use_superres 0: no
    upscaling, the lossless frame all lossless (no restoration is read)."""
    for kw in (dict(lr=LR), dict(q=0, lr=LR)):
        data = superres_file(80, 8, **kw)
        assert answers(data) == "equal"
        assert superres_stats(data).sum() == 0


def test_film_grain_over_an_upscaled_frame_decodes_as_cv2():
    """Grain is added to the upscaled, restored frame as it is output."""
    from test_torch_avif_grain import coded, grain_vectors, put, regrained

    for denom, subsampling in ((11, "4:2:0"), (14, "4:4:4")):
        data = superres_file(90 + denom, denom, parity=1, subsampling=subsampling, lr=LR)
        stream = item_data(data)
        ss = int(subsampling == "4:2:0")
        g = coded(grain_vectors()[3], ss, ss, False)
        put(g, "random_seed", 1000 + denom)
        uw = upscaled_width(denom, 256, 1)
        grained = avif_file(regrained(stream, g), w=uw, h=128, color_props=_props(uw, 128, subsampling))
        assert answers(grained) == "equal"
        stats = decode_stats(item_data(grained))
        assert stats[S["superres"][0] + denom - 9] == 1 and stats[S["grain"][0]:S["grain"][1]].all()
        assert (port_decode(grained) != port_decode(data)).any()


def test_superres_has_its_stage_time():
    data = superres_file(3, 12, lr=LR)
    stream = item_data(data)
    ms = np.zeros(6)
    status, _, _ = native.av1_decode(stream, native.av1_info(stream)[1], stage_ms=ms)
    assert status == 0 and (ms >= 0).all() and ms[4] > 0 and ms[3] > 0 and ms[5] == 0


# -- the filter against libaom's ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rs_functions() -> dict:
    """{isa: av1_convolve_horiz_rs_<isa>}, av1_get_upscale_convolve_step,
    the address of av1_resize_filter_normative, the ISA libaom dispatches."""
    lib = _libaom()
    vp, i = ctypes.c_void_p, ctypes.c_int
    fns = {isa: lib.function(f"av1_convolve_horiz_rs_{isa}", None, vp, i, vp, i, i, i, vp, i, i)
           for isa in ("c", "sse4_1")}
    step = lib.function("av1_get_upscale_convolve_step", ctypes.c_int32, i, i)
    return {"fns": fns, "step": step, "filters": lib.base + lib.sym("av1_resize_filter_normative")[0],
            "dispatched": _dispatched(lib, "av1_convolve_horiz_rs")}


def test_libaom_dispatches_the_sse4_1_filter():
    assert rs_functions()["dispatched"] == "av1_convolve_horiz_rs_sse4_1"


@pytest.mark.parametrize("kind", ["noise", "flat", "step"])
def test_the_upscaling_filter_is_libaoms(kind):
    """Every denominator's step between widths of 1 to 400, random start
    phases, 1 to 4 rows of noise, flat samples of ±1 or a step: the
    filter equals libaom's C and SSE4.1 functions to the sample (the taps
    overshoot past 0 and 255 at a step: the clip)."""
    f = rs_functions()
    rs = np.random.RandomState(("noise", "flat", "step").index(kind))
    for trial in range(200):
        denom = int(rs.randint(9, 17))
        up = int(rs.randint(1, 401))
        down = coded_width(up, denom)
        step = f["step"](down, up)
        x0 = int(rs.randint(0, 1 << 14))
        h = int(rs.randint(1, 5))
        shape = (h, down + 16)
        if kind == "noise":
            src = rs.randint(0, 256, shape)
        elif kind == "flat":
            src = int(rs.randint(0, 256)) + rs.randint(-1, 2, shape)
        else:
            src = np.where(np.arange(shape[1]) < rs.randint(4, shape[1]), 0, 255) + np.zeros(shape, int)
        src = np.clip(src, 0, 255).astype(np.uint8)
        ours = native.av1_convolve_horiz_rs(src, up, x0, step)
        for isa, fn in f["fns"].items():
            dst = np.zeros((h, up + 32), np.uint8)
            fn(src.ctypes.data + 4, src.shape[1], dst.ctypes.data, dst.shape[1], up, h, f["filters"], x0, step)
            assert (dst[:, :up] == ours).all(), (isa, trial, up, down, x0)


def test_a_filter_call_out_of_range_is_refused():
    with pytest.raises(ValueError, match="read past"):
        native.av1_convolve_horiz_rs(np.zeros((2, 10), np.uint8), 20, 0, 1 << 14)


# -- the tools reached --------------------------------------------------------------------------------

def test_every_denominator_and_the_upscaled_boundaries_are_reached():
    total = np.zeros(native.AV1_STATS_SIZE, np.int64)
    for data in list(fuzz_bases().values()) + [superres_file(d, d, lr=LR) for d in DENOMS]:
        total += decode_stats(item_data(data))
    assert (total[S["superres"][0]:S["superres"][1]] > 0).all()
    assert total[S["superres_lr_rows"]] > 0 and total[S["lr_boundary"]] > 0


# -- damage ----------------------------------------------------------------------------------------------

def fuzz_bases() -> dict:
    """Small superres frames the fuzz changes: 4:4:4 and 4:2:0 with loop
    restoration, two tile columns, CDEF, and a coded-lossless frame."""
    return {
        "superres_444_lr": superres_file(101, 9, w=128, h=64, parity=1, lr=LR),
        "superres_420_lr": superres_file(102, 16, w=128, h=64, subsampling="4:2:0", lr=((1, 1, 1), 0, 1, ALL_SETS)),
        "superres_two_tiles": superres_file(103, 12, w=256, h=64, parity=1, tile_cols_log2=1, lr=LR),
        "superres_cdef": superres_file(104, 13, w=128, h=64, cdef=(5, 1, [(9, 6), (30, 3)])),
        "superres_lossless_lr": superres_file(105, 11, w=128, h=64, q=0, lr=LR),
    }


@functools.lru_cache(maxsize=None)
def bases() -> dict:
    return fuzz_bases()


def test_the_fuzz_bases_upscale():
    for name, data in bases().items():
        assert answers(data) == "equal", name
        assert superres_stats(data).sum() == 1, name


@pytest.mark.parametrize("name", list(fuzz_bases()))
def test_mutated_superres_files_answer_as_cv2(name):
    got = collections.Counter(answers(d) for d in mutations(bases()[name], 150, seed=len(name) + 431))
    assert set(got) <= {"none", "equal", "known"}, got
    assert got["equal"] >= 5


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's superres files: ``n`` mutations of each base."""
    return [m for i, data in enumerate(bases().values()) for m in mutations(data, n, seed=10000 * round_ + i + 3300)]


# -- what the card decodes ----------------------------------------------------------------------------

def written_cases() -> dict:
    """For ``assets/image_cases.npz``: each denominator in 4:4:4 and 4:2:0
    (the widths odd where the denominator is), two tile columns, the
    filter cases, the lossless frame, and mutated and cut bases."""
    cases = {}
    for denom in DENOMS:
        for subsampling in ("4:4:4", "4:2:0"):
            cases[f"superres_{denom}_{subsampling.replace(':', '')}"] = superres_file(
                denom, denom, w=128, h=64, parity=denom % 2, subsampling=subsampling,
                lr=((1, 1, 1), 0, int(subsampling == "4:2:0"), ALL_SETS))
    for name in ("cdef_lr", "lr_alone", "sb128_lr", "420_cdef_lr", "odd_height"):
        cases[f"superres_case_{name}"] = superres_file(7, 10, parity=1, **CASES[name])
    for i, (name, data) in enumerate(bases().items()):
        cases[name] = data
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 2, seed=i + 3990))})
        cases[f"{name}_cut"] = data[: len(data) * 3 // 4]
    return {k: v for k, v in cases.items() if answers(v) != "known"}


def test_the_written_cases_decode_as_cv2():
    got = collections.Counter(answers(d) for d in written_cases().values())
    assert set(got) <= {"none", "equal"} and got["equal"] >= 25, got
