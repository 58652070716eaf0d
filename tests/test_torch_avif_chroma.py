"""Subsampled AVIF: 4:2:0 and 4:2:2 frames through ``csrc/av1.cpp`` (the
chroma of sub-8x8 blocks, the chroma transform sizes and types, intra
prediction, CFL, palette and IntraBC in a subsampled plane) against
``cv2.imdecode(buf, IMREAD_COLOR)`` and ``cv2.imread`` (OpenCV 5.0 over
libavif 1.4.2 and libaom 3.14.1): the same ``None`` or not, and 0
differing pixels.

The streams come from Pillow 12.1's AVIF writer (libavif 1.3) with
libaom's in-loop filters turned off (``enable-cdef=0``,
``enable-restoration=0``, ``loopfilter-control=0``), in Pillow's own
files (no colour description: libavif takes BT.601 in full range):
lossless and lossy, q 30 to 95, sizes from 1x1 to 200x300 with odd
widths and heights, noise, photo-like, gradient and text content, screen
content (palette and IntraBC, whose displacements are half samples in a
subsampled plane), the encoder options that change the stream, and
frames of 16x64 and 64x16 blocks written by the lossy suite's own entropy
coder (8x32 and 32x8 chroma transforms, which libaom's all-intra encoder
never reaches). cv2's own files of the serving scenes at quality 95 (4:2:0, BT.601, every
in-loop filter off) decode too; its default file (quality 50) runs
deblocking and CDEF, which decode since (``tests/test_torch_avif_deblock.py``),
and at speed 4 loop restoration, which decodes since too (``tests/test_torch_avif_restoration.py``).

    python -m pytest tests/test_torch_avif_chroma.py -q
"""

import collections
import functools

import cv2
import numpy as np
import pytest

from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.utils import imcodec
from test_torch_avif import (avif_file, decode_stats, gradient, item_data, mutations, noise, pil_avif, read_answers,
                             smooth, text)
from test_torch_avif_lossy import bands, written_file
from test_torch_tiff import answers, cv2_decode, port_decode

FILTERS_OFF = [("enable-cdef", "0"), ("enable-restoration", "0"), ("loopfilter-control", "0")]
CONTENT = {"noise": lambda h, w, s: noise(h, w, 3, s), "smooth": lambda h, w, s: smooth(h, w, 3, s),
           "gradient": gradient, "text": lambda h, w, s: text(h, w, 3, s)}
SUBSAMPLINGS = ("4:2:0", "4:2:2")


def chroma_avif(img, subsampling: str, q: int, speed: int, options=()) -> bytes:
    """Pillow's file of ``img`` with the in-loop filters off (quality 100:
    lossless)."""
    return pil_avif(img, quality=q, subsampling=subsampling, speed=speed, advanced=FILTERS_OFF + list(options))


# -- Pillow's streams: size, quality, speed and content ------------------------------------------

SIZES = [(1, 1), (1, 9), (7, 5), (33, 17), (64, 96), (65, 129)]
QUALITIES = [100, 95, 90, 60, 30]


@functools.lru_cache(maxsize=None)
def spread_file(subsampling: str, size: tuple, q: int) -> bytes:
    h, w = size
    k = SIZES.index(size) * len(QUALITIES) + QUALITIES.index(q)
    kind = list(CONTENT)[k % 4]
    speed = (0, 2, 4, 6, 8, 9)[k % 6] if h * w <= 64 * 96 else 6 + k % 4
    return chroma_avif(CONTENT[kind](h, w, k + 7 * SUBSAMPLINGS.index(subsampling)), subsampling, q, speed)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
def test_pillows_subsampled_streams_decode_as_cv2(subsampling, size, q, tmp_path):
    """Lossless (q100) and lossy frames of every size (odd ones among
    them), the content and the speed turning with the case."""
    data = spread_file(subsampling, size, q)
    info = native.av1_info(item_data(data))[1]
    assert (info[4], info[5]) == ((1, 1) if subsampling == "4:2:0" else (1, 0))
    assert answers(data) == "equal"
    if size[0] >= 33:
        assert read_answers(data, tmp_path) == "equal"


@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
def test_larger_frames_decode_as_cv2(subsampling):
    """200x300 and 97x211 frames of photo-like and text content (several
    superblock rows and a partial one, chroma planes of odd size)."""
    for k, (h, w, kind, q) in enumerate(((200, 300, "smooth", 95), (97, 211, "text", 90), (97, 211, "gradient", 60))):
        assert answers(chroma_avif(CONTENT[kind](h, w, k), subsampling, q, 6)) == "equal", (h, w, kind, q)


# -- screen content: palette and IntraBC ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def screen_file(subsampling: str, q: int) -> bytes:
    h, w = (128, 256) if q != 90 else (97, 211)
    return chroma_avif(text(h, w, 3, q + len(subsampling)), subsampling, q, 6, [("tune-content", "screen")])


@pytest.mark.parametrize("q", [100, 90, 60])
@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
def test_screen_content_decodes_as_cv2(subsampling, q):
    """Palette (chroma palettes with their colour cache) and IntraBC, whose
    luma displacement of whole samples is a half-sample one in a
    subsampled plane (the bilinear 2-tap prediction), the chroma block of a
    sub-8x8 group from the displacement of the block that carries it."""
    data = screen_file(subsampling, q)
    assert answers(data) == "equal"
    stats = decode_stats(item_data(data))
    s = native.AV1_STATS
    assert stats[s["intrabc"]] > 0 and stats[s["palette_y"]] > 0


# -- libaom's encoder options ----------------------------------------------------------------------

OPTIONS = {
    "quantiser_matrices": ("smooth", 40, 6, [("enable-qm", "1"), ("qm-min", "0"), ("qm-max", "15")]),
    "delta_q": ("smooth", 50, 6, [("deltaq-mode", "2")]),
    "reduced_tx_set": ("text", 60, 6, [("tune-content", "screen"), ("reduced-tx-type-set", "1")]),
    "no_cfl": ("smooth", 60, 6, [("enable-cfl-intra", "0")]),
    "square_transforms": ("noise", 60, 4, [("enable-rect-tx", "0")]),
    "tiles_2x2": ("smooth", 70, 6, [("tile-columns", "1"), ("tile-rows", "1")]),
    "superblock_128": ("gradient", 30, 4, [("sb-size", "128")]),
    "min_partition_4_speed_0": ("gradient", 50, 0, [("sb-size", "64")]),
}


@functools.lru_cache(maxsize=None)
def option_file(name: str, subsampling: str) -> bytes:
    kind, q, speed, options = OPTIONS[name]
    h, w = (96, 160) if speed else (48, 64)
    return chroma_avif(CONTENT[kind](h, w, len(name)), subsampling, q, speed, options)


@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
@pytest.mark.parametrize("name", list(OPTIONS))
def test_libaoms_encoder_options_decode_as_cv2(name, subsampling):
    assert answers(option_file(name, subsampling)) == "equal"


@functools.lru_cache(maxsize=None)
def bands_file(axis: int, subsampling: str) -> bytes:
    """Bands of 8 samples: libaom's 4-way partitions into 32x8 and 8x32
    blocks, whose 4:2:0 chroma takes 16x4 and 4x16 transforms (4:2:2 has no
    8x32 blocks: their chroma would be 4x32)."""
    return chroma_avif(bands(64, 64, 8, axis, 15), subsampling, 60, 2)


@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
@pytest.mark.parametrize("axis", [0, 1])
def test_four_way_partitions_decode_as_cv2(axis, subsampling):
    """4:2:2 has no vertical partition at all: each would make a block
    whose chroma has no size (libaom refuses the stream)."""
    data = bands_file(axis, subsampling)
    assert answers(data) == "equal"
    partitions = decode_stats(item_data(data))[native.AV1_STATS["partition"][0]:][:10]
    if subsampling == "4:2:0":
        assert partitions[8 + axis] > 0  # HORZ_4 / VERT_4
    else:
        assert partitions[[2, 6, 7, 9]].sum() == 0 and partitions[8] + partitions[1] > 0


def test_a_subsampled_colour_item_with_its_alpha_decodes_as_cv2():
    rgba = noise(24, 40, 4, 5)
    for subsampling in SUBSAMPLINGS:
        for q in (100, 60):
            both = pil_avif(rgba, quality=q, subsampling=subsampling, speed=6, advanced=FILTERS_OFF)
            assert answers(both) == "equal", (subsampling, q)


@pytest.mark.parametrize("seed", range(4))
def test_written_frames_of_8x32_and_32x8_chroma_transforms_decode_as_cv2(seed):
    """The test's own 4:2:0 key frames of 16x64 and 64x16 blocks (libaom's
    all-intra encoder never picks them), whose chroma takes 8x32 and 32x8
    transforms."""
    data = written_file(seed, subsampled=True)
    assert answers(data) == "equal"
    s = native.AV1_STATS["uv_tx_size"][0]
    assert (decode_stats(item_data(data))[[s + 15, s + 16]] == 8).all()  # TX_8X32, TX_32X8: 4 blocks x 2 planes


# -- cv2's own files -----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def scene_q95(index: int) -> bytes:
    from ppocr_tpu_torch import assets

    scene = assets.load_scenes()["serving"][index]
    return cv2.imencode(".avif", scene, [cv2.IMWRITE_AVIF_QUALITY, 95])[1].tobytes()


@pytest.mark.parametrize("index", [0, 1])
def test_cv2s_quality_95_files_of_the_serving_scenes_decode_as_cv2(index, tmp_path):
    """cv2 writes 4:2:0 with BT.601 (matrix 6) in full range, and at
    quality 95 turns every in-loop filter off."""
    data = scene_q95(index)
    info = dict(zip(native.AV1_INFO, native.av1_info(item_data(data))[1].tolist()))
    assert (info["ss_x"], info["ss_y"], info["matrix"], info["color_range"]) == (1, 1, 6, 1)
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"


def test_cv2s_default_file_decodes_with_its_in_loop_filters(caplog):
    """Quality 50, cv2's default, decodes since its deblocking and CDEF
    are (tests/test_torch_avif_deblock.py); at speed 4 the frame of this
    image also runs loop restoration (Wiener on chroma), which decodes since
    (tests/test_torch_avif_restoration.py), with no log line."""
    img = smooth(64, 96, 3, 9)
    data = cv2.imencode(".avif", img)[1].tobytes()
    assert data == cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, 50])[1].tobytes()
    assert answers(data) == "equal"
    data = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_SPEED, 4])[1].tobytes()
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is not None
    assert not [r for r in caplog.records if r.name == "ppocr_tpu_torch.utils.imcodec"]
    assert answers(data) == "equal"
    stats = decode_stats(item_data(data))
    assert stats[native.AV1_STATS["lr_units"][0]:native.AV1_STATS["lr_units"][1]].reshape(3, 3)[1:, 1].all()


# -- the tools reached -----------------------------------------------------------------------------

def coverage() -> np.ndarray:
    total = np.zeros(native.AV1_STATS_SIZE, np.int64)
    files = [spread_file(s, size, q) for s in SUBSAMPLINGS for size in SIZES for q in QUALITIES]
    files += [screen_file(s, q) for s in SUBSAMPLINGS for q in (100, 90, 60)]
    files += [option_file(n, s) for n in OPTIONS for s in SUBSAMPLINGS]
    files += [bands_file(axis, s) for axis in (0, 1) for s in SUBSAMPLINGS]
    files += [written_file(0, subsampled=True)]
    for data in files:
        total += decode_stats(item_data(data))
    return total


# the chroma transform sizes a subsampled frame can take: every size of a
# plane block, capped at 32 (8x32 and 32x8 only in the written frames)
UV_TX_SIZES = ("4x4", "8x8", "16x16", "32x32", "4x8", "8x4", "8x16", "16x8", "16x32", "32x16", "4x16", "16x4",
               "8x32", "32x8")


def test_every_chroma_transform_size_and_the_subsampled_tools_are_reached():
    """Between them the cases above code every chroma transform size,
    CFL from subsampled luma, the chroma of sub-8x8 groups, chroma
    palettes and half-sample IntraBC displacements."""
    total = coverage()
    s = native.AV1_STATS
    uv = dict(zip(native.AV1_TX_SIZES, total[s["uv_tx_size"][0]:s["uv_tx_size"][1]].tolist()))
    assert all(uv[name] > 0 for name in UV_TX_SIZES), uv
    for tool in ("cfl_subsampled", "sub8x8_chroma", "palette_uv", "chroma_subpel_dv", "intrabc", "qm", "delta_q"):
        assert total[s[tool]] > 0, tool


# -- damage ----------------------------------------------------------------------------------------

def fuzz_bases() -> dict:
    """Small subsampled files the fuzz changes: noise and photo-like frames,
    lossless and lossy, and screen content with IntraBC, in 4:2:0 and
    4:2:2."""
    out = {}
    for sub in SUBSAMPLINGS:
        tag = sub.replace(":", "")
        out[f"chroma{tag}_noise"] = chroma_avif(noise(23, 41, 3, 1), sub, 60, 6)
        out[f"chroma{tag}_lossless"] = chroma_avif(smooth(30, 40, 3, 2), sub, 100, 4)
        out[f"chroma{tag}_screen"] = chroma_avif(text(64, 128, 3, 3), sub, 70, 6, [("tune-content", "screen")])
    out["chroma420_written_8x32_32x8"] = written_file(7, subsampled=True)
    return out


@functools.lru_cache(maxsize=None)
def bases() -> dict:
    return fuzz_bases()


@pytest.mark.parametrize("name", list(fuzz_bases()))
def test_mutated_subsampled_files_answer_as_cv2(name):
    got = collections.Counter(answers(d) for d in mutations(bases()[name], 300, seed=len(name) + 61))
    assert set(got) <= {"none", "equal", "known"}, got
    assert got["equal"] >= 5


def test_every_header_byte_of_a_subsampled_file_xored_answers_as_cv2():
    """The AV1 item's first 48 bytes (OBU headers, the sequence header with
    its subsampling and colour description, the frame header) XOR-ed with
    0x01, 0x10 and 0xFF."""
    data = bases()["chroma420_screen"]
    mdat = data.rindex(b"mdat") + 4
    got = collections.Counter()
    for i in range(mdat, min(len(data), mdat + 48)):
        for x in (0x01, 0x10, 0xFF):
            d = bytearray(data)
            d[i] ^= x
            got[answers(bytes(d))] += 1
    assert set(got) <= {"none", "equal", "known"}, got


def fuzz_files(round_: int, n: int = 2000) -> list:
    """One fuzz round's subsampled files: ``n`` mutations of each base."""
    return [m for i, data in enumerate(bases().values()) for m in mutations(data, n, seed=10000 * round_ + i + 700)]


# -- what the card decodes ---------------------------------------------------------------------

def written_cases() -> dict:
    """For ``assets/image_cases.npz``: a spread of the streams above (the
    small sizes, every quality), screen content, options, and mutated and
    cut subsampled files."""
    cases = {f"chroma_{s.replace(':', '')}_{h}x{w}_q{q}": spread_file(s, (h, w), q)
             for s in SUBSAMPLINGS for h, w in SIZES[:4] for q in QUALITIES}
    cases.update({f"chroma_screen_{s.replace(':', '')}_q{q}": screen_file(s, q) for s in SUBSAMPLINGS for q in (60,)})
    cases.update({f"chroma_option_{n}": option_file(n, "4:2:0") for n in ("quantiser_matrices", "tiles_2x2")})
    cases.update({f"chroma_written_8x32_32x8_{seed}": written_file(seed, subsampled=True) for seed in range(2)})
    for i, (name, data) in enumerate(bases().items()):
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 3, seed=i + 970))})
        cases[f"{name}_cut"] = data[: len(data) * 3 // 4]
    return {k: v for k, v in cases.items() if answers(v) != "known"}


def scene_payload(scene: np.ndarray) -> dict:
    """The serving scene as cv2's quality-95 AVIF (4:2:0, BT.601, the
    in-loop filters off): the smoke's subsampled payload and request."""
    return {"scene0_avif_q95": cv2.imencode(".avif", scene, [cv2.IMWRITE_AVIF_QUALITY, 95])[1].tobytes()}


def test_the_written_cases_and_the_payload_decode_as_cv2():
    cases = {**written_cases(), **scene_payload(smooth(64, 96, 3, 5))}
    got = collections.Counter(answers(d) for d in cases.values())
    assert set(got) <= {"none", "equal"} and got["equal"] >= 40, got
    assert port_decode(cases["scene0_avif_q95"]) is not None
