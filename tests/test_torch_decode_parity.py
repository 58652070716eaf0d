"""The port's image decoders (``utils/imcodec.py``, ``csrc/jpeg.cpp``)
give what ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` (OpenCV 5.0,
libjpeg-turbo 3.1, libpng 1.6) gives, for every payload: the same ``None``
or not-``None``, and equal pixels where cv2 returns an image.

JPEG: 1,600 garbled files (24×40, 1–3 bytes changed; 4:2:0 and 4:4:4 with
a restart interval; baseline and progressive), every cut of a baseline
and of a progressive file, EOI replaced by ``FF D0`` or 1–16 zero bytes,
progressive files with their refinement scans removed (block smoothing),
arithmetic-coded streams (Huffman-coded data under an SOF9 / SOF10
header: cv2 decodes whatever the arithmetic decoder reads), and CMYK /
YCCK files written by PIL. PNG: every cut, garbled files, and Adam7 files
of every colour type and bit depth at sizes with empty passes. No pixel
may differ: where cv2 decodes corrupt data, the port decodes it the same.

What is still refused where cv2 decodes (the formats of
``imcodec.FORMAT_NAMES`` and the TIFF compressions of
``imcodec.TIFF_UNPORTED``) is pinned by
``test_what_is_still_refused_gives_none_and_a_log_line_naming_it``, which
holds cv2 to decoding them: a known difference, written down, not hidden.
A PNG whose zlib stream is damaged under a valid CRC decodes as libpng
decodes it (the last test; many more in
``tests/test_torch_image_formats.py``, with BMP, netpbm and Sun raster).
"""

import io
import logging
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch.utils import imcodec
from test_torch_jpeg import encode, image


def cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def port_decode(data: bytes):
    logging.disable(logging.WARNING)  # a refusal logs a line each
    try:
        return imcodec.decode_image(data)
    finally:
        logging.disable(logging.NOTSET)


def answers(data: bytes) -> str:
    """"none", "equal", or how the port's answer differs from cv2's."""
    want, got = cv2_decode(data), port_decode(data)
    if want is None or got is None:
        return "none" if want is None and got is None else ("cv2 only" if got is None else "port only")
    return "equal" if want.shape == got.shape and (want == got).all() else "pixels"


def assert_all_equal_cv2(datas, what):
    bad = [(i, a) for i, a in enumerate(map(answers, datas)) if a not in ("none", "equal")]
    assert not bad, f"{what}: {len(bad)} of {len(datas)} differ from cv2, e.g. {bad[:8]}"


def garbled(data: bytes, n: int, seed: int):
    """``n`` copies of ``data`` with 1–3 bytes past SOI set at random."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        for at in rng.integers(2, len(bad), rng.integers(1, 4)):
            bad[at] = rng.integers(0, 256)
        out.append(bytes(bad))
    return out


def patch_sof(data: bytes, code: int) -> bytes:
    """``data`` with its SOF marker code replaced by ``code``."""
    at = 2
    while data[at + 1] not in (0xC0, 0xC1, 0xC2):
        at += 2 + struct.unpack(">H", data[at + 2 : at + 4])[0]
    return data[: at + 1] + bytes([code]) + data[at + 2 :]


def segments(data: bytes):
    """[(marker, start, end)] of a JPEG: a scan runs up to the next marker
    that is not RSTn."""
    out, at = [], 2
    while at < len(data):
        m = data[at + 1]
        if m == 0xD9:
            out.append((m, at, at + 2))
            break
        end = at + 2 + struct.unpack(">H", data[at + 2 : at + 4])[0]
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        out.append((m, at, end))
        at = end
    return out


def without_scans(data: bytes, keep) -> bytes:
    """A progressive JPEG with only the scans numbered in ``keep``."""
    segs = segments(data)
    scans = [k for k, s in enumerate(segs) if s[0] == 0xDA]
    return data[:2] + b"".join(data[a:b] for k, (m, a, b) in enumerate(segs)
                               if m != 0xDA or scans.index(k) in keep)


def cmyk_jpeg(h, w, seed, quality=85, subsampling=0, progressive=False) -> bytes:
    """A CMYK JPEG as PIL writes it (an Adobe segment, transform 0)."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([image(h, w, seed), rng.integers(0, 256, (h, w, 1))], axis=2).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a, "CMYK").save(buf, "JPEG", quality=quality, subsampling=subsampling,
                                    progressive=progressive)
    return buf.getvalue()


def adobe_variants(data: bytes) -> dict:
    """The file as written, with the Adobe transform set to 2 (YCCK), and
    without its Adobe segment (CMYK as stored)."""
    m, at, end = next(s for s in segments(data) if s[0] == 0xEE)
    ycck = bytearray(data)
    ycck[at + 4 + 11] = 2
    return {"cmyk": data, "ycck": bytes(ycck), "no-adobe": data[:at] + data[end:]}


# -- PNG writer: every colour type, bit depth, filter type, and Adam7 ---------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, nch] samples → [h, stride] bytes."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filtered(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row with a random filter type (0–4) in front."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ft = int(rng.integers(0, 5))
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([ft]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, interlace: bool, palette=None, seed=0) -> bytes:
    """A PNG of [h, w, nch] ``samples`` (ints below 2**depth)."""
    h, w, nch = samples.shape
    bpp = max(1, nch * depth // 8)
    rng = np.random.default_rng(seed)
    passes = [(0, 0, 1, 1)] if not interlace else ADAM7
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_pack(sub, depth), bpp, rng)

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    out = imcodec.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def png_case(ctype: int, depth: int, h: int, w: int, interlace=True, seed=0) -> bytes:
    rng = np.random.default_rng(seed + 100 * ctype + depth)
    nch = CHANNELS[ctype]
    palette = None
    if ctype == 3:
        n = min(1 << depth, 200)
        palette = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, n, (h, w, 1))
    else:
        samples = rng.integers(0, 1 << depth, (h, w, nch))
    return png_bytes(samples, ctype, depth, interlace, palette, seed)


# -- JPEG: corrupt data ----------------------------------------------------------

GARBLED = [(prog, sampling, seed) for prog in (False, True) for sampling in ("420", "444") for seed in range(4)]


@pytest.mark.parametrize("prog,sampling,seed", GARBLED,
                         ids=[f"{'progressive' if p else 'baseline'}-{s}-{i}" for p, s, i in GARBLED])
def test_garbled_jpegs_answer_as_cv2(prog, sampling, seed):
    """100 files per case, 1,600 in all: 24×40 q75, 4:2:0 without and 4:4:4
    with a restart interval of 1 MCU. Accept/refuse and pixels agree on
    every file (none differ; a count above 0 fails)."""
    data = encode(image(24, 40, seed=10 + seed), 75, sampling, restart=0 if sampling == "420" else 1,
                  progressive=prog)
    assert_all_equal_cv2(garbled(data, 100, seed=100 * prog + 10 * (sampling == "444") + seed), "garbled")


@pytest.mark.parametrize("prog", [False, True], ids=["baseline", "progressive"])
def test_every_cut_answers_as_cv2(prog):
    data = encode(image(24, 40, seed=10), 75, "420", progressive=prog)
    assert_all_equal_cv2([data[:k] for k in range(2, len(data) + 1)], "cuts")


TAILS = [b"", b"\xff\xd0"] + [bytes(k) for k in range(1, 17)]


@pytest.mark.parametrize("tail", TAILS, ids=["cut", "rst0"] + [f"zeros{k}" for k in range(1, 17)])
@pytest.mark.parametrize("kind", ["baseline", "progressive", "768x1024"])
def test_eoi_replaced_answers_as_cv2(kind, tail):
    """EOI cut off, replaced by ``FF D0``, or by 1–16 zero bytes."""
    if kind == "768x1024":
        data = encode(image(768, 1024, seed=1), 95, "420")
    else:
        data = encode(image(48, 64, seed=8), 75, "420", progressive=kind == "progressive")
    assert data.endswith(b"\xff\xd9")
    assert answers(data[:-2] + tail) in ("none", "equal")


def test_the_source_running_dry_is_what_refuses():
    """cv2's rule on the 48×64 q75 file: a sequential scan is refused when
    the Huffman look-ahead needs a byte past the end before it meets a
    marker; a progressive file is refused unless EOI is reached; libjpeg's
    warnings (extraneous bytes, a bad Huffman code) refuse nothing."""
    base = encode(image(48, 64, seed=8), 75, "420")
    body = base[:-2]
    decodes = lambda d: port_decode(d) is not None  # noqa: E731
    for data, want in [(body, False), (body + b"\xff\xd0", True), (body + bytes(1), False),
                       (body + bytes(2), False), (body + bytes(3), True), (body + bytes(16), True),
                       (body + b"\x12\x34\x56\xff\xd9", True)]:
        assert (cv2_decode(data) is not None) == want
        assert decodes(data) == want
        assert answers(data) in ("none", "equal")
    prog = encode(image(48, 64, seed=8), 75, "420", progressive=True)[:-2]
    for tail in (b"\xff\xd0", bytes(16)):
        assert cv2_decode(prog + tail) is None and not decodes(prog + tail)
    sos = base.index(b"\xff\xda")
    flipped = bytearray(base)
    flipped[(sos + len(base)) // 2] ^= 0x55  # a bad Huffman code mid-scan
    assert decodes(bytes(flipped)) and answers(bytes(flipped)) == "equal"


# -- JPEG: what libjpeg decodes beyond baseline ----------------------------------

@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("size", [(17, 33), (48, 64), (40, 24)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_block_smoothing_answers_as_cv2(size, sampling):
    """Progressive files missing scans: libjpeg estimates the first AC
    coefficients of each block from its neighbours' DC values."""
    data = encode(image(*size, seed=7), 75, sampling, progressive=True)
    n = sum(1 for s in segments(data) if s[0] == 0xDA)
    keeps = [range(1), range(2), range(3), range(5), range(n - 1), [0, 2, 4], range(n - 3)]
    assert_all_equal_cv2([without_scans(data, list(k)) for k in keeps], "smoothing")


ARITH = [(prog, s, size, rst) for prog in (False, True) for s in ("444", "420", "422", "411")
         for size in ((1, 1), (17, 33), (48, 64)) for rst in (0, 2)]


@pytest.mark.parametrize("prog,sampling,size,rst", ARITH,
                         ids=[f"{'sof10' if p else 'sof9'}-{s}-{h}x{w}-rst{r}" for p, s, (h, w), r in ARITH])
def test_arithmetic_coding_answers_as_cv2(prog, sampling, size, rst):
    """Huffman-coded scans under an SOF9 / SOF10 header: cv2 decodes
    whatever the arithmetic decoder reads from them."""
    data = patch_sof(encode(image(*size, seed=rst + len(sampling)), 75, sampling, restart=rst,
                            progressive=prog), 0xCA if prog else 0xC9)
    assert answers(data) == "equal"
    assert_all_equal_cv2(garbled(data, 5, seed=size[0] + rst), "garbled arithmetic")


@pytest.mark.parametrize("prog", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
@pytest.mark.parametrize("size", [(40, 56), (1, 1), (17, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_cmyk_and_ycck_answer_as_cv2(size, subsampling, prog):
    """PIL's CMYK JPEGs (Adobe transform 0), the same read as YCCK
    (transform 2) and without the Adobe segment (CMYK as stored), through
    OpenCV's CMYK → BGR."""
    data = cmyk_jpeg(*size, seed=size[0] + subsampling, subsampling=subsampling, progressive=prog)
    for name, variant in adobe_variants(data).items():
        want = cv2_decode(variant)
        assert want is not None and want.shape == (*size, 3), name
        assert answers(variant) == "equal", name


# -- PNG ---------------------------------------------------------------------------

ADAM7_CASES = [(ct, d, size) for ct, depths in DEPTHS.items() for d in depths
               for size in ((1, 1), (3, 5), (33, 17))]


@pytest.mark.parametrize("ctype,depth,size", ADAM7_CASES,
                         ids=[f"type{c}-{d}bit-{h}x{w}" for c, d, (h, w) in ADAM7_CASES])
def test_adam7_png_answers_as_cv2(ctype, depth, size):
    """Every colour type and bit depth; at 1×1 and 3×5 some passes are
    empty and carry no bytes. Random filter types on every row."""
    data = png_case(ctype, depth, *size)
    assert cv2_decode(data) is not None
    assert answers(data) == "equal"
    assert answers(png_case(ctype, depth, *size, interlace=False)) == "equal"


@pytest.mark.parametrize("kind", ["cv2", "plain", "adam7"])
def test_every_png_cut_answers_as_cv2(kind):
    """A PNG is decoded only when the data runs to a whole IEND chunk."""
    if kind == "cv2":
        data = cv2.imencode(".png", image(24, 40, seed=1))[1].tobytes()
    else:
        data = png_case(2, 8, 24, 40, interlace=kind == "adam7")
    assert_all_equal_cv2([data[:k] for k in range(8, len(data) + 1)], "png cuts")


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_garbled_pngs_answer_as_cv2(interlace):
    data = png_case(3, 4, 24, 40, interlace)
    assert_all_equal_cv2(garbled(data, 200, seed=int(interlace)), "garbled png")
    data = cv2.imencode(".png", image(24, 40, seed=2))[1].tobytes()
    assert_all_equal_cv2(garbled(data, 200, seed=2 + int(interlace)), "garbled png")


def _chunk(t, body, crc=None):
    crc = zlib.crc32(t + body) & 0xFFFFFFFF if crc is None else crc
    return struct.pack(">I", len(body)) + t + body + struct.pack(">I", crc)


def _png_chunk_cases():
    data = cv2.imencode(".png", image(24, 40, seed=1))[1].tobytes()
    ihdr, idat, iend = data[8:33], data[33:-12], data[-12:]
    text = _chunk(b"tEXt", b"k\x00v")
    body = idat[8:-4]
    half = [_chunk(b"IDAT", body[:10]), _chunk(b"IDAT", body[10:])]
    magic = imcodec.PNG_MAGIC
    rng = np.random.default_rng(0)
    palette_png = png_bytes(rng.integers(0, 16, (5, 7, 1)), 3, 4, False, rng.integers(0, 256, (9, 3)))
    return {
        "ancillary-bad-crc": (magic + ihdr + _chunk(b"tEXt", b"k\x00v", 0) + idat + iend, True),
        "iend-bad-crc": (data[:-4] + bytes(4), True),
        "iend-crc-cut": (data[:-2], False),
        "no-iend": (data[:-12], False),
        "critical-bad-crc": (magic + ihdr + idat[:-4] + bytes(4) + iend, False),
        "unknown-critical": (magic + ihdr + _chunk(b"ABCD", b"x") + idat + iend, False),
        "idat-split": (magic + ihdr + half[0] + half[1] + iend, True),
        "idat-split-by-text": (magic + ihdr + half[0] + text + half[1] + iend, False),
        "ihdr-not-first": (magic + text + ihdr + idat + iend, False),
        "junk-after-iend": (data + b"junk", True),
        "palette-index-past-plte": (palette_png, True),
    }


@pytest.mark.parametrize("name", list(_png_chunk_cases()))
def test_png_chunk_rules_answer_as_cv2(name):
    """How cv2 reads the chunks: IEND whole but its CRC unchecked, an
    ancillary chunk with a bad CRC dropped, a critical one refused, IDATs
    consecutive, palette indices past PLTE black (libpng's 256 entries)."""
    data, decodes = _png_chunk_cases()[name]
    assert (cv2_decode(data) is not None) == decodes
    assert answers(data) in ("none", "equal")


# -- what is still refused -----------------------------------------------------------

def _refused():
    img = image(16, 24, seed=3)
    base = encode(img, 75, "420")
    sof = base.index(b"\xff\xc0") + 1
    cases = {
        "lossless": (patch_sof(base, 0xC3), "lossless", False),
        "12-bit": (base[:sof + 3] + bytes([12]) + base[sof + 4:], "precision", False),
        "hierarchical": (patch_sof(base, 0xC5), "hierarchical", False),
    }
    # AVIF is decoded since, 8-bit stills of any subsampling, matrix and
    # range, lossless and lossy, deblocked and CDEF-filtered
    # (tests/test_torch_avif.py, test_torch_avif_lossy.py,
    # test_torch_avif_chroma.py, test_torch_avif_colour.py,
    # test_torch_avif_deblock.py, test_torch_avif_cdef.py), and so are
    # frames whose loop restoration runs (test_torch_avif_restoration.py:
    # cv2's default quality at speed 4 of this photo-like image, once the
    # case here), but not a frame with film grain, ``imcodec.AVIF_UNPORTED``:
    # Pillow's 4:2:0 file with libaom's film grain test vector 1 is refused
    # with a line naming A14.7b
    from test_torch_avif import pil_avif, smooth

    grain = pil_avif(smooth(64, 96, 3, 9), quality=60, subsampling="4:2:0", speed=6,
                     advanced=[("enable-cdef", "0"), ("enable-restoration", "0"), ("loopfilter-control", "0"),
                               ("film-grain-test", "1")])
    cases["avif"] = (grain, "superres and film grain (ROADMAP A14.7b)", True)
    # WebP is decoded since, lossless and lossy (tests/test_torch_webp.py,
    # tests/test_torch_webp_lossy.py)
    # TIFF is decoded since, JPEG-compressed too, but not the compressions
    # of ``imcodec.TIFF_UNPORTED``: a ThunderScan (32809) TIFF of 4-bit
    # palette indices, which cv2 decodes (its libtiff's NeXT codec takes
    # only 2-bit samples, which OpenCV refuses: no NeXT TIFF decodes there)
    from test_torch_tiff import colormap, tiff_bytes

    thunder = tiff_bytes(img[..., 0] >> 4, bits=4, photometric=3, compression=32809, colormap=colormap(4, 1))
    cases["tiff"] = (thunder, "compression ThunderScan (32809) is not decoded", True)
    # decoded since, refused where cv2 refuses them: a GIF of another
    # version, a PFM signature ended by a carriage return, an XYZE HDR
    gif, pfm, hdr = (cv2.imencode(ext, img)[1].tobytes() for ext in (".gif", ".pfm", ".hdr"))
    cases["gif"] = (b"GIF90a" + gif[6:], "the version", False)
    cases["pfm"] = (pfm.replace(b"PF\n", b"PF\r", 1), "no line break", False)
    cases["hdr"] = (hdr.replace(b"rle_rgbe", b"rle_xyze", 1), "no FORMAT=32-bit_rle_rgbe line", False)
    # JPEG 2000 is decoded since (tests/test_torch_jpeg2000.py), but not HT
    # (Part 15) code-blocks, ``imcodec.J2K_UNPORTED``: Pillow's JP2 with the
    # HT bit set in its COD marker's code-block style is refused with a line
    # naming them (cv2's HT decoder cannot read the MQ-coded blocks either)
    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(buf, "JPEG2000")
    jp2 = bytearray(buf.getvalue())
    jp2[jp2.index(b"\xff\x52") + 12] |= 0x40
    cases["jpeg2000"] = (bytes(jp2), "HT (Part 15) code-blocks (ROADMAP A18)", False)
    return cases


@pytest.mark.parametrize("name", ["lossless", "12-bit", "hierarchical", "tiff", "jpeg2000", "avif", "gif", "pfm",
                                  "hdr"])
def test_what_is_still_refused_gives_none_and_a_log_line_naming_it(name, caplog):
    """The refusals that remain. The JPEG, GIF, PFM and HDR ones are cv2's
    own on these files; a TIFF whose compression is one of
    ``imcodec.TIFF_UNPORTED`` (ThunderScan here) is decoded by cv2 and not
    by the port: the known difference, held here so that it cannot grow
    unnoticed. A JPEG 2000 file is refused only for what
    ``imcodec.J2K_UNPORTED`` names (HT code-blocks here), an AVIF file only
    for what ``imcodec.AVIF_UNPORTED`` names (film grain here).
    No WebP is refused for its kind any more, and no format is left
    undecoded (``imcodec.FORMAT_NAMES`` is empty)."""
    data, reason, cv2_decodes = _refused()[name]
    assert (cv2_decode(data) is not None) == cv2_decodes
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is None
    assert reason in caplog.text
    assert not imcodec.FORMAT_NAMES
    assert set(imcodec.TIFF_UNPORTED) == {32766, 32809, 34676, 34677}
    assert not hasattr(imcodec, "WEBP_UNPORTED")


def test_cv2s_quality_95_avif_of_the_refused_image_decodes_as_cv2():
    """The image of the refused cases above as cv2 writes it at quality
    95: 4:2:0, BT.601 in full range, every in-loop filter off; the port
    gives cv2's pixels."""
    img = image(16, 24, seed=3)
    data = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, 95])[1].tobytes()
    got = port_decode(data)
    assert got is not None and got.shape == img.shape and answers(data) == "equal"


def test_a_damaged_zlib_stream_under_a_valid_crc_is_the_known_png_difference():
    """One byte of a 1-bit Adam7 palette PNG's zlib stream changed and the
    CRC made valid again: libpng fills every row (rows 7, 9 and 11 come out
    other than the undamaged file's) and meets "invalid distance too far
    back" only in the drain after the last row, a warning; cv2 returns the
    image, and the port, replaying libpng's inflate calls, returns the same
    pixels (ROADMAP C2; more damaged streams:
    ``tests/test_torch_image_formats.py``)."""
    clean = png_case(3, 1, 13, 21, seed=3)
    data = bytearray(clean)
    at = data.index(b"IDAT")
    length = struct.unpack(">I", data[at - 4 : at])[0]
    data[125] = 0x1A
    data[at + 4 + length : at + 8 + length] = struct.pack(
        ">I", zlib.crc32(bytes(data[at : at + 4 + length])) & 0xFFFFFFFF)
    want = cv2_decode(bytes(data))
    assert want is not None
    got = port_decode(bytes(data))
    assert got is not None and answers(bytes(data)) == "equal"
    assert np.flatnonzero((got != port_decode(clean)).any(axis=(1, 2))).tolist() == [7, 9, 11]
