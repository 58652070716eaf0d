"""The port's JPEG-compressed TIFFs (compression 7: ``utils/imcodec.py`` with
``csrc/tiff.cpp`` and ``csrc/jpeg.cpp``) against ``cv2.imdecode(buf,
IMREAD_COLOR)`` and ``cv2.imread`` (OpenCV 5.0, libtiff 4.7.1 over
libjpeg-turbo 3.1): the same ``None`` or not, and 0 differing pixels.

The files are ``test_torch_tiff.tiff_bytes`` with one ``cv2.imencode`` JPEG
(or a stream made from one) per strip or tile, and PIL's own
``compression="jpeg"`` files. Each rule of libtiff's tif_jpeg.c that the
port reproduces has its named kind, cv2's answer pinned beside it:

* contiguous YCbCr is converted by libjpeg (``TIFFRGBAImageBegin`` sets
  JPEGCOLORMODE_RGB): the pixels are ``cv2.imdecode`` of the bare stream,
  at 4:2:0, 4:2:2, 4:4:4, 4:1:1 and 4:4:0, when YCbCrSubsampling agrees
  with the stream; a tag that disagrees refuses the file
  (``JPEGPreDecode``), an absent one is read from the first strip's SOF
  (``JPEGFixupTagsSubsampling``);
* any other photometric takes the stream's components as its samples:
  an RGB photometric over a YCbCr stream shows Y, Cb, Cr as R, G, B, and a
  subsampled one is refused; grey, MinIsWhite, CMYK (PIL's Adobe stream,
  stored inverted), separate planes, grey + alpha from a two-component
  stream;
* the JPEGTables tag: abbreviated strips decode with it and are refused
  without it; a tag that holds a scan is refused, one cut short ends at a
  fake EOI; its entry is read as any byte array (BYTE, ASCII, SHORT, LONG
  ...), an unreadable one is dropped; the tables also carry over from a
  strip to the next;
* a strip that runs out ends at a fake EOI (``std_fill_input_buffer``):
  a cut strip decodes as far as it goes, where the same bare stream is
  refused;
* the frame against the strip or tile: smaller leaves zeros, larger is
  refused except for a last strip of the same width;
* FillOrder 2 is ignored (TIFF_NOBITREV); several strips, tiles and edge
  tiles, BigTIFF, big-endian, the orientation, progressive and
  arithmetic-coded strips, restart intervals; component count, precision
  and frame mismatches; corrupt entropy data and a bad Huffman table.

Then garbled, cut and damaged files, files read by path, and a JPEG TIFF
through both packages' services.
"""

import io
import logging
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch.utils import imcodec
from test_torch_decode_parity import cmyk_jpeg, patch_sof
from test_torch_tiff import answers, assert_all_equal_cv2, compare, cv2_decode, garbled, port_decode, small_enough
from test_torch_tiff import tiff_bytes

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}
SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}


# -- the writer ---------------------------------------------------------------


def scene(h, w, seed) -> np.ndarray:
    """[h, w, 3] RGB, smooth enough for a JPEG to keep its shapes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (yy * 4 + xx * 3)[..., None] + np.arange(3) * 80 + rng.integers(0, 60, (h, w, 3))
    return cv2.GaussianBlur((base % 256).astype(np.uint8), (5, 5), 1.2)


def jpeg(rgb: np.ndarray, sampling="420", quality=90, restart=0, progressive=False) -> bytes:
    """cv2's JPEG of an RGB (or grey) array: JFIF, YCbCr, standard Huffman
    tables."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if rgb.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    img = np.ascontiguousarray(rgb[..., ::-1] if rgb.ndim == 3 else rgb, np.uint8)
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def jpeg_segments(data: bytes) -> list:
    """[(marker, bytes)] of a stream's header, then (0xDA, the first scan to
    the end)."""
    out, at = [(0xD8, data[:2])], 2
    while data[at + 1] != 0xDA:
        end = at + 2 + struct.unpack(">H", data[at + 2 : at + 4])[0]
        out.append((data[at + 1], data[at:end]))
        at = end
    return out + [(0xDA, data[at:])]


def split_tables(data: bytes):
    """(a tables-only stream of the DQT and DHT segments, the abbreviated
    stream without them)."""
    segs = jpeg_segments(data)
    tables = b"\xff\xd8" + b"".join(s for m, s in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
    return tables, b"".join(s for m, s in segs if m not in (0xDB, 0xC4))


def two_components(a: bytes, b: bytes) -> bytes:
    """Two grey cv2 JPEGs of one size as one two-component sequential
    stream, a scan each (``b``'s tables renumbered 1)."""
    sa, sb = jpeg_segments(a), jpeg_segments(b)
    seg = lambda segs, m: next(s for k, s in segs if k == m)
    dqt = seg(sb, 0xDB)
    dqt = dqt[:4] + bytes([dqt[4] | 1]) + dqt[5:]
    dhts = []
    for s in (s for k, s in sb if k == 0xC4):
        dhts.append(s[:4] + bytes([s[4] | 1]) + s[5:])
    sof = seg(sa, 0xC0)
    sof = sof[:2] + struct.pack(">H", 14) + sof[4:9] + b"\x02" + sof[10:13] + b"\x02\x11\x01"
    scan = lambda segs, cid, tables: b"\xff\xda\x00\x08\x01" + bytes([cid, tables, 0, 63, 0]) + segs[-1][1][10:-2]
    return (b"\xff\xd8" + seg(sa, 0xDB) + dqt + sof + b"".join(s for k, s in sa if k == 0xC4) + b"".join(dhts)
            + scan(sa, 1, 0x00) + scan(sb, 2, 0x11) + b"\xff\xd9")


def jpeg_tiff(rgb, stream=None, photometric=6, sub=None, tables=None, extra=(), **kw) -> bytes:
    """A JPEG TIFF of ``rgb``: ``stream`` is a function of a block's
    samples (RGB, tile padding included) giving its JPEG (default: cv2's
    4:2:0 of it), or a list of them in block order; ``sub`` the
    YCbCrSubsampling tag, ``tables`` the JPEGTables tag's (type, values)."""
    rgb = np.asarray(rgb)
    if stream is None:
        stream = lambda b: jpeg(b.astype(np.uint8))
    elif not callable(stream):
        it = iter(stream)
        stream = lambda b: next(it)
    tags = tuple(extra)
    if sub is not None:
        tags += ((530, (3, list(sub))),)
    if tables is not None:
        tags += ((347, tables),)
    return tiff_bytes(rgb.astype(np.int64), photometric=photometric, compression=7, encode=stream, extra=tags, **kw)


def undefined(data: bytes):
    return (7, list(data))


# -- the kinds ----------------------------------------------------------------


def jpeg_tiff_cases() -> dict:
    """name → (file, whether cv2 decodes it)."""
    img = scene(48, 64, seed=1)
    base = jpeg(img)
    tables, abbrev = split_tables(base)
    cases = {}
    # contiguous YCbCr: the tag agreeing, absent (read from the SOF) and disagreeing
    for s, sub in SUBSAMPLING.items():
        data = jpeg(img, s)
        cases[f"ycbcr_{s}_tag_agrees"] = (jpeg_tiff(img, [data], sub=sub), True)
        cases[f"ycbcr_{s}_tag_absent"] = (jpeg_tiff(img, [data]), True)
    cases["ycbcr_444_tag_22"] = (jpeg_tiff(img, [jpeg(img, "444")], sub=(2, 2)), False)
    cases["ycbcr_420_tag_11"] = (jpeg_tiff(img, [jpeg(img, "420")], sub=(1, 1)), False)
    cases["ycbcr_422_tag_12"] = (jpeg_tiff(img, [jpeg(img, "422")], sub=(1, 2)), False)
    cases["ycbcr_tag_33"] = (jpeg_tiff(img, [base], sub=(3, 3)), False)
    # the SOF read for an absent tag: after other segments, a second strip of
    # other sampling, chroma not 1x1 (no correction: the default 2, 2 stays)
    cases["ycbcr_tag_absent_app_before_sof"] = (jpeg_tiff(img, [base[:2] + b"\xff\xe5\x00\x06abcd"
                                                                + b"\xff\xfe\x00\x03x" + base[2:]]), True)
    cases["ycbcr_tag_absent_second_strip_444"] = (jpeg_tiff(img, [jpeg(img[:24]), jpeg(img[24:], "444")],
                                                            rows=24), False)
    sof = base.index(b"\xff\xc0")
    chroma22 = bytearray(base)
    chroma22[sof + 13] = chroma22[sof + 16] = 0x22
    cases["ycbcr_tag_absent_chroma_22"] = (jpeg_tiff(img, [bytes(chroma22)]), False)
    cases["ycbcr_tag_absent_444_first_strip_cut"] = (jpeg_tiff(img, [jpeg(img, "444")[:sof + 12]]), False)
    # other photometrics: the components as stored
    cases["rgb_over_ycbcr_444"] = (jpeg_tiff(img, [jpeg(img, "444")], photometric=2), True)
    cases["rgb_over_ycbcr_420"] = (jpeg_tiff(img, [base], photometric=2), False)
    grey = img[..., 1]
    cases["grey"] = (jpeg_tiff(grey, [jpeg(grey)], photometric=1), True)
    cases["miniswhite"] = (jpeg_tiff(grey, [jpeg(grey)], photometric=0), True)
    cases["grey_strips_of_16"] = (jpeg_tiff(grey, lambda b: jpeg(b[..., 0].astype(np.uint8)), photometric=1,
                                            rows=16), True)
    cases["three_components_under_grey"] = (jpeg_tiff(grey, [base], photometric=1), False)
    cases["grey_under_rgb"] = (jpeg_tiff(img, [jpeg(grey)], photometric=2), False)
    cmyk = np.concatenate([img, img[..., :1]], axis=2)
    for name, sub in (("cmyk", 0), ("cmyk_subsampled", 2)):
        buf = io.BytesIO()
        Image.fromarray(cmyk.astype(np.uint8), "CMYK").save(buf, "JPEG", quality=90, subsampling=sub)
        cases[name] = (jpeg_tiff(cmyk, [buf.getvalue()], photometric=5), sub == 0)
    cases["cmyk_pil_writer"] = (jpeg_tiff(cmyk, [cmyk_jpeg(48, 64, seed=3)], photometric=5), True)
    planes = [jpeg(img[..., k]) for k in range(3)]
    cases["rgb_planar"] = (jpeg_tiff(img, planes, photometric=2, planar=2), True)
    cases["rgb_planar_tiles"] = (jpeg_tiff(img, lambda b: jpeg(b[..., 0].astype(np.uint8)), photometric=2,
                                           planar=2, tile=(32, 32)), True)
    cases["rgb_planar_bad_second_plane"] = (jpeg_tiff(img, [planes[0], planes[1][:20], planes[2]], photometric=2,
                                                      planar=2), True)
    cases["ycbcr_planar_11"] = (jpeg_tiff(img, planes, planar=2, sub=(1, 1)), True)
    alpha = img[..., 2]
    cases["grey_alpha_two_components"] = (jpeg_tiff(np.stack([grey, alpha], -1), [two_components(jpeg(grey),
                                                                                                 jpeg(alpha))],
                                                    photometric=1, extra=((338, (3, [2])),)), True)
    # JPEGTables
    cases["tables_abbreviated"] = (jpeg_tiff(img, [abbrev], tables=undefined(tables)), True)
    cases["no_tables_abbreviated"] = (jpeg_tiff(img, [abbrev]), False)
    cases["tables_full_streams"] = (jpeg_tiff(img, [base], tables=undefined(tables)), True)
    cases["tables_empty_full_streams"] = (jpeg_tiff(img, [base], tables=(7, [])), True)
    cases["tables_soi_eoi_only"] = (jpeg_tiff(img, [base], tables=undefined(b"\xff\xd8\xff\xd9")), True)
    cases["tables_holding_a_scan"] = (jpeg_tiff(img, [base], tables=undefined(base)), False)
    cases["tables_holding_a_frame"] = (jpeg_tiff(img, [abbrev], tables=undefined(
        tables[:-2] + base[sof : sof + 19] + b"\xff\xd9")), False)
    cases["tables_without_eoi"] = (jpeg_tiff(img, [abbrev], tables=undefined(tables[:-2])), True)
    cases["tables_without_soi"] = (jpeg_tiff(img, [abbrev], tables=undefined(tables[2:])), False)
    cases["tables_with_dri"] = (jpeg_tiff(img, [abbrev], tables=undefined(
        tables[:-2] + b"\xff\xdd\x00\x04\x00\x01\xff\xd9")), True)
    for cut in (40, 180, 420):
        cases[f"tables_cut_{cut}"] = (jpeg_tiff(img, [abbrev], tables=undefined(tables[:-cut])), cut == 40)
    cases["tables_quant_only"] = (jpeg_tiff(img, [b"".join(s for m, s in jpeg_segments(base) if m != 0xDB)],
                                            tables=undefined(tables)), True)
    for typ in (1, 2, 3, 4, 16):
        cases[f"tables_type{typ}"] = (jpeg_tiff(img, [abbrev], tables=(typ, list(tables))), True)
    signed = [v - 256 if v > 127 else v for v in tables]
    cases["tables_sbyte_negative_dropped"] = (jpeg_tiff(img, [abbrev], tables=(6, signed)), False)
    cases["tables_sbyte_negative_full_streams"] = (jpeg_tiff(img, [base], tables=(6, signed)), True)
    cases["tables_short_256_dropped"] = (jpeg_tiff(img, [abbrev], tables=(3, list(tables) + [256])), False)
    cases["tables_float_dropped"] = (jpeg_tiff(img, [base], tables=(11, list(tables))), True)
    a, b = jpeg(img[:24]), jpeg(img[24:])
    cases["tables_carried_to_the_next_strip"] = (jpeg_tiff(img, [a, split_tables(b)[1]], rows=24), True)
    cases["first_strip_abbreviated_second_full"] = (jpeg_tiff(img, [split_tables(a)[1], b], rows=24), False)
    # strips and tiles
    cases["strips_last_shorter"] = (jpeg_tiff(img, lambda b: jpeg(b.astype(np.uint8)), rows=20), True)
    cases["strips_of_odd_rows"] = (jpeg_tiff(img, lambda b: jpeg(b.astype(np.uint8), "422"), rows=7,
                                             sub=(2, 1)), True)
    cases["last_strip_taller"] = (jpeg_tiff(img, [jpeg(img[:32]), jpeg(scene(32, 64, seed=2))], rows=32), True)
    cases["first_strip_taller"] = (jpeg_tiff(img, [jpeg(img[:40]), jpeg(img[32:])], rows=32), False)
    cases["last_strip_taller_and_narrower"] = (jpeg_tiff(img, [jpeg(img[:32]), jpeg(img[16:, :56])], rows=32),
                                               False)
    cases["frame_smaller"] = (jpeg_tiff(img, [jpeg(img[:40, :50])]), True)
    cases["frame_wider"] = (jpeg_tiff(img, [jpeg(np.concatenate([img, img[:, :8]], axis=1))]), False)
    for tile in ((32, 16), (48, 32), (16, 64)):
        cases[f"tiles_{tile[0]}x{tile[1]}"] = (jpeg_tiff(img, tile=tile), True)
    cases["tiles_frame_of_the_clipped_edge"] = (jpeg_tiff(img, lambda b: jpeg(b[:16, :16].astype(np.uint8)),
                                                          tile=(48, 32)), True)
    cases["tiles_444_tag_absent"] = (jpeg_tiff(img, lambda b: jpeg(b.astype(np.uint8), "444"), tile=(32, 32)),
                                     True)
    # the container
    cases["fillorder2"] = (jpeg_tiff(img, [base], extra=((266, (3, [2])),)), True)
    reversed_bits = bytes(int(f"{v:08b}"[::-1], 2) for v in base)
    cases["fillorder2_bits_reversed"] = (jpeg_tiff(img, [reversed_bits], extra=((266, (3, [2])),)), False)
    cases["bigtiff"] = (jpeg_tiff(img, [base], big=True), True)
    cases["big_endian_tiles"] = (jpeg_tiff(img, order=">", tile=(32, 32)), True)
    cases["orientation6"] = (jpeg_tiff(img, [base], orientation=6), True)
    cases["orientation3_tiles"] = (jpeg_tiff(img, tile=(32, 32), orientation=3), True)
    cases["predictor_tag_ignored"] = (jpeg_tiff(img, [base], extra=((317, (3, [2])),)), True)
    cases["bits16_rgb"] = (jpeg_tiff(img, [jpeg(img, "444")], photometric=2, bits=16), False)
    # the streams
    cases["progressive"] = (jpeg_tiff(img, [jpeg(img, progressive=True)]), True)
    cases["arithmetic_sof9"] = (jpeg_tiff(img, [patch_sof(base, 0xC9)]), True)
    cases["arithmetic_sof10"] = (jpeg_tiff(img, [patch_sof(jpeg(img, progressive=True), 0xCA)]), True)
    cases["lossless_sof3"] = (jpeg_tiff(img, [patch_sof(base, 0xC3)]), False)
    cases["restart_interval"] = (jpeg_tiff(img, [jpeg(img, restart=2)]), True)
    cases["precision12"] = (jpeg_tiff(img, [base[: sof + 4] + b"\x0c" + base[sof + 5 :]]), False)
    cases["exif_app1"] = (jpeg_tiff(img, [base[:2] + b"\xff\xe1\x00\x10Exif\x00\x00II*\x00\x08\x00\x00\x00"
                                          + base[2:]]), True)
    scan = base.index(b"\xff\xda")
    cases["cut_half"] = (jpeg_tiff(img, [base[: len(base) // 2]]), True)
    cases["cut_before_eoi"] = (jpeg_tiff(img, [base[:-2]]), True)
    cases["cut_after_sos"] = (jpeg_tiff(img, [base[: scan + 14]]), True)
    cases["cut_in_sos"] = (jpeg_tiff(img, [base[: scan + 8]]), False)
    cases["cut_in_dht"] = (jpeg_tiff(img, [base[: base.index(b"\xff\xc4") + 10]]), False)
    cases["progressive_cut"] = (jpeg_tiff(img, [jpeg(img, progressive=True)[:-300]]), True)
    corrupt = bytearray(base)
    corrupt[scan + 40 : scan + 60] = bytes(range(7, 27))
    cases["corrupt_entropy_data"] = (jpeg_tiff(img, [bytes(corrupt)]), True)
    dht = base.index(b"\xff\xc4")
    bad_huffman = bytearray(base)
    bad_huffman[dht + 5], bad_huffman[dht + 5 + 8] = 1, 0  # a 1-bit code and the 2-bit one: over-subscribed
    cases["bad_huffman_table"] = (jpeg_tiff(img, [bytes(bad_huffman)]), False)
    cases["no_soi"] = (jpeg_tiff(img, [base[2:]]), False)
    # PIL's writer: RGB photometric, Adobe RGB streams and JPEGTables; grey
    for mode, arr in (("RGB", img), ("L", grey)):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "TIFF", compression="jpeg")
        cases[f"pil_{mode}"] = (buf.getvalue(), True)
    return cases


_CACHE = {}


def jpeg_tiff_cases_cached() -> dict:
    if not _CACHE:
        _CACHE.update(jpeg_tiff_cases())
    return _CACHE


JPEG_TIFF_CASES = list(jpeg_tiff_cases())


@pytest.mark.parametrize("name", JPEG_TIFF_CASES)
def test_jpeg_tiff_kinds_answer_as_cv2(name):
    """Each kind gives cv2's answer, which is pinned: ``None`` where libtiff
    refuses the file, else an image equal to cv2's."""
    data, decodes = jpeg_tiff_cases_cached()[name]
    assert answers(data) == ("equal" if decodes else "none")


def test_jpeg_tiff_probes_of_cv2_rules():
    """libtiff's rules, held as pixels: under contiguous YCbCr the image is
    the bare stream's ``cv2.imdecode``; under an RGB photometric it is the
    stream's Y, Cb, Cr read as R, G, B; a cut strip decodes where the cut
    bare stream does not; a frame smaller than its strip leaves zeros; a
    taller last strip gives its first rows; two strips stack; PIL's files
    equal their streams' decode."""
    img = scene(48, 64, seed=1)
    base = jpeg(img)
    tiff = lambda name: port_decode(jpeg_tiff_cases_cached()[name][0])
    assert (tiff("ycbcr_420_tag_agrees") == cv2_decode(base)).all()
    # the stream with JFIF's APP0 replaced by an Adobe segment of transform 0:
    # libjpeg then takes its components as R, G, B, with no conversion
    segs = jpeg_segments(jpeg(img, "444"))
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    raw = cv2_decode(b"\xff\xd8" + adobe + b"".join(s for m, s in segs[1:] if m != 0xE0))
    assert (tiff("rgb_over_ycbcr_444") == raw).all() and (raw != cv2_decode(jpeg(img, "444"))).any()
    half = base[: len(base) // 2]
    assert cv2_decode(half) is None and port_decode(half) is None
    cut = tiff("cut_half")
    assert 0 < (cut != cv2_decode(base)).any(axis=2).sum() < cut.shape[0] * cut.shape[1]
    small = tiff("frame_smaller")
    assert (small[:40, :50] == cv2_decode(jpeg(img[:40, :50]))).all()
    assert not small[40:].any() and not small[:, 50:].any()
    taller = tiff("last_strip_taller")
    assert (taller[32:] == cv2_decode(jpeg(scene(32, 64, seed=2)))[:16]).all()
    stacked = tiff("tables_carried_to_the_next_strip")
    assert (stacked == np.concatenate([cv2_decode(jpeg(img[:24])), cv2_decode(jpeg(img[24:]))])).all()
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, "TIFF", compression="jpeg")
    d = imcodec._TiffDir(buf.getvalue())
    tables, strip = imcodec._jpeg_tables(d), buf.getvalue()[d.ints(273)[0] : d.ints(273)[0] + d.ints(279)[0]]
    whole = cv2_decode(tables[:-2] + strip[2:])  # the tables spliced into the first strip: a whole stream
    assert (port_decode(buf.getvalue())[: whole.shape[0]] == whole).all()
    # tables and samples carry the RGB photometric through as stored
    assert imcodec._TiffDir(buf.getvalue()).one(262) == 2 and imcodec._TiffDir(buf.getvalue()).one(259) == 7


def test_what_the_port_decodes_of_tiff_is_pinned():
    """JPEG is decoded; old-style JPEG is refused as cv2 refuses it (its
    libtiff is built without it); what remains unported is named."""
    assert imcodec.TIFF_UNPORTED == {32766: "NeXT", 32809: "ThunderScan", 34676: "SGI LogL", 34677: "SGI LogLuv"}
    assert not imcodec.FORMAT_NAMES  # AVIF is decoded since (tests/test_torch_avif.py)
    assert 6 in imcodec._TIFF_NOT_CONFIGURED
    old = tiff_bytes(scene(8, 16, seed=4).astype(np.int64), compression=6)
    assert cv2_decode(old) is None and port_decode(old) is None


# -- by path ------------------------------------------------------------------

BY_PATH = ["ycbcr_420_tag_agrees", "ycbcr_422_tag_absent", "tables_abbreviated", "tiles_48x32", "rgb_planar",
           "fillorder2", "cut_half", "orientation6", "cmyk", "pil_RGB", "bigtiff"]


@pytest.mark.parametrize("name", BY_PATH)
def test_a_jpeg_tiff_read_by_path_answers_as_cv2_imread(name, tmp_path):
    """``cv2.imread`` maps the file; a JPEG block reads the same either way,
    and the orientations that turn the image are refused by path."""
    path = tmp_path / "x.tif"
    path.write_bytes(jpeg_tiff_cases_cached()[name][0])
    logging.disable(logging.WARNING)
    try:
        got = imcodec.read_image(str(path))
    finally:
        logging.disable(logging.NOTSET)
    assert compare(cv2.imread(str(path), cv2.IMREAD_COLOR), got) in ("none", "equal")


# -- garbled, cut and damaged ---------------------------------------------------

GARBLED = ["ycbcr_420_tag_agrees", "ycbcr_422_tag_absent", "tables_abbreviated", "tables_carried_to_the_next_strip",
           "strips_last_shorter", "tiles_48x32", "rgb_over_ycbcr_444", "grey_strips_of_16", "cmyk", "rgb_planar",
           "grey_alpha_two_components", "progressive", "restart_interval", "pil_RGB", "pil_L"]


@pytest.mark.parametrize("name", GARBLED)
def test_garbled_and_cut_jpeg_tiffs_answer_as_cv2(name):
    """60 seeded files per kind with 1–3 bytes changed anywhere past the
    magic (those that come to declare more than 4 Mpixels are dropped), then
    40 cuts."""
    data = jpeg_tiff_cases_cached()[name][0]
    datas = garbled(data, 60, seed=GARBLED.index(name) + 60) + [data[:k] for k in
                                                                   range(4, len(data), max(1, len(data) // 40))]
    assert_all_equal_cv2([x for x in datas if small_enough(x)], f"garbled {name}")


def damaged(data: bytes, n: int, seed: int, headers: bool):
    """``n`` copies of ``data`` with 1–3 bytes of the blocks set, zeroed or
    flipped: in the JPEG header segments (``headers``: markers, lengths,
    SOF, DQT, DHT, SOS fields) or anywhere in the blocks; or each block cut
    at a random point."""
    d = imcodec._TiffDir(data)
    spans = [(o, o + c) for o, c in zip(d.ints(273 if 273 in d.entries else 324),
                                          d.ints(279 if 279 in d.entries else 325))]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            lo, hi = spans[rng.integers(0, len(spans))]
            if headers:
                hi = lo + bytes(data[lo:hi]).find(b"\xff\xda") + 14 if b"\xff\xda" in data[lo:hi] else hi
            at = rng.integers(lo, hi)
            bad[at] = (bad[at] ^ 0xFF, 0, rng.integers(0, 256), bad[at] ^ (1 << rng.integers(0, 8)))[rng.integers(0, 4)]
        out.append(bytes(bad))
    return out


def cut_blocks(data: bytes, n: int, seed: int):
    """``n`` copies of ``data`` with one block's byte count cut at random."""
    d = imcodec._TiffDir(data)
    tag = 279 if 279 in d.entries else 325
    typ, count, at = d.entries[tag]
    counts = d.ints(tag)
    fmt = d.e + {3: "H", 4: "I", 16: "Q"}[typ]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        k = rng.integers(0, len(counts))
        struct.pack_into(fmt, bad, at + k * struct.calcsize(fmt), int(rng.integers(1, counts[k])))
        out.append(bytes(bad))
    return out


def tables_changed(data: bytes, n: int, seed: int):
    """``n`` copies of ``data`` with 1–3 bytes of the JPEGTables tag's value
    set at random, or its count cut (none when the file has no such tag)."""
    d = imcodec._TiffDir(data)
    if 347 not in d.entries:
        return []
    typ, count, value = d.entries[347]
    size = imcodec._TIFF_SIZES[typ]
    if d.big:
        entry, fmt = struct.unpack(d.e + "Q", data[8:16])[0] + 8 + 20 * d.order[347], d.e + "Q"
    else:
        entry, fmt = struct.unpack(d.e + "I", data[4:8])[0] + 2 + 12 * d.order[347], d.e + "I"
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        if rng.random() < 0.3:
            struct.pack_into(fmt, bad, entry + 4, int(rng.integers(0, count)))
        else:
            for at in rng.integers(value, value + size * count, rng.integers(1, 4)):
                bad[at] = rng.integers(0, 256)
        out.append(bytes(bad))
    return out


@pytest.mark.parametrize("name", ["tables_abbreviated", "strips_last_shorter", "tiles_48x32", "progressive",
                                  "grey_alpha_two_components", "restart_interval", "pil_RGB"])
def test_damaged_and_cut_jpeg_blocks_answer_as_cv2(name):
    """80 files with their JPEG headers damaged (a bad marker, length,
    table or frame field mostly refuses the block, and so the file), 80
    with the blocks damaged anywhere (corrupt entropy data decodes as
    libjpeg decodes it), 40 with a block's byte count cut (the block ends
    at a fake EOI) and, where there is a JPEGTables tag, 40 with its bytes
    changed or its count cut."""
    data = jpeg_tiff_cases_cached()[name][0]
    seed = len(name)
    datas = damaged(data, 80, seed, True) + damaged(data, 80, seed + 1, False) + cut_blocks(data, 40, seed + 2)
    datas += tables_changed(data, 40, seed + 3)
    assert_all_equal_cv2(datas, f"damaged {name}")


# -- through the services -------------------------------------------------------


def test_jpeg_tiff_requests_get_the_jax_services_answer(tmp_path):
    """A parity scene as a YCbCr JPEG TIFF (4:2:0, 32-row strips, with
    JPEGTables) sent as data, and as a tiled one sent by path: the JAX
    service (cv2 decodes) and the port's service answer with the same
    words, fused and staged. Both services are built with no request
    timeout: the test is about the answer."""
    import asyncio
    import base64
    import dataclasses
    import json

    import torch

    from ppocr_tpu.serve.service import OCRIPCService as JaxService
    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.serve import OCRIPCService
    from test_torch_goldens import assert_words_match, jax_config
    from test_torch_serve import small_config

    rgb = assets.load_scenes()["parity"][0][..., ::-1]
    strips = [split_tables(jpeg(rgb[y : y + 32], quality=95))[1] for y in range(0, rgb.shape[0], 32)]
    tables = split_tables(jpeg(rgb[:32], quality=95))[0]
    as_data = jpeg_tiff(rgb, strips, rows=32, sub=(2, 2), tables=undefined(tables))
    tiled = jpeg_tiff(rgb, lambda b: jpeg(b.astype(np.uint8), "444", 95), tile=(128, 64))
    for data in (as_data, tiled):
        assert answers(data) == "equal"
    path = tmp_path / "scene.tif"
    path.write_bytes(tiled)
    assert (cv2.imread(str(path)) == imcodec.read_image(str(path))).all()
    lines = [json.dumps({"command": "recognize", "image_data": base64.b64encode(as_data).decode()}).encode(),
             json.dumps({"command": "recognize", "image_path": str(path)}).encode()]
    model_dir = str(assets.make_jumbo_model_dir(tmp_path / "jumbo"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several test processes at once
    try:
        for changes in ({}, {"fast_path": False}):
            cfg = small_config(**changes)
            jax_svc = JaxService(model_dir, socket_path=str(tmp_path / "j.sock"),
                                 config=jax_config(dataclasses.asdict(cfg)), request_timeout_ms=0)
            svc = OCRIPCService(model_dir=model_dir, socket_path=str(tmp_path / "p.sock"), config=cfg, device="cpu",
                                request_timeout_ms=0)
            for line in lines:
                want, got = (asyncio.run(s.process_request(line)) for s in (jax_svc, svc))
                assert want["success"] and got["success"] and got["words"], (changes, got, want)
                assert_words_match(got.pop("words"), want.pop("words"), 2e-3)
                for r in (want, got):  # the times
                    r.pop("processing_time_ms", None)
                    r.pop("stage_times", None)
                assert got == want, (changes, got, want)
    finally:
        torch.set_num_threads(threads)
