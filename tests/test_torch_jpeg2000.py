"""The port's JPEG 2000 decoder (``utils/imcodec.py`` for the JP2 boxes and
cv2's hand-over, ``csrc/jpeg2000.cpp`` for the codestream, OpenJPEG 2.5.3's
arithmetic and control flow) against ``cv2.imdecode(buf, IMREAD_COLOR)`` and
``cv2.imread`` (OpenCV 5.0 with OpenJPEG 2.5.3 built in): the same ``None``
or not, and 0 differing pixels.

The files come from cv2's own ``.jp2`` writer (sizes, colour and grey, its
compression ratios), from Pillow's (OpenJPEG 2.5.4: JP2 and raw J2K, each
option it exposes, lossless and lossy, modes L, LA, RGB, RGBA and I;16), from
libopenjp2's encoder driven through ctypes (``opj_encode``: the code-block
mode switches, SOP/EPH, POC, ROI, sub-sampled and signed components,
precisions 1 to 16), and from the writers here: JP2 boxes around a
codestream (``jp2_file``: colour spaces, ICC and unknown methods, cdef,
pclr/cmap, misplaced, missing and odd boxes), COM markers, and packed packet
headers (``packed_headers``: PPM and PPT made from a file's own headers).
Then cut, XOR-ed and mutated files (``mutations``, also the fuzz's), and
files read by path.

What cv2 refuses, the port refuses with a log line: cv2's hand-over takes 1
to 4 unsigned components of 8 bits or more, an sRGB (or unknown) image of 3
or 4 components, a grey one, an sYCC one of 3 or more, no image origin
other than 0 and no sub-sampled component. ``imcodec.J2K_UNPORTED`` lists
what cv2 decodes and the port does not (HT code-blocks).
"""

import ctypes
import ctypes.util
import io
import logging
import os
import struct
import tempfile

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.utils import imcodec
from test_torch_tiff import answers, compare, cv2_decode, port_decode

# -- encoders ----------------------------------------------------------------------


def noise(h, w, c, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c) if c else (h, w)).astype(np.uint8)


def smooth(h, w, seed):
    """A picture with edges and gradients: a lossy file's layers matter."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    out = []
    for c in range(3):
        a, b, p = rs.uniform(0.05, 0.4, 3)
        out.append(127 + 80 * np.sin(a * xx + p) * np.cos(b * yy) + 40 * ((xx + 2 * yy + 7 * c) % 23 > 11))
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def pil_j2k(img, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def cv2_jp2(img, x1000=None) -> bytes:
    params = [] if x1000 is None else [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000]
    ok, buf = cv2.imencode(".jp2", img, params)
    return np.asarray(buf).tobytes() if ok else None


# libopenjp2's encoder (the system's, OpenJPEG 2.5) through ctypes: the
# structures are openjpeg.h's (OpenJPEG 2.5) field for field

_PATH_LEN, _MAXRLVLS, _JPWL = 4096, 33, 16


class _Poc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
                                               "precno0", "precno1")] + [
        ("prg1", ctypes.c_int), ("prg", ctypes.c_int), ("progorder", ctypes.c_char * 5), ("tile", ctypes.c_uint32)] + [
        (n, ctypes.c_uint32) for n in ("tx0", "tx1", "ty0", "ty1", "layS", "resS", "compS", "prcS", "layE", "resE",
                                       "compE", "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t",
                                       "comp_t", "prc_t", "tx0_t", "ty0_t")]


class _CParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy", "cp_disto_alloc",
                                            "cp_fixed_alloc", "cp_fixed_quality")] + [
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p), ("csty", ctypes.c_int),
        ("prog_order", ctypes.c_int), ("POC", _Poc * 32), ("numpocs", ctypes.c_uint32),
        ("tcp_numlayers", ctypes.c_int), ("tcp_rates", ctypes.c_float * 100),
        ("tcp_distoratio", ctypes.c_float * 100)] + [
        (n, ctypes.c_int) for n in ("numresolution", "cblockw_init", "cblockh_init", "mode", "irreversible",
                                    "roi_compno", "roi_shift", "res_spec")] + [
        ("prcw_init", ctypes.c_int * _MAXRLVLS), ("prch_init", ctypes.c_int * _MAXRLVLS),
        ("infile", ctypes.c_char * _PATH_LEN), ("outfile", ctypes.c_char * _PATH_LEN), ("index_on", ctypes.c_int),
        ("index", ctypes.c_char * _PATH_LEN)] + [
        (n, ctypes.c_int) for n in ("image_offset_x0", "image_offset_y0", "subsampling_dx", "subsampling_dy",
                                    "decod_format", "cod_format", "jpwl_epc_on", "jpwl_hprot_MH")] + [
        ("jpwl_hprot_TPH_tileno", ctypes.c_int * _JPWL), ("jpwl_hprot_TPH", ctypes.c_int * _JPWL),
        ("jpwl_pprot_tileno", ctypes.c_int * _JPWL), ("jpwl_pprot_packno", ctypes.c_int * _JPWL),
        ("jpwl_pprot", ctypes.c_int * _JPWL)] + [
        (n, ctypes.c_int) for n in ("jpwl_sens_size", "jpwl_sens_addr", "jpwl_sens_range", "jpwl_sens_MH")] + [
        ("jpwl_sens_TPH_tileno", ctypes.c_int * _JPWL), ("jpwl_sens_TPH", ctypes.c_int * _JPWL),
        ("cp_cinema", ctypes.c_int), ("max_comp_size", ctypes.c_int), ("cp_rsiz", ctypes.c_int),
        ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char), ("jpip_on", ctypes.c_int),
        ("mct_data", ctypes.c_void_p), ("max_cs_size", ctypes.c_int), ("rsiz", ctypes.c_uint16)]


class _CompParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                               "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
        ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_ImageComp)), ("icc_profile_buf", ctypes.c_void_p),
        ("icc_profile_len", ctypes.c_uint32)]


_OPJ = []


def openjpeg():
    if not _OPJ:
        lib = ctypes.CDLL(ctypes.util.find_library("openjp2") or "libopenjp2.so.7")
        vp = ctypes.c_void_p
        lib.opj_set_default_encoder_parameters.argtypes = [ctypes.POINTER(_CParams)]
        lib.opj_image_create.restype = ctypes.POINTER(_Image)
        lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.POINTER(_CompParm), ctypes.c_int]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
        lib.opj_create_compress.restype = vp
        lib.opj_create_compress.argtypes = [ctypes.c_int]
        lib.opj_setup_encoder.argtypes = [vp, ctypes.POINTER(_CParams), ctypes.POINTER(_Image)]
        lib.opj_stream_create_default_file_stream.restype = vp
        lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
        for f in ("opj_start_compress",):
            getattr(lib, f).argtypes = [vp, ctypes.POINTER(_Image), vp]
        lib.opj_encode.argtypes = [vp, vp]
        lib.opj_end_compress.argtypes = [vp, vp]
        lib.opj_stream_destroy.argtypes = [vp]
        lib.opj_destroy_codec.argtypes = [vp]
        _OPJ.append(lib)
    return _OPJ[0]


def opj_encode(planes, prec=8, sgnd=0, jp2=False, sub=None, tile=None, rates=(0,), irreversible=False, mode=0,
               csty=0, resolutions=6, cblk=(64, 64), precincts=None, order=0, pocs=(), roi=None, mct=None,
               tile_parts=None):
    """Integer planes [C, H, W] → libopenjp2's codestream (or JP2 file), or
    None where its encoder refuses the parameters. ``sub``: each component's
    (dx, dy) (the plane's every dx-th sample); ``mode``: the code-block
    style bits (1 BYPASS, 2 RESET, 4 TERMALL, 8 VSC, 16 PTERM, 32 SEGSYM);
    ``csty``: 2 SOP, 4 EPH; ``pocs``: (res0, comp0, lay1, res1, comp1,
    progression) each; ``roi``: (component, shift); ``tile_parts``: b"R",
    b"L" or b"C", a tile-part for each resolution, layer or component."""
    lib = openjpeg()
    planes = [np.asarray(p, np.int32) for p in planes]
    n = len(planes)
    h, w = planes[0].shape
    sub = sub or [(1, 1)] * n
    parms = (_CompParm * n)()
    for i, (dx, dy) in enumerate(sub):
        parms[i].dx, parms[i].dy = dx, dy
        parms[i].w, parms[i].h = -(-w // dx), -(-h // dy)
        parms[i].prec, parms[i].sgnd = prec, sgnd
    image = lib.opj_image_create(n, parms, 0)
    img = image.contents
    img.x1, img.y1 = w, h
    for i, (dx, dy) in enumerate(sub):
        src = np.ascontiguousarray(planes[i][::dy, ::dx])
        ctypes.memmove(img.comps[i].data, src.ctypes.data, src.nbytes)
    p = _CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    if tile:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tile
    p.tcp_numlayers = len(rates)
    for i, r in enumerate(rates):
        p.tcp_rates[i] = r
    p.cp_disto_alloc = 1
    p.irreversible, p.mode, p.csty, p.numresolution = int(irreversible), mode, csty, resolutions
    p.cblockw_init, p.cblockh_init = cblk
    if precincts:
        p.csty |= 1
        p.res_spec = len(precincts)
        for i, (pw, ph) in enumerate(precincts):
            p.prcw_init[i], p.prch_init[i] = pw, ph
    p.prog_order = order
    for i, (res0, comp0, lay1, res1, comp1, prg) in enumerate(pocs):
        poc = p.POC[i]
        poc.tile, poc.resno0, poc.compno0, poc.layno1, poc.resno1, poc.compno1, poc.prg1 = (
            1, res0, comp0, lay1, res1, comp1, prg)
    p.numpocs = len(pocs)
    if roi:
        p.roi_compno, p.roi_shift = roi
    if mct is not None:
        p.tcp_mct = bytes([mct])
    if tile_parts:
        p.tp_on, p.tp_flag = b"\x01", tile_parts
    codec = lib.opj_create_compress(2 if jp2 else 0)
    fd, path = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
    os.close(fd)
    out = None
    try:
        if lib.opj_setup_encoder(codec, ctypes.byref(p), image):
            stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
            ok = lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream) and \
                lib.opj_end_compress(codec, stream)
            lib.opj_stream_destroy(stream)
            if ok:
                with open(path, "rb") as f:
                    out = f.read()
    finally:
        os.unlink(path)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
    return out


# -- writers: JP2 boxes, markers, packed headers -------------------------------------


def box(kind: bytes, body: bytes, length=None) -> bytes:
    return struct.pack(">I", 8 + len(body) if length is None else length) + kind + body


def ihdr(w, h, nc, bpc=7) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs=16, meth=1) -> bytes:
    return box(b"colr", struct.pack(">BBB", meth, 0, 0) + (struct.pack(">I", enumcs) if meth == 1 else b"ICC!"))


def codestream_size(cs: bytes):
    """(width, height, components) of a codestream's SIZ marker."""
    x1, y1, x0, y0 = struct.unpack(">IIII", cs[8:24])
    return x1 - x0, y1 - y0, struct.unpack(">H", cs[40:42])[0]


def jp2_file(cs: bytes, header: bytes = None, before: bytes = b"", after: bytes = b"", enumcs=16,
             extra: bytes = b"") -> bytes:
    """A JP2 file around codestream ``cs``: signature, file type, ``before``,
    a JP2 header box (``header``, or ihdr + colr(``enumcs``) + ``extra``),
    ``after``, then the codestream box."""
    w, h, nc = codestream_size(cs)
    if header is None:
        header = ihdr(w, h, nc) + colr(enumcs) + extra
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ") + before
            + box(b"jp2h", header) + after + box(b"jp2c", cs))


def codestream_of(jp2: bytes) -> bytes:
    return jp2[jp2.index(b"jp2c") + 4:]


def markers(cs: bytes):
    """[(offset, marker, segment length or 0)] of the main and tile-part
    headers, with each SOD's tile data skipped by Psot."""
    out, pos = [], 2
    out.append((0, 0xFF4F, 0))
    sot = None
    while pos + 4 <= len(cs):
        m, length = struct.unpack(">HH", cs[pos:pos + 4])
        if m == 0xFF93:
            out.append((pos, m, 0))
            psot = struct.unpack(">I", cs[sot + 6:sot + 10])[0]
            pos = sot + psot if psot else len(cs) - 2
            continue
        if m == 0xFFD9:
            out.append((pos, m, 0))
            break
        if m == 0xFF90:
            sot = pos
        out.append((pos, m, length))
        pos += 2 + length
    return out


def with_marker(cs: bytes, marker: bytes, where="main") -> bytes:
    """``marker`` (a whole segment) put just before the first SOT (main
    header) or just before the first SOD (the first tile-part header, its
    Psot grown to match)."""
    if where == "main":
        at = cs.index(b"\xff\x90")
        return cs[:at] + marker + cs[at:]
    sot = cs.index(b"\xff\x90")
    sod = cs.index(b"\xff\x93", sot)
    psot = struct.unpack(">I", cs[sot + 6:sot + 10])[0]
    head = cs[:sot + 6] + struct.pack(">I", psot + len(marker) if psot else 0) + cs[sot + 10:sod]
    return head + marker + cs[sod:]


def segment(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def packed_headers(cs: bytes, where: str) -> bytes:
    """A one-tile, one-tile-part codestream written with SOP and EPH
    markers, its packet headers (each up to and with its EPH) moved into PPM
    (main header) or PPT (tile-part header) segments; the tile data keeps
    each SOP and packet body."""
    sot = cs.index(b"\xff\x90")
    sod = cs.index(b"\xff\x93", sot)
    data = cs[sod + 2:-2]
    heads, bodies = [], []
    starts = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0x91] + [len(data)]
    for a, b in zip(starts, starts[1:]):
        packet = data[a:b]
        eph = packet.index(b"\xff\x92", 6) + 2
        heads.append(packet[6:eph])
        bodies.append(packet[:6] + packet[eph:])
    headers, tile = b"".join(heads), b"".join(bodies)
    chunks = [headers[i:i + 30000] for i in range(0, len(headers), 30000)] or [b""]
    if where == "ppm":
        body = struct.pack(">I", len(headers)) + headers
        parts = [body[i:i + 30000] for i in range(0, len(body), 30000)]
        main = b"".join(segment(0xFF60, bytes([z]) + part) for z, part in enumerate(parts))
        tph = cs[sot + 12:sod]
    else:
        main = b""
        tph = cs[sot + 12:sod] + b"".join(segment(0xFF61, bytes([z]) + c) for z, c in enumerate(chunks))
    psot = 12 + len(tph) + 2 + len(tile)
    return cs[:sot] + main + cs[sot:sot + 6] + struct.pack(">I", psot) + cs[sot + 10:sot + 12] + tph + \
        b"\xff\x93" + tile + b"\xff\xd9"


def tile_parts(cs: bytes):
    """(main header, [(tile index, tile-part bytes from its SOT)], tail) of a
    codestream whose tile-parts all give Psot."""
    first = cs.index(b"\xff\x90")
    parts, pos = [], first
    while cs[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack(">HI", cs[pos + 4:pos + 10])
        parts.append((isot, cs[pos:pos + psot]))
        pos += psot
    return cs[:first], parts, cs[pos:]


def reorder_tile_parts(cs: bytes, how: str) -> bytes:
    """The tile-parts of ``cs`` interleaved across tiles (each tile's in
    their order): "round_robin" (part k of every tile, then k + 1),
    "tiles_reversed" (the last tile's parts first); or rewritten: "tnsot0"
    (every TNsot 0), "last_psot0" (the last tile-part's Psot 0)."""
    head, parts, tail = tile_parts(cs)
    if how in ("round_robin", "tiles_reversed"):
        by_tile = {}
        for isot, part in parts:
            by_tile.setdefault(isot, []).append(part)
        order = sorted(by_tile, reverse=how == "tiles_reversed")
        if how == "round_robin":
            parts = [(t, by_tile[t][k]) for k in range(max(map(len, by_tile.values()))) for t in order
                     if k < len(by_tile[t])]
        else:
            parts = [(t, p) for t in order for p in by_tile[t]]
    elif how == "tnsot0":
        parts = [(t, p[:11] + b"\x00" + p[12:]) for t, p in parts]
    elif how == "last_psot0":
        t, p = parts[-1]
        parts[-1] = (t, p[:6] + b"\x00\x00\x00\x00" + p[10:])
    return head + b"".join(p for _, p in parts) + tail


def pclr_box(entries: np.ndarray, sizes) -> bytes:
    ne, npc = entries.shape
    body = struct.pack(">HB", ne, npc) + bytes(((s - 1) & 0x7F) for s in sizes)
    for e in range(ne):
        for c in range(npc):
            body += int(entries[e, c]).to_bytes(min((sizes[c] + 7) >> 3, 4), "big")
    return box(b"pclr", body)


def cmap_box(maps) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in maps))


def cdef_box(defs) -> bytes:
    return box(b"cdef", struct.pack(">H", len(defs)) + b"".join(struct.pack(">HHH", *d) for d in defs))


# -- the cases ---------------------------------------------------------------------------

CV2_SIZES = [(32, 32), (33, 47), (64, 64), (37, 101), (101, 35), (48, 200)]  # its 6 levels need 32 pixels


@pytest.mark.parametrize("x1000", [None, 500, 100])
@pytest.mark.parametrize("colour", [True, False])
@pytest.mark.parametrize("size", CV2_SIZES)
def test_cv2s_own_jp2_files_decode_as_cv2(size, colour, x1000, tmp_path):
    """cv2's writer at several sizes (odd ones among them; it refuses images
    under 32 pixels a side, so Pillow's files hold the small ones), colour and grey,
    lossless (1000, its default) and at ratios 500 and 100 (its 9/7 path),
    by ``decode_image`` and by ``read_image``."""
    h, w = size
    img = smooth(h, w, h * w) if colour else smooth(h, w, h + w)[..., 0]
    data = cv2_jp2(img, x1000)
    assert data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    assert answers(data) == "equal"
    assert read_answers(data, tmp_path) == "equal"


def read_answers(data: bytes, tmp_path) -> str:
    path = tmp_path / "x.jp2"
    path.write_bytes(data)
    logging.disable(logging.WARNING)
    try:
        return compare(cv2.imread(str(path)), imcodec.read_image(str(path)))
    finally:
        logging.disable(logging.NOTSET)


PIL_OPTIONS = {
    "default": {},
    "irreversible": dict(irreversible=True),
    "mct0": dict(mct=0),
    "mct0_irreversible": dict(mct=0, irreversible=True),
    "tiles": dict(tile_size=(16, 24), num_resolutions=3),
    "tiles_offset": dict(tile_size=(32, 32), tile_offset=(3, 5), offset=(5, 9)),
    "offset": dict(offset=(1, 0), tile_size=(64, 64), tile_offset=(1, 0)),
    "cblk16": dict(codeblock_size=(16, 16)),
    "cblk4x64": dict(codeblock_size=(4, 64)),
    "cblk64x4": dict(codeblock_size=(64, 4)),
    "precincts": dict(precinct_size=(32, 32), progression="RPCL", num_resolutions=4),
    # Pillow halves the precincts at each lower level: exponent 0 past the
    # first resolution, which OpenJPEG's decoder refuses ("Invalid precinct size")
    "precincts_refused": dict(precinct_size=(16, 16), codeblock_size=(8, 8)),
    "res1": dict(num_resolutions=1),
    "res2": dict(num_resolutions=2),
    "res4": dict(num_resolutions=4),
    "rates": dict(quality_mode="rates", quality_layers=[40, 10, 2]),
    "db": dict(quality_mode="dB", quality_layers=[25, 35, 45]),
    "plt": dict(plt=True),
    "comment": dict(comment="a comment"),
    **{p.lower(): dict(progression=p, quality_mode="rates", quality_layers=[30, 8, 2])
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"{p.lower()}_precincts": dict(progression=p, precinct_size=(32, 32), codeblock_size=(8, 8),
                                     num_resolutions=3, quality_mode="rates", quality_layers=[20, 4])
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "tiled_cprl": dict(tile_size=(24, 24), num_resolutions=3, progression="CPRL", quality_mode="rates",
                       quality_layers=[12, 3]),
}


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("container", ["jp2", "j2k"])
@pytest.mark.parametrize("option", list(PIL_OPTIONS))
def test_pillows_options_decode_as_cv2(option, container, lossy):
    """Each of Pillow's options, in JP2 and in a raw codestream, lossless
    (5/3) and lossy (9/7 with three layers of rates): a lossy file decodes
    to pixels up to ~100 away from its source, and every rounding shows."""
    kw = dict(PIL_OPTIONS[option])
    if lossy:
        kw.setdefault("quality_mode", "rates")
        kw.setdefault("quality_layers", [25, 8, 3])
        kw["irreversible"] = True
    img = smooth(45, 61, len(option)) if option != "precincts" else noise(45, 61, 3, 3)
    try:
        data = pil_j2k(img, no_jp2=container == "j2k", **kw)
    except OSError:  # Pillow's encoder refuses the parameters
        pytest.skip("the encoder refuses these parameters")
    assert answers(data) == ("none" if "offset" in option or "refused" in option else "equal")


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
@pytest.mark.parametrize("container", ["jp2", "j2k"])
def test_pillows_modes_decode_as_cv2(mode, container):
    """Grey (refused as a bare codestream: an unknown colour space is sRGB to
    cv2, which wants 3 components), grey + alpha, RGB, RGBA (the alpha
    dropped) and 16-bit grey (shifted right by 8)."""
    img = smooth(30, 41, 7)
    if mode in ("L", "LA", "RGBA"):
        arr = {"L": img[..., 0], "LA": img[..., :2], "RGBA": np.dstack([img, img[..., :1]])}[mode]
    elif mode == "I;16":
        arr = (img[..., 0].astype(np.uint16) * 257 + np.arange(41, dtype=np.uint16)).astype(np.uint16)
    else:
        arr = img
    data = pil_j2k(arr, None, no_jp2=container == "j2k")
    want = "none" if container == "j2k" and mode in ("L", "LA", "I;16") else "equal"
    assert answers(data) == want


MODE_SWITCHES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32, "all": 63}


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("switch", list(MODE_SWITCHES))
def test_each_code_block_mode_switch_decodes_as_cv2(switch, irreversible):
    """BYPASS (raw passes after the first ten), RESET, TERMALL (a segment per
    pass), VSC (no south neighbours across a stripe), PTERM and SEGSYM, alone
    and all together, over five layers."""
    img = smooth(40, 52, 11).transpose(2, 0, 1)
    data = opj_encode(img, mode=MODE_SWITCHES[switch], irreversible=irreversible, rates=(40, 20, 10, 4, 1),
                      resolutions=4)
    assert answers(data) == "equal"


OPJ_KINDS = {
    "sop_eph": dict(csty=6, rates=(20, 5, 1)),
    "sop": dict(csty=2, rates=(10, 1)),
    "eph": dict(csty=4, rates=(10, 1)),
    "poc": dict(pocs=[(0, 0, 2, 3, 3, 0), (0, 0, 3, 6, 3, 1)], rates=(20, 10, 1)),
    "poc_cprl_lrcp": dict(pocs=[(0, 0, 1, 6, 3, 4), (0, 0, 2, 6, 3, 0)], rates=(20, 5)),
    "roi": dict(roi=(0, 5)),
    "roi_irreversible": dict(roi=(1, 7), irreversible=True, rates=(10,)),
    "tiles": dict(tile=(16, 16), resolutions=3, rates=(10, 3)),
    "tiles_odd": dict(tile=(23, 17), resolutions=3, irreversible=True, rates=(12,)),
    "cblk4x4": dict(cblk=(4, 4), rates=(8, 2)),
    "precincts": dict(precincts=[(32, 32), (16, 16)], order=2, rates=(10, 3)),
    "no_mct": dict(mct=0, irreversible=True),
    "jp2": dict(jp2=True, rates=(10, 2)),
    "sub_sampled": dict(sub=[(1, 1), (2, 2), (2, 1)]),
    "signed": dict(sgnd=1),
}


@pytest.mark.parametrize("kind", list(OPJ_KINDS))
def test_libopenjp2_features_decode_as_cv2(kind):
    """What Pillow cannot ask of OpenJPEG's encoder: SOP/EPH, POC, ROI
    max-shift, odd tile sizes, tiny code-blocks, sub-sampled and signed
    components (cv2 refuses both)."""
    kw = dict(OPJ_KINDS[kind])
    img = smooth(45, 61, 13).astype(np.int32).transpose(2, 0, 1)
    if kw.get("sgnd"):
        img = img - 128
    data = opj_encode(img, **kw)
    assert data is not None
    assert answers(data) == ("none" if kind in ("sub_sampled", "signed") else "equal")


@pytest.mark.parametrize("prec", list(range(1, 17)) + [20, 24])
def test_every_precision_decodes_as_cv2(prec):
    """1 to 16 bits, 20 and 24: cv2 refuses precisions below 8 and shifts
    the others right by ``prec - 8`` (no rounding)."""
    img = smooth(20, 27, prec).astype(np.int64).transpose(2, 0, 1)
    planes = (img * ((1 << prec) - 1) // 255 + np.arange(27) % 3) % (1 << prec)
    lossless = opj_encode(planes, prec=prec, rates=(0,), resolutions=3)
    lossy = opj_encode(planes, prec=prec, irreversible=True, rates=(8,), resolutions=3)
    want = "none" if prec < 8 else "equal"
    assert answers(lossless) == want and answers(lossy) == want


# -- the JP2 container and cv2's hand-over --------------------------------------------------

RGB_CS = pil_j2k(smooth(23, 31, 5), no_jp2=True)
RGB_LOSSY_CS = pil_j2k(smooth(23, 31, 6), no_jp2=True, irreversible=True, quality_mode="rates",
                       quality_layers=[12, 3])
GREY_CS = pil_j2k(smooth(23, 31, 7)[..., 0], no_jp2=True)
LA_CS = pil_j2k(smooth(23, 31, 8)[..., :2], "LA", no_jp2=True)
RGBA_CS = pil_j2k(np.dstack([smooth(23, 31, 9), smooth(23, 31, 10)[..., :1]]), no_jp2=True)
W, H = 31, 23


def container_cases() -> dict:
    rgb, grey = RGB_CS, GREY_CS
    sig = box(b"jP  ", b"\r\n\x87\n")
    ftyp = box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
    head = ihdr(W, H, 3) + colr(16)
    cases = {}
    for name, cs in (("rgb", rgb), ("rgb_lossy", RGB_LOSSY_CS), ("grey", grey), ("la", LA_CS), ("rgba", RGBA_CS)):
        nc = codestream_size(cs)[2]
        for e in (16, 17, 18, 24, 12, 14, 0):
            cases[f"{name}_enumcs{e}"] = jp2_file(cs, ihdr(W, H, nc) + colr(e))
        cases[f"{name}_icc"] = jp2_file(cs, ihdr(W, H, nc) + colr(meth=2))
        cases[f"{name}_meth3"] = jp2_file(cs, ihdr(W, H, nc) + box(b"colr", b"\x03\x00\x00\x00\x00\x00\x10"))
        cases[f"{name}_no_colr"] = jp2_file(cs, ihdr(W, H, nc))
        cases[f"{name}_two_colr"] = jp2_file(cs, ihdr(W, H, nc) + colr(17) + colr(16))
    cases.update({
        "cdef_swap": jp2_file(rgb, extra=cdef_box([(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "cdef_alpha": jp2_file(RGBA_CS, ihdr(W, H, 4) + colr(16) + cdef_box([(0, 0, 1), (1, 0, 2), (2, 0, 3),
                                                                             (3, 1, 0)])),
        "cdef_alpha_first": jp2_file(RGBA_CS, ihdr(W, H, 4) + colr(16) + cdef_box([(3, 0, 1), (1, 0, 2), (2, 0, 3),
                                                                                   (0, 1, 0)])),
        "cdef_incomplete": jp2_file(rgb, extra=cdef_box([(0, 0, 1), (1, 0, 2)])),
        "cdef_bad_channel": jp2_file(rgb, extra=cdef_box([(0, 0, 1), (1, 0, 2), (5, 0, 3)])),
        "cdef_bad_asoc": jp2_file(rgb, extra=cdef_box([(0, 0, 9), (1, 0, 2), (2, 0, 3)])),
        "cdef_empty": jp2_file(rgb, extra=box(b"cdef", b"\x00\x00")),
        "cdef_twice": jp2_file(rgb, extra=cdef_box([(0, 0, 1), (1, 0, 2), (2, 0, 3)]) * 2),
        "res_box": jp2_file(rgb, extra=box(b"res ", box(b"resc", b"\x00" * 10))),
        "unknown_in_header": jp2_file(rgb, extra=box(b"abcd", b"xyz")),
        "bpcc": jp2_file(rgb, ihdr(W, H, 3, 255) + colr(16) + box(b"bpcc", b"\x07\x07\x07")),
        "bpcc_bad": jp2_file(rgb, extra=box(b"bpcc", b"\x07\x07")),
        "xml_before": jp2_file(rgb, before=box(b"xml ", b"<a/>")),
        "xml_after": jp2_file(rgb, after=box(b"xml ", b"<a/>")),
        "uuid_after_codestream": jp2_file(rgb) + box(b"uuid", b"\x00" * 20),
        "colr_misplaced_after": jp2_file(rgb, after=colr(17)),
        "colr_misplaced_before": jp2_file(rgb, before=colr(17)),
        "ihdr_wrong_size": jp2_file(rgb, ihdr(W + 1, H, 3) + colr(16)),
        "ihdr_zero": jp2_file(rgb, ihdr(0, H, 3) + colr(16)),
        "ihdr_bad_box": jp2_file(rgb, box(b"ihdr", b"\x00" * 13) + colr(16)),
        "ihdr_twice": jp2_file(rgb, ihdr(W, H, 3) + ihdr(W + 5, H, 3) + colr(16)),
        "no_ihdr": jp2_file(rgb, colr(16)),
        "no_jp2h": sig + ftyp + box(b"jp2c", rgb),
        "no_signature": ftyp + box(b"jp2h", head) + box(b"jp2c", rgb),
        "no_ftyp": sig + box(b"jp2h", head) + box(b"jp2c", rgb),
        "ftyp_first": ftyp + sig + box(b"jp2h", head) + box(b"jp2c", rgb),
        "jp2c_first": sig + ftyp + box(b"jp2c", rgb) + box(b"jp2h", head),
        "two_jp2h": sig + ftyp + box(b"jp2h", head) + box(b"jp2h", head) + box(b"jp2c", rgb),
        "ftyp_odd_size": sig + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2") + box(b"jp2h", head) + box(b"jp2c", rgb),
        "ftyp_short": sig + box(b"ftyp", b"jp2 ") + box(b"jp2h", head) + box(b"jp2c", rgb),
        "signature_bad": box(b"jP  ", b"\r\n\x87\x0b") + ftyp + box(b"jp2h", head) + box(b"jp2c", rgb),
        "jp2c_length0": sig + ftyp + box(b"jp2h", head) + box(b"jp2c", rgb, length=0),
        "jp2c_length_short": sig + ftyp + box(b"jp2h", head) + box(b"jp2c", rgb, length=20),
        "jp2c_xl": sig + ftyp + box(b"jp2h", head) + struct.pack(">I4sII", 1, b"jp2c", 0, 16 + len(rgb)) + rgb,
        "jp2c_xl_huge": sig + ftyp + box(b"jp2h", head) + struct.pack(">I4sII", 1, b"jp2c", 1, 16) + rgb,
        "box_length_small": sig + ftyp + box(b"xml ", b"", length=4) + box(b"jp2h", head) + box(b"jp2c", rgb),
        "box_past_end": sig + ftyp + box(b"jp2h", head) + box(b"free", b"", length=1 << 20) + box(b"jp2c", rgb),
        "jp2h_sub_box_long": sig + ftyp + box(b"jp2h", head[:-4] + struct.pack(">I", 99)) + box(b"jp2c", rgb),
        "trailing_bytes": jp2_file(rgb) + b"\x00\x01\x02",
        "jp2_without_codestream": sig + ftyp + box(b"jp2h", head),
    })
    # a palette: the grey codestream's samples index a 256-entry colour table
    rs = np.random.RandomState(4)
    table = rs.randint(0, 256, (256, 3))
    pal = pclr_box(table, [8, 8, 8])
    g = ihdr(W, H, 1)
    cases.update({
        "pclr": jp2_file(grey, g + colr(16) + pal + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])),
        "pclr_grey_space": jp2_file(grey, g + colr(17) + pal + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])),
        "pclr_short_table": jp2_file(grey, g + colr(16) + pclr_box(table[:100], [8, 8, 8])
                                     + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])),
        "pclr_12bit": jp2_file(grey, g + colr(16) + pclr_box(table * 16 + 7, [12, 12, 12])
                               + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])),
        "pclr_no_cmap": jp2_file(grey, g + colr(17) + pal),
        "pclr_direct": jp2_file(rgb, ihdr(W, H, 3) + colr(16) + pclr_box(table, [8, 8, 8])
                                + cmap_box([(0, 0, 0), (1, 1, 1), (2, 0, 0)])),
        "pclr_wrong_pcol": jp2_file(grey, g + colr(16) + pal + cmap_box([(0, 1, 1), (0, 1, 0), (0, 1, 2)])),
        "pclr_bad_cmp": jp2_file(grey, g + colr(16) + pal + cmap_box([(3, 1, 0), (0, 1, 1), (0, 1, 2)])),
        "pclr_fixed_mapping": jp2_file(grey, g + colr(16) + pal + cmap_box([(0, 0, 0), (0, 0, 0), (0, 0, 0)])),
        "cmap_without_pclr": jp2_file(grey, g + colr(16) + cmap_box([(0, 1, 0)])),
        "pclr_cdef": jp2_file(grey, g + colr(16) + pal + cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)])
                              + cdef_box([(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "pclr_zero_entries": jp2_file(grey, g + colr(16) + box(b"pclr", b"\x00\x00\x03\x07\x07\x07")),
    })
    return cases


CONTAINERS = container_cases()


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_jp2_boxes_and_colour_spaces_answer_as_cv2(name, tmp_path):
    """OpenJPEG's jp2.c rules on the boxes (which it requires, their order,
    lengths of 0 and 1, misplaced image boxes, the codestream running to the
    end of the data), the palette and channel definitions, then cv2's
    colour-space branch: sRGB, grey, sYCC (cv2's YUV conversion), e-YCC and
    CMYK refused, ICC and unknown spaces taken as sRGB."""
    data = CONTAINERS[name]
    assert answers(data) in ("none", "equal")
    assert read_answers(data, tmp_path) in ("none", "equal")


def test_the_container_cases_decode_where_they_should():
    """The hand-over's branches are reached: these decode, those do not."""
    decoded = {n for n, d in CONTAINERS.items() if cv2_decode(d) is not None}
    for name in ("rgb_enumcs16", "rgb_enumcs18", "rgb_enumcs0", "rgb_icc", "grey_enumcs17", "la_enumcs17",
                 "rgba_enumcs16", "cdef_swap", "cdef_alpha_first", "pclr", "pclr_12bit", "pclr_cdef", "jp2c_xl",
                 "colr_misplaced_after", "pclr_direct", "xml_after", "trailing_bytes"):
        assert name in decoded, name
    for name in ("grey_enumcs16", "rgb_enumcs24", "rgb_enumcs12", "la_enumcs18", "cdef_incomplete", "no_jp2h",
                 "jp2c_first", "ihdr_wrong_size", "pclr_wrong_pcol", "no_ihdr"):
        assert name not in decoded, name


@pytest.mark.parametrize("where", ["ppm", "ppt"])
@pytest.mark.parametrize("lossy", [False, True])
def test_packed_packet_headers_decode_as_cv2(where, lossy):
    """PPM and PPT: the packet headers of an SOP/EPH file moved out of the
    tile data into the main or the tile-part header; the same pixels as the
    file they came from."""
    img = smooth(33, 47, 21).transpose(2, 0, 1)
    data = opj_encode(img, csty=6, rates=(20, 5, 1) if lossy else (0,), irreversible=lossy, resolutions=4)
    packed = packed_headers(data, where)
    assert (b"\xff\x60" if where == "ppm" else b"\xff\x61") in packed
    assert answers(packed) == "equal"
    assert (port_decode(packed) == port_decode(data)).all()


@pytest.mark.parametrize("how", ["as_written", "round_robin", "tiles_reversed", "tnsot0", "last_psot0"])
@pytest.mark.parametrize("split", [b"R", b"L", b"C"])
def test_tile_parts_in_any_order_decode_as_cv2(split, how):
    """Four tiles, each in several tile-parts (one per resolution, layer or
    component), interleaved across tiles as OpenJPEG allows (each tile's
    parts in their order), with TNsot 0 (the count unknown until the end)
    or the last Psot 0 (it runs to the EOC)."""
    data = opj_encode(smooth(45, 61, 3).transpose(2, 0, 1), tile=(32, 32), resolutions=3, rates=(20, 5, 1),
                      tile_parts=split)
    changed = data if how == "as_written" else reorder_tile_parts(data, how)
    assert how == "as_written" or changed != data
    assert answers(changed) == "equal"


def mct_offsets(offsets, element_type=0, mcc_index=5, mct_index=1, stage=5) -> bytes:
    """Part 2 segments: an MCT record of per-component offsets, an MCC
    collection naming it as its offset array, an MCO stage naming the MCC."""
    size = {0: 2, 1: 4, 2: 4, 3: 8}[element_type]
    fmt = {0: ">H", 1: ">i", 2: ">f", 3: ">d"}[element_type]
    mct = segment(0xFF74, struct.pack(">HHH", 0, (element_type << 10) | (2 << 8) | mct_index, 0)
                  + b"".join(struct.pack(fmt, v) for v in offsets))
    assert len(mct) == 10 + size * len(offsets)
    n = len(offsets)
    mcc = segment(0xFF75, struct.pack(">HBHH", 0, mcc_index, 0, 1) + struct.pack(">BH", 1, n) + bytes(range(n))
                  + struct.pack(">H", n) + bytes(range(n)) + struct.pack(">I", (1 << 16) | (mct_index << 8))[1:])
    return mct + mcc + segment(0xFF77, bytes([1, stage]))


@pytest.mark.parametrize("kind", ["int16", "int32", "float", "double", "no_stage", "other_stage", "bad_size"])
def test_part2_offsets_set_the_dc_level_shift_as_cv2_does(kind):
    """An MCO stage naming an MCC collection with an offset array: OpenJPEG
    takes the offsets as the DC level shifts (the decorrelation itself needs
    an MCT type of 2, which its COD reader refuses)."""
    segments = {"int16": mct_offsets([10, 200, 30]), "int32": mct_offsets([-40, 90, 128], 1),
                "float": mct_offsets([12.7, -3.5, 300.0], 2), "double": mct_offsets([1e10, 64.5, -1e10], 3),
                "no_stage": segment(0xFF77, b"\x00"), "other_stage": mct_offsets([10, 20, 30], stage=6),
                "bad_size": mct_offsets([10, 20], 0)[:-1]}[kind]
    data = with_marker(RGB_CS, segments, "main")
    assert answers(data) == ("none" if kind == "bad_size" else "equal")
    if kind in ("int16", "no_stage"):
        assert not (port_decode(data) == port_decode(RGB_CS)).all()


@pytest.mark.parametrize("where", ["main", "tile"])
def test_com_and_other_markers_decode_as_cv2(where):
    """COM, CRG, TLM, PLM and PLT segments (valid and not) in the main or
    first tile-part header, where OpenJPEG allows them."""
    cs = RGB_CS
    for marker in (segment(0xFF64, b"\x00\x01a comment"), segment(0xFF63, b"\x00" * 12), segment(0xFF63, b"\x00" * 5),
                   segment(0xFF55, b"\x00\x00"), segment(0xFF55, b"\x00\x50\x00\x00\x00\x10"),
                   segment(0xFF57, b"\x00"), segment(0xFF58, b"\x00\x05\x81\x00"), segment(0xFF58, b"\x00\x81"),
                   segment(0xFF50, b"\x00" * 6), segment(0xFF59, b"\x00\x00"), segment(0xFF91, b"\x00\x00"),
                   segment(0xFF5E, b"\x00\x00\x03"), segment(0xFF5E, b"\x07\x00\x03"), segment(0xFF78, b"\x00\x03\x07\x07\x07"),
                   segment(0xFF77, b"\x00"), segment(0xFF74, b"\x00\x01"), b"\xff\x30\xff\x31"):
        assert answers(with_marker(cs, marker, where)) in ("none", "equal"), marker[:4].hex()


# -- damage ----------------------------------------------------------------------------


def mutations(data: bytes, n: int, seed: int) -> list:
    """``n`` damaged copies: cuts (at a marker or anywhere), one to three
    bytes XOR-ed (in the headers more often than in the packet data), bytes
    set to marker-like values, and a header field (Psot, a segment length, a
    tile index, TPsot/TNsot, a SIZ or COD field) changed."""
    rs = np.random.RandomState(seed)
    cs_at = data.index(b"\xff\x4f\xff\x51") if b"\xff\x4f\xff\x51" in data else 0
    ms = markers(data[cs_at:])
    head_end = cs_at + next((off for off, m, _ in ms if m == 0xFF93), len(data) - cs_at)
    out = []
    for _ in range(n):
        d = bytearray(data)
        kind = rs.randint(6)
        if kind == 0:
            if rs.rand() < 0.5:
                off = cs_at + ms[rs.randint(len(ms))][0] + rs.randint(0, 4)
            else:
                off = rs.randint(1, len(d))
            d = d[:max(1, min(off, len(d) - 1))]
        elif kind in (1, 2):
            for _ in range(rs.randint(1, 4)):
                i = rs.randint(head_end) if kind == 1 else rs.randint(len(d))
                d[i] ^= rs.randint(1, 256)
        elif kind == 3:
            i = rs.randint(len(d))
            d[i] = rs.choice([0x00, 0xFF, 0x90, 0x91, 0x92, 0x93, 0xD9, 0x01, 0x7F, 0x80])
        else:
            off, m, length = ms[rs.randint(len(ms))]
            at = cs_at + off
            if m == 0xFF90 and kind == 4:
                field = rs.randint(4)
                if field == 0:
                    d[at + 6:at + 10] = struct.pack(">I", max(0, struct.unpack(">I", d[at + 6:at + 10])[0]
                                                              + rs.randint(-20, 20)))
                elif field == 1:
                    d[at + 4:at + 6] = struct.pack(">H", rs.randint(0, 6))
                else:
                    d[at + 8 + field] = rs.randint(0, 4)
            elif length and at + 4 <= len(d):
                if kind == 4:
                    d[at + 2:at + 4] = struct.pack(">H", max(0, length + rs.randint(-3, 4)))
                elif at + 4 + length <= len(d) and length > 2:
                    i = at + 4 + rs.randint(length - 2)
                    d[i] = rs.randint(256)
        out.append(bytes(d))
    return out


def fuzz_bases() -> dict:
    """Small files of each kind the fuzz changes."""
    sm, nz = smooth(21, 27, 1), noise(21, 27, 3, 2)
    planes = sm.transpose(2, 0, 1)
    return {
        "jp2": pil_j2k(nz),
        "j2k": pil_j2k(nz, no_jp2=True),
        "grey": pil_j2k(sm[..., 0]),
        "lossy": pil_j2k(sm, irreversible=True, quality_mode="rates", quality_layers=[20, 8, 2]),
        "tiles": pil_j2k(nz, tile_size=(16, 16), num_resolutions=3, no_jp2=True),
        "rpcl": pil_j2k(sm, progression="RPCL", precinct_size=(16, 16), quality_mode="rates", quality_layers=[10, 3],
                        no_jp2=True),
        "cv2": cv2_jp2(smooth(33, 40, 3), 200),
        "sop_eph": opj_encode(planes, csty=6, rates=(20, 5, 1), resolutions=3),
        "modes": opj_encode(planes, mode=63, rates=(20, 5, 1), resolutions=3, irreversible=True),
        "bypass": opj_encode(planes, mode=1, rates=(30, 10, 3, 1), resolutions=3),
        "poc": opj_encode(planes, pocs=[(0, 0, 2, 3, 3, 0), (0, 0, 3, 6, 3, 4)], rates=(20, 10, 1), resolutions=3),
        "ppt": packed_headers(opj_encode(planes, csty=6, rates=(20, 5), resolutions=3), "ppt"),
        "tile_parts": reorder_tile_parts(opj_encode(planes, tile=(16, 16), resolutions=3, rates=(20, 5),
                                                    tile_parts=b"R"), "round_robin"),
        "pclr": CONTAINERS["pclr"],
        "sycc": CONTAINERS["rgb_lossy_enumcs18"],
    }


BASES = fuzz_bases()


@pytest.mark.parametrize("name", list(BASES))
def test_every_cut_at_a_marker_and_stepped_cuts_answer_as_cv2(name):
    """Cut at (and just after) every marker and at 40 stepped offsets: a cut
    file is refused (OpenJPEG's strict mode as cv2 drives it), a cut multi-tile
    file may keep its complete tiles."""
    data = BASES[name]
    cs_at = data.index(b"\xff\x4f\xff\x51")
    cuts = {cs_at + off + k for off, _, _ in markers(data[cs_at:]) for k in (0, 1, 2, 4)}
    cuts |= set(np.linspace(1, len(data) - 1, 40).astype(int).tolist())
    got = [answers(data[:k]) for k in sorted(cuts) if 0 < k < len(data)]
    assert set(got) <= {"none", "equal"}, got


@pytest.mark.parametrize("name", ["jp2", "j2k", "lossy", "tiles", "sop_eph", "modes", "ppt", "pclr"])
def test_every_header_byte_xored_answers_as_cv2(name):
    """Each byte of the boxes and the main and tile-part headers XOR-ed with
    0x01, 0x10 and 0xFF: OpenJPEG's checks of every field."""
    data = BASES[name]
    cs_at = data.index(b"\xff\x4f\xff\x51")
    end = cs_at + next(off for off, m, _ in markers(data[cs_at:]) if m == 0xFF93) + 2
    got = []
    for i in range(end):
        for x in (0x01, 0x10, 0xFF):
            d = bytearray(data)
            d[i] ^= x
            got.append(answers(bytes(d)))
    assert set(got) <= {"none", "equal", "known"}, sorted(set(got))


@pytest.mark.parametrize("name", list(BASES))
def test_mutated_files_answer_as_cv2(name):
    """300 mutations of each base: changed packet data (tier 1 decodes
    through it: the MQ decoder's ends of data, a bad segmentation symbol),
    packet headers, segment lengths, Psot, tile indices, cuts."""
    got = [answers(d) for d in mutations(BASES[name], 300, seed=list(BASES).index(name) + 7)]
    assert set(got) <= {"none", "equal", "known"}, sorted(set(got))
    assert got.count("equal") >= 20


def test_damaged_files_by_path_answer_as_cv2_imread(tmp_path):
    datas = [d for i, data in enumerate(BASES.values()) for d in mutations(data, 10, seed=i + 400)]
    assert {read_answers(d, tmp_path) for d in datas} <= {"none", "equal"}


# -- refusals and the build --------------------------------------------------------------

REFUSALS = {
    "sub-sampled": (opj_encode(smooth(40, 48, 3).transpose(2, 0, 1), sub=[(1, 1), (2, 2), (2, 2)]),
                    "sub-sampled component"),
    "signed": (opj_encode(smooth(40, 48, 3).astype(np.int32).transpose(2, 0, 1) - 128, sgnd=1), "signed component"),
    "precision": (opj_encode(smooth(40, 48, 3).transpose(2, 0, 1) >> 2, prec=6), "precision of 6 bits"),
    "offset": (pil_j2k(smooth(20, 24, 3), offset=(2, 2), tile_size=(64, 64), tile_offset=(2, 2)), "image origin"),
    "grey sRGB": (GREY_CS, "1 components in an sRGB image"),
    "cmyk": (CONTAINERS["rgb_enumcs12"], "colour space CMYK"),
    "e-ycc": (CONTAINERS["rgb_enumcs24"], "colour space e-YCC"),
    "cut": (RGB_CS[:-40], "OpenJPEG refuses it"),
    "box order": (CONTAINERS["jp2c_first"], "codestream box before the JP2 header box"),
    "cdef": (CONTAINERS["cdef_incomplete"], "incomplete channel definitions"),
    "ht": (RGB_CS[:RGB_CS.index(b"\xff\x52") + 12] + bytes([RGB_CS[RGB_CS.index(b"\xff\x52") + 12] | 0x40])
           + RGB_CS[RGB_CS.index(b"\xff\x52") + 13:], "HT (Part 15) code-blocks (ROADMAP A18)"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_every_refusal_gives_none_and_one_log_line_naming_it(name, caplog):
    data, reason = REFUSALS[name]
    assert cv2_decode(data) is None
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is None
    lines = [r.getMessage() for r in caplog.records if r.name == "ppocr_tpu_torch.utils.imcodec"]
    assert len(lines) == 1 and lines[0].startswith("JPEG 2000 payload not decoded") and reason in lines[0], lines


def test_what_the_port_does_not_decode_is_pinned():
    assert set(imcodec.J2K_UNPORTED) == {"HT (Part 15) code-blocks"}
    assert set(imcodec.J2K_UNPORTED.values()) == {"A18"}
    assert imcodec.sniff_format(RGB_CS) == imcodec.sniff_format(jp2_file(RGB_CS)) == "jpeg2000"
    assert "jpeg2000" not in imcodec.FORMAT_NAMES


def test_a_jpeg2000_decode_raises_when_its_decoder_cannot_be_built(monkeypatch):
    """A missing compiler is not a bad image: the decode raises and never
    falls back."""

    def no_compiler(source=None):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(native, "_jpeg2000_lib", None)
    monkeypatch.setattr(native, "build", no_compiler)
    with pytest.raises(RuntimeError, match="compiler"):
        imcodec.decode_image(jp2_file(RGB_CS))


def test_a_lossless_file_gives_back_its_source_and_a_lossy_one_does_not():
    """A 5/3 file equals its source, so the lossy files carry the test of
    the 9/7 arithmetic: they differ from their source by tens of levels."""
    img = smooth(40, 50, 77)
    assert (port_decode(pil_j2k(img[..., ::-1], no_jp2=True)) == img).all()
    lossy = port_decode(pil_j2k(img, quality_mode="rates", quality_layers=[40], irreversible=True))
    assert np.abs(lossy.astype(int) - img[..., ::-1]).max() > 20
    assert answers(pil_j2k(img, quality_mode="rates", quality_layers=[40], irreversible=True)) == "equal"


# -- what the card decodes, and the fuzz ------------------------------------------------


def written_cases() -> dict:
    """A spread of the cases above for ``assets/image_cases.npz`` (the card
    has no cv2 to make or decode them): cv2's and Pillow's files, each mode
    switch, SOP/EPH, POC, ROI, precisions, the container and colour-space
    cases, packed headers, and cut, XOR-ed and mutated files."""
    cases = {f"cv2_{h}x{w}_{x}": cv2_jp2(smooth(h, w, h * w), x) for h, w in CV2_SIZES[:3] for x in (None, 100)}
    for option in ("default", "tiles", "precincts", "res1", "rates", "db", "plt", "rlcp", "rpcl_precincts",
                   "pcrl_precincts", "cprl_precincts", "tiled_cprl", "offset"):
        img = smooth(45, 61, len(option))
        for lossy in (False, True):
            kw = dict(PIL_OPTIONS[option])
            if lossy:
                kw.setdefault("quality_mode", "rates")
                kw.setdefault("quality_layers", [25, 8, 3])
                kw["irreversible"] = True
            cases[f"pil_{option}_{'lossy' if lossy else 'lossless'}"] = pil_j2k(img, **kw)
    planes = smooth(40, 52, 11).transpose(2, 0, 1)
    for switch, mode in MODE_SWITCHES.items():
        cases[f"mode_{switch}"] = opj_encode(planes, mode=mode, irreversible=True, rates=(40, 10, 2), resolutions=4)
    for kind in ("sop_eph", "poc", "roi", "tiles_odd", "sub_sampled"):
        cases[f"opj_{kind}"] = opj_encode(smooth(45, 61, 13).transpose(2, 0, 1), **OPJ_KINDS[kind])
    for prec in (4, 12, 16):
        p = smooth(20, 27, prec).astype(np.int64).transpose(2, 0, 1) * ((1 << prec) - 1) // 255
        cases[f"prec{prec}"] = opj_encode(p, prec=prec, irreversible=True, rates=(8,), resolutions=3)
    for name in ("rgb_enumcs18", "rgb_lossy_enumcs18", "grey_enumcs17", "rgba_enumcs16", "la_enumcs17", "pclr",
                 "pclr_12bit", "cdef_swap", "jp2c_xl", "rgb_enumcs12", "no_jp2h"):
        cases[f"jp2_{name}"] = CONTAINERS[name]
    cases["ppt"], cases["ppm"] = BASES["ppt"], packed_headers(
        opj_encode(planes, csty=6, rates=(20, 5), resolutions=3, irreversible=True), "ppm")
    for i, (name, data) in enumerate(BASES.items()):
        cases.update({f"{name}_mutated_{k}": m for k, m in enumerate(mutations(data, 4, seed=i + 900))})
        cases[f"{name}_cut"] = data[: len(data) * 2 // 3]
    return cases


def scene_payloads(scene: np.ndarray) -> dict:
    """A serving scene as the smoke run's JPEG 2000 timing inputs: cv2's
    default (lossless) ``.jp2``, Pillow's irreversible (9/7) files at a rate
    of 20, a raw codestream and a JP2, and Pillow's JP2 of five layers
    (rates 160 to 10)."""
    rgb = np.ascontiguousarray(scene[..., ::-1])
    lossy = dict(irreversible=True, quality_mode="rates", quality_layers=[20])
    layers = dict(irreversible=True, quality_mode="rates", quality_layers=[160, 80, 40, 20, 10])
    return {"scene0_jp2": cv2_jp2(scene), "scene0_j2k_lossy": pil_j2k(rgb, no_jp2=True, **lossy),
            "scene0_jp2_lossy": pil_j2k(rgb, **lossy), "scene0_jp2_5layers": pil_j2k(rgb, **layers)}


def fuzz_files(round_: int, n: int = 3000) -> list:
    """One fuzz round's files: ``n`` mutations of each base and every cut."""
    files = []
    for i, data in enumerate(BASES.values()):
        files += mutations(data, n, seed=10000 * round_ + i)
        files += [data[:k] for k in range(1, len(data))]
    return files


def test_the_smoke_cases_and_payloads_decode_as_cv2():
    cases = {**written_cases(), **scene_payloads(smooth(64, 96, 5))}
    got = [answers(d) for d in cases.values()]
    assert set(got) <= {"none", "equal", "known"} and got.count("equal") >= 40
    payloads = scene_payloads(smooth(64, 96, 5))
    assert payloads["scene0_jp2_lossy"][:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    assert payloads["scene0_j2k_lossy"][:4] == imcodec.J2K_MAGIC


def test_concurrent_decodes_share_the_host_thread_pool():
    """Service workers decode at once: the decoder's one pool of host
    threads serves one decode and the others run on their own threads; the
    pixels are the same either way and every decode finishes."""
    import sys
    import threading

    from ppocr_tpu_torch import assets

    cases = assets.load_image_cases()
    datas = [(cases[n][0], cases[n][1]) for n in ("scene0_jp2", "scene0_j2k_lossy")] + [
        (d, port_decode(d)) for d in list(BASES.values())[:6]]
    bad, interval = [], sys.getswitchinterval()

    def work():
        for data, want in datas * 2:
            got = port_decode(data)
            if (got is None) != (want is None) or (got is not None and not (got == want).all()):
                bad.append(len(data))

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
