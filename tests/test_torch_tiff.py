"""The port's TIFF and BigTIFF decoder (``utils/imcodec.py`` with
``csrc/tiff.cpp``) against ``cv2.imdecode(buf, IMREAD_COLOR)`` and
``cv2.imread`` (OpenCV 5.0, libtiff 4.7): the same ``None`` or not, and 0
differing pixels.

The files come from a small tag writer (``tiff_bytes``), from PIL and from
``cv2.imencode``: every compression the port decodes (none, LZW with and
without the horizontal predictor and in its old-style LSB-first codes,
PackBits, deflate under both tags), grey (MinIsBlack and MinIsWhite),
palette, RGB, RGB with associated, unassociated and unspecified alpha,
CMYK, uncompressed YCbCr (every subsampling) and CIE L*a*b* at the depths
cv2 reads, contiguous and planar, strips and tiles (the
last ones partial), both byte orders, BigTIFF, the eight orientations, and
the directory's odd cases (no RowsPerStrip, no or wrong StripByteCounts,
several pages). Then garbled and cut files and damaged LZW, PackBits and
deflate strips. What cv2 refuses the port refuses; the compressions cv2
decodes and the port does not (NeXT, ThunderScan, SGI Log) are a known
difference, each refused with one log line that names it. The CCITT fax
compressions are held in ``tests/test_torch_tiff_fax.py``, JPEG in
``tests/test_torch_tiff_jpeg.py``.
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

# -- cv2 and the port ---------------------------------------------------------


def cv2_decode(data: bytes):
    """cv2's answer; ``None`` also where it raises on its size limits."""
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error as e:
        if "validateInputImageSize" not in str(e):
            raise
        return None


def port_decode(data: bytes, mapped: bool = False):
    logging.disable(logging.WARNING)  # a refusal logs a line each
    try:
        return imcodec.decode_image(data, mapped=mapped)
    finally:
        logging.disable(logging.NOTSET)


def compare(want, got) -> str:
    if want is None or got is None:
        return "none" if want is None and got is None else ("cv2 only" if got is None else "port only")
    if want.shape != got.shape:
        return "shape"
    return "equal" if (want == got).all() else "pixels"


class _Reasons(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def answers(data: bytes) -> str:
    """"none", "equal", "known" (cv2 decodes a compression the port names
    as not decoded: the known difference, which garbling can reach), or how
    the port's answer differs from cv2's."""
    want = cv2_decode(data)
    log = logging.getLogger("ppocr_tpu_torch.utils.imcodec")
    reasons, level, propagate = _Reasons(), log.level, log.propagate
    log.addHandler(reasons)
    log.setLevel(logging.WARNING)
    log.propagate = False
    try:
        got = imcodec.decode_image(data)
    finally:
        log.removeHandler(reasons)
        log.setLevel(level)
        log.propagate = propagate
    if want is not None and got is None and any(m.endswith(" is not decoded") for m in reasons.messages):
        return "known"
    return compare(want, got)


def assert_all_equal_cv2(datas, what):
    bad = [(i, a) for i, a in enumerate(map(answers, datas)) if a not in ("none", "equal", "known")]
    assert not bad, f"{what}: {len(bad)} of {len(datas)} differ from cv2, e.g. {bad[:8]}"


def garbled(data: bytes, n: int, seed: int, first: int = 4, last=None):
    """``n`` copies of ``data`` with 1–3 bytes in [first, last) set at random."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        for at in rng.integers(first, last or len(bad), rng.integers(1, 4)):
            bad[at] = rng.integers(0, 256)
        out.append(bytes(bad))
    return out


# -- the writer ---------------------------------------------------------------

TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}


def lzw_encode(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW: a clear code first, EOI last, codes MSB first and one bit
    wider from 511 entries on (``compat``: the old-style codes, LSB first and
    wider from 512), a clear code when the table is full."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 255)
                acc &= (1 << nacc) - 1

    early = 0 if compat else 1
    table = {bytes([i]): i for i in range(256)}
    nxt, nbits = 258, 9
    put(256, nbits)
    w = b""
    for b in data:
        wb = w + bytes([b])
        if wb in table:
            w = wb
            continue
        put(table[w], nbits)
        table[wb] = nxt
        nxt += 1
        if nxt + early > (1 << nbits) and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            put(256, nbits)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([b])
    if w:
        put(table[w], nbits)
        nxt += 1
        if nxt + early > (1 << nbits) and nbits < 12:
            nbits += 1
    put(257, nbits)
    if nacc:
        out.append(acc & 255 if compat else (acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2 or more as a repeat, the rest as literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 255, data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def pack_samples(samples: np.ndarray, bits: int, order: str) -> bytes:
    """[rows, n] sample values → rows of ``bits``-bit samples, each row
    padded to a byte."""
    if bits in (8, 16, 32):
        return samples.astype(f"{order}u{bits // 8}").tobytes()
    shifts = np.arange(bits - 1, -1, -1)
    return b"".join(np.packbits(((r[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)).tobytes()
                    for r in samples.astype(np.int64))


def encode_block(raw: bytes, compression: int, rows: int, compat=False) -> bytes:
    if compression == 5:
        return lzw_encode(raw, compat)
    if compression == 32773:  # row by row, as libtiff writes it
        step = len(raw) // rows
        return b"".join(packbits(raw[i : i + step]) for i in range(0, len(raw), step))
    if compression in (8, 32946):
        return zlib.compress(raw)
    return raw


def ycbcr_rows(ycc: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """[H, W, 3] Y, Cb, Cr → the rows of subsampled blocks TIFF stores:
    [H / vs, W / hs * (hs·vs + 2)], each block its hs × vs luma samples row
    by row, then the mean Cb and Cr of the block (edges padded)."""
    h, w, _ = ycc.shape
    bh, bw = -(-h // vs), -(-w // hs)
    pad = np.pad(ycc, ((0, bh * vs - h), (0, bw * hs - w), (0, 0)), mode="edge").astype(np.int64)
    blocks = pad.reshape(bh, vs, bw, hs, 3).transpose(0, 2, 1, 3, 4)
    luma = blocks[..., 0].reshape(bh, bw, vs * hs)
    chroma = blocks[..., 1:].reshape(bh, bw, vs * hs, 2).mean(axis=2).round().astype(np.int64)
    return np.concatenate([luma, chroma], axis=2).reshape(bh, bw * (vs * hs + 2))


def tiff_bytes(samples, bits=8, photometric=2, compression=1, predictor=1, planar=1, rows=None, tile=None,
               order="<", big=False, extra=(), colormap=None, drop=(), override=None, orientation=None,
               compat=False, pages=1, ycbcr=None, encode=None):
    """A TIFF (or BigTIFF) file of ``samples`` [H, W, S]: strips of ``rows``
    rows (all rows by default) or ``tile`` (width, height) tiles, the last
    ones padded; ``extra`` are more (tag, (type, values)) entries, ``drop``
    tags to leave out and ``override`` entries to put in their place.
    ``encode``: a function of a block's samples [rows, columns, S] that
    gives its coded bytes, in place of ``compression``'s own coder.
    ``pages`` > 1 writes more directories after the first, each with the
    samples inverted."""
    samples = np.asarray(samples, np.int64)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    if ycbcr is not None:  # (hs, vs): contiguous subsampled strips of ``rows`` rows, a multiple of vs
        hs, vs = ycbcr
        packed = ycbcr_rows(samples, hs, vs)
        rps = rows or h
        strips = [pack_samples(packed[y // vs : -(-min(y + rps, h) // vs)], 8, order) for y in range(0, h, rps)]
        extra = ((262, (3, [6])), (530, (3, [hs, vs])), *extra)
        override = {273: (4, [0] * len(strips)), 279: (4, [len(x) for x in strips]), **(override or {})}
        return _with_strips(tiff_bytes(np.zeros((1, 1, 3)), extra=extra, big=big, order=order, drop=drop,
                                       override={256: (4, [w]), 257: (4, [h]), 278: (4, [rps]), **override},
                                       orientation=orientation), strips)
    e = order
    head = (b"II" if e == "<" else b"MM") + (struct.pack(e + "HHHQ", 43, 8, 0, 0) if big else struct.pack(e + "HI", 42, 0))
    body = bytearray(head)
    prev_next = 8 if big else 4  # where the offset of the next directory is written
    for page in range(pages):
        img = samples if page == 0 else ((1 << bits) - 1) - samples
        planes = [img] if planar == 1 else [img[..., i : i + 1] for i in range(spp)]
        blocks = []
        for p in planes:
            if tile:
                tw, th = tile
                for ty in range(0, h, th):
                    for tx in range(0, w, tw):
                        t = np.zeros((th, tw, p.shape[2]), np.int64)
                        part = p[ty : ty + th, tx : tx + tw]
                        t[: part.shape[0], : part.shape[1]] = part
                        blocks.append(t)
            else:
                blocks += [p[y : y + (rows or h)] for y in range(0, h, rows or h)]
        enc = []
        for b in blocks:
            bh, bw, bs = b.shape
            flat = b.reshape(bh, bw * bs)
            if predictor == 2:
                diff = flat.copy()
                diff[:, bs:] = flat[:, bs:] - flat[:, :-bs]
                flat = diff & ((1 << bits) - 1)
            enc.append(encode(b) if encode else encode_block(pack_samples(flat, bits, e), compression, bh, compat))
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
                262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
        if tile:
            tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
        else:
            tags[278] = (4, [rows or h])
        if predictor != 1:
            tags[317] = (3, [predictor])
        if colormap is not None:
            tags[320] = (3, list(np.asarray(colormap).reshape(-1)))
        if orientation is not None:
            tags[274] = (3, [orientation])
        tags.update(dict(extra))
        offsets, at = [], len(body)
        for block in enc:
            offsets.append(at)
            at += len(block) + len(block) % 2
        off_type = 16 if big else 4
        tags[324 if tile else 273] = (off_type, offsets)
        tags[325 if tile else 279] = (off_type, [len(x) for x in enc])
        for t in drop:
            tags.pop(t, None)
        tags.update(override or {})
        for block in enc:
            body += block + b"\0" * (len(block) % 2)
        ifd_at = len(body)
        entry = 20 if big else 12
        values_at = ifd_at + (8 if big else 2) + len(tags) * entry + (8 if big else 4)
        ifd = bytearray(struct.pack(e + ("Q" if big else "H"), len(tags)))
        values = bytearray()
        for tag in sorted(tags):
            typ, vals = tags[tag]
            if typ == 2:
                payload, count = bytes(vals), len(vals)
            elif typ in (5, 10):
                payload, count = b"".join(struct.pack(e + ("II" if typ == 5 else "ii"), *v) for v in vals), len(vals)
            else:
                payload, count = struct.pack(f"{e}{len(vals)}{TYPES[typ]}", *vals), len(vals)
            room = 8 if big else 4
            if len(payload) <= room:
                value = payload + bytes(room - len(payload))
            else:
                value = struct.pack(e + ("Q" if big else "I"), values_at + len(values))
                values += payload + b"\0" * (len(payload) % 2)
            ifd += struct.pack(e + ("HHQ" if big else "HHI"), tag, typ, count) + value
        ifd += bytes(8 if big else 4)
        body += ifd + values
        struct.pack_into(e + ("Q" if big else "I"), body, prev_next, ifd_at)
        prev_next = ifd_at + (8 if big else 2) + len(tags) * entry
    return bytes(body)


def _with_strips(data: bytes, strips) -> bytes:
    """``data`` (a one-directory TIFF whose StripOffsets hold zeros) with
    ``strips`` appended and the offsets pointed at them."""
    d = imcodec._TiffDir(data)
    typ, count, at = d.entries[273]
    out = bytearray(data)
    pos = len(out)
    offsets = []
    for x in strips:
        offsets.append(pos)
        out += x
        pos += len(x)
    size = 8 if typ == 16 else 4
    fmt = d.e + ("Q" if size == 8 else "I")
    for k, off in enumerate(offsets):
        struct.pack_into(fmt, out, at + k * size, off)
    return bytes(out)


# -- the kinds ----------------------------------------------------------------

COMPRESSIONS = {"none": dict(compression=1), "lzw": dict(compression=5), "lzw_pred": dict(compression=5, predictor=2),
                "packbits": dict(compression=32773), "deflate": dict(compression=8),
                "deflate_pred": dict(compression=32946, predictor=2)}


def noise(h, w, spp, bits, seed):
    """Runs and noise mixed, so that every codec has both to write."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    runs = np.repeat(rng.integers(0, top + 1, (h, w // 3 + 1, spp)), 3, axis=1)[:, :w]
    return np.where(rng.random((h, w, 1)) < 0.4, rng.integers(0, top + 1, (h, w, spp)), runs)


def colormap(bits, seed, wide=True):
    """A 3 x 2^bits colour map: 16-bit values, or (``wide`` False) values
    below 256, which libtiff takes as an old 8-bit map."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 65536 if wide else 256, (3, 1 << bits))


def tiff_cases() -> dict:
    """name → file. Each layout under each compression, then the kinds."""
    cases = {}
    layouts = {
        "grey8": dict(spp=1, bits=8, photometric=1),
        "rgb8": dict(spp=3, bits=8, photometric=2),
        "rgb16": dict(spp=3, bits=16, photometric=2),
        "rgba8_unassoc": dict(spp=4, bits=8, photometric=2, extra=((338, (3, [2])),)),
        "palette8": dict(spp=1, bits=8, photometric=3, colormap=colormap(8, 1)),
        "bilevel": dict(spp=1, bits=1, photometric=0),
    }
    for lname, lay in layouts.items():
        lay = dict(lay)
        spp, bits = lay.pop("spp"), lay["bits"]
        for cname, comp in COMPRESSIONS.items():
            if comp.get("predictor") and bits < 8:
                continue
            for (h, w), blocks, tag in (((13, 21), dict(rows=4), "strips"), ((21, 37), dict(tile=(32, 16)), "tiles"),
                                        ((9, 7), dict(), "onestrip")):
                img = noise(h, w, spp, bits, seed=len(cases))
                cases[f"{lname}_{cname}_{tag}"] = tiff_bytes(img, **lay, **comp, **blocks)
    # photometric x depth x samples x planar, in strips and in tiles
    kinds = {
        "miniswhite1": (1, 1, 0, {}), "miniswhite8": (1, 8, 0, {}), "miniswhite16": (1, 16, 0, {}),
        "minisblack1": (1, 1, 1, {}), "minisblack16": (1, 16, 1, {}),
        "grey_alpha8": (2, 8, 1, {"extra": ((338, (3, [2])),)}),
        "grey_assoc8": (2, 8, 1, {"extra": ((338, (3, [1])),)}),
        "grey_extra8": (2, 8, 1, {}), "grey_alpha16": (2, 16, 1, {"extra": ((338, (3, [2])),)}),
        "palette1": (1, 1, 3, {"colormap": colormap(1, 2)}), "palette4": (1, 4, 3, {"colormap": colormap(4, 3)}),
        "palette8_old_map": (1, 8, 3, {"colormap": colormap(8, 4, wide=False)}),
        "palette4_old_map": (1, 4, 3, {"colormap": colormap(4, 5, wide=False)}),
        "palette8_extra": (2, 8, 3, {"colormap": colormap(8, 6)}),
        "rgba8_assoc": (4, 8, 2, {"extra": ((338, (3, [1])),)}),
        "rgba8_unspecified": (4, 8, 2, {"extra": ((338, (3, [0])),)}),
        "rgba8_no_extrasamples": (4, 8, 2, {}),
        "rgba16_unassoc": (4, 16, 2, {"extra": ((338, (3, [2])),)}),
        "rgba16_assoc": (4, 16, 2, {"extra": ((338, (3, [1])),)}),
        "cmyk8": (4, 8, 5, {}), "cmyk8_inkset2": (4, 8, 5, {"extra": ((332, (3, [2])),)}),
        "cmyk16": (4, 16, 5, {}),
        "rgb_extra_corel": (4, 8, 2, {"extra": ((338, (3, [999])),)}),
    }
    for name, (spp, bits, phot, kw) in kinds.items():
        for (h, w), blocks, tag in (((11, 19), dict(rows=3), "strips"), ((21, 19), dict(tile=(16, 16)), "tiles")):
            img = noise(h, w, spp, bits, seed=len(cases))
            for planar in (1, 2) if spp > 1 else (1,):
                cases[f"{name}_planar{planar}_{tag}"] = tiff_bytes(img, bits=bits, photometric=phot, planar=planar,
                                                                   compression=5, **blocks, **kw)
    for cname, comp in COMPRESSIONS.items():  # the planes of a separate image under each codec
        cases[f"rgb8_planar2_{cname}"] = tiff_bytes(noise(10, 17, 3, 8, seed=len(cases)), planar=2, rows=4, **comp)
    # byte order, BigTIFF, 16 bits and the predictor
    for order in "<>":
        for big in (False, True):
            for bits, comp in ((8, dict(compression=5, predictor=2)), (16, dict(compression=5, predictor=2)),
                               (16, dict(compression=8, predictor=2)), (16, dict(compression=1)),
                               (16, dict(compression=32773))):
                img = noise(12, 15, 3, bits, seed=len(cases))
                name = f"{'be' if order == '>' else 'le'}_{'big' if big else 'classic'}_{bits}bit_{comp['compression']}" \
                       f"_pred{comp.get('predictor', 1)}"
                cases[name] = tiff_bytes(img, bits=bits, order=order, big=big, rows=5, **comp)
                cases[name + "_tiles"] = tiff_bytes(img, bits=bits, order=order, big=big, tile=(16, 16), **comp)
    # orientations, strips and tiles
    for o in range(1, 9):
        img = noise(21, 35, 3, 8, seed=o)
        cases[f"orientation{o}_strips"] = tiff_bytes(img, orientation=o, rows=6, compression=32773)
        cases[f"orientation{o}_tiles"] = tiff_bytes(img, orientation=o, tile=(16, 16), compression=5)
        cases[f"orientation{o}_grey16_tiles"] = tiff_bytes(noise(21, 35, 1, 16, seed=o), bits=16, photometric=1,
                                                           orientation=o, tile=(16, 16), compression=8)
    # the directory's odd cases
    img = noise(23, 30, 3, 8, seed=7)
    cases["no_rowsperstrip"] = tiff_bytes(img, drop=(278,))
    cases["rowsperstrip_past_height"] = tiff_bytes(img, override={278: (4, [1000])})
    cases["rowsperstrip_max"] = tiff_bytes(img, override={278: (4, [0xFFFFFFFF])})
    cases["rowsperstrip_zero"] = tiff_bytes(img, override={278: (4, [0])})
    cases["rowsperstrip_short"] = tiff_bytes(img, rows=7, override={278: (3, [7])})
    cases["no_bytecounts_one_strip"] = tiff_bytes(img, drop=(279,))
    cases["no_bytecounts_lzw_one_strip"] = tiff_bytes(img, compression=5, drop=(279,))
    cases["no_bytecounts_strips"] = tiff_bytes(img, rows=8, drop=(279,))
    cases["bytecount_too_long"] = tiff_bytes(img, override={279: (4, [10 ** 6])})
    cases["bytecount_too_short"] = tiff_bytes(img, override={279: (4, [100])})
    cases["bytecount_zero"] = tiff_bytes(img, override={279: (4, [0])})
    cases["bytecounts_wrong_strips"] = tiff_bytes(img, rows=5, override={279: (4, [900, 450, 450, 450, 270])})
    cases["lzw_bytecount_too_long"] = tiff_bytes(img, compression=5, override={279: (4, [10 ** 6])})
    cases["no_photometric"] = tiff_bytes(img, drop=(262,))
    cases["no_samplesperpixel"] = tiff_bytes(img, drop=(277,))
    cases["no_bitspersample"] = tiff_bytes(noise(9, 17, 1, 1, seed=3), bits=1, photometric=0, drop=(258,))
    cases["no_compression"] = tiff_bytes(img, drop=(259,))
    cases["no_planarconfig"] = tiff_bytes(img, drop=(284,))
    cases["no_stripoffsets"] = tiff_bytes(img, drop=(273,))
    cases["planar3"] = tiff_bytes(img, override={284: (3, [3])})
    cases["bitspersample_per_sample_differ"] = tiff_bytes(img, override={258: (3, [8, 16, 8])})
    cases["fillorder2_lzw"] = tiff_bytes(img, compression=5, extra=((266, (3, [2])),))
    cases["fillorder2_none"] = tiff_bytes(img, rows=4, extra=((266, (3, [2])),))
    cases["predictor3"] = tiff_bytes(img, compression=5, override={317: (3, [3])})
    cases["predictor0"] = tiff_bytes(img, compression=5, override={317: (3, [0])})
    cases["predictor2_packbits"] = tiff_bytes(img, compression=32773, override={317: (3, [2])})
    cases["sampleformat_int"] = tiff_bytes(img, extra=((339, (3, [2, 2, 2])),))
    cases["sampleformat_float32"] = tiff_bytes(noise(5, 6, 1, 16, seed=1) * 65536, bits=32, photometric=1,
                                                extra=((339, (3, [3])),))
    cases["grey32"] = tiff_bytes(noise(5, 6, 1, 16, seed=2) * 65536, bits=32, photometric=1)
    cases["grey2"] = tiff_bytes(noise(5, 6, 1, 2, seed=3), bits=2, photometric=1)
    cases["grey4"] = tiff_bytes(noise(5, 6, 1, 4, seed=3), bits=4, photometric=1)
    cases["palette2"] = tiff_bytes(noise(5, 6, 1, 2, seed=3), bits=2, photometric=3, colormap=colormap(2, 7))
    cases["palette_no_colormap"] = tiff_bytes(noise(5, 6, 1, 4, seed=3), bits=4, photometric=3)
    cases["palette8_no_colormap"] = tiff_bytes(noise(5, 6, 1, 8, seed=3), photometric=3)
    cases["rgb5"] = tiff_bytes(noise(5, 6, 5, 8, seed=3), extra=((338, (3, [0, 0])),))
    cases["long_values_as_short"] = tiff_bytes(img, override={256: (3, [30]), 257: (3, [23])})
    cases["width_zero"] = tiff_bytes(img, override={256: (4, [0])})
    cases["orientation9"] = tiff_bytes(img, orientation=9)
    cases["two_pages"] = tiff_bytes(img, pages=2, compression=5)
    cases["bigtiff_two_pages"] = tiff_bytes(img, pages=2, big=True, order=">")
    cases["lzw_compat"] = tiff_bytes(img, compression=5, compat=True, rows=5)
    cases["lzw_compat_pred"] = tiff_bytes(img, compression=5, compat=True, predictor=2, rows=5)
    cases["unknown_compression"] = tiff_bytes(img, compression=12345)
    cases["unknown_compression_miniswhite"] = tiff_bytes(noise(5, 9, 1, 8, seed=1), photometric=0, compression=9)
    for comp in (6, 32909, 34661, 34887, 34925, 50000, 50001):
        cases[f"not_configured_{comp}"] = tiff_bytes(img, compression=comp)
    # odd tiles: widths that are not multiples of 16, tiles clipped on the right
    for name, (bits, spp, phot, tile) in {"grey8_tile24": (8, 1, 1, (24, 8)), "grey16_tile16": (16, 1, 1, (16, 16)),
                                          "grey_alpha8_tile16": (8, 2, 1, (16, 16)),
                                          "bilevel_tile16": (1, 1, 0, (16, 16)),
                                          "palette4_tile16": (4, 1, 3, (16, 16)), "rgb16_tile16": (16, 3, 2, (16, 16)),
                                          "cmyk8_tile32": (8, 4, 5, (32, 16))}.items():
        img2 = noise(20, 37, spp, bits, seed=len(cases))
        cmap = {"colormap": colormap(bits, 9)} if phot == 3 else {}
        for comp in ("lzw", "deflate"):
            cases[f"{name}_{comp}"] = tiff_bytes(img2, bits=bits, photometric=phot, tile=tile, **COMPRESSIONS[comp],
                                                 **cmap)
    for name, tile in {"none_tile16": (16, 16), "none_tile32x16": (32, 16), "none_tile64": (64, 64)}.items():
        cases[f"rgb8_{name}"] = tiff_bytes(noise(40, 50, 3, 8, seed=1), tile=tile)
        cases[f"rgba8_{name}"] = tiff_bytes(noise(40, 50, 4, 8, seed=2), tile=tile)
    # YCbCr, uncompressed: every subsampling (1x4 and 2x4 are refused),
    # strips of whole and partial blocks, the coefficient and reference tags,
    # separate planes (1x1 only), no subsampling tag (2x2 is meant)
    for shape in ((9, 11), (16, 16)):
        ycc = noise(*shape, 3, 8, seed=len(cases))
        for hs, vs in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2), (1, 4), (2, 4)):
            for rows in (4, None):
                cases[f"ycbcr_{shape[0]}x{shape[1]}_{hs}x{vs}_rows{rows}"] = tiff_bytes(ycc, ycbcr=(hs, vs), rows=rows)
    ycc = noise(10, 13, 3, 8, seed=3)
    cases["ycbcr_coefficients"] = tiff_bytes(ycc, ycbcr=(2, 2), extra=(
        (529, (5, [(2125, 10000), (7154, 10000), (721, 10000)])),))
    cases["ycbcr_reference"] = tiff_bytes(ycc, ycbcr=(2, 1), extra=(
        (532, (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])),))
    cases["ycbcr_luma_green_zero"] = tiff_bytes(ycc, ycbcr=(1, 1), extra=((529, (11, [0.3, 0.0, 0.1])),))
    cases["ycbcr_planar2"] = tiff_bytes(ycc, photometric=6, planar=2, rows=4, extra=((530, (3, [1, 1])),))
    cases["ycbcr_planar2_no_subsampling"] = tiff_bytes(ycc, photometric=6, planar=2, rows=4)
    cases["ycbcr_no_subsampling_tag"] = tiff_bytes(ycc, photometric=6, rows=4)
    cases["ycbcr_16bit"] = tiff_bytes(noise(6, 8, 3, 16, seed=1), bits=16, photometric=6, extra=((530, (3, [1, 1])),))
    # CIE L*a*b*, through libtiff's sRGB display: 8 and 16 bits, the D50
    # white point or another, a zero white point (refused), 4 samples and
    # separate planes (refused)
    for bits in (8, 16):
        lab = noise(20, 37, 3, bits, seed=bits)
        cases[f"cielab{bits}_strips"] = tiff_bytes(lab, bits=bits, photometric=8, rows=6, compression=5)
        cases[f"cielab{bits}_tiles"] = tiff_bytes(lab, bits=bits, photometric=8, tile=(16, 16), compression=8)
        cases[f"cielab{bits}_d65"] = tiff_bytes(lab, bits=bits, photometric=8, extra=(
            (318, (5, [(3127, 10000), (3290, 10000)])),))
    cases["cielab8_white_zero"] = tiff_bytes(lab, bits=16, photometric=8, extra=((318, (5, [(3127, 10000), (0, 1)])),))
    cases["cielab8_4samples"] = tiff_bytes(noise(5, 6, 4, 8, seed=1), photometric=8)
    cases["cielab8_planar2"] = tiff_bytes(noise(5, 6, 3, 8, seed=1), photometric=8, planar=2)
    # PIL and cv2's own files
    rng = np.random.default_rng(11)
    for mode in ("1", "L", "P", "RGB", "RGBA", "CMYK", "I;16", "LA", "YCbCr"):
        im = Image.fromarray(noise(19, 27, 3, 8, seed=3).astype(np.uint8)).convert(mode)
        for comp in ("raw", "tiff_lzw", "packbits", "tiff_deflate", "tiff_adobe_deflate"):
            buf = io.BytesIO()
            try:
                im.save(buf, "TIFF", compression=comp)
            except (OSError, ValueError):
                continue
            cases[f"pil_{mode.replace(';', '')}_{comp}"] = buf.getvalue()
    for name, arr in {"grey": rng.integers(0, 256, (17, 23), dtype=np.uint8),
                      "colour": rng.integers(0, 256, (17, 23, 3), dtype=np.uint8),
                      "bgra": rng.integers(0, 256, (17, 23, 4), dtype=np.uint8),
                      "grey16": rng.integers(0, 65536, (17, 23), dtype=np.uint16),
                      "colour16": rng.integers(0, 65536, (17, 23, 3), dtype=np.uint16)}.items():
        cases[f"cv2_{name}"] = cv2.imencode(".tiff", arr)[1].tobytes()
    return cases


def small_enough(data: bytes, limit: int = 1 << 22) -> bool:
    """False for a file whose first directory declares more than ``limit``
    pixels (or blocks of more): a garbled size field can ask both decoders
    for gigabytes, and the size rules have cases of their own."""
    try:
        d = imcodec._TiffDir(data)
    except Exception:
        return True
    sizes = []
    for tag in (256, 257, 278, 322, 323):
        try:
            sizes.append(d.one(tag, 0xFFFFFFFF) or 1)
        except Exception:
            sizes.append(1)
    w, h, rps, tw, th = sizes
    return w * h <= limit and w * min(rps, 1 << 24) <= limit and tw * th <= limit


TIFF_CASES = list(tiff_cases())


@pytest.mark.parametrize("name", TIFF_CASES)
def test_tiff_kinds_answer_as_cv2(name):
    assert answers(tiff_cases_cached()[name]) in ("none", "equal")  # no known difference among the kinds


_CACHE = {}


def tiff_cases_cached() -> dict:
    if not _CACHE:
        _CACHE.update(tiff_cases())
    return _CACHE


BY_PATH = ["rgb8_none_strips", "rgb8_none_tiles", "rgb8_none_tile16", "rgb8_none_tile32x16", "rgba8_none_tile64",
           "grey8_lzw_tiles", "be_big_16bit_1_pred1_tiles", "le_classic_16bit_1_pred1_tiles", "orientation3_tiles",
           "orientation6_strips", "orientation8_tiles", "two_pages", "fillorder2_none", "bytecount_too_long",
           "cv2_colour", "pil_RGB_tiff_lzw", "rgb8_planar2_none", "grey_alpha8_planar2_tiles"]


@pytest.mark.parametrize("name", BY_PATH)
def test_a_tiff_read_by_path_answers_as_cv2_imread(name, tmp_path):
    """``cv2.imread`` maps the file: an uncompressed tile must hold exactly its
    size (``imdecode``'s stream rounds its buffer up to 1024 bytes), and an
    orientation that turns the image (5–8) is refused."""
    path = tmp_path / "x.tif"
    path.write_bytes(tiff_cases_cached()[name])
    logging.disable(logging.WARNING)
    try:
        got = imcodec.read_image(str(path))
    finally:
        logging.disable(logging.NOTSET)
    assert compare(cv2.imread(str(path), cv2.IMREAD_COLOR), got) in ("none", "equal")


def test_tiff_probes_of_cv2_rules():
    """cv2's TIFF rules, held as numbers: a 16-bit grey sample gives its high
    byte and a 16-bit RGB one (v + 128) // 257; unassociated alpha is
    premultiplied, (v·a + 127) // 255, associated and unspecified alpha is
    dropped; CMYK is (255 − K)(255 − C) // 255; MinIsWhite inverts; a palette
    of values below 256 is taken as 8-bit; the orientation turns the image
    as EXIF does; the first page is read; 32-bit and float samples, 2-bit
    samples and 4-bit grey are refused."""
    grey16 = tiff_bytes(np.array([[0x12FF, 0x1200, 0xFFFF]]), bits=16, photometric=1)
    assert port_decode(grey16)[0, :, 0].tolist() == [0x12, 0x12, 0xFF] == cv2_decode(grey16)[0, :, 0].tolist()
    rgb16 = tiff_bytes(np.array([[[128, 385, 65535]]]), bits=16)
    assert port_decode(rgb16)[0, 0].tolist() == [255, 1, 0] == cv2_decode(rgb16)[0, 0].tolist()
    px = np.array([[[200, 100, 50, 128]]])
    for extra, want in ((2, [25, 50, 100]), (1, [50, 100, 200]), (0, [50, 100, 200])):
        data = tiff_bytes(px, extra=((338, (3, [extra])),))
        assert port_decode(data)[0, 0].tolist() == want == cv2_decode(data)[0, 0].tolist(), extra
    cmyk = tiff_bytes(np.array([[[10, 100, 200, 60]]]), photometric=5)
    assert port_decode(cmyk)[0, 0].tolist() == [42, 118, 187] == cv2_decode(cmyk)[0, 0].tolist()
    white = tiff_bytes(np.array([[0, 1, 0b1010]]), bits=8, photometric=0)
    assert port_decode(white)[0, :, 0].tolist() == [255, 254, 245]
    old_map = tiff_bytes(np.array([[0, 1]]), photometric=3, colormap=np.array([[10, 20] + [0] * 254] * 3))
    assert port_decode(old_map)[0, :, 0].tolist() == [10, 20] == cv2_decode(old_map)[0, :, 0].tolist()
    img = noise(3, 5, 3, 8, seed=1)
    bgr = img[..., ::-1].astype(np.uint8)
    for o, want in ((3, bgr[::-1, ::-1]), (6, bgr.transpose(1, 0, 2)[:, ::-1]), (8, bgr.transpose(1, 0, 2)[::-1])):
        assert (port_decode(tiff_bytes(img, orientation=o)) == want).all(), o
    assert (port_decode(tiff_bytes(img, pages=3, compression=5)) == bgr).all()
    for name in ("grey32", "sampleformat_float32", "grey2", "grey4", "palette2"):
        assert port_decode(tiff_cases_cached()[name]) is None and cv2_decode(tiff_cases_cached()[name]) is None
    assert imcodec.sniff_format(b"II+\x00\x08\x00\x00\x00") == imcodec.sniff_format(b"MM\x00+") == "tiff"


GARBLED = ["rgb8_none_strips", "rgb8_lzw_strips", "rgb8_lzw_pred_tiles", "rgb8_packbits_strips",
           "rgb8_deflate_tiles", "rgb16_deflate_pred_strips", "grey8_lzw_onestrip", "bilevel_packbits_tiles",
           "palette8_lzw_strips", "rgba8_unassoc_none_onestrip", "cmyk8_planar2_strips", "grey_alpha8_planar2_tiles",
           "be_big_16bit_5_pred2", "le_big_16bit_1_pred1", "orientation3_tiles", "orientation6_strips", "two_pages",
           "lzw_compat", "no_rowsperstrip", "cv2_colour", "pil_P_packbits", "pil_RGBA_tiff_adobe_deflate",
           "ycbcr_16x16_2x2_rows4", "ycbcr_9x11_4x4_rowsNone"]


@pytest.mark.parametrize("name", GARBLED)
def test_garbled_and_cut_tiffs_answer_as_cv2(name):
    """60 seeded files per kind with 1–3 bytes changed anywhere past the
    magic (header, directory, tag values and strip data; those that come to
    declare more than 4 Mpixels are dropped), then 40 cuts."""
    data = tiff_cases_cached()[name]
    datas = garbled(data, 60, seed=GARBLED.index(name)) + [data[:k] for k in range(4, len(data), max(1, len(data) // 40))]
    assert_all_equal_cv2([x for x in datas if small_enough(x)], f"garbled {name}")


@pytest.mark.parametrize("codec", ["lzw", "lzw_pred", "packbits", "deflate", "deflate_pred", "none"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_damaged_strips_and_tiles_answer_as_cv2(codec, layout):
    """120 files with 1–3 bytes of the strip or tile data changed: libtiff
    keeps what a block decoded before its error (LZW and deflate zero the
    rest, PackBits leaves it) and goes on with the next block."""
    blocks = dict(rows=3) if layout == "strips" else dict(tile=(16, 16))
    data = tiff_bytes(noise(40, 50, 3, 8, seed=5), **COMPRESSIONS[codec], **blocks)
    ifd = struct.unpack("<I", data[4:8])[0]
    assert_all_equal_cv2(garbled(data, 120, seed=len(codec), first=8, last=ifd), f"damaged {codec} {layout}")


def test_a_damaged_lzw_strip_still_gives_cv2s_image():
    """One byte changed in an LZW strip: cv2 logs "Using code not yet in
    table" and keeps the strip's rows up to there; the port gives the same
    pixels, not ``None``."""
    img = noise(32, 40, 1, 8, seed=9)
    data = bytearray(tiff_bytes(img, photometric=1, compression=5))
    data[8 + 300] ^= 0x5A
    want, got = cv2_decode(bytes(data)), port_decode(bytes(data))
    assert want is not None and got is not None and (want == got).all()
    assert 0 < (want[..., 0] != img[..., 0]).sum() < img.size


# compressions and photometric interpretations cv2 decodes and the port does not
KNOWN_DIFFERENCES = {**{f"compression{c}": dict(compression=c) for c in (32766, 32809)},
                     "compression34676": dict(compression=34676, photometric=32844),
                     "compression34677": dict(compression=34677, photometric=32845)}


@pytest.mark.parametrize("name", list(KNOWN_DIFFERENCES))
def test_an_unported_tiff_kind_logs_one_line_naming_it(name, caplog):
    """The known difference: these are refused with one log line that names
    them, whatever cv2 makes of them. The set is pinned."""
    assert set(imcodec.TIFF_UNPORTED) == {32766, 32809, 34676, 34677}
    kw = KNOWN_DIFFERENCES[name]
    spp = 1 if kw.get("compression", 1) in (32809, 34676) else 3
    bits = 8
    data = tiff_bytes(noise(8, 16, spp, bits, seed=1), bits=bits, photometric=kw.get("photometric", 1 if spp == 1 else 2),
                      compression=kw.get("compression", 1))
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is None
    assert len(caplog.records) == 1
    msg = caplog.records[0].getMessage()
    label = imcodec.TIFF_UNPORTED[kw["compression"]]
    assert msg.startswith("TIFF payload not decoded: ") and label in msg and "not decoded" in msg[20:], msg


# -- through the services -------------------------------------------------------


def test_tiff_requests_get_the_jax_services_answer(tmp_path):
    """A scene as cv2's own LZW TIFF (predictor 2) and as a two-page LZW file
    with orientation 6, sent as data, and as an uncompressed tiled TIFF sent
    by path: the JAX service (cv2 decodes) and the port's service answer
    with the same words, fused, staged and through the batching dispatcher.
    ``FinetuneDataset`` reads a TIFF crop as the JAX one does. Both services
    are built with no request timeout: the test is about the answer."""
    import asyncio
    import base64
    import dataclasses
    import json

    import torch

    from ppocr_tpu.serve.service import OCRIPCService as JaxService
    from ppocr_tpu.train.finetune import FinetuneDataset as JaxDataset
    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.serve import OCRIPCService
    from ppocr_tpu_torch.train.finetune import FinetuneDataset
    from test_torch_goldens import assert_words_match, jax_config
    from test_torch_serve import small_config

    scene = assets.load_scenes()["parity"][0]
    lzw = cv2.imencode(".tiff", scene)[1].tobytes()
    turned = tiff_bytes(np.ascontiguousarray(scene.transpose(1, 0, 2)[::-1, :, ::-1]), compression=5, predictor=2,
                        orientation=6, rows=16, pages=2)
    tiled = tiff_bytes(scene[..., ::-1], tile=(64, 64))
    for data in (lzw, turned, tiled):
        assert answers(data) == "equal" and (port_decode(data) == scene).all()
    path = tmp_path / "scene.tif"
    path.write_bytes(tiled)
    assert (cv2.imread(str(path)) == scene).all() and (imcodec.read_image(str(path)) == scene).all()
    lines = [json.dumps({"command": "recognize", "image_data": base64.b64encode(lzw).decode()}).encode(),
             json.dumps({"command": "recognize", "image_data": base64.b64encode(turned).decode()}).encode(),
             json.dumps({"command": "recognize", "image_path": str(path)}).encode()]
    model_dir = str(assets.make_jumbo_model_dir(tmp_path / "jumbo"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several test processes at once
    try:
        for changes in ({}, {"fast_path": False}, {"request_batch_buckets": (1, 2)}):
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
    crop = scene[20:68, 10:170]
    (tmp_path / "crop.tif").write_bytes(cv2.imencode(".tiff", crop)[1].tobytes())
    labels = tmp_path / "labels.txt"
    labels.write_text("crop.tif\t12\n")
    jax_ds, ds = JaxDataset(str(labels)), FinetuneDataset(str(labels))
    assert len(ds) == len(jax_ds) == 1 and (ds.images[0] == jax_ds.images[0]).all()
