"""Image bytes → BGR uint8, without cv2 or PIL.

The service's stand-in for ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` and
``cv2.imread``: the machines that serve the port need have neither cv2
nor PIL. It answers as cv2 5.0 does, ``None`` included. Decoded:

* **PNG** (``zlib`` + numpy), plain or Adam7-interlaced: grey, grey +
  alpha, RGB, RGBA and palette, bit depths 1–8 (and 16, reduced to its
  high byte), all five filter types. Alpha is dropped, as
  ``IMREAD_COLOR`` does. The chunks are read as cv2 reads them: the data
  must run to a whole IEND chunk, a critical chunk with a bad CRC or an
  unknown critical chunk refuses the image, an ancillary chunk with a bad
  CRC is dropped.
* **BMP** (numpy), uncompressed: 24- and 32-bit, and 8-bit with a palette.
* **JPEG**, 8-bit sequential and progressive, Huffman or arithmetic coded
  (SOF0, SOF1, SOF2, SOF9, SOF10), one, three or four (CMYK / YCCK)
  components, any integral sampling, restart intervals:
  ``csrc/jpeg.cpp``, host C++ built at first use by ``ops.native``,
  libjpeg-turbo 3.1's decoder as OpenCV drives it, so the pixels equal
  cv2's, on corrupt data too. Corrupt entropy data decodes as libjpeg
  decodes it with a warning. What refuses a JPEG is libjpeg's errors and
  the end of the data: OpenCV's memory source cannot refill, so a
  sequential image whose MCUs (the Huffman look-ahead included) need a
  byte past the end, or a progressive or multi-scan image that does not
  reach EOI, gives ``None``. The EXIF orientation is applied as
  ``cv2.imdecode`` applies it; grey comes out as three equal channels.

Refused with ``None`` and a log line naming the reason, as cv2 refuses
them on the repo's cases: lossless, hierarchical and 12-bit JPEGs. And,
named by their sniffed format, what cv2 decodes and this module does not
(``FORMAT_NAMES``): GIF, WebP, TIFF, JPEG 2000, PPM/PGM/PBM, Sun raster,
AVIF, PFM and Radiance HDR. ``None`` becomes the reference's own error response in the
service. A JPEG decode raises when the decoder cannot be built: a missing
compiler is not a bad image.

``encode_png`` writes 8-bit grey, BGR or BGRA arrays as PNG (filter types
0–2 only), for tests and for request payloads made from arrays.
"""

from __future__ import annotations

import logging
import struct
import zlib
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type → samples per pixel


def sniff_format(data: bytes) -> str:
    """Name of the container by its magic bytes: one of ``FORMAT_NAMES``'
    keys or "unknown"."""
    if data[:8] == PNG_MAGIC:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    if data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51":
        return "jpeg2000"
    if data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6", b"7") and data[2:3].isspace():
        return "pnm"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "sunraster"
    if data[4:12] in (b"ftypavif", b"ftypavis"):
        return "avif"
    if data[:3] in (b"PF\n", b"Pf\n"):
        return "pfm"
    if data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE":
        return "hdr"
    return "unknown"


# the formats that cv2 decodes and this module does not, by their sniffed name
FORMAT_NAMES = {
    "gif": "GIF",
    "webp": "WebP",
    "tiff": "TIFF",
    "jpeg2000": "JPEG 2000",
    "pnm": "PPM/PGM/PBM",
    "sunraster": "Sun raster",
    "avif": "AVIF",
    "pfm": "PFM",
    "hdr": "Radiance HDR",
}


# -- PNG ----------------------------------------------------------------------


def _paeth(a, b, c):
    """Paeth predictor on int16 arrays (a: left, b: up, c: up-left)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(raw: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Filter types 0–2 only: one pass over the rows. Sub is a running sum
    mod 256 along the row per byte lane, Up adds the row above."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    lanes = stride // bpp * bpp  # stride is a multiple of bpp whenever bpp > 1
    for r in range(h):
        row = raw[r]
        if ftypes[r] == 1:
            row = np.cumsum(row[:lanes].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftypes[r] == 2:
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_wavefront(raw: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Any filter types, Average and Paeth included. A pixel needs its
    left, upper and upper-left neighbours only, whatever its row's filter,
    so all pixels of one anti-diagonal (row + column = d) are reconstructed
    together: H + W vector steps instead of H · W scalar ones."""
    h, stride = raw.shape
    w = stride // bpp
    px = raw.reshape(h, w, bpp)
    # skew[d, r] = pixel (r, d − r): a diagonal is one contiguous slab
    skew = np.zeros((h + w, h, bpp), np.int16)
    rows = np.arange(h)
    for c in range(0, w, 4096):  # fancy-index assignment in column chunks
        cols = np.arange(c, min(c + 4096, w))
        skew[rows[:, None] + cols[None, :], rows[:, None]] = px[:, cols]
    ft = ftypes.astype(np.int16)[:, None]
    zero_row = np.zeros((1, bpp), np.int16)
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1  # rows on this diagonal
        x = skew[d, lo:hi]
        a = skew[d - 1, lo:hi] if d >= 1 else np.zeros_like(x)  # left
        # the row above, one diagonal back (up) and two back (up-left)
        if lo == 0:
            b = np.concatenate([zero_row, skew[d - 1, : hi - 1]]) if d >= 1 else np.zeros_like(x)
            c_ = np.concatenate([zero_row, skew[d - 2, : hi - 1]]) if d >= 2 else np.zeros_like(x)
        else:
            b = skew[d - 1, lo - 1 : hi - 1]
            c_ = skew[d - 2, lo - 1 : hi - 1]
        f = ft[lo:hi]
        pred = np.where(f == 1, a, 0)
        pred = np.where(f == 2, b, pred)
        pred = np.where(f == 3, (a + b) >> 1, pred)
        if (f == 4).any():
            pred = np.where(f == 4, _paeth(a, b, c_), pred)
        skew[d, lo:hi] = (x + pred) & 0xFF
    out = np.empty((h, w, bpp), np.uint8)
    for c in range(0, w, 4096):
        cols = np.arange(c, min(c + 4096, w))
        out[:, cols] = skew[rows[:, None] + cols[None, :], rows[:, None]]
    return out.reshape(h, stride)


# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes):
    """(IHDR fields, palette or None, the IDAT data) as cv2 5.0 reads the
    chunk stream, or ``None``. IHDR comes first; every chunk up to and
    including IEND is whole (IEND's CRC is not checked); a critical chunk
    with a bad CRC, an unknown critical chunk or IDATs that are not
    consecutive refuse the image; an ancillary chunk with a bad CRC is
    dropped."""
    pos = 8
    ihdr = palette = None
    idat = []
    idat_closed = False
    while True:
        if pos + 8 > len(data):
            return None  # the data ends before IEND
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 12 + length
        if end > len(data):
            return None
        body = data[pos + 8 : end - 4]
        crc_ok = struct.unpack(">I", data[end - 4 : end])[0] == zlib.crc32(ctype + body) & 0xFFFFFFFF
        first, pos = pos == 8, end
        if first != (ctype == b"IHDR"):
            return None
        if ctype == b"IEND":
            break
        critical = not ctype[0] & 0x20
        if not crc_ok:
            if critical:
                return None
            continue
        if idat and ctype != b"IDAT":
            idat_closed = True
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            if idat_closed:
                return None
            idat.append(body)
        elif critical:
            return None
    return ihdr, palette, b"".join(idat)


def _unfilter(lines: np.ndarray, bpp: int) -> Optional[np.ndarray]:
    """[h, 1 + stride] filtered lines → [h, stride] bytes, or ``None`` on
    a filter type above 4."""
    ftypes, raw = lines[:, 0], lines[:, 1:]
    if ftypes.max() > 4:
        return None
    if ftypes.max() <= 2:
        return _unfilter_rows(raw, ftypes, bpp)
    return _unfilter_wavefront(raw, ftypes, bpp)


def _unpack(rows: np.ndarray, w: int, nch: int, depth: int, ctype: int) -> np.ndarray:
    """[h, stride] bytes → [h, w, nch] uint8 samples: 16-bit samples by
    their high byte, grey below 8 bits scaled to 0–255, palette indices as
    they are."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, w, nch, 2)[..., 0]  # big-endian: the high byte
    if depth == 8:
        return rows.reshape(h, w, nch)
    # 1, 2 or 4 bits per sample, one sample per pixel
    unpacked = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(h, w, depth)
    values = unpacked.dot(1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    if ctype == 0:
        values = (values * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return values[..., None]


def _decode_png(data: bytes) -> Optional[np.ndarray]:
    chunks = _png_chunks(data)
    if chunks is None:
        return None
    ihdr, palette, idat = chunks
    if ihdr is None or not idat:
        return None
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if w == 0 or h == 0 or comp != 0 or filt != 0 or ctype not in _CHANNELS or interlace > 1:
        return None
    if w > 1_000_000 or h > 1_000_000 or w * h > 1 << 30:  # libpng's user limits, OpenCV's pixel limit
        return None
    if depth not in ((1, 2, 4, 8) if ctype == 3 else (1, 2, 4, 8, 16) if ctype == 0 else (8, 16)):
        return None
    if ctype == 3 and palette is None:
        return None
    nch = _CHANNELS[ctype]
    bits = nch * depth
    bpp = max(1, bits // 8)  # the filters' byte distance to the "left" pixel
    try:
        flat = zlib.decompress(idat)
    except zlib.error:
        return None
    # each pass: (its pixels' place in the image, its width and height);
    # a pass with no columns or no rows has no bytes, not even filter bytes
    passes = [((slice(None), slice(None)), w, h)]
    if interlace:
        passes = [((slice(y0, None, dy), slice(x0, None, dx)), (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy)
                  for x0, y0, dx, dy in _ADAM7]
        passes = [p for p in passes if p[1] > 0 and p[2] > 0]
    if len(flat) < sum(ph * ((pw * bits + 7) // 8 + 1) for _, pw, ph in passes):
        return None
    samples = np.empty((h, w, nch), np.uint8)
    at = 0
    for where, pw, ph in passes:
        stride = (pw * bits + 7) // 8
        lines = np.frombuffer(flat, np.uint8, ph * (stride + 1), at).reshape(ph, stride + 1)
        at += ph * (stride + 1)
        rows = _unfilter(lines, bpp)
        if rows is None:
            return None
        samples[where] = _unpack(rows, pw, nch, depth, ctype)
    if ctype == 3:  # libpng keeps 256 entries, zero past the PLTE's: black
        full = np.zeros((256, 3), np.uint8)
        full[: min(len(palette), 256)] = palette[:256]
        rgb = full[samples[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(samples[..., :1], 3, axis=2)
    else:
        rgb = samples[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """8-bit [H, W] grey, [H, W, 3] BGR or [H, W, 4] BGRA → PNG bytes. Each
    row takes whichever of the filters None, Sub and Up has the smallest
    sum of absolute (signed) residuals."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"encode_png wants a uint8 HxW or HxWxC array, got {img.dtype} {img.shape}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, nch = img.shape
    if nch not in (1, 3, 4) or h == 0 or w == 0:
        raise ValueError(f"encode_png: unsupported shape {img.shape}")
    ctype = {1: 0, 3: 2, 4: 6}[nch]
    px = img if nch == 1 else img[..., [2, 1, 0, 3][:nch]]  # BGR(A) → RGB(A)
    px = np.ascontiguousarray(px)
    left = np.zeros_like(px)
    left[:, 1:] = px[:, :-1]
    up = np.zeros_like(px)
    up[1:] = px[:-1]
    cands = np.stack([px, px - left, px - up]).reshape(3, h, w * nch)  # uint8 wraps
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)  # [3, H]
    best = cost.argmin(axis=0).astype(np.uint8)
    lines = np.empty((h, 1 + w * nch), np.uint8)
    lines[:, 0] = best
    lines[:, 1:] = cands[best, np.arange(h)]

    def chunk(ctype_, body):
        return (
            struct.pack(">I", len(body))
            + ctype_
            + body
            + struct.pack(">I", zlib.crc32(ctype_ + body) & 0xFFFFFFFF)
        )

    return (
        PNG_MAGIC
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(lines.tobytes(), level))
        + chunk(b"IEND", b"")
    )


# -- BMP ----------------------------------------------------------------------


def _decode_bmp(data: bytes) -> Optional[np.ndarray]:
    if len(data) < 54:
        return None
    offset = struct.unpack("<I", data[10:14])[0]
    hdr_size, w, h, planes, bits, comp = struct.unpack("<IiiHHI", data[14:34])
    if hdr_size < 40 or planes != 1 or w <= 0 or h == 0:
        return None
    # 0: BI_RGB; 3: BI_BITFIELDS, taken only in its usual 32-bit BGRA layout
    if comp == 3 and bits == 32 and len(data) >= 66:
        if struct.unpack("<III", data[54:66]) != (0xFF0000, 0xFF00, 0xFF):
            return None
    elif comp != 0:
        return None
    if bits not in (8, 24, 32):
        return None
    rows = abs(h)
    stride = (w * bits + 31) // 32 * 4
    if len(data) < offset + rows * stride:
        return None
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if bits == 8:
        n_colors = struct.unpack("<I", data[46:50])[0] or 256
        table_at = 14 + hdr_size
        if len(data) < table_at + 4 * n_colors:
            return None
        table = np.frombuffer(data, np.uint8, 4 * n_colors, table_at).reshape(-1, 4)
        idx = px[:, :w]
        if int(idx.max()) >= n_colors:
            return None
        bgr = table[idx][..., :3]
    else:
        bgr = px[:, : w * bits // 8].reshape(rows, w, bits // 8)[..., :3]
    if h > 0:  # bottom-up
        bgr = bgr[::-1]
    return np.ascontiguousarray(bgr)


# -- JPEG ---------------------------------------------------------------------

# csrc/jpeg.cpp's Status codes other than success
_JPEG_REFUSED = {
    1: "corrupt data",
    2: "the data ends before the image does",
    3: "a frame header without a scan",
    5: "lossless",
    6: "hierarchical",
    7: "a sample precision other than 8 bits",
    8: "a component count other than 1, 3 or 4",
    9: "sampling factors libjpeg does not take",
    10: "a zero width, height or component count",
    11: "too large",
    12: "no frame header",
    13: "an output buffer too small",
}

# EXIF orientation → the flips and transposes of OpenCV's
# ApplyExifOrientation, in its order
_ORIENT = {
    2: lambda a: a[:, ::-1],
    3: lambda a: a[::-1, ::-1],
    4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2),
    6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
    7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
    8: lambda a: a.transpose(1, 0, 2)[::-1],
}


def _decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    from ..ops import native  # builds csrc/jpeg.cpp at first use; raises if it cannot

    status, img, orientation = native.jpeg_decode(data)
    if status:
        log.warning("JPEG payload not decoded: %s", _JPEG_REFUSED.get(status, f"status {status}"))
        return None
    if orientation in _ORIENT:
        img = np.ascontiguousarray(_ORIENT[orientation](img))
    return img


# -- entry points -------------------------------------------------------------


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes → [H, W, 3] BGR uint8, or ``None`` when the
    bytes are no PNG, BMP or JPEG this module decodes."""
    data = bytes(data)
    fmt = sniff_format(data)
    if fmt == "jpeg":
        return _decode_jpeg(data)
    try:
        if fmt == "png":
            return _decode_png(data)
        if fmt == "bmp":
            return _decode_bmp(data)
    except (struct.error, ValueError, IndexError):
        return None  # malformed inside a well-formed container
    if fmt == "unknown":
        log.warning("image payload of unknown format: not decoded")
    else:
        log.warning("%s payload: the format is not decoded (PNG, BMP and JPEG are)", FORMAT_NAMES[fmt])
    return None


def read_image(path: str) -> Optional[np.ndarray]:
    """``decode_image`` of a file's bytes; ``None`` when it cannot be read."""
    try:
        with open(path, "rb") as f:
            return decode_image(f.read())
    except OSError:
        return None
