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
  CRC is dropped. The zlib stream is inflated as libpng 1.6 inflates it,
  row by row over 8192-byte slices of the IDAT data, so a damaged stream
  gives libpng's answer: an error while the rows are filled refuses the
  image, one after the last row is a warning and the damaged rows stand.
* **BMP** (numpy; run-length streams in ``csrc/bmp_rle.cpp``, host C++
  built at first use by ``ops.native``), as OpenCV's ``grfmt_bmp.cpp``
  reads it: OS/2 core, 40-byte, V4 and V5 headers; 1-, 4- and 8-bit
  palette images (an index past the colour table is black), ``BI_RLE4``
  and ``BI_RLE8`` with their end-of-line, end-of-bitmap and delta codes,
  16-bit 555 and 565 (channels shifted up, no bit replication; other
  16-bit masks are refused), 24-bit, and 32-bit, whose ``BI_BITFIELDS``
  masks apply only under a header of 56 bytes or more; bottom-up and
  top-down rows.
* **PPM / PGM / PBM / PAM** (numpy), as ``grfmt_pxm.cpp`` and
  ``grfmt_pam.cpp`` read them: P1–P6, ASCII and binary, comments, maxval
  1–65535 (16-bit samples keep their high byte, unscaled; ASCII samples
  below 256 are scaled to 0–255, binary ones are not), P1 and P4 with 1
  black; P7 with the TUPLTYPEs GRAYSCALE, GRAYSCALE_ALPHA, RGB, RGB_ALPHA
  and BLACKANDWHITE as cv2 maps them (an RGB tuple lands in B, G, R as
  stored; of a DEPTH 2 or 4 row cv2 writes only the first
  ceil(width / DEPTH) pixels, and here the rest are 0).
* **Sun raster** (numpy), as ``grfmt_sunras.cpp`` reads it: types 0 and
  1 at 1, 8, 24 and 32 bits, with no colour map or an RGB one. cv2 5.0
  refuses the byte-encoded (2) and RGB (3) types, and so does this module.
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
* **PFM** (numpy), as ``grfmt_pfm.cpp`` reads it: ``PF`` (RGB) or ``Pf``
  (grey) and a line break (``P``, ``F`` or ``f`` and other whitespace is
  sniffed as PFM and refused, as cv2 refuses it), width, height and scale
  as ``atoi`` / ``atof`` read them, rows bottom-up, big-endian under a
  positive scale. The values are divided by |scale| and rounded half to
  even, with no ×255: [0, 1] floats give 0s and 1s; NaN, ±inf and values
  at or past 2^31 give 0. **A grey PFM decodes to [H, W]**, as
  ``cv2.imdecode`` gives it even under ``IMREAD_COLOR``; ``read_image``
  gives ``None`` for it, as ``cv2.imread`` does. The JAX service hands
  that array to its worker, which answers an error response (``could
  not broadcast ...``); the port's service gives the same response, and a
  grey PFM sent by path, or named in a fine-tuning label file, is refused
  as cv2.imread refuses it.
* **Radiance HDR** (header in Python, scanlines in ``csrc/hdr_rgbe.cpp``,
  host C++ built at first use), as ``grfmt_hdr.cpp`` and its bundled
  ``rgbe.cpp`` read it: header lines up to exactly
  ``FORMAT=32-bit_rle_rgbe`` (XYZE files are refused), one blank line, and
  the resolution ``-Y H +X W``, the only orientation read; new-style
  run-length or flat scanlines (no old-style runs); ``clip(rint(m ·
  2^(E-136) · 255))`` in float, RGB turned to BGR.
* **GIF**, the first frame (container in Python, LZW and painting in
  ``csrc/gif_lzw.cpp``, host C++ built at first use), as OpenCV 5.0's own
  ``grfmt_gif.cpp`` reads it: GIF87a and GIF89a; every block to the
  trailer is walked first (a cut file or a stray byte refuses it); the
  screen takes the global table's background colour (black without one),
  a transparent pixel keeps it; local over global tables, grey levels with
  no table at all (index 1 white), an index past the tables refuses the
  file; interlaced rows; cv2's LZW rules on damaged streams.
* **TIFF and BigTIFF**, the first page (the directory and the colour
  tables in Python, strips and tiles in ``csrc/tiff.cpp``, host C++ built
  at first use), as OpenCV 5.0's ``grfmt_tiff.cpp`` reads it through
  libtiff 4.7's RGBA interface: libtiff's directory rules (which tags are
  fatal when unreadable, the byte count estimate for a lone strip,
  StripOffsets and TileOffsets in one slot), OpenCV's own checks (1, 4
  (palette), 8 or 16 bits, integer samples, at most 4 samples, its tile
  limits), the RGBA interface's photometric interpretations (grey,
  palette, RGB with or without alpha (unassociated alpha premultiplied),
  CMYK, YCbCr at every subsampling libtiff reads, CIE L*a*b* through its
  sRGB display) and its put routines,
  pointer steps included; compressions none, LZW (old-style codes too),
  PackBits, deflate (zlib's ``inflate`` with libtiff's calls), the
  CCITT fax codecs of 1-bit images (RLE, RLEW, G3 1D and 2D, G4, as
  tif_fax3.c decodes them, damaged rows and G3 data without EOLs
  included) and JPEG (``csrc/jpeg.cpp`` as tif_jpeg.c drives libjpeg:
  the JPEGTables tag, contiguous YCbCr converted by libjpeg, the
  subsampling read from the first block when the tag is absent, cut
  blocks ended by a fake EOI), the horizontal predictor; the orientation
  as cv2 turns the
  image (libtiff mirrors each tile, OpenCV turns the whole); a strip that
  fails to decode keeps what it decoded, as libtiff's RGBA reader goes
  on. ``read_image`` reads a file as ``cv2.imread`` maps it: an
  uncompressed tile must hold exactly its size, an orientation that turns
  the image (5–8) is refused, and RLEW aligns its rows on the mapped
  address.
* **WebP**, lossless and lossy (the RIFF container in Python, the VP8L
  bitstream in ``csrc/webp.cpp``, the VP8 key frame and its ALPH plane in
  ``csrc/vp8.cpp``, host C++ built at first use), as OpenCV 5.0's
  ``grfmt_webp.cpp`` reads it through its bundled libwebp: the first 32
  bytes must pass ``WebPGetFeatures``; a still image is decoded as
  ``WebPDecode`` decodes it (the simple format, the extended format with
  its VP8X canvas equal to the image's size and any metadata chunks, or a
  bare VP8L or VP8 chunk or bitstream; the RIFF size checked against the
  data, trailing bytes ignored, the bitstream free to run past its chunk
  into what follows it; the last ALPH chunk before a VP8 one decoded, and
  a bad one refusing the file, whatever the VP8X flags say); the first
  frame of an animation as
  ``WebPAnimDecoder`` gives it (the demuxer's rules on every chunk and
  frame, the frame's pixels at its offset on a zero canvas, no blending,
  no background colour); alpha is dropped, not blended. The EXIF chunk's
  orientation is applied where the demuxer accepts the file and the VP8X
  flags name the chunk, read as a TIFF header from the chunk's first byte
  (a leading ``Exif\\0\\0`` hides it, as it does from cv2).
* **JPEG 2000**, JP2 files and raw J2K codestreams (the JP2 boxes, the
  palette and channel definitions and cv2's hand-over in Python, the
  codestream in ``csrc/jpeg2000.cpp``, host C++ built at first use), as
  OpenCV 5.0's ``grfmt_jpeg2000_openjpeg.cpp`` reads them through
  OpenJPEG 2.5.3 in strict mode: the boxes by jp2.c's rules (the
  codestream runs from the jp2c box to the end of the data), every
  progression order and POC, tiles and tile-parts, precincts, layers,
  SOP/EPH, PPM/PPT, the code-block mode switches, ROI, the 5/3 and 9/7
  wavelets, the RCT and ICT, with OpenJPEG's arithmetic; a cut file is
  refused. cv2 then takes 1 to 4 unsigned components of 8 bits or more,
  no image origin other than 0 and no sub-sampled component: sRGB (or an
  unknown colour space) from three or four components, grey from the
  first, sYCC through its integer YUV conversion, each sample shifted
  right by the largest precision less 8.
* **AVIF**, 8-bit stills (4:4:4, 4:2:2, 4:2:0 and monochrome), lossless
  or lossy, deblocked, CDEF-filtered and loop-restored (the ISOBMFF boxes and cv2's hand-over
  in Python, the AV1 stream in ``csrc/av1.cpp``, host C++ built at first
  use), as OpenCV 5.0's ``grfmt_avif.cpp`` reads them through libavif
  1.4.2 over libaom 3.14.1: the boxes by libavif's rules with its strict
  checks off (brands, the meta box's unique boxes, ``iloc`` versions 0–2
  from the file or ``idat``, ``ipma`` essential flags, every image
  item's ``ispe``), cv2's signature check over the first 500 bytes (a
  top-level box of size 0 running to their end), the
  primary item and its alpha item (decoded, a bad one refusing the file,
  then dropped); the AV1 intra syntax of a key frame (transform sizes and
  types, coefficients, quantisers, inverse transforms) as libaom decodes
  it, subsampled chroma included, then libaom's deblocking filter, CDEF
  and loop restoration (Wiener, self-guided); then one channel (the Y plane as it
  is) where the ``av1C`` says monochrome, else libavif's YUV to BGR for
  the CICP of the ``colr`` box or the sequence header (``csrc/avif_yuv.cpp``:
  libyuv's fixed point with its bilinear chroma upsampling for BT.709,
  BT.601 and BT.2020, libavif's float path for the other matrices, in
  either range; the matrices libavif refuses give ``None``).

Cut and corrupt data get cv2's answer in every format. Every ``None``
logs one warning that names the format and the reason: cv2's own
refusals (lossless, hierarchical and 12-bit JPEGs among them), an image
over ``imdecode``'s size limits (where cv2 raises), and what cv2 decodes
and this module does not: TIFF's compressions of ``TIFF_UNPORTED`` (NeXT,
ThunderScan, SGI Log), JPEG 2000's HT code-blocks (``J2K_UNPORTED``) and
the AVIF kinds of ``AVIF_UNPORTED`` (10/12-bit, grid and sequence files
among them); no sniffed format is without a decoder
(``FORMAT_NAMES`` is empty). ``None`` becomes the reference's own error
response in the service. A JPEG, run-length BMP, HDR, GIF, TIFF, WebP,
JPEG 2000 or AVIF decode raises when its host C++ cannot be built: a
missing compiler is not a bad image.

``encode_png`` writes 8-bit grey, BGR or BGRA arrays as PNG (filter types
0–2 only), for tests and for request payloads made from arrays.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import re
import struct
import zlib
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type → samples per pixel


def sniff_format(data: bytes) -> str:
    """Name of the container by its magic bytes: one of ``FORMAT_LABELS``'
    keys or "unknown"."""
    if data[:8] == PNG_MAGIC:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:3] == b"GIF":
        return "gif"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51":
        return "jpeg2000"
    if data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6", b"7") and data[2:3].isspace():
        return "pnm"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "sunraster"
    if data[4:8] == b"ftyp" and _avif_brand(data):
        return "avif"
    if data[:1] == b"P" and data[1:2] in (b"F", b"f") and data[2:3].isspace():
        return "pfm"
    if data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE":
        return "hdr"
    # a bare WebP chunk or bitstream, which libwebp reads without RIFF: VP8L
    # by its signature byte and version bits, a VP8 key frame by its start code
    if data[:4] in (b"VP8L", b"VP8 ", b"ALPH") or (data[:1] == b"\x2f" and len(data) >= 5 and data[4] >> 5 == 0) or (
            data[3:6] == b"\x9d\x01\x2a"):
        return "webp"
    return "unknown"


def _avif_brand(data: bytes) -> bool:
    """cv2 takes a file as AVIF when libavif parses its start: an ftyp box
    first whose major or compatible brands name 'avif' or 'avis'."""
    size = int.from_bytes(data[:4], "big")
    end = min(len(data), size) if size >= 8 else len(data)
    brands = [data[8:12]] + [data[k:k + 4] for k in range(16, end - 3, 4)]
    return b"avif" in brands or b"avis" in brands


# every sniffed format's display name; those without a decoder in
# ``_DECODERS`` are the ones cv2 decodes and this module does not
FORMAT_LABELS = {
    "png": "PNG",
    "bmp": "BMP",
    "jpeg": "JPEG",
    "pnm": "PPM/PGM/PBM/PAM",
    "sunraster": "Sun raster",
    "gif": "GIF",
    "webp": "WebP",
    "tiff": "TIFF",
    "jpeg2000": "JPEG 2000",
    "avif": "AVIF",
    "pfm": "PFM",
    "hdr": "Radiance HDR",
}


class _Refused(Exception):
    """A payload that cv2 5.0 does not decode either; the message is the
    reason, logged by ``decode_image``."""


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
    """(IHDR fields, palette or None, the IDAT chunks' bodies) as cv2 5.0
    reads the chunk stream, or ``_Refused``. IHDR comes first; every chunk up to and
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
            raise _Refused("the data ends before IEND")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise _Refused(f"the data ends inside a {ctype!r} chunk")
        body = data[pos + 8 : end - 4]
        crc_ok = struct.unpack(">I", data[end - 4 : end])[0] == zlib.crc32(ctype + body) & 0xFFFFFFFF
        first, pos = pos == 8, end
        if first != (ctype == b"IHDR"):
            raise _Refused("IHDR is not the first chunk")
        if ctype == b"IEND":
            break
        critical = not ctype[0] & 0x20
        if not crc_ok:
            if critical:
                raise _Refused(f"a bad CRC on the critical chunk {ctype!r}")
            continue
        if idat and ctype != b"IDAT":
            idat_closed = True
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            if idat_closed:
                raise _Refused("IDAT chunks that are not consecutive")
            idat.append(body)
        elif critical:
            raise _Refused(f"the unknown critical chunk {ctype!r}")
    return ihdr, palette, idat


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


# libpng's IDAT reader (pngrutil.c png_read_IDAT_data), as cv2 drives it
PNG_IDAT_READ_SIZE = 8192  # libpng feeds inflate at most this many bytes at a time
_Z_OK, _Z_STREAM_END, _Z_NO_FLUSH = 0, 1, 0


class _ZStream(ctypes.Structure):
    """zlib's ``z_stream``."""

    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint), ("total_in", ctypes.c_ulong),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_uint), ("total_out", ctypes.c_ulong),
                ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p), ("zalloc", ctypes.c_void_p),
                ("zfree", ctypes.c_void_p), ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
                ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong)]


_libz = None


def _zlib() -> ctypes.CDLL:
    """The zlib shared library that Python's ``zlib`` module is built on,
    for ``inflate`` calls with libpng's output sizes: the module's
    ``decompress(data, max_length)`` splits a call's output at 32 KiB, and
    a match may reach back over the bytes of the same call only."""
    global _libz
    if _libz is None:
        path = "libz.so.1"
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            path = ctypes.util.find_library("z")
            if path is None:
                raise RuntimeError("zlib's shared library (libz) cannot be loaded: a damaged PNG stream "
                                   "cannot be read as libpng reads it") from None
            lib = ctypes.CDLL(path)
        lib.zlibVersion.restype = ctypes.c_char_p
        lib.inflateInit2_.argtypes = [ctypes.POINTER(_ZStream), ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.inflate.argtypes = [ctypes.POINTER(_ZStream), ctypes.c_int]
        lib.inflateEnd.argtypes = [ctypes.POINTER(_ZStream)]
        _libz = lib
    return _libz


def _inflate_rows(chunks, row_lens) -> bytes:
    """The image rows of the IDAT chunks' zlib stream as libpng 1.6 reads
    them (``png_read_IDAT_data``), or ``_Refused``.

    libpng inflates one row at a time (``avail_out`` is that row's bytes),
    feeding each IDAT chunk in slices of at most 8192 bytes. A zlib error
    while a row is filled is fatal. After the last row it drains the rest
    of the stream through a 1024-byte buffer: an error there is a benign
    error (a warning on read) and the image stands. zlib goes on past a
    row's last byte as far as the codes need no output, into the
    end-of-block code and the Adler-32 trailer when the slice holds them:
    so a bad trailer in the last row's slice is fatal, and one in a later
    slice is not. A match may reach back over the bytes written in the same
    ``inflate`` call and the window the stream's header declares."""
    total = sum(row_lens)
    joined = b"".join(chunks)
    # One call when the answer cannot differ: a clean stream that ends with
    # the image and whose window is 32 KiB or holds the whole image, so that
    # no distance is valid in one call and too far back in rows
    if joined and (joined[0] >> 4 == 7 or total <= 1 << ((joined[0] >> 4) + 8)):
        d = zlib.decompressobj(0)
        try:
            flat = d.decompress(joined, total)
            if len(flat) == total and d.eof and not d.unused_data and not d.unconsumed_tail:
                return flat
        except zlib.error:
            pass
    lib = _zlib()
    src = ctypes.create_string_buffer(joined, len(joined))
    slices, at = [], ctypes.addressof(src)
    for c in chunks:
        slices += [(at + i, min(PNG_IDAT_READ_SIZE, len(c) - i)) for i in range(0, len(c), PNG_IDAT_READ_SIZE)]
        at += len(c)
    slices = iter(slices)
    out, spill = ctypes.create_string_buffer(total), ctypes.create_string_buffer(1024)
    z = _ZStream()
    # windowBits 0: the window the stream's header declares, as libpng asks
    if lib.inflateInit2_(ctypes.byref(z), 0, lib.zlibVersion(), ctypes.sizeof(_ZStream)) != _Z_OK:
        raise RuntimeError("zlib's inflateInit2 failed")

    def inflate(avail_out: int) -> int:
        if not z.avail_in:
            z.next_in, z.avail_in = next(slices, (None, 0))
            if not z.avail_in:
                return -1
        z.avail_out = avail_out
        return lib.inflate(ctypes.byref(z), _Z_NO_FLUSH)

    try:
        z.next_out = ctypes.addressof(out)
        ended = False
        for n in row_lens:
            goal = z.total_out + n
            while z.total_out < goal:
                if ended:
                    raise _Refused("the zlib stream ends before the image does")
                ret = inflate(goal - z.total_out)
                if ret == -1:
                    raise _Refused("the IDAT data ends before the image does")
                if ret == _Z_STREAM_END:
                    ended = True
                elif ret != _Z_OK:
                    raise _Refused(f"zlib error inside the image rows ({(z.msg or b'').decode()})")
        extra = 0  # the drain: each call to a 1024-byte buffer, until a call gives nothing
        while not ended:
            z.next_out = ctypes.addressof(spill)
            before = z.total_out
            ret = inflate(1024)
            if ret == -1:  # libpng reads the next chunk header, which is no IDAT
                raise _Refused("the zlib stream does not end before the IDAT data does")
            extra += z.total_out - before
            if ret != _Z_OK or not extra:  # the end, a benign error (libpng warns), or nothing more
                break
        return out.raw
    finally:
        lib.inflateEnd(ctypes.byref(z))


def _decode_png(data: bytes) -> np.ndarray:
    chunks = _png_chunks(data)
    ihdr, palette, idat = chunks
    if ihdr is None or not idat:
        raise _Refused("no IHDR or no IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if w == 0 or h == 0 or comp != 0 or filt != 0 or ctype not in _CHANNELS or interlace > 1:
        raise _Refused(f"IHDR fields libpng refuses ({w}x{h}, colour type {ctype}, method {comp}/{filt}/{interlace})")
    if w > 1_000_000 or h > 1_000_000 or w * h > 1 << 30:  # libpng's user limits, OpenCV's pixel limit
        raise _Refused(f"too large ({w}x{h})")
    if depth not in ((1, 2, 4, 8) if ctype == 3 else (1, 2, 4, 8, 16) if ctype == 0 else (8, 16)):
        raise _Refused(f"bit depth {depth} with colour type {ctype}")
    if ctype == 3 and palette is None:
        raise _Refused("a palette image without PLTE")
    nch = _CHANNELS[ctype]
    bits = nch * depth
    bpp = max(1, bits // 8)  # the filters' byte distance to the "left" pixel
    # each pass: (its pixels' place in the image, its width and height);
    # a pass with no columns or no rows has no bytes, not even filter bytes
    passes = [((slice(None), slice(None)), w, h)]
    if interlace:
        passes = [((slice(y0, None, dy), slice(x0, None, dx)), (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy)
                  for x0, y0, dx, dy in _ADAM7]
        passes = [p for p in passes if p[1] > 0 and p[2] > 0]
    row_lens = [(pw * bits + 7) // 8 + 1 for _, pw, ph in passes for _ in range(ph)]
    flat = _inflate_rows(idat, row_lens)
    samples = np.empty((h, w, nch), np.uint8)
    at = 0
    for where, pw, ph in passes:
        stride = (pw * bits + 7) // 8
        lines = np.frombuffer(flat, np.uint8, ph * (stride + 1), at).reshape(ph, stride + 1)
        at += ph * (stride + 1)
        rows = _unfilter(lines, bpp)
        if rows is None:
            raise _Refused("a row filter type above 4")
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
# OpenCV's grfmt_bmp.cpp as cv2 5.0 runs it


def _u32(data: bytes, at: int) -> int:
    """OpenCV's getDWord: four bytes past the end end the stream."""
    if at + 4 > len(data):
        raise _Refused("the data ends inside the header")
    return int.from_bytes(data[at : at + 4], "little")


def _i32(data: bytes, at: int) -> int:
    v = _u32(data, at)
    return v - (1 << 32) if v >= 1 << 31 else v


def _check_size(w: int, h: int):
    """imdecode's own limits; cv2 raises where they are passed."""
    if w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise _Refused(f"too large ({w}x{h}; cv2.imdecode raises)")


def _bmp_header(data: bytes):
    """(width, height, bits, compression, palette [256, 4] or None,
    32-bit masks (R, G, B) or None) as BmpDecoder::readHeader reads them;
    bits 15 is 16-bit 555, 16 is 565."""
    size = _i32(data, 14)
    palette = masks = None
    if size >= 36:
        w, h = _i32(data, 18), _i32(data, 22)
        bits, comp = _i32(data, 26) >> 16, _i32(data, 30)
        if not 0 <= comp <= 3:
            raise _Refused(f"compression {comp}")
        clrused = _i32(data, 46)
        if bits == 32 and comp == 3 and size >= 56:
            masks = [_u32(data, 54 + 4 * k) for k in range(3)]  # R, G, B
        ok = w > 0 and h != 0 and (
            (bits in (1, 4, 8, 24, 32) and comp == 0) or (bits in (16, 32) and comp in (0, 3))
            or (bits == 4 and comp == 2) or (bits == 8 and comp == 1))
        if not ok:
            raise _Refused(f"{w}x{h} at {bits} bits, compression {comp}")
        table_at = 14 + size
        if bits <= 8:
            if not 0 <= clrused <= 256:
                raise _Refused(f"a colour table of {clrused} entries")
            n = clrused or 1 << bits
            if table_at + 4 * n > len(data):
                raise _Refused("the data ends inside the colour table")
            palette = np.zeros((256, 4), np.uint8)
            palette[:n] = np.frombuffer(data, np.uint8, 4 * n, table_at).reshape(n, 4)
        elif bits == 16:
            if comp == 3:  # the masks follow the header; only 555 and 565 are taken
                red, green, blue = (_u32(data, table_at + 4 * k) for k in range(3))
                if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                    bits = 15
                elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                    raise _Refused(f"16-bit masks {red:#x}/{green:#x}/{blue:#x}")
            else:
                bits = 15
    elif size == 12:  # OS/2 core header: 16-bit sizes, 3-byte colour table entries
        if len(data) < 26:
            raise _Refused("the data ends inside the header")
        w, h = struct.unpack("<HH", data[18:22])
        bits, comp = _u32(data, 22) >> 16, 0
        if w == 0 or h == 0 or bits not in (1, 4, 8, 24, 32):
            raise _Refused(f"{w}x{h} at {bits} bits (OS/2 header)")
        if bits <= 8:
            n = 1 << bits
            if 26 + 3 * n > len(data):
                raise _Refused("the data ends inside the colour table")
            palette = np.zeros((256, 4), np.uint8)
            palette[:n, :3] = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)
    else:
        raise _Refused(f"an info header of {size} bytes")
    return w, h, bits, comp, palette, masks


def _decode_bmp(data: bytes) -> np.ndarray:
    offset = _i32(data, 10)
    w, h, bits, comp, palette, masks = _bmp_header(data)
    rows = abs(h)
    _check_size(w, rows)
    if rows * w * 3 >= 1 << 30:
        raise _Refused(f"too large for OpenCV's BMP reader ({w}x{rows})")
    if offset < 0:
        raise _Refused(f"a pixel data offset of {offset}")
    if comp in (1, 2):
        from ..ops import native  # builds csrc/bmp_rle.cpp at first use; raises if it cannot

        status, img = native.bmp_rle_decode(data, offset, w, rows, bits, palette)
        if status:
            raise _Refused("the data ends before the image does" if status == 1
                           else "a run past the end of its row")
        return np.ascontiguousarray(img[::-1]) if h > 0 else img
    stride = ((w * (16 if bits == 15 else bits) + 7) // 8 + 3) & ~3
    if offset + rows * stride > len(data):
        raise _Refused("the data ends before the image does")
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if bits <= 8:  # indices into the 256 entries; past the file's table they are black
        if bits == 8:
            idx = px[:, :w]
        else:
            idx = np.unpackbits(px, axis=1)[:, : w * bits].reshape(rows, w, bits).dot(1 << np.arange(bits)[::-1])
        bgr = palette[idx, :3]
    elif bits in (15, 16):  # channels shifted up, low bits zero
        v = px[:, : 2 * w].view("<u2").astype(np.uint16)
        if bits == 15:
            bgr = np.stack([v << 3, (v >> 2) & 0xF8, (v >> 7) & 0xF8], axis=2)
        else:
            bgr = np.stack([v << 3, (v >> 3) & 0xFC, (v >> 8) & 0xF8], axis=2)
        bgr = bgr.astype(np.uint8)
    elif bits == 24:
        bgr = px[:, : 3 * w].reshape(rows, w, 3)
    elif masks is None or 0 in masks:  # 32 bits: B, G, R, unused
        bgr = px[:, : 4 * w].reshape(rows, w, 4)[..., :3]
    else:  # BI_BITFIELDS under a header of 56 bytes or more: each channel
        # shifted down and scaled to 0–255 in float, as OpenCV does
        v = px[:, : 4 * w].view("<u4")
        chans = []
        for mask in masks[::-1]:
            shift = (mask & -mask).bit_length() - 1
            scale = np.float32(255) / np.float32(mask >> shift)
            chans.append((((v & mask) >> shift).astype(np.float32) * scale).astype(np.int64) & 0xFF)
        bgr = np.stack(chans, axis=2).astype(np.uint8)
    if h > 0:  # bottom-up
        bgr = bgr[::-1]
    return np.ascontiguousarray(bgr)


# -- PPM / PGM / PBM / PAM -----------------------------------------------------
# OpenCV's grfmt_pxm.cpp (P1–P6) and grfmt_pam.cpp (P7)

_SPACE = b" \t\n\r\x0b\x0c"


class _Bytes:
    """OpenCV's RLByteStream over ``data``: a byte past the end ends the
    decode."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Refused("the data ends before the image does")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, maxdigits: int = 0) -> int:
        """PxMDecoder's ReadNumber: whitespace and ``#`` comments are
        skipped, the first byte after the digits is consumed (a byte must
        be there), any other byte is an error."""
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:  # '#': to the end of the line
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise _Refused(f"the byte {code:#x} where a number should be")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 0x7FFFFFFF:
                raise _Refused("a number above INT_MAX")
            digits += 1
            if maxdigits and digits >= maxdigits:
                return val
            code = self.byte()
            if not 48 <= code <= 57:
                return val


def _ascii_samples(s: _Bytes, n: int, maxdigits: int = 0) -> np.ndarray:
    """``n`` numbers read as ReadNumber reads them, as int64."""
    return np.array([s.number(maxdigits) for _ in range(n)], np.int64)


def _decode_pxm(data: bytes) -> np.ndarray:
    kind = data[1] - 48
    s = _Bytes(data, 2)
    w, h = s.number(), s.number()
    maxval = 1 if kind in (1, 4) else s.number()
    if maxval > 65535:
        raise _Refused(f"maxval {maxval}")
    if w <= 0 or h <= 0 or maxval <= 0:
        raise _Refused(f"{w}x{h}, maxval {maxval}")
    _check_size(w, h)
    nch = 3 if kind in (3, 6) else 1
    if kind in (1, 4):  # 1 is black, 0 white
        if kind == 1:
            bits = _ascii_samples(s, w * h, maxdigits=1).reshape(h, w) != 0
        else:
            pitch = (w + 7) // 8
            if s.pos + h * pitch > len(data):
                raise _Refused("the data ends before the image does")
            raw = np.frombuffer(data, np.uint8, h * pitch, s.pos).reshape(h, pitch)
            bits = np.unpackbits(raw, axis=1)[:, :w] != 0
        grey = np.where(bits, 0, 255).astype(np.uint8)
        return np.ascontiguousarray(np.repeat(grey[..., None], 3, axis=2))
    wide = maxval > 255  # 16-bit samples: IMREAD_COLOR keeps the high byte
    if kind in (2, 3):  # ASCII: clipped to maxval; 8-bit samples scaled to 0–255
        v = np.minimum(_ascii_samples(s, w * h * nch), maxval)
        v = v >> 8 if wide else v * 255 // maxval
    else:  # binary: as stored, not scaled, big-endian when 16-bit
        n = w * h * nch * (2 if wide else 1)
        if s.pos + n > len(data):
            raise _Refused("the data ends before the image does")
        v = np.frombuffer(data, np.uint8, n, s.pos)[:: 2 if wide else 1]
    v = v.astype(np.uint8, copy=False).reshape(h, w, nch)
    return np.ascontiguousarray(np.repeat(v, 3, axis=2) if nch == 1 else v[..., ::-1])


_PAM_FIELDS = (b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
_PAM_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3, b"RGB_ALPHA": 4}


def _pam_line(s: _Bytes):
    """ReadPAMHeaderLine: (field name or None for a comment, its value)."""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    if code == 35:  # '#'
        while code not in (10, 13):
            code = s.byte()
        return None, b""
    ident = bytearray()
    while len(ident) < 8 and code not in _SPACE:
        ident.append(code)
        code = s.byte()
    ident = bytes(ident).split(b"\0")[0]  # C strings
    if code not in _SPACE or ident not in _PAM_FIELDS:
        raise _Refused(f"the header line {ident!r}")
    if code in (10, 13):
        return ident, b""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    value = bytearray()
    while len(value) < 255 and code not in (10, 13):
        value.append(code)
        code = s.byte()
    if code not in (10, 13):
        raise _Refused("a header value over 255 bytes")
    return ident, bytes(value).split(b"\0")[0].rstrip(_SPACE)


def _pam_number(value: bytes) -> int:
    """ParseInt: an optional minus sign, then decimal digits to the end of
    the value, below INT_MAX."""
    m = re.fullmatch(rb"-?[0-9]+", value)
    if m is None or abs(int(value)) >= 0x7FFFFFFF:
        raise _Refused(f"the number {value!r}")
    return int(value)


def _decode_pam(data: bytes) -> np.ndarray:
    if data[2] not in (10, 13):
        raise _Refused("no line break after P7")
    s = _Bytes(data, 3)
    fields, tupltype = {}, None
    while True:
        name, value = _pam_line(s)
        if name == b"ENDHDR":
            break
        if name == b"TUPLTYPE":
            if value not in _PAM_TUPLTYPES:
                raise _Refused(f"TUPLTYPE {value!r}")
            tupltype = value
        elif name is not None:
            if name in fields:
                raise _Refused(f"{name.decode()} given twice")
            fields[name] = _pam_number(value)
    if len(fields) < 4:
        raise _Refused(f"a header without {sorted(set(_PAM_FIELDS[:4]) - set(fields))}")
    w, h, nch, maxval = (fields[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    if maxval > 65535:  # 0 and below are read as 8-bit samples
        raise _Refused(f"MAXVAL {maxval}")
    if tupltype is None:
        if nch == 3 and maxval < 256:
            tupltype = b"RGB"
        elif nch != 1 or maxval >= 256:
            raise _Refused(f"no TUPLTYPE for DEPTH {nch}, MAXVAL {maxval}")
    if tupltype is not None and _PAM_TUPLTYPES[tupltype] != nch:
        raise _Refused(f"TUPLTYPE {tupltype.decode()} with DEPTH {nch}")
    if w <= 0 or h <= 0:
        raise _Refused(f"{w}x{h}")
    _check_size(w, h)
    wide = maxval > 255
    n = w * h * nch * (2 if wide else 1)
    if s.pos + n > len(data):
        raise _Refused("the data ends before the image does")
    v = np.frombuffer(data, np.uint8, n, s.pos)[:: 2 if wide else 1].reshape(h, w * nch)
    if maxval == 1:  # the samples' bytes read as packed bits, 1 white
        bits = np.unpackbits(v, axis=1)[:, :w]
        return np.ascontiguousarray(np.repeat((bits * 255)[..., None], 3, axis=2))
    if nch == 3:  # copied as stored: the first sample lands in blue
        return np.ascontiguousarray(v.reshape(h, w, 3))
    # OpenCV's conversion loop ends after W samples, not W pixels: only the
    # first ceil(W / DEPTH) pixels of a row are written, and cv2 returns
    # whatever memory held in the rest; here they are 0
    out = np.zeros((h, w, 3), np.uint8)
    k = -(-w // nch)
    px = v[:, : k * nch].reshape(h, k, nch)
    out[:, :k] = px[..., [2, 1, 0]] if nch == 4 else px[..., :1]
    return out


def _decode_netpbm(data: bytes) -> np.ndarray:
    return _decode_pam(data) if data[1] == ord("7") else _decode_pxm(data)


# -- Sun raster ----------------------------------------------------------------
# OpenCV's grfmt_sunras.cpp

def _decode_sunraster(data: bytes) -> np.ndarray:
    if len(data) < 32:
        raise _Refused("the data ends inside the header")
    w, h, bpp, _, rtype, maptype, maplength = struct.unpack(">7i", data[4:32])
    if rtype not in (0, 1):  # cv2 5.0's header check refuses the byte-encoded
        # (2) and RGB (3) types whatever else the file holds
        raise _Refused(f"raster type {rtype}" + (" (byte-encoded or RGB, which cv2 5.0 refuses)"
                                                 if rtype in (2, 3) else ""))
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    if w <= 0 or h <= 0 or bpp not in (1, 8, 24, 32):
        raise _Refused(f"{w}x{h} at {bpp} bits")
    if not ((maptype == 0 and maplength == 0) or (maptype == 1 and 0 < maplength <= pal_size and bpp <= 8)):
        raise _Refused(f"colour map type {maptype} of {maplength} bytes at {bpp} bits")
    _check_size(w, h)
    if 32 + maplength > len(data):
        raise _Refused("the data ends inside the colour map")
    if maplength:  # planes of R, then G, then B; entries past the map are black
        n = maplength // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = cmap[::-1].T
    else:  # grey ramp
        palette = np.repeat((np.arange(256) * 255 // ((1 << min(bpp, 8)) - 1)).clip(0, 255)[:, None], 3, 1)
        palette = palette.astype(np.uint8)
    pitch = ((w * bpp + 7) // 8 + 1) & ~1  # rows padded to 16 bits
    at = 32 + maplength
    if at + h * pitch > len(data):
        raise _Refused("the data ends before the image does")
    px = np.frombuffer(data, np.uint8, h * pitch, at).reshape(h, pitch)
    if bpp == 1:
        return np.ascontiguousarray(palette[np.unpackbits(px, axis=1)[:, :w]])
    if bpp == 8:
        return np.ascontiguousarray(palette[px[:, :w]])
    if bpp == 24:  # stored B, G, R
        return np.ascontiguousarray(px[:, : 3 * w].reshape(h, w, 3))
    return np.ascontiguousarray(px[:, : 4 * w].reshape(h, w, 4)[..., 1:])  # X, B, G, R


# -- PFM ------------------------------------------------------------------------
# OpenCV's grfmt_pfm.cpp


def _to_u8(x: np.ndarray) -> np.ndarray:
    """float32 → uint8 as OpenCV's ``saturate_cast`` does: ``cvRound``
    (half to even), whose int32 conversion gives INT_MIN for NaN, ±inf and
    anything at or past ±2^31, so those become 0."""
    with np.errstate(invalid="ignore"):
        r = np.rint(x)
        r[~(np.abs(x) < np.float32(2**31))] = 0
    return np.clip(r, 0, 255, out=r).astype(np.uint8)


def _pfm_token(s: _Bytes) -> bytes:
    """PFM's read_number: the bytes up to the first whitespace (which is
    consumed), at most 2048; a byte above 127 is an error; the string ends
    at a NUL."""
    tok = bytearray()
    for _ in range(2048):
        c = s.byte()
        if c >= 128:
            raise _Refused(f"the header byte {c:#x}")
        if c in _SPACE:
            break
        tok.append(c)
    return bytes(tok).split(b"\0")[0]


_C_FLOAT = re.compile(rb"[+-]?(?:inf(?:inity)?|nan(?:\([0-9a-z_]*\))?|0x(?:[0-9a-f]+\.?[0-9a-f]*|\.[0-9a-f]+)"
                      rb"(?:p[+-]?[0-9]+)?|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:e[+-]?[0-9]+)?)", re.I)


def _atoi(tok: bytes) -> int:
    """glibc's ``atoi``: ``(int) strtol``, clamped to 64 bits, then wrapped
    to 32."""
    m = re.match(rb"[+-]?[0-9]+", tok)
    v = max(-(1 << 63), min((1 << 63) - 1, int(m.group()))) if m else 0
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _atof(tok: bytes) -> float:
    """``atof``: ``strtod``'s longest prefix (decimal, hex, inf, nan), else 0."""
    m = _C_FLOAT.match(tok)
    if m is None:
        return 0.0
    t = m.group().decode().lower()
    if "x" in t:
        return float.fromhex(t)
    return float(t.split("(")[0])


def _decode_pfm(data: bytes) -> np.ndarray:
    """``PF`` (RGB) or ``Pf`` (grey), a line break, width, height and
    scale, each ended by one whitespace byte, then float32 rows bottom-up,
    big-endian when the scale is positive. The values are divided by
    |scale| and rounded, not scaled by 255. A grey file gives [H, W], as
    cv2 gives it even under ``IMREAD_COLOR``."""
    if data[2] != 10:
        raise _Refused("no line break after the signature")
    s = _Bytes(data, 3)
    w, h = _atoi(_pfm_token(s)), _atoi(_pfm_token(s))
    scale = _atof(_pfm_token(s))
    if w <= 0 or h <= 0:
        raise _Refused(f"{w}x{h} (cv2.imdecode raises)")
    _check_size(w, h)
    nch = 3 if data[1:2] == b"F" else 1
    if s.pos + 4 * w * h * nch > len(data):
        raise _Refused("the data ends before the image does")
    if not abs(scale) > 0:  # NaN too
        raise _Refused(f"the scale {scale}")
    x = np.frombuffer(data, ">f4" if scale >= 0 else "<f4", w * h * nch, s.pos).astype(np.float32)
    if abs(scale) != 1:
        with np.errstate(over="ignore", invalid="ignore"):
            x *= np.float32(1.0 / abs(scale))
    x = _to_u8(x).reshape(h, w, nch)[::-1]
    return np.ascontiguousarray(x[..., ::-1] if nch == 3 else x[..., 0])


# -- Radiance HDR -----------------------------------------------------------------
# OpenCV's grfmt_hdr.cpp over its bundled rgbe.cpp


def _fgets(data: bytes, pos: int):
    """``fgets`` into a 128-byte buffer: (the line up to its NUL, the next
    position), or ``_Refused`` at the end of the data."""
    if pos >= len(data):
        raise _Refused("the data ends inside the header")
    nl = data.find(b"\n", pos, pos + 127)
    end = min(len(data), pos + 127 if nl < 0 else nl + 1)
    return data[pos:end].split(b"\0")[0], end


_HDR_SIZE = re.compile(rb"-Y\s*([+-]?[0-9]+)\s*\+X\s*([+-]?[0-9]+)")
_HDR_REFUSED = {1: "the data ends before the image does", 2: "a scanline of another width",
                3: "bad scanline data (a run count of 0 or past its channel)"}


def _decode_hdr(data: bytes) -> np.ndarray:
    """RGBE_ReadHeader: header lines up to exactly ``FORMAT=32-bit_rle_rgbe``
    (a blank line before it refuses the file, so XYZE files are refused),
    one blank line, then ``-Y height +X width``, the only orientation
    read. The scanlines go to ``csrc/hdr_rgbe.cpp``."""
    line, pos = _fgets(data, 0)
    while line != b"FORMAT=32-bit_rle_rgbe\n":
        if line[:1] in (b"", b"\n"):
            raise _Refused("no FORMAT=32-bit_rle_rgbe line before the blank line")
        line, pos = _fgets(data, pos)
    line, pos = _fgets(data, pos)
    if line != b"\n":
        raise _Refused("no blank line after the FORMAT line")
    line, pos = _fgets(data, pos)
    m = _HDR_SIZE.match(line)
    if m is None:
        raise _Refused(f"the resolution line {line[:40]!r} (only -Y H +X W is read)")
    h, w = (_atoi(g) for g in m.groups())
    if w <= 0 or h <= 0:
        raise _Refused(f"a {w}x{h} image")
    _check_size(w, h)
    from ..ops import native  # builds csrc/hdr_rgbe.cpp at first use; raises if it cannot

    status, img = native.hdr_decode(data, pos, w, h)
    if status:
        raise _Refused(_HDR_REFUSED.get(status, f"status {status}"))
    return img


# -- GIF ----------------------------------------------------------------------
# OpenCV's grfmt_gif.cpp, the first frame


def _gif_sub_blocks(s: _Bytes, app: bool = False):
    """Skips sub-blocks to the zero length byte, as cv2's frame count reads
    them. In an application extension a sub-block of 3 bytes is read as 2
    unless the last 11-byte sub-block was ``NETSCAPE2.0``."""
    netscape = False
    n = s.byte()
    while n:
        if app and n == 11:
            netscape = s.data[s.pos : s.pos + 11] == b"NETSCAPE2.0"
        if app and n == 3 and not netscape:
            n = 2
        if s.pos + n > len(s.data):
            raise _Refused("the data ends inside a sub-block")
        s.pos += n
        n = s.byte()


def _gif_table(s: _Bytes, flags: int) -> Optional[np.ndarray]:
    """The colour table that ``flags`` announces, as BGR [2^k, 3], or None."""
    if not flags & 0x80:
        return None
    n = 2 << (flags & 7)
    if s.pos + 3 * n > len(s.data):
        raise _Refused("the data ends inside a colour table")
    s.pos += 3 * n
    return np.frombuffer(s.data, np.uint8, 3 * n, s.pos - 3 * n).reshape(n, 3)[:, ::-1]


_GIF_REFUSED = {1: "the data ends inside the image data", 2: "an LZW code size outside 2..11",
                3: "an LZW code past the table", 4: "an LZW string past the end of the frame",
                5: "more LZW codes than pixels", 6: "fewer pixels than the frame holds",
                7: "a colour index past its colour tables"}


def _decode_gif(data: bytes) -> np.ndarray:
    """The logical screen, the global table, then every block to the
    trailer (cv2 counts the frames first: a cut file, or a byte that
    starts no block, refuses it), then the first frame: its extensions
    (a graphic control extension of 4 bytes with a disposal method of 0–3
    gives the transparent index), its descriptor, which must lie inside
    the screen, and its LZW data (``csrc/gif_lzw.cpp``). The screen is the
    global table's background colour, or black without a global table; a
    transparent pixel keeps it. An index takes the local table's colour,
    else the global one's; past both it refuses the file, and with no table
    at all it is a grey level (index 1 is white)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise _Refused(f"the version {data[3:6]!r}")
    s = _Bytes(data, 6)

    def word() -> int:
        return s.byte() | s.byte() << 8

    sw, sh = word(), word()
    if not sw or not sh:
        raise _Refused(f"a {sw}x{sh} screen")
    flags, bg, _aspect = s.byte(), s.byte(), s.byte()
    glob = _gif_table(s, flags)
    if glob is not None and bg >= len(glob):
        raise _Refused(f"the background index {bg} past a global table of {len(glob)}")
    first = s.pos
    while True:  # the frame count's walk over every block
        b = s.byte()
        if b == 0x21:
            _gif_sub_blocks(s, app=s.byte() == 0xFF)
        elif b == 0x2C:
            s.pos += 8
            _gif_table(s, s.byte())
            s.pos += 1
            _gif_sub_blocks(s)
        elif b == 0x3B:
            break
        else:
            raise _Refused(f"the byte {b:#x} where a block should start")
    _check_size(sw, sh)
    s.pos = first
    transparent = None
    b = s.byte()
    while b == 0x21:
        if s.byte() == 0xF9:
            if s.byte() != 4:
                raise _Refused("a graphic control extension whose size is not 4")
            gflags = s.byte()
            s.pos += 2
            index = s.byte()
            transparent = index if gflags & 1 else None
            if (gflags >> 2) & 7 > 3:
                raise _Refused(f"the disposal method {(gflags >> 2) & 7}")
        _gif_sub_blocks(s)
        b = s.byte()
    if b != 0x2C:
        raise _Refused("no image descriptor before the trailer")
    left, top, w, h = word(), word(), word(), word()
    if not (w and h and left + w <= sw and top + h <= sh):
        raise _Refused(f"a {w}x{h} frame at ({left}, {top}) outside the {sw}x{sh} screen")
    fflags = s.byte()
    loc = _gif_table(s, fflags)
    colours = np.zeros((256, 3), np.uint8)
    known = np.zeros(256, bool)
    if glob is None and loc is None:  # no table: grey levels, 1 white
        colours[:] = np.arange(256, dtype=np.uint8)[:, None]
        colours[1] = 255
        known[:] = True
    for table in (glob, loc):  # the local table over the global one
        if table is not None:
            colours[: len(table)] = table
            known[: len(table)] = True
    background = glob[bg] if glob is not None else np.zeros(3, np.uint8)
    from ..ops import native  # builds csrc/gif_lzw.cpp at first use; raises if it cannot

    status, screen = native.gif_frame(data, s.pos, (left, top, w, h), bool(fflags & 0x40), colours, known,
                                      transparent, background, (sw, sh))
    if status:
        raise _Refused(_GIF_REFUSED.get(status, f"status {status}"))
    return screen


# -- TIFF ---------------------------------------------------------------------
# The first directory as libtiff 4.7's TIFFReadDirectory reads it, the rules of
# its RGBA interface and of OpenCV 5.0's grfmt_tiff.cpp; the strips and tiles
# in csrc/tiff.cpp

_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_TIFF_INTS = {1: "B", 6: "b", 3: "H", 8: "h", 4: "I", 9: "i", 16: "Q", 17: "q", 13: "I", 18: "Q"}
_TIFF_SHORT_TYPES = (1, 6, 3, 8, 4, 9, 16, 17)  # the integer types libtiff reads as a SHORT, LONG or LONG8
# compressions OpenCV's libtiff decodes and this module does not (a known
# difference), and those it was built without (cv2 refuses them too)
TIFF_UNPORTED = {32766: "NeXT", 32809: "ThunderScan", 34676: "SGI LogL", 34677: "SGI LogLuv"}
_TIFF_FAX = (2, 3, 4, 32771)  # CCITT RLE, G3, G4, RLEW
_TIFF_NOT_CONFIGURED = {6: "old-style JPEG", 32909: "PixarLog", 34661: "JBIG", 34887: "LERC", 34925: "LZMA",
                        50000: "ZSTD", 50001: "WebP"}
_TIFF_PUT = {"grey": 1, "palette": 2, "rgb8": 3, "rgbua8": 4, "rgb16": 5, "rgbua16": 6, "cmyk8": 7, "sep8": 8,
             "sepua8": 9, "sep16": 10, "sepua16": 11, "sepcmyk8": 12, "ycbcr": 13, "sepycbcr": 14, "cielab8": 15,
             "cielab16": 16}
_TIFF_REFUSED = {1: "a strip or tile whose data cannot be read", 2: "an uncompressed tile whose byte count is not "
                 "the size of its buffer", 4: "a JPEG strip or tile that libjpeg or libtiff's JPEG codec refuses"}
_TIFF_BYTE_ARRAY_TYPES = (1, 2, 6, 7, 3, 8, 4, 9, 16, 17)  # what TIFFReadDirEntryByteArray takes


class _TiffDir:
    """The entries of the first directory: tag → (type, count, the file
    position of its value), the first of each tag only."""

    def __init__(self, data: bytes):
        self.data = data
        e = "<" if data[:2] == b"II" else ">"
        self.e = e
        version = struct.unpack(e + "H", data[2:4])[0]
        self.big = version == 43
        if version not in (42, 43):
            raise _Refused(f"the version {version} (42 or 43, BigTIFF)")
        if self.big:
            if len(data) < 16:
                raise _Refused("the data ends inside the BigTIFF header")
            offsize, unused = struct.unpack(e + "HH", data[4:8])
            if offsize != 8 or unused != 0:
                raise _Refused(f"a BigTIFF header with offset size {offsize} and {unused} in its reserved word")
            at = struct.unpack(e + "Q", data[8:16])[0]
            n_size, entry = 8, 20
        else:
            if len(data) < 8:
                raise _Refused("the data ends inside the header")
            at = struct.unpack(e + "I", data[4:8])[0]
            n_size, entry = 2, 12
        if at + n_size > len(data):
            raise _Refused("the first directory lies past the end of the data")
        n = struct.unpack(e + ("Q" if self.big else "H"), data[at : at + n_size])[0]
        if n > 4096:
            raise _Refused(f"a directory of {n} entries (libtiff's sanity limit is 4096)")
        at += n_size
        if at + n * entry > len(data):
            raise _Refused("the data ends inside the first directory")
        self.entries, self.order, self.types = {}, {}, []
        fmt = e + ("HHQ" if self.big else "HHI")
        for k in range(n):
            pos = at + k * entry
            tag, typ, count = struct.unpack(fmt, data[pos : pos + (12 if self.big else 8)])
            value = pos + (12 if self.big else 8)
            size = _TIFF_SIZES.get(typ, 0) * count
            if size > (8 if self.big else 4):
                value = struct.unpack(e + ("Q" if self.big else "I"), data[value : value + (8 if self.big else 4)])[0]
            if tag not in self.entries:
                self.entries[tag] = (typ, count, value)
                self.order[tag] = k
            self.types.append((typ, count))

    def ints(self, tag, limit=None):
        """The entry's values as integers (libtiff's SHORT, LONG and LONG8
        readers: unsigned and signed integers, negative ones refused), at most
        ``limit`` of them; None for a type libtiff does not take there or a
        value outside the data."""
        typ, count, value = self.entries[tag]
        if typ not in _TIFF_INTS:
            return None
        if limit is not None:
            count = min(count, limit)
        size = _TIFF_SIZES[typ]
        if value + size * count > len(self.data):
            return None
        vals = struct.unpack(f"{self.e}{count}{_TIFF_INTS[typ]}", self.data[value : value + size * count])
        return None if any(v < 0 for v in vals) else list(vals)

    def one(self, tag, maximum=0xFFFF):
        """A tag of one value (libtiff's TIFFReadDirEntryShort / Long): the
        value, or None (absent); raises ``ValueError`` for an entry libtiff
        cannot read (wrong count or type, a value out of range)."""
        if tag not in self.entries:
            return None
        typ, count, _ = self.entries[tag]
        if count != 1 or typ not in _TIFF_SHORT_TYPES:
            raise ValueError(f"tag {tag}: {count} values of type {typ}")
        vals = self.ints(tag)
        if vals is None or vals[0] > maximum:
            raise ValueError(f"tag {tag}: a type or value libtiff does not read")
        return vals[0]

    def floats(self, tag, n):
        """A tag of exactly ``n`` numbers as float32 (libtiff's float array
        read: integers, rationals, floats, doubles), or None (absent or
        unreadable, which libtiff only warns about)."""
        if tag not in self.entries:
            return None
        typ, count, value = self.entries[tag]
        if count != n or value + _TIFF_SIZES.get(typ, 0) * n > len(self.data):
            return None
        raw = self.data[value : value + _TIFF_SIZES.get(typ, 0) * n]
        if typ in _TIFF_SHORT_TYPES:
            return np.array(struct.unpack(f"{self.e}{n}{_TIFF_INTS[typ]}", raw), np.float32)
        if typ in (5, 10):
            v = np.array(struct.unpack(f"{self.e}{2 * n}{'I' if typ == 5 else 'i'}", raw), np.float32).reshape(n, 2)
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(v[:, 1] == 0, np.float32(0), v[:, 0] / v[:, 1]).astype(np.float32)
        if typ in (11, 12):
            return np.array(struct.unpack(f"{self.e}{n}{'f' if typ == 11 else 'd'}", raw)).astype(np.float32)
        return None

    def per_sample(self, tag, spp):
        """libtiff's Short-or-PersampleShort read: one value, or ``spp`` or
        more of which the first ``spp`` agree."""
        if tag not in self.entries:
            return None
        typ, count, _ = self.entries[tag]
        if count == 1:
            return self.one(tag)
        vals = self.ints(tag) if typ in _TIFF_SHORT_TYPES and count <= 0xFFFF else None
        if count < spp or vals is None or max(vals, default=0) > 0xFFFF or len(set(vals[:spp])) != 1:
            raise ValueError(f"tag {tag}: per-sample values libtiff does not read")
        return vals[0]


def _tiff_sizes(w, spp, bps, contig):
    """libtiff's scanline size (bytes of one row of ``w`` pixels)."""
    return (w * (spp if contig else 1) * bps + 7) // 8


def _ycbcr_tables(luma, ref) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit in its float32 arithmetic: [5, 256]
    int32, the Y, Cr→R, Cb→B, Cr→G and Cb→G tables."""
    f = np.float32

    def clamp(v, lo, hi):
        return f(lo) if not v >= lo else f(hi) if v > hi else f(v)

    def fix(v):  # FIX(): a float times 65536, + 0.5 in double, truncated
        return int(float(f(v) * f(65536)) + 0.5)

    def code2v(c, rb, rw, cr):
        return f(f(c - int(rb)) * f(cr)) / f(rw - rb if f(rw - rb) != 0 else 1)

    def clampw(v):
        return int(f(-4096) if v < -4096 else f(4096) if v > 4096 else v)

    with np.errstate(all="ignore"):  # C's float arithmetic overflows to inf silently, and so may this
        lr, lg, lb = (f(v) for v in luma)
        f1 = f(2) - f(2) * lr
        d1, d2 = fix(clamp(f1, 0, 2)), -fix(clamp(f(lr * f1 / lg), 0, 2))
        f3 = f(2) - f(2) * lb
        d3, d4 = fix(clamp(f3, 0, 2)), -fix(clamp(f(lb * f3 / lg), 0, 2))
        t = np.zeros((5, 256), np.int64)
        for i in range(256):
            x = i - 128
            cr = clampw(code2v(x, f(ref[4] - f(128)), f(ref[5] - f(128)), 127))
            cb = clampw(code2v(x, f(ref[2] - f(128)), f(ref[3] - f(128)), 127))
            t[:, i] = (clampw(code2v(x + 128, ref[0], ref[1], 255)), (d1 * cr + 32768) >> 16,
                       (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768)
    return t.astype(np.int32)


def _jpeg_tables(d: _TiffDir) -> Optional[bytes]:
    """The JPEGTables tag (347) as TIFFReadDirEntryByteArray reads it: raw
    bytes, or integers each 0–255; None when it is absent, empty or
    unreadable (libtiff drops the tag with a warning)."""
    if 347 not in d.entries:
        return None
    typ, count, value = d.entries[347]
    if typ not in _TIFF_BYTE_ARRAY_TYPES or not 0 < count <= 0x7FFFFFFF // _TIFF_SIZES[typ]:
        return None
    raw = d.data[value : value + _TIFF_SIZES[typ] * count]
    if len(raw) != _TIFF_SIZES[typ] * count:
        return None
    if typ in (1, 2, 7):
        return raw
    vals = struct.unpack(f"{d.e}{count}{_TIFF_INTS[typ]}", raw)
    return bytes(vals) if min(vals) >= 0 and max(vals) <= 255 else None


def _jpeg_sof_sampling(data: bytes, offset: int, count: int, spp: int):
    """tif_jpeg.c JPEGFixupTagsSubsampling: the first block's SOF read by
    libtiff's own marker walk, 2048-byte reads of the block's byte count
    (a read the file cannot fill ends the walk) → the luma's (h, v) sampling
    when the chroma's is 1×1 and h and v are 1, 2 or 4, else None (the
    YCbCrSubsampling default stays)."""
    if offset == 0:
        return None
    buf, at, left = b"", 0, count

    def byte():
        nonlocal buf, at, offset, left
        if at == len(buf):
            if left == 0:
                return None
            m = min(2048, left)
            buf, at = data[offset : offset + m], 0
            if len(buf) != m:
                return None
            offset, left = offset + m, left - m
        at += 1
        return buf[at - 1]

    def skip(k):
        nonlocal buf, at, offset, left
        if k <= len(buf) - at:
            at += k
            return
        m = k - (len(buf) - at)
        buf, at = b"", 0
        if m <= left:
            offset, left = offset + m, left - m
        else:
            left = 0

    def word():
        a = byte()
        b = None if a is None else byte()
        return None if b is None else a << 8 | b

    while True:
        m = byte()
        while m is not None and m != 255:
            m = byte()
        while m == 255:
            m = byte()
        if m is None:
            return None
        if m == 0xD8:
            continue
        if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:  # segments skipped by their length
            n = word()
            if n is None or n < 2:
                return None
            if n > 2:
                skip(n - 2)
            continue
        if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA) or word() != 8 + spp * 3:
            return None
        skip(7)
        p = byte()
        if p is None:
            return None
        skip(1)
        for _ in range(1, spp):
            skip(1)
            q = byte()
            if q is None or q != 0x11:
                return None
            skip(1)
        h, v = p >> 4, p & 15
        return (h, v) if h in (1, 2, 4) and v in (1, 2, 4) else None


def _decode_tiff(data: bytes, mapped: bool = False) -> np.ndarray:
    """The first directory of a TIFF or BigTIFF file, read as libtiff reads
    it (see ``csrc/tiff.cpp`` for the strips and tiles): the tags libtiff
    needs to size the image are fatal when unreadable, the others are
    dropped; a lone strip whose byte count is missing or looks wrong is sized
    from the image (OpenCV's libtiff does not cut it into smaller strips); a
    missing RowsPerStrip means one strip. Then OpenCV's checks (1, 4 (a
    palette only), 8 or 16 bits per sample, integer samples; at most 4
    samples) and those of libtiff's RGBA interface, which reads grey
    (MinIsBlack, MinIsWhite) at 1, 8 and 16 bits, palette at 1, 4 and 8,
    RGB at 8 and 16 with or without alpha (unassociated alpha is
    premultiplied), CMYK at 8, YCbCr at 8 (subsampled when contiguous) and
    CIE L*a*b* at 8 and 16 (contiguous). Compressions: none, LZW, PackBits,
    deflate, the CCITT fax codecs and JPEG; old-style JPEG (6) and those of
    ``_TIFF_NOT_CONFIGURED`` are refused as cv2 refuses them, those of
    ``TIFF_UNPORTED`` as not decoded. A JPEG image under contiguous YCbCr
    is read as libtiff's RGBA interface reads it (JPEGCOLORMODE_RGB: libjpeg
    converts to RGB, and the blocks have the sizes of RGB ones); any other
    photometric takes the JPEG's components as its samples. ``mapped``: the file is read as
    ``cv2.imread`` maps it (not as ``cv2.imdecode`` streams it), which
    changes the rule for uncompressed tiles and refuses the orientations
    that turn the image."""
    d = _TiffDir(data)
    e = d.entries
    if not e:
        raise _Refused("an empty first directory")
    try:
        spp = d.one(277)
        if spp == 0:
            raise ValueError("SamplesPerPixel 0")
        spp = spp or 1
        compression = d.per_sample(259, spp) if 259 in e else 1
        width, height = d.one(256, 0xFFFFFFFF), d.one(257, 0xFFFFFFFF)
        tile_w, tile_h = d.one(322, 0xFFFFFFFF), d.one(323, 0xFFFFFFFF)
        planar = d.one(284)
        if planar not in (None, 1, 2):
            raise ValueError(f"PlanarConfiguration {planar}")
        rps = d.one(278, 0xFFFFFFFF)
        if rps == 0:
            raise ValueError("RowsPerStrip 0")
        extras = []
        if 338 in e:
            extras = d.ints(338) if e[338][0] in _TIFF_SHORT_TYPES and e[338][1] <= 0xFFFF else None
            if extras is None or len(extras) > spp or any(v > 2 and v != 999 for v in extras) or max(extras + [0]) > 0xFFFF:
                raise ValueError("ExtraSamples libtiff does not take")
            extras = [2 if v == 999 else v for v in extras]
        bps = d.per_sample(258, spp)
        sample_format = d.per_sample(339, spp)
        if sample_format is not None and not 1 <= sample_format <= 6:
            raise ValueError(f"SampleFormat {sample_format}")
        for tag in (280, 281, 32996):  # Min/MaxSampleValue, DataType: read, and fatal when unreadable
            d.per_sample(tag, spp)
        for tag in (340, 341):  # SMin/SMaxSampleValue: one number per sample
            if tag in e and (e[tag][1] != spp or e[tag][0] not in _TIFF_SIZES or e[tag][0] in (2, 7, 13, 18)
                             or e[tag][2] + spp * _TIFF_SIZES[e[tag][0]] > len(data)):
                raise ValueError(f"tag {tag}: not one number per sample")
    except ValueError as err:
        raise _Refused(f"a directory libtiff refuses ({err})") from None

    def soft(tag, ok=lambda v: True, maximum=0xFFFF):  # a tag whose errors libtiff only warns about
        try:
            v = d.one(tag, maximum)
        except ValueError:
            return None
        return v if v is not None and ok(v) else None

    photometric = soft(262)
    orientation = soft(274, lambda v: 1 <= v <= 8) or 1
    fill_order = soft(266, lambda v: v in (1, 2)) or 1
    predictor = soft(317) if compression in (5, 8, 32946) else None
    predictor = 1 if predictor is None else predictor
    # T4Options: a tag of the G3 codec alone (bit 0: 2D-coded rows); the decoder reads no other option
    group3_options = (soft(292, maximum=0xFFFFFFFF) or 0) if compression == 3 else 0
    inkset = soft(332)
    inkset = 1 if inkset is None else inkset
    bps_read = bps is not None
    bps = 1 if bps is None else bps
    planar = planar or 1
    if width is None and height is None:
        raise _Refused("no ImageWidth or ImageLength")
    width, height = width or 0, height or 0
    tiled = tile_w is not None or tile_h is not None
    contig = planar == 1
    if tiled:
        # a RowsPerStrip read before the first tile tag set the tile to
        # (the width read so far, the rows per strip)
        first_tile = min(d.order[t] for t in (322, 323) if t in e)
        if rps is not None and d.order[278] < first_tile:
            tile_w = tile_w if tile_w is not None else (width if 256 in e and d.order[256] < d.order[278] else 0)
            tile_h = tile_h if tile_h is not None else rps
        tile_w, tile_h = tile_w or 0, tile_h or 0
        across = -(-width // tile_w) if tile_w else 0
        nblocks = across * (-(-height // tile_h) if tile_h else 0)
    else:
        nblocks = 1 if rps is None else -(-height // rps)
    per_plane = nblocks
    if not contig:
        nblocks *= spp
    if nblocks == 0:
        raise _Refused(f"no {'tiles' if tiled else 'strips'} in a {width}x{height} image")
    # StripOffsets and TileOffsets fill one field, and so do the byte counts:
    # the later entry of the directory wins
    offsets_tag = max((t for t in (273, 324) if t in e), key=d.order.get, default=None)
    counts_tag = max((t for t in (279, 325) if t in e), key=d.order.get, default=None)
    if offsets_tag is None:
        raise _Refused(f"no {'TileOffsets' if tiled else 'StripOffsets'}")
    # the extra samples: every sample past the photometric's colour channels
    colours = {0: 1, 1: 1, 3: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 32845: 3, 5: 4, 4: 4}.get(photometric or 0, 0)
    if colours and spp - len(extras) > colours:
        extras = extras + [0] * (spp - colours - len(extras))
    colormap = None
    if 320 in e and bps_read and bps <= 16 and e[320][1] == 3 * (1 << bps) and e[320][0] in _TIFF_SHORT_TYPES:
        cm = d.ints(320)
        if cm is not None and max(cm) <= 0xFFFF:
            colormap = np.array(cm, np.int64).reshape(3, -1)
    if photometric == 3 and colormap is None:
        if bps >= 8:
            photometric = 2 if spp == 3 else 1
        else:
            raise _Refused("a palette image without a colour map")

    def strile(tag):
        typ, count, _ = d.entries[tag]
        if typ not in _TIFF_SHORT_TYPES or count * _TIFF_SIZES[typ] >= 1 << 64:  # no IFD types; no overflow
            raise _Refused(f"strip or tile offsets or byte counts libtiff cannot read (tag {tag})")
        vals = d.ints(tag, limit=nblocks)
        if vals is None:
            raise _Refused(f"strip or tile offsets or byte counts libtiff cannot read (tag {tag})")
        return (vals + [0] * nblocks)[:nblocks]

    offsets = strile(offsets_tag)
    row_bytes = _tiff_sizes(tile_w if tiled else width, spp, bps, contig)
    ycc_sub, sampling_row, sub_fetched = (1, 1), 0, False
    if photometric == 6 and contig and spp == 3:  # YCbCr: rows of subsampled blocks
        sub = d.ints(530) if 530 in e and e[530][1] == 2 and e[530][0] in _TIFF_SHORT_TYPES else None
        sub_fetched = bool(sub) and max(sub) <= 0xFFFF
        ycc_sub = (sub[0], sub[1]) if sub_fetched else (2, 2)
        hs, vs = ycc_sub
        if hs not in (1, 2, 4) or vs not in (1, 2, 4):
            raise _Refused(f"the YCbCr subsampling {hs}x{vs} (libtiff reads 1, 2 or 4 each way)")
        sampling_row = (-(-(tile_w if tiled else width) // hs) * (hs * vs + 2) * bps + 7) // 8
        if not tiled:
            row_bytes = sampling_row // vs  # libtiff's scanline size, rounded down
    counts = strile(counts_tag) if counts_tag else None
    n = len(data)

    def estimate():
        if compression != 1:
            space = (16 + 8 + len(d.types) * 20 + 8) if d.big else (8 + 2 + len(d.types) * 12 + 4)
            for typ, count in d.types:  # every entry, repeated tags too
                size = _TIFF_SIZES.get(typ, 0)
                if size == 0:
                    raise _Refused(f"an entry of unknown type {typ}")
                space += size * count if size * count > (8 if d.big else 4) else 0
            space = n if n < space else n - space
            if not contig:
                space //= spp
            est = [space] * nblocks
            if offsets[-1] + est[-1] > n:
                est[-1] = 0 if offsets[-1] >= n else n - offsets[-1]
            return est
        if tiled:
            return [row_bytes * tile_h] * nblocks
        return [row_bytes * (height // (nblocks // (1 if contig else spp)))] * nblocks

    if counts is None:
        if (contig and nblocks > 1) or (not contig and nblocks != spp):
            raise _Refused("no StripByteCounts")
        counts = estimate()
    elif nblocks == 1 and not tiled and offsets[0] != 0 and (
            counts[0] == 0 or (compression == 1 and (
                (offsets[0] <= n and counts[0] > n - offsets[0]) or counts[0] < row_bytes * height))):
        counts = estimate()
    elif (contig and nblocks > 2 and compression == 1 and counts[0] != counts[1] and counts[0] and counts[1]):
        counts = estimate()
    jpeg_ycc = compression == 7 and photometric == 6 and contig
    if jpeg_ycc and spp == 3 and not sub_fetched:  # JPEGFixupTagsSubsampling, before the sizes
        ycc_sub = _jpeg_sof_sampling(data, offsets[0], counts[0], spp) or ycc_sub
    if row_bytes == 0:
        raise _Refused("a zero scanline size")
    if jpeg_ycc:  # TIFFRGBAImageBegin sets JPEGCOLORMODE_RGB: upsampled scanlines and blocks
        row_bytes = _tiff_sizes(tile_w if tiled else width, spp, bps, contig)
    # OpenCV's readHeader and readData
    if photometric is None:
        raise _Refused("no PhotometricInterpretation (OpenCV requires it)")
    if bps not in (1, 4, 8, 10, 12, 14, 16, 32, 64):
        raise _Refused(f"{bps} bits per sample (OpenCV reads 1, 4, 8, 10, 12, 14, 16, 32 or 64)")
    if bps == 4 and photometric != 3:
        raise _Refused("4 bits per sample outside a palette image (OpenCV refuses it)")
    if sample_format not in (None, 1, 2) and bps <= 16:
        raise _Refused(f"the sample format {sample_format} (OpenCV reads unsigned and signed integers)")
    if spp > 4:
        raise _Refused(f"{spp} samples per pixel (OpenCV reads at most 4)")
    _check_size(width, height)
    if not width or not height:
        raise _Refused(f"a {width}x{height} image")
    block_w = tile_w if tiled else width
    block_h = tile_h if tiled else (rps if rps is not None and rps != 0xFFFFFFFF else height)
    if not (0 < block_w <= 1 << 24 and 0 < block_h <= 1 << 24) or \
            block_w * block_h * spp * max(1, bps // 8) >= 1 << 30:
        raise _Refused(f"{block_w}x{block_h} blocks (OpenCV's tile limits)")
    # libtiff's RGBA interface: TIFFRGBAImageOK, TIFFRGBAImageBegin and the put routine
    if compression in _TIFF_NOT_CONFIGURED:
        raise _Refused(f"compression {_TIFF_NOT_CONFIGURED[compression]} ({compression}), which OpenCV's libtiff "
                       "is built without")
    if compression in TIFF_UNPORTED:
        raise _Refused(f"compression {TIFF_UNPORTED[compression]} ({compression}) is not decoded")
    if bps not in (1, 2, 4, 8, 16):
        raise _Refused(f"{bps}-bit samples (libtiff's RGBA interface reads 1, 2, 4, 8 and 16)")
    if sample_format == 3:
        raise _Refused("floating-point samples")
    alpha = 0
    if extras:
        if extras[0] == 0 and spp > 3:
            alpha = 1
        elif extras[0] in (1, 2):
            alpha = extras[0]
    if not extras and spp == 4 and photometric == 2:
        alpha, extras = 1, [1]
    channels = spp - len(extras)
    if photometric in (0, 1, 3):
        if contig and spp != 1 and bps < 8:
            raise _Refused(f"{bps}-bit contiguous samples with {spp} samples per pixel")
    elif photometric == 2:
        if channels < 3:
            raise _Refused(f"an RGB image with {channels} colour channels")
    elif photometric == 5:
        if inkset != 1:
            raise _Refused(f"a separated image with ink set {inkset}")
        if channels < 4:
            raise _Refused(f"a separated image with {channels} colour channels")
    elif photometric == 6:
        pass
    elif photometric == 8:
        if spp != 3 or channels != 3 or bps not in (8, 16):
            raise _Refused(f"a CIE L*a*b* image of {spp} samples, {channels} colour channels, {bps} bits")
    else:
        raise _Refused(f"the photometric interpretation {photometric}")
    put = None
    if contig or spp == 1:
        planes, plane_index = 0, []
        if photometric == 2:
            put = {(8, 1): "rgb8", (8, 2): "rgbua8", (8, 0): "rgb8", (16, 1): "rgb16", (16, 2): "rgbua16",
                   (16, 0): "rgb16"}.get((bps, alpha))
        elif photometric == 5:
            put = "cmyk8" if bps == 8 else None
        elif photometric == 8:
            put = f"cielab{bps}"
        elif jpeg_ycc:  # RGB from libjpeg, which converts three 8-bit components only: any other fails every block
            if bps != 8 or spp != 3:
                raise _Refused(f"a JPEG YCbCr image of {spp} samples at {bps} bits, which libjpeg does not convert")
            put = "rgb8"
        elif photometric == 6:
            put = "ycbcr" if bps == 8 and spp == 3 and ycc_sub in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2),
                                                                   (1, 1)) else None
        elif photometric == 3:
            put = "palette" if bps <= 8 else None
        else:
            put = "grey" if bps in (1, 2, 4, 8, 16) else None
    else:
        grey = photometric in (0, 1, 3)
        planes = (1 if grey else 3) + (1 if alpha else 0)
        plane_index = list(range(planes))
        if photometric in (0, 1, 2):
            put = {(8, 0): "sep8", (8, 1): "sep8", (8, 2): "sepua8", (16, 0): "sep16", (16, 1): "sep16",
                   (16, 2): "sepua16"}.get((bps, alpha))
        elif photometric == 5 and bps == 8 and spp == 4:
            put, planes, plane_index = "sepcmyk8", 4, [0, 1, 2, 3]
        elif photometric == 6 and bps == 8 and spp == 3:
            sub = d.ints(530) if 530 in e and e[530][1] == 2 and e[530][0] in _TIFF_SHORT_TYPES else None
            if (tuple(sub) if sub else (2, 2)) == (1, 1):
                put, planes, plane_index = "sepycbcr", 3, [0, 1, 2]
    white = [0, 1]
    if put in ("cielab8", "cielab16"):  # the white point (D50 by default), as initCIELabConversion reads it
        f = np.float32
        wp = d.floats(318, 2)
        white = [f(96.425) / (f(96.425) + f(100) + f(82.468)), f(100) / (f(96.425) + f(100) + f(82.468))] \
            if wp is None else list(wp)
        if white[1] == 0:
            put = None
    ycc_tables = None
    if put in ("ycbcr", "sepycbcr"):  # initYCbCrConversion, and its checks
        luma = d.floats(529, 3)
        luma = np.array([0.299, 0.587, 0.114], np.float32) if luma is None else luma
        ref = d.floats(532, 6)
        ref = np.array([0, 255, 128, 255, 128, 255], np.float32) if ref is None else ref
        if np.isnan(luma).any() or luma[1] == 0 or not ((ref > -2147483647 + 128) & (ref < 2147483647)).all():
            put = None
        else:
            ycc_tables = _ycbcr_tables(luma, ref)
    if put is None:
        raise _Refused(f"no libtiff put routine for photometric {photometric} at {bps} bits, {spp} samples, "
                       f"planar {planar}")
    if predictor not in (1, 2, 3) or (predictor == 2 and bps not in (8, 16, 32, 64)) or predictor == 3:
        raise _Refused(f"the predictor {predictor} with {bps}-bit samples")
    if compression in _TIFF_FAX and (bps != 1 or (contig and spp != 1)):  # Fax3SetupState fails every block
        raise _Refused(f"a CCITT compression ({compression}) with {bps}-bit samples, {spp} per pixel")
    grey_map = np.zeros(256, np.uint8)
    palette = np.zeros((256, 3), np.uint8)
    if put == "grey":
        levels = 255 if bps == 16 else (1 << bps) - 1
        x = np.arange(levels + 1)
        level = ((levels - x) if photometric == 0 else x) * 255 // levels
        grey_map[: levels + 1] = level
    elif put == "palette":
        cm = colormap[:, : 1 << bps]
        cm = cm >> 8 if (cm >= 256).any() else cm & 0xFF
        palette[: 1 << bps] = cm.T
    block_bytes = row_bytes * (tile_h if tiled else min(rps if rps is not None else height, height))
    if put == "ycbcr":  # TIFFVStripSize / TIFFVTileSize: whole rows of blocks
        block_bytes = -(-(tile_h if tiled else min(rps if rps is not None else height, height)) // ycc_sub[1]) \
            * sampling_row
    from ..ops import native  # builds csrc/tiff.cpp at first use; raises if it cannot

    params = dict(width=width, height=height, block_w=block_w, block_h=block_h,
                  blocks_across=-(-width // block_w) if tiled else 1, blocks_per_plane=per_plane, nblocks=nblocks,
                  row_bytes=row_bytes, block_bytes=block_bytes, tiled=int(tiled), spp=spp, bps=bps,
                  compression=8 if compression == 32946 else compression, predictor=predictor,
                  swab=int(d.e == ">" and bps == 16), bitrev=int(fill_order == 2), mapped=int(mapped),
                  put=_TIFF_PUT[put], flip_h=int(orientation in (2, 3, 6, 7)), planes=planes,
                  plane_index=plane_index, ycc_hs=ycc_sub[0], ycc_vs=ycc_sub[1], sampling_row=sampling_row,
                  white=white, group3_options=group3_options, jpeg_ycc=int(jpeg_ycc))
    status, img = native.tiff_decode(data, params, offsets, counts, grey_map, palette, ycc_tables,
                                     _zlib() if compression in (8, 32946) else None,
                                     _jpeg_tables(d) if compression == 7 else None)
    if status:
        raise _Refused(_TIFF_REFUSED.get(status, f"status {status}"))
    if mapped and orientation >= 5:
        raise _Refused(f"the orientation {orientation} turns the image, which cv2.imread refuses "
                       "(cv2.imdecode turns it)")
    if orientation in (2, 3, 6, 7):  # libtiff mirrored each block; OpenCV turns the whole image
        img = img[:, ::-1]
    if orientation in _ORIENT:
        img = _ORIENT[orientation](img)
    return np.ascontiguousarray(img)


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


def _decode_jpeg(data: bytes) -> np.ndarray:
    from ..ops import native  # builds csrc/jpeg.cpp at first use; raises if it cannot

    status, img, orientation = native.jpeg_decode(data)
    if status:
        raise _Refused(_JPEG_REFUSED.get(status, f"status {status}"))
    if orientation in _ORIENT:
        img = np.ascontiguousarray(_ORIENT[orientation](img))
    return img


# -- WebP ---------------------------------------------------------------------
# The RIFF container as OpenCV 5.0's grfmt_webp.cpp reads it through its
# bundled libwebp: src/dec/webp_dec.c for a still image, src/demux/demux.c
# and src/demux/anim_decode.c for an animation and for the EXIF chunk; the
# VP8L bitstream in csrc/webp.cpp, the VP8 one in csrc/vp8.cpp

WEBP_HEADER_SIZE = 32  # grfmt_webp.cpp: readHeader needs this many bytes
_WEBP_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_WEBP_VALID_FLAGS = 0x3E  # demux.c ALL_VALID_FLAGS: alpha, animation, ICCP, EXIF, XMP
# csrc/webp.cpp's Status codes other than success
_WEBP_REFUSED = {1: "a VP8L header whose signature or version is wrong",
                 2: "the VP8L data ends before the image does", 3: "a VP8L transform given twice",
                 4: "colour cache bits outside 1..11",
                 5: "a prefix code that is over-subscribed, incomplete or empty",
                 6: "prefix code lengths past the alphabet",
                 7: "a backward reference before the first pixel or past the last", 8: "out of memory"}
# csrc/vp8.cpp's
_VP8_REFUSED = {1: "a VP8 frame tag or start code libwebp refuses", 2: "a VP8 frame header under 10 bytes",
                3: "a first VP8 partition longer than the data", 4: "the VP8 segment header ends the first partition",
                5: "the VP8 filter header ends the first partition",
                6: "no room for the VP8 token partitions' sizes", 7: "no byte left for the last VP8 token partition",
                8: "the VP8 intra modes end the first partition", 9: "a VP8 token partition ends inside a macroblock",
                11: "out of memory",
                12: "an ALPH chunk of 1 byte or less, or a method, pre-processing or reserved bits out of range",
                13: "an ALPH chunk's raw plane shorter than the image",
                14: "an ALPH chunk's lossless plane libwebp refuses"}


class _WebPError(Exception):
    """libwebp's BITSTREAM_ERROR, or NOT_ENOUGH_DATA where ``short``."""

    def __init__(self, reason: str, short: bool = False):
        super().__init__(reason)
        self.short = short


def _u24(data: bytes, at: int) -> int:
    return int.from_bytes(data[at : at + 3], "little")


def _le32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at : at + 4], "little")


def _webp_optional_chunks(data: bytes, pos: int, riff_size: int):
    """webp_dec.c ParseOptionalChunks: skips the chunks before the VP8/VP8L
    chunk (odd sizes padded) and returns its offset and the payload's
    (offset, size) of the last ALPH chunk among them, or None."""
    total = 4 + 8 + 10  # "WEBP" and the VP8X chunk
    alpha = None
    while True:
        if len(data) - pos < 8:
            raise _WebPError("the data ends inside the chunks before the image", short=True)
        size = _le32(data, pos + 4)
        if size > _WEBP_MAX_CHUNK_PAYLOAD:
            raise _WebPError(f"a chunk of {size} bytes")
        disk = (8 + size + 1) & ~1
        total = (total + disk) & 0xFFFFFFFF  # uint32, as libwebp adds
        if riff_size and total > riff_size:
            raise _WebPError("chunks past the RIFF size")
        if data[pos : pos + 4] in (b"VP8 ", b"VP8L"):
            return pos, alpha
        if len(data) - pos < disk:
            raise _WebPError("the data ends inside a chunk before the image", short=True)
        if data[pos : pos + 4] == b"ALPH":
            alpha = (pos + 8, size)
        pos += disk


def _vp8_info(data: bytes, pos: int, chunk_size: int):
    """vp8_dec.c VP8GetInfo: a lossy key frame's width and height."""
    bits = int.from_bytes(data[pos : pos + 3], "little")
    w = int.from_bytes(data[pos + 6 : pos + 8], "little") & 0x3FFF
    h = int.from_bytes(data[pos + 8 : pos + 10], "little") & 0x3FFF
    if (data[pos + 3 : pos + 6] != b"\x9d\x01\x2a" or bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk_size or not w or not h):
        raise _WebPError("a VP8 frame header libwebp refuses")
    return w, h


def _webp_headers(data: bytes, full: bool):
    """webp_dec.c ParseHeadersInternal, as WebPGetFeatures runs it on the
    first 32 bytes (``full`` False; a VP8X chunk then answers for the image
    even where the rest is cut off) or WebPDecode on the whole file.
    Returns (width, height, animated, lossless, offset of the bitstream,
    the ALPH payload's (offset, size) or None); the last three are None
    where the VP8X chunk answered."""
    n = len(data)
    if n < 12:
        raise _WebPError("fewer than 12 bytes", short=True)
    riff_size = pos = 0
    riff = data[:4] == b"RIFF"
    if riff:  # ParseRIFF
        if data[8:12] != b"WEBP":
            raise _WebPError("a RIFF file that is not WEBP")
        riff_size = _le32(data, 4)
        if riff_size < 12 or riff_size > _WEBP_MAX_CHUNK_PAYLOAD:
            raise _WebPError(f"a RIFF size of {riff_size}")
        if full and riff_size > n - 8:
            raise _WebPError("the RIFF size passes the end of the data", short=True)
        pos = 12
    if n - pos < 8:  # ParseVP8X
        raise _WebPError("the data ends before the first chunk", short=True)
    vp8x = data[pos : pos + 4] == b"VP8X"
    flags = cw = ch = 0
    if vp8x:
        if _le32(data, pos + 4) != 10:
            raise _WebPError("a VP8X chunk whose size is not 10")
        if n - pos < 18:
            raise _WebPError("the data ends inside the VP8X chunk", short=True)
        flags, cw, ch = _le32(data, pos + 8), 1 + _u24(data, pos + 12), 1 + _u24(data, pos + 15)
        if cw * ch >= 1 << 32:
            raise _WebPError(f"a {cw}x{ch} canvas")
        pos += 18
        if not riff:
            raise _WebPError("a VP8X chunk outside a RIFF file")
    animated = bool(flags & 2)
    if vp8x and animated and not full:
        return cw, ch, True, None, None, None
    alpha = None
    try:
        if n - pos < 4:
            raise _WebPError("the data ends before the image chunk", short=True)
        if (riff and vp8x) or (not riff and not vp8x and data[pos : pos + 4] == b"ALPH"):
            pos, alpha = _webp_optional_chunks(data, pos, riff_size)
        if n - pos < 8:  # ParseVP8Header
            raise _WebPError("the data ends before the image chunk", short=True)
        tag = data[pos : pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            size = _le32(data, pos + 4)
            if riff_size >= 12 and size > riff_size - 12:
                raise _WebPError(f"a {tag.decode()} chunk larger than the RIFF size")
            if full and size > n - pos - 8:
                raise _WebPError(f"the {tag.decode()} chunk passes the end of the data", short=True)
            pos += 8
            lossless = tag == b"VP8L"
        else:  # a bare bitstream: VP8LCheckSignature tells the two apart
            size = n - pos
            lossless = size >= 5 and data[pos] == 0x2F and data[pos + 4] >> 5 == 0
        if size > _WEBP_MAX_CHUNK_PAYLOAD:
            raise _WebPError(f"a bitstream of {size} bytes")
        if not lossless:
            if n - pos < 10:
                raise _WebPError("the data ends inside the VP8 frame header", short=True)
            w, h = _vp8_info(data, pos, size)
        else:  # VP8LGetInfo
            if n - pos < 5:
                raise _WebPError("the data ends inside the VP8L header", short=True)
            head = int.from_bytes(data[pos : pos + 5], "little")
            if head & 0xFF != 0x2F or head >> 37:
                raise _WebPError("a VP8L header whose signature or version is wrong")
            w, h = 1 + ((head >> 8) & 0x3FFF), 1 + ((head >> 22) & 0x3FFF)
        if vp8x and (cw, ch) != (w, h):
            raise _WebPError(f"a {cw}x{ch} canvas around a {w}x{h} image")
    except _WebPError as e:
        if e.short and vp8x and not full:
            return cw, ch, animated, None, None, None
        raise
    return w, h, animated, lossless, pos, alpha


class _WebPFrame:
    num = 0
    complete = False
    alpha = image = None  # (offset, size) of the chunk, its header included
    x = y = w = h = 0


def _webp_demux(data: bytes):
    """demux.c WebPDemux on the whole file, of the extended format (the
    simple format stores no chunks and holds no animation): (canvas width,
    canvas height, flags, frames, the first EXIF payload stored or None).
    Raises _WebPError where it returns NULL. Every NEED_MORE_DATA is an
    error here, since the whole file is given."""
    n = len(data)
    if n < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":  # ReadHeader
        raise _WebPError("not a RIFF WEBP file")
    riff_size = _le32(data, 4)
    if riff_size < 8 or riff_size > _WEBP_MAX_CHUNK_PAYLOAD or n < riff_size + 8:
        raise _WebPError("a RIFF size the demuxer refuses")
    end = riff_size + 8  # nothing past the RIFF payload is read
    if data[12:16] != b"VP8X":
        raise _WebPError("the simple format")
    pos = 20

    def check(size: int):  # SizeIsInvalid, and the data a read needs
        if size > end - pos:
            raise _WebPError("a chunk past the RIFF size")

    vsize = _le32(data, 16)  # ParseVP8X
    if vsize > _WEBP_MAX_CHUNK_PAYLOAD or vsize < 10:
        raise _WebPError(f"a VP8X chunk of {vsize} bytes")
    vsize += vsize & 1
    check(vsize)
    flags, cw, ch = data[pos], 1 + _u24(data, pos + 4), 1 + _u24(data, pos + 7)
    if cw * ch >= 1 << 32:
        raise _WebPError(f"a {cw}x{ch} canvas")
    pos += vsize
    check(8)
    animation = bool(flags & 2)
    frames = []
    exif = None

    def add(frame: _WebPFrame):  # AddFrame
        if frames and not frames[-1].complete:
            raise _WebPError("a frame after an incomplete one")
        frames.append(frame)

    def store_frame(num: int, min_size: int, frame: _WebPFrame):  # StoreFrame
        nonlocal pos
        check(max(8, min_size))
        alpha_chunks = image_chunks = 0
        while True:
            start = pos
            tag, size = data[pos : pos + 4], _le32(data, pos + 4)
            pos += 8
            if size > _WEBP_MAX_CHUNK_PAYLOAD:
                raise _WebPError(f"a chunk of {size} bytes")
            padded = size + (size & 1)
            check(padded)
            if tag == b"ALPH" and not alpha_chunks:
                alpha_chunks = 1
                frame.alpha, frame.num = (start, 8 + padded), num
            elif tag in (b"VP8L", b"VP8 "):
                if tag == b"VP8L" and alpha_chunks:
                    raise _WebPError("an ALPH chunk before a VP8L chunk")
                if image_chunks:
                    pos = start
                    return
                image_chunks = 1
                w, h = _webp_headers(data[start : start + 8 + padded], full=False)[:2]
                frame.image, frame.w, frame.h, frame.num, frame.complete = (start, 8 + padded), w, h, num, True
            else:
                pos = start
                return
            pos += padded
            if pos == end:
                return
            check(8)

    anim_chunks = 0
    while True:  # ParseVP8XChunks
        start = pos
        tag, size = data[pos : pos + 4], _le32(data, pos + 4)
        pos += 8
        if size > _WEBP_MAX_CHUNK_PAYLOAD:
            raise _WebPError(f"a chunk of {size} bytes")
        padded = size + (size & 1)
        check(padded)
        if tag == b"VP8X":
            raise _WebPError("a second VP8X chunk")
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):  # ParseSingleImage
            if anim_chunks or animation:
                raise _WebPError("an image outside the frames of an animation")
            if frames:
                raise _WebPError("a second image")
            pos = start
            frame = _WebPFrame()
            store_frame(1, 0, frame)
            if not flags & 0x10:  # no alpha flag: the ALPH chunk is dropped
                frame.alpha = None
            add(frame)
        elif tag == b"ANIM":
            if padded < 6:
                raise _WebPError("an ANIM chunk under 6 bytes")
            anim_chunks += 1
            pos += padded
        elif tag == b"ANMF":  # ParseAnimationFrame
            if not anim_chunks:
                raise _WebPError("an ANMF chunk before the ANIM chunk")
            check(16)
            if padded < 16:
                raise _WebPError("an ANMF chunk under 16 bytes")
            frame = _WebPFrame()
            frame.x, frame.y = 2 * _u24(data, pos), 2 * _u24(data, pos + 3)
            w, h = 1 + _u24(data, pos + 6), 1 + _u24(data, pos + 9)
            if w * h >= 1 << 32:
                raise _WebPError(f"a {w}x{h} frame")
            pos += 16
            first = pos
            store_frame(len(frames) + 1, padded - 16, frame)
            if pos - first > padded - 16:
                raise _WebPError("a frame's chunks past its ANMF chunk")
            if animation and frame.num:
                add(frame)
        else:  # ICCP, EXIF, XMP (stored where the flags name them) and unknown chunks
            if tag == b"EXIF" and flags & 0x08 and exif is None:
                exif = data[start + 8 : start + 8 + size]
            pos += padded
        if pos == end:
            break
        check(8)
    # IsValidExtendedFormat
    if not frames:
        raise _WebPError("no image")
    if flags & ~_WEBP_VALID_FLAGS:
        raise _WebPError(f"the VP8X flags {flags:#x}")
    for f in frames:
        if not f.complete:
            raise _WebPError("a frame without an image chunk")
        if f.alpha is not None and f.alpha[0] > f.image[0]:
            raise _WebPError("an ALPH chunk after its image")
        if animation:
            fits = f.x + f.w <= cw and f.y + f.h <= ch
        else:
            fits = (f.x, f.y, f.w, f.h) == (0, 0, cw, ch)
        if not fits:
            raise _WebPError(f"a {f.w}x{f.h} frame at ({f.x}, {f.y}) outside the {cw}x{ch} canvas")
    return cw, ch, flags, frames, exif


# ExifReader::parseExifEntry: the tags whose values it reads (a read past
# the payload ends the parse): strings, and rationals by their count
_EXIF_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}


def _exif_orientation(exif: bytes) -> int:
    """OpenCV's ExifReader on a WebP EXIF payload, read as a TIFF header from
    its first byte (a leading ``Exif\\0\\0`` hides it): IFD0's first 0x0112
    entry's 16-bit value, 0 without one. Two equal bytes 'II' are Intel
    order; anything else reads as Motorola order. An entry before it whose
    string or rationals lie past the payload ends the parse, as
    ExifParsingError does."""
    n = len(exif)
    little = n >= 1 and exif[0] == ord("I") and (n == 1 or exif[1] == exif[0])

    def u16(at: int) -> int:
        if at + 1 >= n:
            raise IndexError
        return int.from_bytes(exif[at : at + 2], "little" if little else "big")

    def u32(at: int) -> int:
        if at + 3 >= n:
            raise IndexError
        return int.from_bytes(exif[at : at + 4], "little" if little else "big")

    try:
        if u16(2) != 0x2A:
            return 0
        ifd = u32(4)
        for k in range(u16(ifd)):
            entry = ifd + 2 + 12 * k
            tag = u16(entry)
            if tag == 0x0112:
                return u16(entry + 8)
            if tag in _EXIF_STRINGS:  # getString
                size = u32(entry + 4)
                at = u32(entry + 8) if size > 4 else 8
                if at > n or at + size > n:
                    raise IndexError
            elif tag in _EXIF_RATIONALS:  # getResolution, getWhitePoint, ...
                u32(u32(entry + 8) + 8 * _EXIF_RATIONALS[tag] - 4)
            elif tag in (0x0128, 0x0213):  # getResolutionUnit, getYCbCrPos
                u16(entry + 8)
    except IndexError:  # ExifParsingError: the entries read so far stand
        pass
    return 0


def _decode_webp(data: bytes) -> np.ndarray:
    """The header's first 32 bytes (WebPGetFeatures: fewer refuses the file),
    then a still image (WebPDecode: RIFF size, chunk sizes, VP8X canvas equal
    to the image's size) or the first frame of an animation (WebPAnimDecoder:
    WebPDecode of the frame's ALPH and image chunks, its pixels at its
    offset on a zero canvas, no blending, no background colour), then the
    EXIF orientation, where the demuxer accepts the file and the VP8X flags
    name the chunk."""
    if len(data) < WEBP_HEADER_SIZE:
        raise _Refused(f"fewer than {WEBP_HEADER_SIZE} bytes")
    try:
        w, h, animated = _webp_headers(data[:WEBP_HEADER_SIZE], full=False)[:3]
    except _WebPError as e:
        raise _Refused(f"a header WebPGetFeatures refuses: {e}")
    try:
        demuxed = _webp_demux(data)
    except _WebPError as e:
        if animated:
            raise _Refused(f"an animation the demuxer refuses: {e}")
        demuxed = None
    _check_size(w, h)
    if animated:
        cw, ch, _, frames, exif = demuxed
        first = frames[0]
        start, size = first.image
        img = np.zeros((ch, cw, 3), np.uint8)
        img[first.y : first.y + first.h, first.x : first.x + first.w] = _decode_webp_bitstream(
            data[(first.alpha or first.image)[0] : start + size], "the first frame: ")
    else:
        img = _decode_webp_bitstream(data, "")
        exif = demuxed[4] if demuxed else None
    orientation = _exif_orientation(exif) if exif is not None else 0
    if orientation in _ORIENT:
        img = np.ascontiguousarray(_ORIENT[orientation](img))
    return img


def _decode_webp_bitstream(data: bytes, what: str) -> np.ndarray:
    """WebPDecode: the VP8L bitstream, or the VP8 one with the ALPH chunk
    before it, each read from its chunk to the end of ``data``."""
    from ..ops import native  # builds csrc/webp.cpp with csrc/vp8.cpp at first use; raises if it cannot

    try:
        w, h, _, lossless, pos, alpha = _webp_headers(data, full=True)
    except _WebPError as e:
        raise _Refused(f"{what}{e}")
    if lossless:
        status, img = native.vp8l_decode(data[pos:], w, h)
        refused = _WEBP_REFUSED
    else:
        status, img, _ = native.vp8_decode(data[pos:], w, h, None if alpha is None else data[alpha[0] : sum(alpha)])
        refused = _VP8_REFUSED
    if status:
        raise _Refused(what + refused.get(status, f"status {status}"))
    return img


# -- JPEG 2000 ------------------------------------------------------------------

J2K_MAGIC = b"\xff\x4f\xff\x51"
# what cv2 5.0 decodes in a JPEG 2000 file and this module does not, by the
# decoder's UNPORTED reason (ROADMAP A18): HT (Part 15) code-blocks
J2K_UNPORTED = {"HT (Part 15) code-blocks": "A18"}
_J2K_COLOURS = {16: "sRGB", 17: "grey", 18: "sYCC", 24: "e-YCC", 12: "CMYK"}
_JP2_SIGNATURE, _JP2_FILE_TYPE, _JP2_HEADER = 1, 2, 4


class _Jp2Header:
    """What opj_jp2_read_header keeps of the boxes before the codestream."""

    def __init__(self):
        self.state = 0
        self.has_jp2h = self.has_ihdr = False
        self.ihdr = None  # (w, h, numcomps)
        self.bpc = 0
        self.has_colr = False
        self.enumcs = 0
        self.pclr = None  # the palette: [entries, columns] int64
        self.cmap = None  # [(cmp, mtyp, pcol)]
        self.cdef = None  # [[cn, typ, asoc]]


def _jp2_ihdr(h: _Jp2Header, body: bytes):
    if h.ihdr is not None:  # "Ignoring ihdr box. First ihdr box already read"
        return
    if len(body) != 14:
        raise _Refused("a JP2 ihdr box whose size is not 14 (Bad image header box)")
    ih, iw, nc = struct.unpack(">IIH", body[:10])
    if iw < 1 or ih < 1 or nc < 1:
        raise _Refused(f"a JP2 ihdr box of {iw}x{ih} with {nc} components")
    if nc > 16384:
        raise _Refused("a JP2 ihdr box with an invalid number of components")
    h.ihdr = (iw, ih, nc)
    h.bpc = body[10]
    h.has_ihdr = True


def _jp2_colr(h: _Jp2Header, body: bytes):
    if len(body) < 3:
        raise _Refused("a JP2 colr box of fewer than 3 bytes")
    if h.has_colr:  # only the first colr box counts
        return
    meth = body[0]
    if meth == 1:
        if len(body) < 7:
            raise _Refused("a JP2 colr box of fewer than 7 bytes")
        h.enumcs = struct.unpack(">I", body[3:7])[0]
        h.has_colr = True
    elif meth == 2:  # an ICC profile: the colour space stays unknown
        h.has_colr = True


def _jp2_bpcc(h: _Jp2Header, body: bytes):
    if len(body) != (h.ihdr[2] if h.ihdr else 0):
        raise _Refused("a JP2 bpcc box of another size than the component count")


def _jp2_pclr(h: _Jp2Header, body: bytes):
    if h.pclr is not None:
        raise _Refused("a second JP2 pclr box")
    if len(body) < 3:
        raise _Refused("a JP2 pclr box of fewer than 3 bytes")
    ne, npc = struct.unpack(">HB", body[:3])
    if not 1 <= ne <= 1024:
        raise _Refused(f"a JP2 pclr box with {ne} entries")
    if npc == 0:
        raise _Refused("a JP2 pclr box with no palette column")
    if len(body) < 3 + npc:
        raise _Refused("a JP2 pclr box too short for its columns")
    sizes = [(b & 0x7F) + 1 for b in body[3 : 3 + npc]]
    nbytes = [min((s + 7) >> 3, 4) for s in sizes]
    entries = np.zeros((ne, npc), np.int64)
    at = 3 + npc
    for e in range(ne):
        for c in range(npc):
            if len(body) < at + nbytes[c]:
                raise _Refused("a JP2 pclr box too short for its entries")
            entries[e, c] = int.from_bytes(body[at : at + nbytes[c]], "big")
            at += nbytes[c]
    h.pclr = entries


def _jp2_cmap(h: _Jp2Header, body: bytes):
    if h.pclr is None:
        raise _Refused("a JP2 cmap box before the pclr box")
    if h.cmap is not None:
        raise _Refused("a second JP2 cmap box")
    npc = h.pclr.shape[1]
    if len(body) < 4 * npc:
        raise _Refused("a JP2 cmap box too short")
    h.cmap = [struct.unpack(">HBB", body[4 * i : 4 * i + 4]) for i in range(npc)]


def _jp2_cdef(h: _Jp2Header, body: bytes):
    if h.cdef is not None:
        raise _Refused("a second JP2 cdef box")
    if len(body) < 2:
        raise _Refused("a JP2 cdef box of fewer than 2 bytes")
    n = struct.unpack(">H", body[:2])[0]
    if n == 0:
        raise _Refused("a JP2 cdef box with no channel")
    if len(body) < 2 + 6 * n:
        raise _Refused("a JP2 cdef box too short")
    h.cdef = [list(struct.unpack(">HHH", body[2 + 6 * i : 8 + 6 * i])) for i in range(n)]


_JP2_IMAGE_BOXES = {b"ihdr": _jp2_ihdr, b"colr": _jp2_colr, b"bpcc": _jp2_bpcc, b"pclr": _jp2_pclr,
                    b"cmap": _jp2_cmap, b"cdef": _jp2_cdef}


def _jp2_jp2h(h: _Jp2Header, body: bytes):
    if not h.state & _JP2_FILE_TYPE:
        raise _Refused("a JP2 header box before the file type box")
    has_ihdr = False
    pos = 0
    while pos < len(body):  # opj_jp2_read_boxhdr_char on what is left
        left = len(body) - pos
        if left < 8:
            raise _Refused("a box of fewer than 8 bytes inside the JP2 header box")
        length, kind = struct.unpack(">I4s", body[pos : pos + 8])
        head = 8
        if length == 1:
            if left < 16:
                raise _Refused("an XL box of fewer than 16 bytes inside the JP2 header box")
            hi, length = struct.unpack(">II", body[pos + 8 : pos + 16])
            head = 16
            if hi:
                raise _Refused("a box of 2^32 bytes or more inside the JP2 header box")
        if length == 0:
            raise _Refused("a box of undefined size inside the JP2 header box")
        if length < head or length > left:
            raise _Refused("a box length inside the JP2 header box that does not fit")
        handler = _JP2_IMAGE_BOXES.get(kind)
        if handler:
            handler(h, body[pos + head : pos + length])
        if kind == b"ihdr":
            has_ihdr = True
        pos += length
    if not has_ihdr:
        raise _Refused("a JP2 header box with no ihdr box")
    h.state |= _JP2_HEADER
    h.has_jp2h = True


def _jp2_signature(h: _Jp2Header, body: bytes):
    if h.state:
        raise _Refused("a JP2 signature box that is not the first box")
    if len(body) != 4 or body != b"\r\n\x87\n":
        raise _Refused("a JP2 signature box with a bad size or magic number")
    h.state |= _JP2_SIGNATURE


def _jp2_ftyp(h: _Jp2Header, body: bytes):
    if h.state != _JP2_SIGNATURE:
        raise _Refused("a JP2 file type box that is not the second box")
    if len(body) < 8 or (len(body) - 8) % 4:
        raise _Refused("a JP2 file type box of a bad size")
    h.state |= _JP2_FILE_TYPE


_JP2_BOXES = {b"jP  ": _jp2_signature, b"ftyp": _jp2_ftyp, b"jp2h": _jp2_jp2h}


def _jp2_header(data: bytes):
    """opj_jp2_read_header_procedure: the boxes up to the codestream box →
    (the codestream's offset, _Jp2Header). The codestream runs to the end of
    the data, whatever the jp2c box's length says."""
    h = _Jp2Header()
    pos, n = 0, len(data)
    while True:
        if n - pos < 8:  # opj_jp2_read_boxhdr fails: the procedure ends there
            pos = n
            break
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        pos += 8
        head = 8
        if length == 0:
            length = n - pos + 8
        elif length == 1:
            if n - pos < 8:
                pos = n
                break
            hi, length = struct.unpack(">II", data[pos : pos + 8])
            pos += 8
            head = 16
            if hi:
                break
        if kind == b"jp2c":
            if h.state & _JP2_HEADER:
                break
            raise _Refused("a codestream box before the JP2 header box")
        if length < head:
            raise _Refused(f"a JP2 box of an invalid size ({length})")
        size = length - head
        handler = _JP2_BOXES.get(kind)
        if handler is None and kind in _JP2_IMAGE_BOXES:  # a misplaced image box
            if h.state & _JP2_HEADER:
                handler = _JP2_IMAGE_BOXES[kind]
            else:
                if size > n - pos:
                    raise _Refused("a JP2 box that runs past the end of the data")
                pos += size
                continue
        if handler is not None:
            if size > n - pos:
                raise _Refused("a JP2 box that runs past the end of the data")
            handler(h, data[pos : pos + size])
            pos += size
        else:
            if not h.state & _JP2_SIGNATURE:
                raise _Refused("a JP2 file whose first box is not the signature box")
            if not h.state & _JP2_FILE_TYPE:
                raise _Refused("a JP2 file whose second box is not the file type box")
            if size > n - pos:
                raise _Refused("a JP2 box that runs past the end of the data")
            pos += size
    if not h.has_jp2h:
        raise _Refused("a JP2 file with no JP2 header box")
    if not h.has_ihdr:
        raise _Refused("a JP2 file with no ihdr box")
    return pos, h


def _jp2_check_color(h: _Jp2Header, numcomps: int):
    """opj_jp2_check_color, before the palette and channel definitions apply."""
    if h.cdef is not None:
        nr = numcomps
        if h.pclr is not None and h.cmap is not None:
            nr = h.pclr.shape[1]
        for cn, _, asoc in h.cdef:
            if cn >= nr:
                raise _Refused("a JP2 cdef box naming a channel past the image's")
            if asoc != 65535 and asoc > 0 and asoc - 1 >= nr:
                raise _Refused("a JP2 cdef box associating a channel past the image's")
        for c in range(nr - 1, -1, -1):
            if not any(cn == c for cn, _, _ in h.cdef):
                raise _Refused("a JP2 cdef box with incomplete channel definitions")
    if h.pclr is not None and h.cmap is not None:
        npc = h.pclr.shape[1]
        sane = True
        used = [False] * npc
        for i, (cmp, mtyp, pcol) in enumerate(h.cmap):
            if cmp >= numcomps:
                sane = False
        for i, (cmp, mtyp, pcol) in enumerate(h.cmap):
            if mtyp not in (0, 1) or pcol >= npc or (used[pcol] and mtyp == 1) or (mtyp == 0 and pcol != 0) or (
                    mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        for i, (cmp, mtyp, pcol) in enumerate(h.cmap):
            if not used[i] and mtyp != 0:
                sane = False
        if sane and numcomps == 1 and not all(used):  # "Component mapping seems wrong. Trying to correct."
            h.cmap = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(h.cmap)]
        if not sane:
            raise _Refused("a JP2 cmap box that maps the components wrongly")


def _jp2_apply(h: _Jp2Header, comps: list) -> list:
    """opj_jp2_apply_pclr, then opj_jp2_apply_cdef: the decoded components'
    int32 planes → the image's after them."""
    if h.pclr is not None and h.cmap is not None:
        entries = h.pclr
        new = []
        for cmp, mtyp, pcol in h.cmap:
            if mtyp == 0:
                new.append(comps[cmp])
            else:
                k = np.clip(comps[cmp], 0, len(entries) - 1)
                new.append(entries[:, pcol].astype(np.uint32).view(np.int32)[k])
        comps = new
    if h.cdef is not None:
        info = [list(c) for c in h.cdef]
        for i, (cn, typ, asoc) in enumerate(info):
            if cn >= len(comps) or asoc in (0, 65535):
                continue
            acn = asoc - 1
            if acn >= len(comps):
                continue
            if cn != acn and typ == 0:
                comps[cn], comps[acn] = comps[acn], comps[cn]
                for later in info[i + 1 :]:
                    if later[0] == cn:
                        later[0] = acn
                    elif later[0] == acn:
                        later[0] = cn
    return comps


def _yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) on 8-bit planes: 14-bit fixed point."""
    u = u - 128
    v = v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14

    b = y + descale(u * 33292)
    g = y + descale(u * -6472 + v * -9519)
    r = y + descale(v * 18678)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _decode_jpeg2000(data: bytes) -> np.ndarray:
    """OpenCV 5.0's grfmt_jpeg2000_openjpeg.cpp over OpenJPEG 2.5.3: the JP2
    boxes (or a bare codestream), the main header, cv2's header checks and
    size limits, the decode (``csrc/jpeg2000.cpp``), the JP2 palette and
    channel definitions, then cv2's hand-over to BGR by the colour space:
    sRGB (and an unknown or unspecified one) from the first three
    components, grey from the first, sYCC through cv2's YUV conversion;
    samples above 8 bits shifted right by the largest precision less 8."""
    from ..ops import native  # builds csrc/jpeg2000.cpp at first use; raises if it cannot

    jp2 = None
    offset, ihdr = 0, (0, 0)
    if data[:4] != J2K_MAGIC:
        offset, jp2 = _jp2_header(data)
        ihdr = jp2.ihdr[:2]
    codestream = data[offset:]
    status, header, reason = native.j2k_header(codestream, *ihdr)
    if status:
        raise _Refused(_j2k_reason(status, reason))
    x0, y0, x1, y1, numcomps, comps = header
    if not 1 <= numcomps <= 4:
        raise _Refused(f"{numcomps} components (cv2 reads 1 to 4)")
    if any(sgnd for _, sgnd, _, _ in comps):
        raise _Refused("a signed component (cv2 refuses them)")
    max_prec = max(prec for prec, _, _, _ in comps)
    if max_prec < 8:
        raise _Refused(f"a precision of {max_prec} bits (cv2 refuses precisions below 8)")
    _check_size(x1 - x0, y1 - y0)
    if x0 or y0 or any(dx != 1 or dy != 1 for _, _, dx, dy in comps):
        raise _Refused("an image origin other than 0 or a sub-sampled component (cv2: tiles are not supported)")
    status, planes, reason = native.j2k_decode(codestream, *ihdr, numcomps, x1, y1)
    if status:
        raise _Refused(_j2k_reason(status, reason))
    space = "unknown"
    planes = list(planes)
    if jp2 is not None:
        _jp2_check_color(jp2, numcomps)
        space = _J2K_COLOURS.get(jp2.enumcs, "unknown")
        planes = _jp2_apply(jp2, planes)
    shift = max_prec - 8  # the header's: a palette's entries are shifted by the indices' precision
    chans = [(p >> shift if shift else p).astype(np.uint8) for p in planes]  # static_cast<uchar>: the low byte
    if space in ("unknown", "sRGB"):
        if len(chans) < 3:
            raise _Refused(f"{len(chans)} components in an sRGB image (cv2 converts 3 or 4)")
        return np.ascontiguousarray(np.stack([chans[2], chans[1], chans[0]], -1))
    if space == "grey":
        return np.ascontiguousarray(np.stack([chans[0]] * 3, -1))
    if space == "sYCC":
        if len(chans) < 3:
            raise _Refused(f"{len(chans)} components in an sYCC image (cv2 converts 3 or more)")
        return _yuv_to_bgr(*(c.astype(np.int64) for c in chans[:3]))
    raise _Refused(f"the colour space {space} (cv2: unsupported color space conversion)")


def _j2k_reason(status: int, reason: str) -> str:
    if status == 3:
        return f"{reason} (ROADMAP {J2K_UNPORTED.get(reason, 'A18')}): the feature is not decoded"
    return f"OpenJPEG refuses it: {reason}"


# -- AVIF -----------------------------------------------------------------------

# what cv2 5.0 decodes in an AVIF file and this module does not, by the
# reason logged, with its ROADMAP item
AVIF_UNPORTED = {
    "10/12-bit samples": "A14.7c",
    "grids": "A14.7c",
    "image sequences' first frame": "A14.7c",
    "layered images (a1op, lsel)": "A14.7c",
    "a frame scaled to its ispe size": "A14.7c",
    "premultiplied alpha (prem)": "A14.7c",
}
_AVIF_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
# the properties libavif parses; any other is opaque, and an opaque one
# marked essential hides its item
_AVIF_PARSED = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi", b"a1op", b"lsel",
                b"a1lx", b"clli")
_AVIF_MUST_BE_ESSENTIAL = (b"a1op", b"lsel", b"clap", b"irot", b"imir")


def _avif_unported(what: str) -> _Refused:
    return _Refused(f"{what} (ROADMAP {AVIF_UNPORTED[what]}): the feature is not decoded")


class _AvifStream:
    """libavif's avifROStream over ``data[pos:end]``: a read past the end
    fails the parse."""

    def __init__(self, data: bytes, pos: int, end: int, what: str):
        self.data, self.pos, self.end, self.what = data, pos, end, what
        self.bit = 0  # bits of the current byte already read by bits()

    def take(self, n: int) -> bytes:
        self.bit = 0
        if n > self.end - self.pos:
            raise _Refused(f"libavif refuses it: Box[{self.what}] ends too early")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def bits(self, count: int) -> int:
        v = 0
        for _ in range(count):
            if self.bit == 0 and self.pos >= self.end:
                raise _Refused(f"libavif refuses it: Box[{self.what}] ends too early")
            v = (v << 1) | ((self.data[self.pos] >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v

    def version(self, enforce=None):
        version, flags = self.uint(1), self.uint(3)
        if enforce is not None and version != enforce:
            raise _Refused(f"libavif refuses it: Box[{self.what}] version {version}")
        return version, flags

    def string(self) -> bytes:
        zero = self.data.find(b"\0", self.pos, self.end)
        if zero < 0:
            raise _Refused(f"libavif refuses it: Box[{self.what}] has a string without its NULL")
        out = self.data[self.pos:zero]
        self.pos = zero + 1
        return out

    def left(self) -> int:
        return self.end - self.pos

    def box_header(self, top: bool = False, file_end: int = 0):
        """avifROStreamReadBoxHeaderPartial (and, below the top level, the
        check that the box fits in its parent): (type, payload start,
        payload end)."""
        size = self.uint(4)
        kind = self.take(4)
        header = 8
        if size == 1:
            size = self.uint(8)
            header = 16
        if kind == b"uuid":
            self.take(16)
            header += 16
        if size == 0:
            if not top:
                raise _Refused(f"libavif refuses it: Box[{self.what}] holds a box of size 0")
            size = header + (file_end - self.pos)
        if size < header:
            raise _Refused(f"libavif refuses it: a box of size {size} in Box[{self.what}]")
        if not top and size - header > self.end - self.pos:
            raise _Refused(f"libavif refuses it: Box[{self.what}] holds a box that runs past it")
        return kind, self.pos, self.pos + size - header


class _AvifItem:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.extents = []  # (offset, length)
        self.size = 0
        self.idat = False
        self.props = []  # (type, value, essential)
        self.unsupported_essential = False
        self.ipma_seen = False
        self.thumb_for = self.aux_for = self.prem_by = 0

    def prop(self, kind: bytes):
        return next((v for k, v, _ in self.props if k == kind), None)

    def skipped(self) -> bool:  # avifDecoderItemShouldBeSkipped
        return (not self.size or self.unsupported_essential or self.type not in (b"av01", b"grid")
                or self.thumb_for != 0)


class _AvifMeta:
    def __init__(self):
        self.items = {}  # id → item, in the order libavif creates them
        self.props = []  # (type, value)
        self.primary = 0
        self.idat = None

    def item(self, item_id: int) -> _AvifItem:
        if item_id not in self.items:
            self.items[item_id] = _AvifItem(item_id)
        return self.items[item_id]


def _avif_property(kind: bytes, s: _AvifStream):
    """The value of a property libavif parses (a failure refuses the file)."""
    if kind == b"ispe":
        s.version(0)
        return s.uint(4), s.uint(4)
    if kind == b"auxC":
        s.version(0)
        return s.string()
    if kind == b"colr":
        ctype = s.take(4)
        if ctype == b"nclx":
            cp, tc, mc = s.uint(2), s.uint(2), s.uint(2)
            full = s.bits(1)
            if s.bits(7):
                raise _Refused("libavif refuses it: Box[colr] contains nonzero reserved bits")
            return ("nclx", cp, tc, mc, full)
        return ("icc",) if ctype in (b"rICC", b"prof") else ("other",)
    if kind == b"av1C":
        if s.bits(1) != 1:
            raise _Refused("libavif refuses it: av1C contains illegal marker")
        if s.bits(7) != 1:
            raise _Refused("libavif refuses it: av1C contains illegal version")
        profile, _level, _tier, high, twelve, mono, ssx, ssy, _pos = (s.bits(3), s.bits(5), s.bits(1), s.bits(1),
                                                                      s.bits(1), s.bits(1), s.bits(1), s.bits(1),
                                                                      s.bits(2))
        s.take(1)
        return {"depth": 12 if twelve else (10 if high else 8), "mono": mono, "ss": (ssx, ssy), "profile": profile}
    if kind == b"pixi":
        s.version(0)
        n = s.uint(1)
        if not 1 <= n <= 4:
            raise _Refused(f"libavif refuses it: Box[pixi] contains unsupported plane count [{n}]")
        depths = [s.uint(1) for _ in range(n)]
        if any(d != depths[0] for d in depths):
            raise _Refused("libavif refuses it: Box[pixi] contains mismatched plane depths")
        return depths
    if kind == b"irot":
        v = s.uint(1)
        if v & 0xFC:
            raise _Refused("libavif refuses it: Box[irot] contains nonzero reserved bits")
        return v & 3
    if kind == b"imir":
        v = s.uint(1)
        if v & 0xFE:
            raise _Refused("libavif refuses it: Box[imir] contains nonzero reserved bits")
        return v & 1
    if kind == b"clap":
        return [s.uint(4) for _ in range(8)]
    if kind == b"pasp":
        return s.uint(4), s.uint(4)
    if kind == b"a1op":
        v = s.uint(1)
        if v > 31:
            raise _Refused(f"libavif refuses it: Box[a1op] contains an unsupported operating point [{v}]")
        return v
    if kind == b"lsel":
        v = s.uint(2)
        if v != 0xFFFF and v >= 4:
            raise _Refused(f"libavif refuses it: Box[lsel] contains an unsupported layer [{v}]")
        return v
    if kind == b"a1lx":
        s.bits(7)
        large = s.bits(1)
        return [s.uint(4 if large else 2) for _ in range(3)]
    if kind == b"clli":
        return s.uint(2), s.uint(2)
    return None


def _avif_iloc(meta: _AvifMeta, s: _AvifStream):
    version, _ = s.version()
    if version > 2:
        raise _Refused(f"libavif refuses it: Box[iloc] has an unsupported version [{version}]")
    offset_size, length_size, base_size = s.bits(4), s.bits(4), s.bits(4)
    index_size = s.bits(4)  # reserved in version 0
    if version == 0:
        index_size = 0
    if any(v not in (0, 4, 8) for v in (offset_size, length_size, base_size, index_size)):
        raise _Refused("libavif refuses it: Box[iloc] has an invalid size")
    count = s.uint(2 if version < 2 else 4)
    for _ in range(count):
        item_id = s.uint(2 if version < 2 else 4)
        if item_id == 0:
            raise _Refused("libavif refuses it: Box[iloc] has an invalid item ID [0]")
        item = meta.item(item_id)
        if item.extents:
            raise _Refused(f"libavif refuses it: Item ID [{item_id}] contains duplicate sets of extents")
        if version in (1, 2):
            if s.bits(12):
                raise _Refused("libavif refuses it: Box[iloc] has a non null reserved field")
            method = s.bits(4)
            if method not in (0, 1):
                raise _Refused(f"libavif refuses it: Box[iloc] has an unsupported construction method [{method}]")
            item.idat = method == 1
        s.uint(2)  # data_reference_index
        base = s.uint(base_size)
        for _ in range(s.uint(2)):
            # an extent_index is not read, whatever index_size says (libavif)
            off, length = s.uint(offset_size), s.uint(length_size)
            if off > (1 << 64) - 1 - base:
                raise _Refused(f"libavif refuses it: Item ID [{item_id}] contains an extent offset which overflows")
            item.extents.append((base + off, length))
            item.size += length


def _avif_iinf(meta: _AvifMeta, s: _AvifStream):
    version, _ = s.version()
    if version > 1:
        raise _Refused(f"libavif refuses it: Box[iinf] has an unsupported version {version}")
    for _ in range(s.uint(2 if version == 0 else 4)):
        kind, start, end = s.box_header()
        if kind != b"infe":
            raise _Refused("libavif refuses it: Box[iinf] contains a box that isn't type 'infe'")
        e = _AvifStream(s.data, start, end, "infe")
        v, _ = e.version()
        if v not in (2, 3):
            raise _Refused(f"libavif refuses it: Box[infe]: Expecting box version 2 or 3, got version {v}")
        item_id = e.uint(2 if v == 2 else 4)
        if item_id == 0:
            raise _Refused("libavif refuses it: Box[infe] has an invalid item ID [0]")
        e.uint(2)  # item_protection_index
        item_type = e.take(4)
        e.string()  # item_name
        if item_type == b"mime":
            e.string()
        meta.item(item_id).type = item_type
        s.pos = end


def _avif_iref(meta: _AvifMeta, s: _AvifStream):
    version, _ = s.version()
    while s.left() >= 1:
        kind, _start, _end = s.box_header()
        if version > 1:
            break  # an unsupported iref version is skipped
        from_id = s.uint(2 if version == 0 else 4)
        if from_id == 0:
            raise _Refused("libavif refuses it: Box[iref] has an invalid item ID [0]")
        for _ in range(s.uint(2)):
            to_id = s.uint(2 if version == 0 else 4)
            if to_id == 0:
                raise _Refused("libavif refuses it: Box[iref] has an invalid item ID [0]")
            item = meta.item(from_id)
            if kind == b"thmb":
                item.thumb_for = to_id
            elif kind == b"auxl":
                item.aux_for = to_id
            elif kind == b"dimg":
                meta.item(to_id)
            elif kind == b"prem":
                item.prem_by = to_id


def _avif_iprp(meta: _AvifMeta, s: _AvifStream):
    kind, start, end = s.box_header()
    if kind != b"ipco":
        raise _Refused("libavif refuses it: Failed to find Box[ipco] as the first box in Box[iprp]")
    c = _AvifStream(s.data, start, end, "ipco")
    while c.left() >= 1:
        pkind, pstart, pend = c.box_header()
        value = _avif_property(pkind, _AvifStream(s.data, pstart, pend, pkind.decode("latin-1"))) \
            if pkind in _AVIF_PARSED else None
        meta.props.append((pkind, value))
        c.pos = pend
    s.pos = end
    seen = []
    while s.left() >= 1:
        kind, start, end = s.box_header()
        if kind != b"ipma":
            raise _Refused("libavif refuses it: Box[iprp] contains a box that isn't type 'ipma'")
        a = _AvifStream(s.data, start, end, "ipma")
        version, flags = a.version()
        if (version, flags) in seen:
            raise _Refused("libavif refuses it: Multiple Box[ipma] with a given pair of values of version and flags")
        if len(seen) == 2:
            raise _Refused("libavif refuses it: Exceeded possible count of unique ipma version and flags tuples")
        seen.append((version, flags))
        prev = 0
        for _ in range(a.uint(4)):
            item_id = a.uint(2 if version < 1 else 4)
            if item_id == 0:
                raise _Refused("libavif refuses it: Box[ipma] has an invalid item ID [0]")
            if item_id <= prev:
                raise _Refused("libavif refuses it: Box[ipma] item IDs are not ordered by increasing ID")
            prev = item_id
            item = meta.item(item_id)
            if item.ipma_seen:
                raise _Refused(f"libavif refuses it: Duplicate Box[ipma] for item ID [{item_id}]")
            item.ipma_seen = True
            for _ in range(a.uint(1)):
                essential = a.bits(1)
                index = a.bits(15 if flags & 1 else 7)
                if index == 0:
                    if essential:
                        raise _Refused(f"libavif refuses it: Item ID [{item_id}] has an essential property "
                                       "association with index 0")
                    continue
                index -= 1
                if index >= len(meta.props):
                    raise _Refused(f"libavif refuses it: Box[ipma] for item ID [{item_id}] contains an illegal "
                                   f"property index [{index}]")
                pkind, value = meta.props[index]
                if pkind == b"a1lx" and essential:
                    raise _Refused("libavif refuses it: an a1lx property association marked essential")
                if pkind in _AVIF_PARSED:
                    if not essential and pkind in _AVIF_MUST_BE_ESSENTIAL:
                        raise _Refused(f"libavif refuses it: Item ID [{item_id}] has a {pkind.decode()} property "
                                       "association which must be marked essential, but is not")
                elif essential:
                    item.unsupported_essential = True
                item.props.append((pkind, value, essential))
        s.pos = end


def _avif_children(data: bytes, start: int, end: int, what: str):
    """The child boxes of ``data[start:end]``, each inside it."""
    s = _AvifStream(data, start, end, what)
    while s.left() >= 1:
        s.pos = s.box_header()[2]


def _avif_meta(meta: _AvifMeta, data: bytes, start: int, end: int):
    """avifParseMetaBox: hdlr first, each unique box at most once."""
    s = _AvifStream(data, start, end, "meta")
    s.version(0)
    seen = set()
    first = True
    while s.left() >= 1:
        kind, bstart, bend = s.box_header()
        b = _AvifStream(data, bstart, bend, kind.decode("latin-1"))
        if first:
            if kind != b"hdlr":
                raise _Refused("libavif refuses it: Box[meta] does not have a Box[hdlr] as its first child box")
            b.version(0)
            if b.uint(4) != 0:
                raise _Refused("libavif refuses it: Box[hdlr] contains a pre_defined value that is nonzero")
            if b.take(4) != b"pict":
                raise _Refused("libavif refuses it: Box[hdlr] handler_type is not 'pict'")
            b.take(12)
            b.string()
            first = False
            seen.add(kind)
        elif kind in (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            if kind in seen:
                raise _Refused(f"libavif refuses it: Box[meta] contains a duplicate unique box of type "
                               f"'{kind.decode()}'")
            seen.add(kind)
            if kind == b"iloc":
                _avif_iloc(meta, b)
            elif kind == b"pitm":
                version, _ = b.version()
                meta.primary = b.uint(2 if version == 0 else 4)
            elif kind == b"idat":
                meta.idat = data[bstart:bend]
            elif kind == b"iprp":
                _avif_iprp(meta, b)
            elif kind == b"iinf":
                _avif_iinf(meta, b)
            else:
                _avif_iref(meta, b)
        s.pos = bend
    if first:
        raise _Refused("libavif refuses it: Box[meta] has no child boxes")


def _avif_parse(data: bytes):
    """avifParse over the whole file: the top-level boxes until ftyp and
    what its brands need (meta for 'avif', moov for 'avis') are seen →
    (meta, major brand, whether a moov box was seen)."""
    pos = 0
    ftyp = None
    meta = None
    moov = False
    needs_meta = needs_moov = False
    while True:
        if pos > len(data):
            raise _Refused("libavif refuses it: a box runs past the end of the data")
        if pos == len(data):
            break
        s = _AvifStream(data, pos, min(len(data), pos + 32), "file")
        kind, start, end = s.box_header(top=True, file_end=len(data))
        if kind in (b"ftyp", b"meta", b"moov") and end > len(data):
            raise _Refused(f"libavif refuses it: the {kind.decode()} box is cut (truncated data)")
        pos = end
        if kind == b"ftyp":
            if ftyp is not None:
                raise _Refused("libavif refuses it: a second ftyp box")
            if end - start < 8 or (end - start - 8) % 4:
                raise _Refused("libavif refuses it: Box[ftyp] is malformed")
            brands = [data[start:start + 4]] + [data[k:k + 4] for k in range(start + 8, end, 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise _Refused("libavif refuses it: the ftyp box names neither 'avif' nor 'avis'")
            ftyp = brands
            needs_meta, needs_moov = b"avif" in brands, b"avis" in brands
        elif kind == b"meta":
            if meta is not None:
                raise _Refused("libavif refuses it: a second meta box")
            meta = _AvifMeta()
            _avif_meta(meta, data, start, end)
        elif kind == b"moov":
            moov = True
        if ftyp is not None and (not needs_meta or meta is not None) and (not needs_moov or moov):
            return meta, ftyp[0], moov
    if ftyp is None:
        raise _Refused("libavif refuses it: no ftyp box")
    raise _Refused("libavif refuses it: the data ends before the meta (or moov) box (truncated data)")


AVIF_SIGNATURE_SIZE = 500  # grfmt_avif.cpp: the bytes cv2's AVIF signature check parses


def _avif_signature(data: bytes, meta: _AvifMeta, color: _AvifItem) -> bool:
    """cv2 takes a file for AVIF when avifDecoderParse over its first 500
    bytes (an IO that fails a read past them and gives a short one across
    them; a file under 500 bytes padded with spaces, as imdecode's
    findDecoder pads its signature buffer) ends in success or in truncated
    data. The full parse succeeded, so what is left to fail is a read that
    starts past the window: a top-level box header before the boxes the
    brands need are complete, or, when those boxes end inside the window and
    the primary item has no nclx colour box, the item data libavif reads for
    the sequence header's colour description.

    A top-level box of size 0 runs to the end of what the IO holds: for
    ftyp, meta and moov that is the window's end (cv2 sets the IO's size
    hint to 1e9, so libavif reads "to the end" and gets the window), and
    the box is parsed on what the window holds of it. A child box that the
    window cuts, or the padding read as a box, fails that parse: the mdat
    after a meta of size 0 does, unless the file is 500 bytes or more and
    the window ends where a box ends. Any other box of size 0 runs past the
    window."""
    window = AVIF_SIGNATURE_SIZE
    sig = data[:window].ljust(window, b" ")
    pos = 0
    needs_meta = needs_moov = None
    seen = set()
    while True:
        if pos > window:
            return False
        if pos == window:
            return True
        s = _AvifStream(sig, pos, min(window, pos + 32), "file")
        try:
            kind, start, end = s.box_header(top=True, file_end=max(len(data), window + 1))
        except _Refused:
            return False
        if kind in (b"ftyp", b"meta", b"moov") and sig[pos:pos + 4] == b"\0\0\0\0":
            end = window
            try:
                if kind == b"ftyp" and (end - start < 8 or (end - start - 8) % 4):
                    raise _Refused("libavif refuses it: Box[ftyp] is malformed")
                if kind == b"meta":
                    _avif_meta(_AvifMeta(), sig, start, end)
                if kind == b"moov":
                    _avif_children(sig, start, end, "moov")
            except _Refused:
                return False
        if kind in (b"ftyp", b"meta", b"moov") and end > window:
            return True
        if kind == b"ftyp":
            brands = [sig[start:start + 4]] + [sig[k:k + 4] for k in range(start + 8, end, 4)]
            needs_meta, needs_moov = b"avif" in brands, b"avis" in brands
        seen.add(kind)
        pos = end
        if needs_meta is not None and (not needs_meta or b"meta" in seen) and (not needs_moov or b"moov" in seen):
            break
    if color.idat or any(k == b"colr" and v[0] == "nclx" for k, v, _ in color.props):
        return True
    for off, length in color.extents:
        if off > window:
            return False
        if off + length > window:
            return True
    return True


def _avif_item_data(meta: _AvifMeta, item: _AvifItem, data: bytes) -> bytes:
    """avifDecoderItemRead: the extents in order, from the file or idat."""
    out = []
    for off, length in item.extents:
        if item.idat:
            idat = meta.idat or b""
            if not idat:
                raise _Refused(f"libavif refuses it: item {item.id} is in an idat box that is missing or empty")
            if off > len(idat) or length > len(idat) - off:
                raise _Refused(f"libavif refuses it: item {item.id} has an impossible extent in the idat buffer")
            out.append(idat[off:off + length])
        else:
            if off > len(data):
                raise _Refused(f"libavif refuses it: item {item.id} has an extent past the end (truncated data?)")
            chunk = data[off:off + length]
            if len(chunk) != length:
                raise _Refused(f"libavif refuses it: item {item.id} tried to read {length} bytes, but only "
                               f"received {len(chunk)} bytes")
            out.append(chunk)
    return b"".join(out)


def _avif_check_properties(item: _AvifItem):
    """avifDecoderItemValidateProperties (cv2 turns libavif's strict checks
    off): an av1C, and a pixi, where there is one, of the av1C's depth."""
    av1c = item.prop(b"av1C")
    if av1c is None:
        raise _Refused(f"libavif refuses it: item {item.id} is missing its mandatory av1C property")
    pixi = item.prop(b"pixi")
    if pixi is not None and any(d != av1c["depth"] for d in pixi):
        raise _Refused(f"libavif refuses it: item {item.id}'s pixi depth does not match its av1C")
    return av1c


def _decode_av1(stream: bytes, what: str, size, max_area: int = 0) -> tuple:
    """The AV1 item through ``csrc/av1.cpp`` → ([planes, H, W] uint8, info).
    A frame of another size than ``size`` (the image's ispe), which libavif
    scales to it, is named before it is decoded; with ``size`` None a frame
    of any size up to ``max_area`` samples is decoded."""
    from ..ops import native  # builds csrc/av1.cpp at first use; raises if it cannot

    status, info, reason = native.av1_info(stream)
    if status == 3:
        raise _avif_unported(reason)
    if status:
        raise _Refused(f"libaom refuses the {what}: {reason}")
    if (int(info[0]), int(info[1])) != size and (size is not None or int(info[0]) * int(info[1]) > max_area):
        raise _avif_unported("a frame scaled to its ispe size")
    status, planes, reason = native.av1_decode(stream, info)
    if status == 3:
        raise _avif_unported(reason)
    if status:
        raise _Refused(f"libaom refuses the {what}: {reason}")
    return planes, info


def _decode_avif(data: bytes) -> np.ndarray:
    """OpenCV 5.0's grfmt_avif.cpp over libavif 1.4.2 and libaom 3.14.1:
    the boxes by libavif's rules (strict checks off), the primary item and
    its alpha item, cv2's channel count from the av1C (one for a
    monochrome one, whose Y plane is taken as it is), then libavif's YUV
    to BGR (``native.avif_yuv_to_bgr``); the alpha item is decoded, and a
    bad one refuses the file, but dropped."""
    meta, major, moov = _avif_parse(data)
    if major == b"avis" or (major != b"avif" and moov):
        raise _avif_unported("image sequences' first frame")
    for item in meta.items.values():  # avifDecoderReset harvests every image item's ispe
        if item.skipped():
            continue
        ispe = item.prop(b"ispe")
        if ispe is None:
            if item.prop(b"auxC") not in _AVIF_ALPHA_URNS:
                raise _Refused(f"libavif refuses it: Item ID [{item.id}] is missing a mandatory ispe property")
        elif not ispe[0] or not ispe[1] or ispe[0] > 32768 or ispe[1] > 32768 or ispe[0] * ispe[1] > 16384 * 16384:
            raise _Refused(f"libavif refuses it: Item ID [{item.id}] has an ispe of {ispe[0]}x{ispe[1]}")
    color = next((it for it in meta.items.values() if not it.skipped() and it.id == meta.primary), None)
    if color is None:
        raise _Refused("libavif refuses it: Primary item not found")
    if not _avif_signature(data, meta, color):
        raise _Refused("cv2 does not take it for AVIF: its signature check needs a read past the first "
                       f"{AVIF_SIGNATURE_SIZE} bytes")
    if color.type == b"grid":
        raise _avif_unported("grids")
    alpha = next((it for it in meta.items.values() if not it.skipped() and it.aux_for == color.id
                  and it.prop(b"auxC") in _AVIF_ALPHA_URNS), None)
    av1c = _avif_check_properties(color)
    if alpha is not None:
        _avif_check_properties(alpha)
    ispe = color.prop(b"ispe")
    if ispe is None:
        raise _Refused("libavif refuses it: the primary item has no ispe property")
    width, height = ispe
    _check_size(width, height)
    if alpha is not None and alpha.prop(b"ispe") not in (None, ispe):
        raise _Refused("libavif refuses it: the alpha item's ispe differs from the color item's")
    for item in (color, alpha):
        if item is not None and ((item.prop(b"a1op") or 0) != 0 or item.prop(b"lsel") not in (None, 0xFFFF)):
            raise _avif_unported("layered images (a1op, lsel)")
    if av1c["depth"] != 8:
        raise _avif_unported("10/12-bit samples")
    if av1c["mono"] and alpha is not None:  # cv2 reads two channels, which it cannot convert
        raise _Refused("a monochrome av1C with an alpha item (cv2 asserts on two channels)")
    planes, info = _decode_av1(_avif_item_data(meta, color, data), "color item", (width, height))
    if alpha is not None:  # libavif scales an alpha plane of another size; its samples are dropped
        _decode_av1(_avif_item_data(meta, alpha, data), "alpha item", None, 4 * width * height)
        if color.prem_by == alpha.id:
            raise _avif_unported("premultiplied alpha (prem)")
    if av1c["mono"]:  # cv2 reads one channel: the Y plane as it is
        return np.ascontiguousarray(np.repeat(planes[0][..., None], 3, -1))
    # libavif's CICP: the colr nclx box where there is one, else the sequence header's
    nclx = next((v for k, v, _ in color.props if k == b"colr" and v[0] == "nclx"), None)
    primaries, matrix, full_range = ((nclx[1], nclx[3], nclx[4]) if nclx is not None
                                     else (int(info[6]), int(info[8]), int(info[9])))
    from ..ops import native  # built with csrc/av1.cpp, loaded by the decode above

    ss_x, ss_y = int(info[4]), int(info[5])
    bgr = native.avif_yuv_to_bgr(planes, ss_x, ss_y, matrix, primaries, full_range)
    if bgr is None:
        layout = "4:0:0" if len(planes) == 1 else {(0, 0): "4:4:4", (1, 0): "4:2:2", (1, 1): "4:2:0"}[ss_x, ss_y]
        raise _Refused(f"libavif refuses to convert it: matrix coefficients {matrix} in "
                       f"{'full' if full_range else 'limited'} range, {layout}")
    return bgr


# -- entry points -------------------------------------------------------------

_DECODERS = {"png": _decode_png, "bmp": _decode_bmp, "jpeg": _decode_jpeg, "pnm": _decode_netpbm,
             "sunraster": _decode_sunraster, "pfm": _decode_pfm, "hdr": _decode_hdr,
             "gif": _decode_gif, "tiff": _decode_tiff, "webp": _decode_webp,
             "jpeg2000": _decode_jpeg2000, "avif": _decode_avif}
# the formats that cv2 decodes and this module does not, by their sniffed name
FORMAT_NAMES = {k: v for k, v in FORMAT_LABELS.items() if k not in _DECODERS}


def decode_image(data: bytes, mapped: bool = False) -> Optional[np.ndarray]:
    """Encoded image bytes → [H, W, 3] BGR uint8 ([H, W] for a grey PFM, as
    ``cv2.imdecode`` gives it), or ``None`` where cv2 5.0 gives ``None`` (or
    raises) and for the formats this module does not decode. Every
    ``None`` logs one warning that names the format and the reason.
    ``mapped``: the bytes are a file's, read as ``cv2.imread`` maps it
    (this changes one rule, of uncompressed TIFF tiles)."""
    data = bytes(data)
    fmt = sniff_format(data)
    decoder = _DECODERS.get(fmt)
    if decoder is None:
        if fmt == "unknown":
            log.warning("image payload of unknown format: not decoded")
        else:
            log.warning("%s payload: the format is not decoded (%s are)", FORMAT_LABELS[fmt],
                        ", ".join(FORMAT_LABELS[k] for k in _DECODERS))
        return None
    try:
        img = _decode_tiff(data, mapped) if fmt == "tiff" else decoder(data)
        return img if img.flags.writeable else img.copy()  # not a view of ``data``
    except _Refused as e:
        log.warning("%s payload not decoded: %s", FORMAT_LABELS[fmt], e)
    except (struct.error, ValueError, IndexError, OverflowError) as e:  # malformed inside a well-formed container
        log.warning("%s payload not decoded: malformed data (%s)", FORMAT_LABELS[fmt], e)
    return None


def read_image(path: str) -> Optional[np.ndarray]:
    """``cv2.imread``: ``decode_image`` of a file's bytes, read as mapped;
    ``None`` when it cannot be read, and for a grey PFM, whose [H, W]
    decode ``imread`` refuses where ``imdecode`` returns it."""
    try:
        with open(path, "rb") as f:
            img = decode_image(f.read(), mapped=True)
    except OSError:
        return None
    if img is not None and img.ndim == 2:
        log.warning("PFM file not read: a grey PFM, which cv2.imread refuses (cv2.imdecode gives [H, W])")
        return None
    return img
