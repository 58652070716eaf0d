"""Build and ctypes bindings of the port's host C++: the DB-postprocess
core, ``csrc/dbpost.cpp``, the JPEG decoder, ``csrc/jpeg.cpp``, the BMP
run-length decoder, ``csrc/bmp_rle.cpp``, the Radiance HDR scanline
decoder, ``csrc/hdr_rgbe.cpp``, the GIF LZW decoder,
``csrc/gif_lzw.cpp``, the TIFF strip and tile decoder, ``csrc/tiff.cpp``,
built together with ``csrc/jpeg.cpp`` (its JPEG blocks, through
``csrc/jpeg_tiff.h``), and the WebP decoders, lossless (VP8L,
``csrc/webp.cpp``) and lossy (VP8 with its ALPH plane, ``csrc/vp8.cpp``),
built together (the lossy one's lossless alpha plane through
``csrc/webp_alpha.h``), and the bilinear warps of ``ops/geometry.py``,
``csrc/warp.cpp`` (cv2 5.0's ``warpAffine`` / ``warpPerspective``), and
the text drawing of ``train/cv2_text.py``, ``csrc/cv2_text.cpp`` (cv2
5.0's ``putText`` with its upright Rubik face), and the JPEG 2000
codestream decoder, ``csrc/jpeg2000.cpp`` (OpenJPEG 2.5.3's), and the
AV1 decoder of still pictures, ``csrc/av1.cpp`` (libaom 3.14.1's, with the
default tables of ``csrc/av1_tables.h``), built together with libavif
1.4.2's YUV to BGR, ``csrc/avif_yuv.cpp``.

Counterpart of ``ppocr_tpu/ops/native.py``. The JAX package runs the
contour half of the DB postprocess on cv2 and keeps the C++ core as an
alternative; the machines that serve the port need not have cv2, so here
the C++ core is the only backend. It is host code (border following,
scanline polygon scoring, rotating-calipers min-area rects, closed-form
unclip), not a GPU kernel.

Each source (with the files it is built with) is compiled at first use
with the host compiler into ``_build/lib<name>-<hash>.so`` (``_build/`` is
listed in ``.gitignore``), the hash taken over the files and the flags. There is no ``-march=native``
among them, so a file built on one host loads on any other. Several worker
processes may boot together: the build runs under a file lock and the
library is written under another name and moved into place with
``os.replace``, so no process can load a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .kernels import BUILD_DIR, CSRC

SOURCE = CSRC / "dbpost.cpp"
JPEG_SOURCE = CSRC / "jpeg.cpp"
BMP_RLE_SOURCE = CSRC / "bmp_rle.cpp"
HDR_SOURCE = CSRC / "hdr_rgbe.cpp"
GIF_SOURCE = CSRC / "gif_lzw.cpp"
TIFF_SOURCE = CSRC / "tiff.cpp"
WEBP_SOURCE = CSRC / "webp.cpp"
VP8_SOURCE = CSRC / "vp8.cpp"
WARP_SOURCE = CSRC / "warp.cpp"
CV2_TEXT_SOURCE = CSRC / "cv2_text.cpp"
JPEG2000_SOURCE = CSRC / "jpeg2000.cpp"
AV1_SOURCE = CSRC / "av1.cpp"
# the files a library is built with besides its source (a header counts in
# the hash only): the TIFF decoder hands its JPEG blocks to jpeg.cpp, the
# lossy WebP decoder its lossless alpha planes to webp.cpp, the AV1 decoder
# sits beside the AVIF colour conversion
BUILT_WITH = {TIFF_SOURCE: (JPEG_SOURCE, CSRC / "jpeg_tiff.h"),
              WEBP_SOURCE: (VP8_SOURCE, CSRC / "webp_alpha.h"),
              AV1_SOURCE: (CSRC / "av1_tables.h", CSRC / "avif_yuv.cpp")}
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_jpeg_lib = None
_bmp_rle_lib = None
_hdr_lib = None
_gif_lib = None
_tiff_lib = None
_webp_lib = None
_warp_lib = None
_cv2_text_lib = None
_jpeg2000_lib = None
_av1_lib = None
_lock = threading.Lock()  # detect runs in the service's worker threads


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++ or c++) found: the port's host C++ cannot be built")


def build(source: Optional[Path] = None) -> Path:
    """Compile ``source`` (``csrc/<name>.cpp``, default ``SOURCE``), with the
    ``.cpp`` files ``BUILT_WITH`` names for it, into
    ``_build/lib<name>-<hash>.so`` (skipped when that file exists) and
    return its path. Raises with the compiler's output when the build
    fails."""
    source = source or SOURCE
    also = BUILT_WITH.get(source, ())
    digest = hashlib.sha1(source.read_bytes())
    for extra in also:
        digest.update(extra.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    lib = BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    cxx = _cxx()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f"{source.stem}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(source), *(str(f) for f in also if f.suffix == ".cpp")],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if run.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on {source}:\n{run.stdout}")
        os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the core; returns the ctypes handle."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.dbpost_boxes_from_bitmap.restype = ctypes.c_int
            lib.dbpost_boxes_from_bitmap.argtypes = [
                fp,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_float,
                ctypes.c_float,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                fp,
                ctypes.c_int,
            ]
            lib.dbpost_min_area_rect.restype = None
            lib.dbpost_min_area_rect.argtypes = [fp, ctypes.c_int, fp]
            _lib = lib
    return _lib


def boxes_from_bitmap(
    pred: np.ndarray,
    bitmap: np.ndarray,
    box_thresh: float,
    unclip_ratio: float,
    score_mode: str = "slow",
    max_candidates: int = 1000,
    min_size: int = 3,
) -> Tuple[List[np.ndarray], List[float]]:
    """Bitmap → (int64 quads [4, 2] in pred-map coordinates, their scores)
    (postprocess_op.cpp:255-331). The contours come in cv2's bottom-up
    order and ``max_candidates`` cuts that order. A box is kept when the
    longer side of its min-area rect is at least ``min_size`` and that of
    its unclipped rect at least ``min_size + 2``. ``bitmap`` must have
    ``pred``'s shape: the core indexes both with the same dims."""
    lib = load_library()
    pred = np.ascontiguousarray(pred, np.float32)
    bmp = np.ascontiguousarray((np.asarray(bitmap) > 0).astype(np.uint8))
    if pred.ndim != 2 or bmp.shape != pred.shape:
        raise ValueError(
            f"bitmap shape {bmp.shape} != pred shape {pred.shape} "
            "(the postprocess core requires same-resolution 2-D maps)"
        )
    h, w = pred.shape
    max_boxes = max(int(max_candidates), 0)
    out_boxes = np.zeros((max_boxes, 4, 2), np.int32)
    out_scores = np.zeros((max_boxes,), np.float32)
    n = lib.dbpost_boxes_from_bitmap(
        pred.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bmp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w,
        h,
        ctypes.c_float(box_thresh),
        ctypes.c_float(unclip_ratio),
        1 if score_mode == "slow" else 0,
        max_boxes,
        int(min_size),
        out_boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_boxes,
    )
    return [out_boxes[i].astype(np.int64) for i in range(n)], out_scores[:n].tolist()


def min_area_rect(points: np.ndarray):
    """Min-area rotated rect of a point set, as ``cv2.minAreaRect`` gives
    it up to the choice of side order: ((cx, cy), (w, h), degrees)."""
    lib = load_library()
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 2)
    out = np.zeros(5, np.float32)
    lib.dbpost_min_area_rect(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(pts),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    cx, cy, w, h, ang = out
    return (float(cx), float(cy)), (float(w), float(h)), float(np.degrees(ang))


def load_jpeg_library() -> ctypes.CDLL:
    """Build (if needed) and load the JPEG decoder; returns the handle."""
    global _jpeg_lib
    with _lock:
        if _jpeg_lib is None:
            lib = ctypes.CDLL(str(build(JPEG_SOURCE)))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.jpeg_header.restype = ctypes.c_int
            lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                i32p,
            ]
            _jpeg_lib = lib
    return _jpeg_lib


def jpeg_decode(data: bytes) -> Tuple[int, Optional[np.ndarray], int]:
    """JPEG bytes → (status, [H, W, 3] BGR uint8 or None, EXIF orientation
    1..8 or 0). Status 0 is success; the others are ``csrc/jpeg.cpp``'s
    ``Status`` codes. The orientation is not applied here."""
    lib = load_jpeg_library()
    data = bytes(data)
    info = np.zeros(3, np.int32)
    status = lib.jpeg_header(data, len(data), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if status:
        return status, None, 0
    w, h = int(info[0]), int(info[1])
    out = np.empty((h, w, 3), np.uint8)
    status = lib.jpeg_decode(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if status:
        return status, None, 0
    return 0, out, int(info[2])


def load_bmp_rle_library() -> ctypes.CDLL:
    """Build (if needed) and load the BMP run-length decoder."""
    global _bmp_rle_lib
    with _lock:
        if _bmp_rle_lib is None:
            lib = ctypes.CDLL(str(build(BMP_RLE_SOURCE)))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.bmp_rle_decode.restype = ctypes.c_int
            lib.bmp_rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, ctypes.c_int32, u8p, u8p]
            _bmp_rle_lib = lib
    return _bmp_rle_lib


def bmp_rle_decode(data: bytes, offset: int, width: int, height: int, bits: int,
                   palette: np.ndarray) -> Tuple[int, np.ndarray]:
    """The BI_RLE8 (``bits`` 8) or BI_RLE4 (4) stream of a BMP from byte
    ``offset`` → (status, [height, width, 3] BGR uint8 in the stream's row
    order). ``palette`` is [256, 4] uint8 (B, G, R, reserved). Status 0 is
    success; 1: the data ends before the image does; 2: a run passes the
    end of its row. The image is only meaningful on status 0."""
    pal = np.ascontiguousarray(palette, np.uint8)
    if pal.shape != (256, 4) or bits not in (4, 8) or width <= 0 or height <= 0:
        raise ValueError(f"bmp_rle_decode: palette {pal.shape}, {bits} bits, {width}x{height}")
    lib = load_bmp_rle_library()
    out = np.zeros((height, width, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    status = lib.bmp_rle_decode(data, len(data), offset, width, height, bits, pal.ctypes.data_as(u8p),
                                out.ctypes.data_as(u8p))
    return status, out


def load_hdr_library() -> ctypes.CDLL:
    """Build (if needed) and load the Radiance HDR scanline decoder."""
    global _hdr_lib
    with _lock:
        if _hdr_lib is None:
            lib = ctypes.CDLL(str(build(HDR_SOURCE)))
            lib.hdr_decode.restype = ctypes.c_int
            lib.hdr_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
            _hdr_lib = lib
    return _hdr_lib


def hdr_decode(data: bytes, offset: int, width: int, height: int) -> Tuple[int, np.ndarray]:
    """The RGBE scanlines of a Radiance HDR file from byte ``offset`` →
    (status, [height, width, 3] BGR uint8). Status 0 is success; 1: the
    data ends before the image does; 2: a scanline of another width; 3: a
    run count of 0 or past the end of its channel. The image is only
    meaningful on status 0."""
    if width <= 0 or height <= 0:
        raise ValueError(f"hdr_decode: {width}x{height}")
    lib = load_hdr_library()
    out = np.zeros((height, width, 3), np.uint8)
    status = lib.hdr_decode(data, len(data), offset, width, height, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return status, out


def load_gif_library() -> ctypes.CDLL:
    """Build (if needed) and load the GIF frame decoder."""
    global _gif_lib
    with _lock:
        if _gif_lib is None:
            lib = ctypes.CDLL(str(build(GIF_SOURCE)))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32 = ctypes.c_int32
            lib.gif_frame.restype = ctypes.c_int
            lib.gif_frame.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i32, i32, i32, u8p, u8p, i32,
                                      u8p, u8p, i32, i32, i32, i32]
            _gif_lib = lib
    return _gif_lib


def gif_frame(data: bytes, offset: int, frame: Tuple[int, int, int, int], interlaced: bool, colours: np.ndarray,
              known: np.ndarray, transparent: Optional[int], background, screen: Tuple[int, int]
              ) -> Tuple[int, np.ndarray]:
    """Decode a GIF frame's LZW data (its code size byte at ``offset``)
    onto a screen: ``frame`` is (left, top, width, height) inside
    ``screen`` (width, height), ``colours`` [256, 3] BGR, ``known`` [256]
    bool (the entries the colour tables hold), ``transparent`` the index
    that keeps the ``background`` BGR colour. Returns (status, [H, W, 3]
    BGR uint8); status 0 is success, the others are ``csrc/gif_lzw.cpp``'s
    codes, and the image is only meaningful on 0."""
    left, top, w, h = frame
    sw, sh = screen
    if not (w > 0 and h > 0 and left + w <= sw and top + h <= sh):
        raise ValueError(f"gif_frame: a {w}x{h} frame at ({left}, {top}) on a {sw}x{sh} screen")
    lib = load_gif_library()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    pal = np.ascontiguousarray(colours, np.uint8)
    flags = np.ascontiguousarray(known, np.uint8)
    fill = np.ascontiguousarray(background, np.uint8)
    out = np.empty((sh, sw, 3), np.uint8)
    status = lib.gif_frame(data, len(data), offset, w, h, int(interlaced), pal.ctypes.data_as(u8p),
                           flags.ctypes.data_as(u8p), -1 if transparent is None else transparent,
                           fill.ctypes.data_as(u8p), out.ctypes.data_as(u8p), sw, sh, left, top)
    return status, out


class TiffParams(ctypes.Structure):
    """``csrc/tiff.cpp``'s ``TiffParams``."""

    _fields_ = [(name, ctypes.c_int64) for name in ("width", "height", "block_w", "block_h", "blocks_across",
                                                    "blocks_per_plane", "nblocks", "row_bytes", "block_bytes")] + [
        (name, ctypes.c_int32) for name in ("tiled", "spp", "bps", "compression", "predictor", "swab", "bitrev",
                                            "mapped", "put", "flip_h", "planes")] + [
        ("plane_index", ctypes.c_int32 * 4), ("ycc_hs", ctypes.c_int32), ("ycc_vs", ctypes.c_int32),
        ("sampling_row", ctypes.c_int64), ("white", ctypes.c_float * 2), ("group3_options", ctypes.c_int32),
        ("jpeg_ycc", ctypes.c_int32)]


def load_tiff_library() -> ctypes.CDLL:
    """Build (if needed) and load the TIFF strip and tile decoder (with the
    JPEG decoder its JPEG blocks go to)."""
    global _tiff_lib
    with _lock:
        if _tiff_lib is None:
            lib = ctypes.CDLL(str(build(TIFF_SOURCE)))
            u8p, u64p, vp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p
            lib.tiff_decode.restype = ctypes.c_int
            lib.tiff_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(TiffParams), u64p, u64p,
                                        u8p, u8p, ctypes.POINTER(ctypes.c_int32), vp, vp, vp, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_int64, u8p]
            _tiff_lib = lib
    return _tiff_lib


def tiff_decode(data: bytes, params: dict, offsets: np.ndarray, counts: np.ndarray, grey_map: np.ndarray,
                palette: np.ndarray, ycbcr: Optional[np.ndarray] = None, zlib: Optional[ctypes.CDLL] = None,
                jpeg_tables: Optional[bytes] = None) -> Tuple[int, np.ndarray]:
    """Decode a TIFF image's strips or tiles (``params``: ``TiffParams``'
    fields; ``offsets`` / ``counts``: every strip's or tile's offset and byte
    count; ``grey_map`` [256] uint8, the grey level of a sample; ``palette``
    [256, 3] uint8 RGB; ``ycbcr`` [5, 256] int32, libtiff's YCbCr to RGB
    tables; ``zlib``: the zlib library, for deflate; ``jpeg_tables``: the
    JPEGTables tag's bytes, for JPEG) → (status, [height, width, 3] BGR
    uint8, each block at its stored place). Status 0 is success; 1: a
    block's data cannot be read; 2: an uncompressed tile whose byte count is
    not the tile's size; 4: the JPEG codec refuses the first plane's block.
    The image is only meaningful on 0."""
    p = TiffParams()
    for name, value in params.items():
        if name == "plane_index":
            p.plane_index[:] = (list(value) + [0, 0, 0, 0])[:4]
        elif name == "white":
            p.white[:] = [float(v) for v in value]
        else:
            setattr(p, name, int(value))
    if p.width <= 0 or p.height <= 0 or p.block_w <= 0 or p.block_h <= 0:
        raise ValueError(f"tiff_decode: a {p.width}x{p.height} image in {p.block_w}x{p.block_h} blocks")
    offs = np.ascontiguousarray(offsets, np.uint64)
    cnts = np.ascontiguousarray(counts, np.uint64)
    if len(offs) != p.nblocks or len(cnts) != p.nblocks:
        raise ValueError(f"tiff_decode: {len(offs)} offsets and {len(cnts)} counts for {p.nblocks} blocks")
    gmap = np.ascontiguousarray(grey_map, np.uint8)
    pal = np.ascontiguousarray(palette, np.uint8)
    if gmap.shape != (256,) or pal.shape != (256, 3):
        raise ValueError(f"tiff_decode: grey map {gmap.shape}, palette {pal.shape}")
    ycc = np.ascontiguousarray(np.zeros((5, 256)) if ycbcr is None else ycbcr, np.int32)
    if ycc.shape != (5, 256):
        raise ValueError(f"tiff_decode: YCbCr tables {ycc.shape}")
    lib = load_tiff_library()
    u8p, u64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64)
    fns = [None, None, None]
    version = None
    if zlib is not None:
        fns = [ctypes.cast(getattr(zlib, f), ctypes.c_void_p).value for f in ("inflateInit2_", "inflate", "inflateEnd")]
        version = zlib.zlibVersion()
    out = np.zeros((p.height, p.width, 3), np.uint8)
    status = lib.tiff_decode(data, len(data), ctypes.byref(p), offs.ctypes.data_as(u64p), cnts.ctypes.data_as(u64p),
                             gmap.ctypes.data_as(u8p), pal.ctypes.data_as(u8p),
                             ycc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), *fns, version, jpeg_tables,
                             len(jpeg_tables or b""), out.ctypes.data_as(u8p))
    if status == 3:
        raise ValueError("tiff_decode: parameters the decoder does not take")
    return status, out


def load_webp_library() -> ctypes.CDLL:
    """Build (if needed) and load the WebP decoders, lossless (VP8L) and
    lossy (VP8)."""
    global _webp_lib
    with _lock:
        if _webp_lib is None:
            lib = ctypes.CDLL(str(build(WEBP_SOURCE)))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.vp8l_decode.restype = ctypes.c_int
            lib.vp8l_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p, ctypes.c_int32, ctypes.c_int32]
            lib.vp8_decode.restype = ctypes.c_int
            lib.vp8_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, u8p, u8p,
                                       ctypes.c_int32, ctypes.c_int32]
            _webp_lib = lib
    return _webp_lib


def vp8l_decode(data: bytes, width: int, height: int) -> Tuple[int, Optional[np.ndarray]]:
    """A VP8L bitstream (the chunk's payload and whatever follows it) →
    (status, [height, width, 3] BGR uint8, the alpha dropped, or None).
    ``width`` and ``height`` are its header's. Status 0 is success; the
    others are ``csrc/webp.cpp``'s codes."""
    if width <= 0 or height <= 0:
        raise ValueError(f"vp8l_decode: {width}x{height}")
    lib = load_webp_library()
    out = np.empty((height, width, 3), np.uint8)
    status = lib.vp8l_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), width, height)
    if status == 9:
        raise ValueError(f"vp8l_decode: {width}x{height} is not the header's size")
    return status, (None if status else out)


def vp8_decode(data: bytes, width: int, height: int, alpha: Optional[bytes] = None,
               want_alpha: bool = False) -> Tuple[int, Optional[np.ndarray], Optional[np.ndarray]]:
    """A VP8 key frame (the chunk's payload and whatever follows it in the
    data WebPDecode reads) with its ALPH chunk's payload, if any →
    (status, [height, width, 3] BGR uint8 or None, the [height, width]
    alpha plane where ``want_alpha``, else None). ``width`` and ``height``
    are the frame header's. Status 0 is success; the others are
    ``csrc/vp8.cpp``'s codes."""
    if width <= 0 or height <= 0:
        raise ValueError(f"vp8_decode: {width}x{height}")
    lib = load_webp_library()
    out = np.empty((height, width, 3), np.uint8)
    plane = np.empty((height, width), np.uint8) if want_alpha and alpha is not None else None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    status = lib.vp8_decode(data, len(data), alpha, -1 if alpha is None else len(alpha), out.ctypes.data_as(u8p),
                            None if plane is None else plane.ctypes.data_as(u8p), width, height)
    if status == 10:
        raise ValueError(f"vp8_decode: {width}x{height} is not the frame header's size")
    return status, (None if status else out), (None if status else plane)


def load_warp_library() -> ctypes.CDLL:
    """Build (if needed) and load the bilinear warps."""
    global _warp_lib
    with _lock:
        if _warp_lib is None:
            lib = ctypes.CDLL(str(build(WARP_SOURCE)))
            u8p, fp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
            lib.warp_bilinear_u8.restype = ctypes.c_int
            lib.warp_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
                                             ctypes.c_int, fp, ctypes.c_int, fp]
            _warp_lib = lib
    return _warp_lib


def warp_bilinear(img: np.ndarray, inverse: np.ndarray, width: int, height: int, perspective: bool,
                  border: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] image (C 1 to 4) sampled bilinearly at the positions
    the f32 3×3 ``inverse`` maps each pixel of the [height, width, C] output
    to, as cv2 5.0 warps; a tap outside the image reads ``border`` (C
    values)."""
    src = np.ascontiguousarray(img, np.uint8)
    h, w, cn = src.shape
    m = np.ascontiguousarray(inverse, np.float32).reshape(9)
    bv = np.ascontiguousarray(border, np.float32).reshape(cn)
    out = np.empty((height, width, cn), np.uint8)
    u8p, fp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    status = load_warp_library().warp_bilinear_u8(
        src.ctypes.data_as(u8p), h, w, cn, out.ctypes.data_as(u8p), height, width, m.ctypes.data_as(fp),
        int(perspective), bv.ctypes.data_as(fp))
    if status:
        raise ValueError(f"warp_bilinear: {img.shape} image to {height}x{width}")
    return out


def load_cv2_text_library() -> ctypes.CDLL:
    """Build (if needed) and load the text drawing of ``train/cv2_text.py``."""
    global _cv2_text_lib
    with _lock:
        if _cv2_text_lib is None:
            lib = ctypes.CDLL(str(build(CV2_TEXT_SOURCE)))
            u8p, i16p, i32p = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16),
                               ctypes.POINTER(ctypes.c_int32))
            lib.cv2_text_draw.restype = ctypes.c_int
            lib.cv2_text_draw.argtypes = [i32p, ctypes.c_int, ctypes.c_longlong, u8p, i16p, i32p, i16p, i16p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, u8p,
                                          i32p]
            _cv2_text_lib = lib
    return _cv2_text_lib


def load_jpeg2000_library() -> ctypes.CDLL:
    """Build (if needed) and load the JPEG 2000 codestream decoder."""
    global _jpeg2000_lib
    with _lock:
        if _jpeg2000_lib is None:
            lib = ctypes.CDLL(str(build(JPEG2000_SOURCE)))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.j2k_header.restype = ctypes.c_int
            lib.j2k_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, i32p,
                                       ctypes.c_char_p, ctypes.c_int]
            lib.j2k_decode.restype = ctypes.c_int
            lib.j2k_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, i32p,
                                       ctypes.c_int64, i32p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            _jpeg2000_lib = lib
    return _jpeg2000_lib


def j2k_header(codestream: bytes, ihdr_w: int = 0, ihdr_h: int = 0):
    """A JPEG 2000 codestream's main header (the data from its SOC to the
    end of the file) → (status, (x0, y0, x1, y1, numcomps, [(prec, sgnd,
    dx, dy)] of the first four components) or None, OpenJPEG's reason).
    ``ihdr_w`` / ``ihdr_h``: a JP2 file's ihdr size, which SIZ must match
    (0 for a bare codestream). Status 0 is success; the others are
    ``csrc/jpeg2000.cpp``'s ``Status`` codes (3: a feature not decoded)."""
    lib = load_jpeg2000_library()
    info = np.zeros(21, np.int32)
    msg = ctypes.create_string_buffer(256)
    status = lib.j2k_header(codestream, len(codestream), ihdr_w, ihdr_h,
                            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), msg, len(msg))
    if status:
        return status, None, msg.value.decode(errors="replace")
    n = int(info[4])
    comps = [tuple(int(v) for v in info[5 + 4 * i : 9 + 4 * i]) for i in range(min(n, 4))]
    return 0, (int(info[0]), int(info[1]), int(info[2]), int(info[3]), n, comps), ""


def j2k_decode(codestream: bytes, ihdr_w: int, ihdr_h: int, numcomps: int, width: int, height: int,
               threads: int = 0):
    """Decode a codestream whose header ``j2k_header`` read (origin 0, no
    sub-sampled component, ``numcomps`` of 1 to 4) → (status, [numcomps,
    height, width] int32 samples or None, OpenJPEG's reason). ``threads``:
    the host threads that decode code-blocks and wavelet rows (0: the
    cores, at most 8); the samples do not depend on it."""
    lib = load_jpeg2000_library()
    out = np.empty((numcomps, height, width), np.int32)
    info = np.zeros(8, np.int32)
    msg = ctypes.create_string_buffer(256)
    i32p = ctypes.POINTER(ctypes.c_int32)
    status = lib.j2k_decode(codestream, len(codestream), ihdr_w, ihdr_h, out.ctypes.data_as(i32p), out.size,
                            info.ctypes.data_as(i32p), threads, msg, len(msg))
    if status == 4:
        raise ValueError(f"j2k_decode: a {numcomps}x{height}x{width} output the header does not describe")
    if status:
        return status, None, msg.value.decode(errors="replace")
    return 0, out, ""


AV1_INFO = ("width", "height", "bit_depth", "mono", "ss_x", "ss_y", "color_primaries", "transfer", "matrix",
            "color_range", "profile", "still_picture", "reduced_header", "base_q_idx", "tiles", "allow_intrabc",
            "allow_screen_content_tools", "use_128x128", "grain_bit", "header_bits")
# the tool counters of ``av1_decode(..., stats=...)`` (``csrc/av1.cpp``'s ST_*)
AV1_STATS = {"partition": (0, 10), "y_mode": (10, 23), "uv_mode": (23, 37), "angle_delta": 37, "palette_y": 38,
             "palette_uv": 39, "filter_intra": 40, "intrabc": 41, "tiles": 42, "blocks": 43, "palette_cache": 44,
             "segment_id": 45, "edge_upsample": 46, "edge_filter": 47, "golomb": 48,
             "tx_size": (49, 68), "tx_type": (68, 84), "qm": 84, "delta_q": 85, "vartx_split": 86, "residual": 87,
             "sub8x8_chroma": 88, "chroma_subpel_dv": 89, "cfl_subsampled": 90, "uv_tx_size": (91, 110),
             "lf_edges": (110, 122), "cdef_y": 122, "cdef_uv": 123, "cdef_skip": 124, "cdef_unset": 125,
             "cdef_bits": 126, "lr_units": (127, 136), "lr_stripes": 136, "lr_sgr_sets": (137, 153),
             "lr_unit_sizes": (153, 157), "lr_uv_shift": 157, "lr_boundary": 158,
             "superres": (160, 168), "superres_lr_rows": 168, "grain": (169, 172), "grain_ar_lag": (172, 176),
             "grain_overlap": 176, "grain_from_luma": 177, "grain_clip": 178, "grain_odd": 179}
# the deblocking filter's lengths, the order of the "lf_edges" counters within each plane's four
AV1_LF_LENGTHS = (4, 6, 8, 14)
# loop restoration's unit types, the order of the "lr_units" counters within each plane's three,
# and its unit sizes, the order of the "lr_unit_sizes" counters
AV1_LR_TYPES = ("none", "wiener", "sgrproj")
AV1_LR_UNIT_SIZES = (32, 64, 128, 256)
AV1_STATS_SIZE = 180  # ST_COUNT
# libaom's TX_SIZE order, the order of the "tx_size" counters
AV1_TX_SIZES = ("4x4", "8x8", "16x16", "32x32", "64x64", "4x8", "8x4", "8x16", "16x8", "16x32", "32x16", "32x64",
                "64x32", "4x16", "16x4", "8x32", "32x8", "16x64", "64x16")


def load_av1_library() -> ctypes.CDLL:
    """Build (if needed) and load the AV1 decoder."""
    global _av1_lib
    with _lock:
        if _av1_lib is None:
            lib = ctypes.CDLL(str(build(AV1_SOURCE)))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.av1_info.restype = ctypes.c_int
            lib.av1_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, ctypes.c_char_p, ctypes.c_int]
            lib.av1_decode.restype = ctypes.c_int
            lib.av1_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                                       i32p, ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_int]
            lib.av1_inverse_transform.restype = ctypes.c_int
            lib.av1_inverse_transform.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                                                  ctypes.c_int]
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            lib.av1_loop_filter.restype = ctypes.c_int
            lib.av1_loop_filter.argtypes = [u8p] + [ctypes.c_int] * 6
            lib.av1_cdef_find_dir.restype = ctypes.c_int
            lib.av1_cdef_find_dir.argtypes = [u16p, ctypes.c_int, i32p]
            lib.av1_cdef_filter.restype = ctypes.c_int
            lib.av1_cdef_filter.argtypes = [u8p, ctypes.c_int, u16p] + [ctypes.c_int] * 8
            lib.av1_wiener_filter.restype = ctypes.c_int
            lib.av1_wiener_filter.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16)]
            lib.av1_selfguided_filter.restype = ctypes.c_int
            lib.av1_selfguided_filter.argtypes = [u8p] + [ctypes.c_int] * 4 + [i32p, u8p, ctypes.c_int]
            lib.av1_convolve_horiz_rs.restype = ctypes.c_int
            lib.av1_convolve_horiz_rs.argtypes = [u8p, ctypes.c_int, u8p] + [ctypes.c_int] * 5
            lib.av1_film_grain.restype = ctypes.c_int
            lib.av1_film_grain.argtypes = [ctypes.c_void_p, u8p, u8p, u8p] + [ctypes.c_int] * 7
            lib.avif_yuv_to_bgr.restype = ctypes.c_int
            lib.avif_yuv_to_bgr.argtypes = [u8p] * 3 + [ctypes.c_int] * 8 + [u8p]
            _av1_lib = lib
    return _av1_lib


def av1_info(stream: bytes):
    """An AV1 stream's sequence header and first frame header → (status,
    int32 [len(AV1_INFO)] or None, libaom's reason). Status 0 is success;
    the others are ``csrc/av1.cpp``'s ``Status`` codes (3: a feature not
    decoded, the reason its name)."""
    lib = load_av1_library()
    info = np.zeros(len(AV1_INFO), np.int32)
    msg = ctypes.create_string_buffer(256)
    status = lib.av1_info(stream, len(stream), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), msg, len(msg))
    if status:
        return status, None, msg.value.decode(errors="replace")
    return 0, info, ""


def av1_decode(stream: bytes, info: np.ndarray, stats: Optional[np.ndarray] = None,
               stage_ms: Optional[np.ndarray] = None):
    """Decode a stream whose headers ``av1_info`` read → (status, the uint8
    planes [Y] or [Y, U, V] (U and V of ((height + ss_y) >> ss_y, (width +
    ss_x) >> ss_x)) or None, libaom's reason). ``stats``: an int32 array of
    ``AV1_STATS_SIZE`` that gets the tool counters (``AV1_STATS``);
    ``stage_ms``: a float64 array of 6 that gets the wall ms of the tiles'
    syntax and reconstruction, of deblocking, of CDEF, of loop
    restoration, of superres and of film grain."""
    lib = load_av1_library()
    planes = 1 if info[3] else 3
    w, h, ss_x, ss_y = (int(info[k]) for k in (0, 1, 4, 5))
    cw, ch = (w + ss_x) >> ss_x, (h + ss_y) >> ss_y
    out = np.empty(w * h + (planes - 1) * cw * ch, np.uint8)
    if stats is None:
        stats = np.zeros(AV1_STATS_SIZE, np.int32)
    if stats.dtype != np.int32 or stats.size < AV1_STATS_SIZE or not stats.flags.c_contiguous:
        raise ValueError(f"av1_decode: stats must be a contiguous int32 array of {AV1_STATS_SIZE}")
    if stage_ms is not None and (stage_ms.dtype != np.float64 or stage_ms.size < 6 or not stage_ms.flags.c_contiguous):
        raise ValueError("av1_decode: stage_ms must be a contiguous float64 array of 6")
    msg = ctypes.create_string_buffer(256)
    status = lib.av1_decode(stream, len(stream), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
                            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            None if stage_ms is None else stage_ms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                            msg, len(msg))
    if status == 4:
        raise ValueError(f"av1_decode: a {planes}-plane {w}x{h} output the stream does not describe")
    if status:
        return status, None, msg.value.decode(errors="replace")
    chroma = out[w * h:].reshape(planes - 1, ch, cw)
    return 0, [out[:w * h].reshape(h, w), *chroma], ""


def avif_yuv_to_bgr(planes: list, ss_x: int, ss_y: int, matrix: int, primaries: int,
                    full_range: int) -> Optional[np.ndarray]:
    """libavif 1.4.2's ``avifImageYUVToRGB`` into 8-bit BGR, as cv2 5.0
    asks for it, of the decoded planes ([Y] monochrome, or [Y, U, V] with U
    and V subsampled by ``ss_x``, ``ss_y``: 4:2:0 is (1, 1), 4:2:2 (1, 0)):
    [H, W, 3] uint8, or None where libavif refuses the matrix
    (``csrc/avif_yuv.cpp``)."""
    lib = load_av1_library()
    y = np.ascontiguousarray(planes[0], np.uint8)
    h, w = y.shape
    mono = len(planes) == 1
    u, v = (y, y) if mono else (np.ascontiguousarray(p, np.uint8) for p in planes[1:])
    if not mono and (u.shape != ((h + ss_y) >> ss_y, (w + ss_x) >> ss_x) or v.shape != u.shape):
        raise ValueError(f"avif_yuv_to_bgr: chroma planes {u.shape} / {v.shape} of no subsampling of {h}x{w}")
    out = np.empty((h, w, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    status = lib.avif_yuv_to_bgr(y.ctypes.data_as(u8p), u.ctypes.data_as(u8p), v.ctypes.data_as(u8p), w, h, ss_x,
                                 ss_y, int(mono), int(matrix), int(primaries), int(full_range), out.ctypes.data_as(u8p))
    return None if status else out


def av1_inverse_transform(coef: np.ndarray, tx_size: int, tx_type: int, dst: np.ndarray):
    """Add one inverse transform of ``csrc/av1.cpp`` to the uint8 block
    ``dst`` (its rows and columns the size's; changed in place): ``coef``
    int32 in libaom's layout (column by column; a side of 64 holds 32),
    ``tx_size`` / ``tx_type`` by libaom's TX_SIZE / TX_TYPE order, with the
    decoder's arithmetic (that of libaom's x86 path)."""
    lib = load_av1_library()
    w, h = (int(v) for v in AV1_TX_SIZES[tx_size].split("x"))
    coef = np.ascontiguousarray(coef, np.int32)
    if dst.shape != (h, w) or dst.dtype != np.uint8 or not dst.flags.c_contiguous or coef.size != min(w, 32) * min(h, 32):
        raise ValueError(f"av1_inverse_transform: a {h}x{w} uint8 block and {min(w, 32) * min(h, 32)} coefficients")
    status = lib.av1_inverse_transform(coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), tx_size, tx_type,
                                       dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w)
    if status:
        raise ValueError(f"av1_inverse_transform: no transform of size {tx_size} and type {tx_type}")


def av1_loop_filter(block: np.ndarray, row: int, col: int, vertical: bool, length: int, blimit: int, limit: int,
                    thresh: int):
    """One deblocking edge filter of ``csrc/av1.cpp`` (libaom's
    ``aom_lpf_{vertical,horizontal}_{length}``) on the uint8 array
    ``block`` (changed in place): the 4-sample segment whose first sample
    past the edge is at (``row``, ``col``), across a vertical or a
    horizontal edge, with a level's ``blimit``, ``limit`` and ``thresh``."""
    lib = load_av1_library()
    reach = {4: 2, 6: 3, 8: 4, 14: 7}.get(length)
    h, w = block.shape
    across, along = (col, row) if vertical else (row, col)
    if (reach is None or block.dtype != np.uint8 or not block.flags.c_contiguous or across < reach
            or across + reach > (w if vertical else h) or along < 0 or along + 4 > (h if vertical else w)):
        raise ValueError(f"av1_loop_filter: no {length}-tap segment at ({row}, {col}) of a {h}x{w} uint8 block")
    at = block.ctypes.data + row * w + col
    lib.av1_loop_filter(ctypes.cast(at, ctypes.POINTER(ctypes.c_uint8)), w, int(vertical), length, blimit, limit, thresh)


def av1_cdef_find_dir(block: np.ndarray):
    """CDEF's direction search (``cdef_find_dir``) of an 8x8 uint16 block →
    (direction 0-7, variance)."""
    lib = load_av1_library()
    block = np.ascontiguousarray(block, np.uint16)
    if block.shape != (8, 8):
        raise ValueError("av1_cdef_find_dir: an 8x8 block")
    var = ctypes.c_int32()
    d = lib.av1_cdef_find_dir(block.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 8, ctypes.byref(var))
    return d, var.value


def av1_cdef_filter(src: np.ndarray, pri: int, sec: int, direction: int, pri_damping: int, sec_damping: int,
                    bw: int, bh: int) -> np.ndarray:
    """CDEF's filter of one block (``cdef_filter_8_*``): ``src`` uint16 of
    (bh + 4) x (bw + 4), the block two samples in from each side (30000 is a
    sample outside the frame) → the filtered bh x bw uint8 block."""
    lib = load_av1_library()
    src = np.ascontiguousarray(src, np.uint16)
    if src.shape != (bh + 4, bw + 4):
        raise ValueError(f"av1_cdef_filter: a {bh + 4}x{bw + 4} source for a {bh}x{bw} block")
    out = np.zeros((bh, bw), np.uint8)
    at = src.ctypes.data + 2 * (2 * (bw + 4) + 2)
    status = lib.av1_cdef_filter(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bw,
                                 ctypes.cast(at, ctypes.POINTER(ctypes.c_uint16)), bw + 4, pri, sec, direction,
                                 pri_damping, sec_damping, bw, bh)
    if status:
        raise ValueError(f"av1_cdef_filter: no {bh}x{bw} block in direction {direction}")
    return out


def _restoration_unit(src: np.ndarray, w: int, h: int):
    """The readable source of a processing unit: uint8, its w x h samples
    three in from each side."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 2 or src.shape != (h + 6, w + 6) or w < 1 or h < 1:
        raise ValueError(f"loop restoration: a {h + 6}x{w + 6} uint8 source for a {h}x{w} unit")
    return src, ctypes.cast(src.ctypes.data + 3 * (w + 6) + 3, ctypes.POINTER(ctypes.c_uint8))


def av1_wiener_filter(src: np.ndarray, hfilter, vfilter) -> np.ndarray:
    """Loop restoration's Wiener filter of one processing unit
    (``av1_wiener_convolve_add_src``): ``src`` uint8 of (h + 6) x (w + 6),
    the unit three samples in from each side; ``hfilter`` / ``vfilter`` the
    7 taps as libaom's WienerInfo holds them → the h x w uint8 unit."""
    lib = load_av1_library()
    h, w = src.shape[0] - 6, src.shape[1] - 6
    src, at = _restoration_unit(src, w, h)
    hf, vf = (np.ascontiguousarray(f, np.int16) for f in (hfilter, vfilter))
    if hf.shape != (7,) or vf.shape != (7,):
        raise ValueError("av1_wiener_filter: 7 taps in each direction")
    out = np.zeros((h, w), np.uint8)
    lib.av1_wiener_filter(at, w + 6, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, w, h,
                          hf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                          vf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out


def av1_selfguided_filter(src: np.ndarray, ep: int, xqd) -> np.ndarray:
    """Loop restoration's self-guided filter of one processing unit
    (``av1_apply_selfguided_restoration``): ``src`` uint8 of (h + 6) x
    (w + 6), the unit three samples in from each side; parameter set ``ep``
    (0-15) and the two weights ``xqd`` as coded → the h x w uint8 unit."""
    lib = load_av1_library()
    h, w = src.shape[0] - 6, src.shape[1] - 6
    src, at = _restoration_unit(src, w, h)
    x = np.ascontiguousarray(xqd, np.int32)
    out = np.zeros((h, w), np.uint8)
    if x.shape != (2,) or lib.av1_selfguided_filter(at, w, h, w + 6, int(ep), x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w):
        raise ValueError(f"av1_selfguided_filter: no parameter set {ep} or not two weights")
    return out


def av1_convolve_horiz_rs(src: np.ndarray, width: int, x0_qn: int, x_step_qn: int) -> np.ndarray:
    """Superres's upscaling filter (``av1_convolve_horiz_rs``) over the rows
    of the uint8 array ``src``: ``width`` samples of each from position
    ``x0_qn`` in steps of ``x_step_qn`` (1/16384 sample), ``src[:, 4]``
    the sample before the first the 8 taps centre on (4 samples readable
    before it, and after the last position) → [rows, width] uint8."""
    lib = load_av1_library()
    src = np.ascontiguousarray(src, np.uint8)
    last = 4 + ((x0_qn + (width - 1) * x_step_qn) >> 14) + 4
    if src.ndim != 2 or width < 1 or x_step_qn < 1 or x0_qn < 0 or last >= src.shape[1]:
        raise ValueError(f"av1_convolve_horiz_rs: {width} samples from {x0_qn} by {x_step_qn} read past a "
                         f"source of {src.shape}")
    out = np.zeros((src.shape[0], width), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.av1_convolve_horiz_rs(ctypes.cast(src.ctypes.data + 4, u8p), src.shape[1], out.ctypes.data_as(u8p), width,
                              width, src.shape[0], int(x0_qn), int(x_step_qn))
    return out


# the int32 fields of libaom's aom_film_grain_t (grain_params.h): name → (offset, count); the
# 16-bit random_seed is the low half of the last
AV1_GRAIN_FIELDS = {"apply_grain": (0, 1), "update_parameters": (1, 1), "scaling_points_y": (2, 28),
                    "num_y_points": (30, 1), "scaling_points_cb": (31, 20), "num_cb_points": (51, 1),
                    "scaling_points_cr": (52, 20), "num_cr_points": (72, 1), "scaling_shift": (73, 1),
                    "ar_coeff_lag": (74, 1), "ar_coeffs_y": (75, 24), "ar_coeffs_cb": (99, 25),
                    "ar_coeffs_cr": (124, 25), "ar_coeff_shift": (149, 1), "cb_mult": (150, 1),
                    "cb_luma_mult": (151, 1), "cb_offset": (152, 1), "cr_mult": (153, 1), "cr_luma_mult": (154, 1),
                    "cr_offset": (155, 1), "overlap_flag": (156, 1), "clip_to_restricted_range": (157, 1),
                    "bit_depth": (158, 1), "chroma_scaling_from_luma": (159, 1), "grain_scale_shift": (160, 1),
                    "random_seed": (161, 1)}
AV1_GRAIN_SIZE = 162  # int32s: 648 bytes


def av1_film_grain(params: np.ndarray, planes: list, ss_x: int, ss_y: int, mc_identity: bool) -> list:
    """Film grain (``add_film_grain_run``) on copies of the uint8 planes
    [Y, Cb, Cr] (Y of an even size, chroma of its subsampling): ``params``
    int32 [``AV1_GRAIN_SIZE``] in libaom's ``aom_film_grain_t`` layout
    (``AV1_GRAIN_FIELDS``, 8-bit) → the noised planes."""
    lib = load_av1_library()
    params = np.ascontiguousarray(params, np.int32)
    y, cb, cr = (np.array(p, np.uint8, order="C") for p in planes)
    h, w = y.shape
    if params.shape != (AV1_GRAIN_SIZE,) or cb.shape != (h >> ss_y, w >> ss_x) or cr.shape != cb.shape:
        raise ValueError(f"av1_film_grain: {AV1_GRAIN_SIZE} parameters and chroma of {h >> ss_y}x{w >> ss_x}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if lib.av1_film_grain(params.ctypes.data, y.ctypes.data_as(u8p), cb.ctypes.data_as(u8p), cr.ctypes.data_as(u8p),
                          h, w, w, cb.shape[1], ss_y, ss_x, int(mc_identity)):
        raise ValueError("av1_film_grain: parameters out of their ranges, an odd size or no such subsampling")
    return [y, cb, cr]
