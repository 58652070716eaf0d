"""The port's BMP, netpbm (PPM/PGM/PBM/PAM) and Sun raster decoders, and
its PNG reader on damaged zlib streams, against ``cv2.imdecode(buf,
IMREAD_COLOR)`` (OpenCV 5.0, libpng 1.6): the same ``None`` or not, and 0
differing pixels.

BMP: every depth (1, 4, 8, 16 as 555 and 565, 24, 32), every compression
cv2 takes (``BI_RGB``, ``BI_RLE8``, ``BI_RLE4``, ``BI_BITFIELDS``), the
OS/2 core, 40-byte, V4 and V5 headers, bottom-up and top-down rows, PIL's
files, colour tables shorter than the indices, seeded garbled files and
every cut of an RLE4 and an RLE8 file. The RLE streams come from a seeded
encoder that mixes encoded and absolute runs, end-of-line, delta and
end-of-bitmap codes.

PNG: seeded zlib streams with 1–3 bytes changed and the CRC made valid
again, interlaced and not, every colour type: libpng decodes some of them
with a warning, and the port must give the same rows.

Netpbm and Sun raster: each variant cv2 reads, and garbled and cut files.

Where cv2 raises instead of returning (an image over ``imdecode``'s size
limits) the port gives ``None``; a PAM of DEPTH 2 or 4 is compared on the
pixels cv2 writes (``ceil(W / DEPTH)`` of each row; cv2 leaves the rest of
its buffer as it found it).

``python tests/test_torch_image_formats.py --write`` rewrites
``ppocr_tpu_torch/assets/image_cases.npz``, the cases the card decodes (it
has no cv2): each payload beside cv2's decode, or a flag where cv2 gives
``None``.
"""

import io
import logging
import os
import pathlib
import struct
import sys
import zlib

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch import assets
from ppocr_tpu_torch.utils import imcodec


def cv2_decode(data: bytes):
    """cv2's answer; ``None`` also where it raises on its size limits."""
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error as e:
        if "validateInputImageSize" not in str(e):
            raise
        return None


def port_decode(data: bytes):
    logging.disable(logging.WARNING)  # a refusal logs a line each
    try:
        return imcodec.decode_image(data)
    finally:
        logging.disable(logging.NOTSET)


def written_columns(data: bytes, width: int) -> int:
    """The columns cv2 writes: all but in a PAM of DEPTH 2 or 4."""
    if data[:2] == b"P7":
        depth = next((int(line.split()[1]) for line in data.split(b"ENDHDR")[0].splitlines()
                      if line.startswith(b"DEPTH ")), 1)
        if depth in (2, 4):
            return -(-width // depth)
    return width


def answers(data: bytes) -> str:
    """"none", "equal", or how the port's answer differs from cv2's."""
    want, got = cv2_decode(data), port_decode(data)
    if want is None or got is None:
        return "none" if want is None and got is None else ("cv2 only" if got is None else "port only")
    if want.shape != got.shape:
        return "shape"
    k = written_columns(data, want.shape[1])
    return "equal" if (want[:, :k] == got[:, :k]).all() else "pixels"


def assert_all_equal_cv2(datas, what):
    bad = [(i, a) for i, a in enumerate(map(answers, datas)) if a not in ("none", "equal")]
    assert not bad, f"{what}: {len(bad)} of {len(datas)} differ from cv2, e.g. {bad[:8]}"


def garbled(data: bytes, n: int, seed: int, first: int = 2):
    """``n`` copies of ``data`` with 1–3 bytes from ``first`` on set at
    random."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bad = bytearray(data)
        for at in rng.integers(first, len(bad), rng.integers(1, 4)):
            bad[at] = rng.integers(0, 256)
        out.append(bytes(bad))
    return out


def pattern(h, w, seed, levels=256):
    """Runs of equal values with noise between them: RLE has runs of both
    kinds to write."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.integers(0, levels, (h, w // 4 + 1)), 4, axis=1)[:, :w]
    noise = rng.integers(0, levels, (h, w))
    return np.where(rng.random((h, w)) < 0.3, noise, runs)


# -- BMP writer ------------------------------------------------------------------


def bmp_bytes(w, h, bits, comp, body, palette=None, hdr=40, clrused=0, masks=None, os2=False):
    """A BMP of ``body`` under a file header and an info header of ``hdr``
    bytes (12: OS/2 core, 3-byte table entries). ``masks`` (R, G, B[, A])
    go inside a header of 56 bytes or more, else after it."""
    pal = b""
    if os2:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        if palette is not None:
            pal = np.asarray(palette, np.uint8)[:, :3].tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", hdr, w, h, 1, bits, comp, len(body), 2835, 2835, clrused, 0)
        if hdr >= 56:
            info += struct.pack("<4I", *(tuple(masks or ()) + (0, 0, 0, 0))[:4])
        info = (info + bytes(max(0, hdr - len(info))))[:hdr]
        if masks is not None and hdr < 56:
            pal += struct.pack(f"<{len(masks)}I", *masks)
        if palette is not None:
            pal += np.asarray(palette, np.uint8).tobytes()
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + pal + body


def pack_rows(idx: np.ndarray, bits: int) -> bytes:
    """[h, w] indices → rows of ``bits``-bit pixels padded to 32 bits,
    bottom row first."""
    h, w = idx.shape
    if bits == 8:
        rows = idx.astype(np.uint8)
    else:
        shifts = np.arange(8 // bits - 1, -1, -1) * bits
        pad = -w % (8 // bits)
        x = np.pad(idx, ((0, 0), (0, pad))).reshape(h, -1, 8 // bits)
        rows = (x << shifts).sum(axis=2).astype(np.uint8)
    stride = -(-rows.shape[1] // 4) * 4
    return np.pad(rows, ((0, 0), (0, stride - rows.shape[1])))[::-1].tobytes()


def rle_bytes(idx: np.ndarray, bits: int, seed: int, top_down=False, skips=True) -> bytes:
    """A BI_RLE8 (``bits`` 8) or BI_RLE4 (4) stream of the [h, w] indices
    ``idx``: encoded and absolute runs, each row closed by end-of-line or
    (RLE8, now and then, when an encoded run ends it) nothing, some pixels
    skipped by a delta. Deltas down and an early end-of-bitmap (the last
    rows left to cv2's fill) are written for RLE8 only: cv2 5.0 counts no
    rows in an RLE4 delta or end-of-bitmap. ``skips=False``: no delta and
    no early end-of-bitmap, so the stream holds every pixel of ``idx``."""
    rng = np.random.default_rng(seed)
    h, w = idx.shape
    rows = np.array(idx if top_down else idx[::-1])
    out = bytearray()
    y = 0
    while y < h:
        row, x, encoded = rows[y], 0, False
        while x < w:
            if skips and rng.random() < 0.03 and x + 3 < w:  # delta right (and sometimes down)
                dx = int(rng.integers(1, min(w - x, 8)))
                dy = int(bits == 8 and rng.random() < 0.2 and y + 1 < h)
                out += bytes([0, 2, dx, dy])
                x += dx
                if dy:
                    y += 1
                    row = rows[y]
                continue
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if bits == 4 and run == 1 and x + 1 < w and rng.random() < 0.5:  # two alternating nibbles
                run = 2 + 2 * int(rng.integers(0, 3))
                run = min(run, w - x)
                pair = (row[x], row[x + 1] if x + 1 < w else row[x])
                out += bytes([run, (pair[0] << 4) | pair[1]])
                for k in range(run):
                    row[x + k] = pair[k % 2]  # what the stream now says
                x += run
                encoded = True
                continue
            if run >= 2 or w - x < 3:
                out += bytes([run, row[x] * (17 if bits == 4 else 1)])
                x += run
                encoded = True
                continue
            encoded = False
            n = int(min(w - x, rng.integers(3, 40)))
            vals = row[x : x + n].astype(np.uint8)
            if bits == 8:
                body = vals.tobytes() + bytes(n % 2)
            else:
                packed = np.pad(vals, (0, n % 2)).reshape(-1, 2)
                body = ((packed[:, 0] << 4) | packed[:, 1]).astype(np.uint8).tobytes()
                body += bytes(len(body) % 2)
            out += bytes([0, n]) + body
            x += n
        y += 1
        if y == h:
            break
        if bits == 8 and x == w and encoded and rng.random() < 0.3:
            continue  # an encoded run ended the row: cv2 moves on without a code
        if skips and bits == 8 and rng.random() < 0.05 and y > h // 2:
            break  # end of bitmap early: the rest takes palette entry 0
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_palette(n, seed):
    """``n`` distinct entries (B, G, R, 0): 16 random colours, the blue of
    each repeat raised by its row of 16, which keeps the committed files
    small."""
    base = np.random.default_rng(seed).integers(0, 256, (16, 4))
    pal = base[np.arange(n) % 16] + np.stack([np.arange(n) // 16, 0 * np.arange(n), 0 * np.arange(n),
                                              0 * np.arange(n)], axis=1)
    pal[:, 3] = 0
    return (pal % 256).astype(np.uint8)


def bmp_cases() -> dict:
    """{name: BMP bytes}: every kind of step, header and row order cv2
    reads, and the files it refuses."""
    rng = np.random.default_rng(0)
    cases = {}
    for bits in (1, 4, 8):
        for h, w in ((5, 13), (3, 1), (9, 33)):
            n = 1 << bits
            idx = rng.integers(0, n, (h, w))
            cases[f"{bits}bit_{h}x{w}"] = bmp_bytes(w, h, bits, 0, pack_rows(idx, bits), bmp_palette(n, bits))
            cases[f"{bits}bit_{h}x{w}_topdown"] = bmp_bytes(w, -h, bits, 0, pack_rows(idx[::-1], bits),
                                                           bmp_palette(n, bits))
            cases[f"{bits}bit_{h}x{w}_os2"] = bmp_bytes(w, h, bits, 0, pack_rows(idx, bits), bmp_palette(n, bits),
                                                        os2=True)
    # indices past a short colour table read black
    idx = rng.integers(0, 256, (6, 10))
    cases["8bit_past_table"] = bmp_bytes(10, 6, 8, 0, pack_rows(idx, 8), bmp_palette(4, 3), clrused=4)
    cases["4bit_past_table"] = bmp_bytes(10, 6, 4, 0, pack_rows(idx % 16, 4), bmp_palette(3, 4), clrused=3)
    cases["1bit_one_entry"] = bmp_bytes(10, 6, 1, 0, pack_rows(idx % 2, 1), bmp_palette(1, 5), clrused=1)
    cases["8bit_table_300"] = bmp_bytes(10, 6, 8, 0, pack_rows(idx, 8), bmp_palette(300, 6), clrused=300)
    for bits, comp in ((8, 1), (4, 2)):
        name = f"rle{bits}"
        for k, (h, w) in enumerate(((7, 21), (16, 40), (1, 5), (12, 3))):
            idx = pattern(h, w, 10 * bits + k, 1 << bits)
            cases[f"{name}_{h}x{w}"] = bmp_bytes(w, h, bits, comp, rle_bytes(idx, bits, k), bmp_palette(1 << bits, k))
            cases[f"{name}_{h}x{w}_topdown"] = bmp_bytes(w, -h, bits, comp, rle_bytes(idx, bits, k, True),
                                                         bmp_palette(1 << bits, k))
        idx = pattern(8, 16, bits, 1 << bits)
        body = rle_bytes(idx, bits, 99)
        cases[f"{name}_no_eob"] = bmp_bytes(16, 8, bits, comp, body[:-2], bmp_palette(1 << bits, 1))
        cases[f"{name}_cut"] = bmp_bytes(16, 8, bits, comp, body[: len(body) // 2], bmp_palette(1 << bits, 1))
        cases[f"{name}_run_past_row"] = bmp_bytes(4, 2, bits, comp, bytes([6, 0x12, 0, 1]), bmp_palette(1 << bits, 1))
        cases[f"{name}_small_table"] = bmp_bytes(16, 8, bits, comp, body, bmp_palette(5, 2), clrused=5)
    px16 = rng.integers(0, 1 << 16, (5, 7)).astype("<u2")
    px16[0, :4] = [0x7FFF, 0xFFFF, 0x001F, 0x07E0]
    body16 = b"".join(np.pad(r, (0, 1)).tobytes() for r in px16[::-1])
    cases["16bit_555"] = bmp_bytes(7, 5, 16, 0, body16)
    cases["16bit_555_bitfields"] = bmp_bytes(7, 5, 16, 3, body16, masks=(0x7C00, 0x3E0, 0x1F))
    cases["16bit_565_bitfields"] = bmp_bytes(7, 5, 16, 3, body16, masks=(0xF800, 0x7E0, 0x1F))
    cases["16bit_565_topdown"] = bmp_bytes(7, -5, 16, 3, body16, masks=(0xF800, 0x7E0, 0x1F))
    cases["16bit_444_bitfields"] = bmp_bytes(7, 5, 16, 3, body16, masks=(0xF00, 0xF0, 0xF))
    cases["16bit_565_v4"] = bmp_bytes(7, 5, 16, 3, body16, hdr=108, masks=(0xF800, 0x7E0, 0x1F, 0))
    cases["16bit_555_v5"] = bmp_bytes(7, 5, 16, 0, body16, hdr=124)
    px32 = rng.integers(0, 256, (4, 6, 4)).astype(np.uint8)
    body32 = px32[::-1].tobytes()
    for name, masks in {"bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000), "rgba": (0xFF, 0xFF00, 0xFF0000, 0),
                        "argb": (0xFF00, 0xFF0000, 0xFF000000, 0xFF), "10bit": (0x3FF00000, 0xFFC00, 0x3FF, 0),
                        "3bit": (0x7, 0x38, 0x1C0, 0), "sparse": (0xF0F, 0xF0F00000, 0x101, 0),
                        "zero_green": (0xFF0000, 0, 0xFF, 0)}.items():
        cases[f"32bit_bitfields_{name}_hdr40"] = bmp_bytes(6, 4, 32, 3, body32, masks=masks[:3])
        cases[f"32bit_bitfields_{name}_v4"] = bmp_bytes(6, 4, 32, 3, body32, hdr=108, masks=masks)
        cases[f"32bit_bitfields_{name}_v5_topdown"] = bmp_bytes(6, -4, 32, 3, px32.tobytes(), hdr=124, masks=masks)
    cases["32bit_bitfields_hdr56"] = bmp_bytes(6, 4, 32, 3, body32, hdr=56, masks=(0xFF, 0xFF00, 0xFF0000, 0))
    cases["32bit_bitfields_hdr52"] = bmp_bytes(6, 4, 32, 3, body32, hdr=52, masks=(0xFF, 0xFF00, 0xFF0000, 0))
    cases["32bit_rgb_v4"] = bmp_bytes(6, 4, 32, 0, body32, hdr=108, masks=(0xFF, 0xFF00, 0xFF0000, 0))
    cases["32bit_os2"] = bmp_bytes(6, 4, 32, 0, body32, os2=True)
    px24 = rng.integers(0, 256, (4, 5, 3)).astype(np.uint8)
    body24 = b"".join(np.pad(r.reshape(-1), (0, 1)).tobytes() for r in px24[::-1])
    for hdr in (36, 40, 52, 56, 64, 108, 124):
        cases[f"24bit_hdr{hdr}"] = bmp_bytes(5, 4, 24, 0, body24, hdr=hdr)
    cases["24bit_os2"] = bmp_bytes(5, 4, 24, 0, body24, os2=True)
    # refused: other depths, compressions and header sizes
    cases["2bit"] = bmp_bytes(8, 2, 2, 0, bytes(8), bmp_palette(4, 0))
    cases["24bit_rle8"] = bmp_bytes(5, 4, 24, 1, body24)
    cases["24bit_bitfields"] = bmp_bytes(5, 4, 24, 3, body24, masks=(0xFF0000, 0xFF00, 0xFF))
    cases["8bit_rle4"] = bmp_bytes(4, 2, 8, 2, bytes([4, 0x11, 0, 1]), bmp_palette(256, 0))
    cases["jpeg_compression"] = bmp_bytes(5, 4, 24, 4, body24)
    cases["hdr20"] = bmp_bytes(5, 4, 24, 0, body24, hdr=20)
    cases["os2_16bit"] = bmp_bytes(7, 5, 16, 0, body16, os2=True)
    cases["width0"] = bmp_bytes(0, 4, 24, 0, body24)
    for mode in ("1", "L", "P", "RGB", "RGBA"):  # PIL's own
        buf = io.BytesIO()
        Image.fromarray(pattern(9, 17, 3, 256).astype(np.uint8)).convert(mode).save(buf, "BMP")
        cases[f"pil_{mode}"] = buf.getvalue()
    return cases


BMP_CASES = list(bmp_cases())


@pytest.mark.parametrize("name", BMP_CASES)
def test_bmp_kinds_answer_as_cv2(name):
    data = bmp_cases()[name]
    assert answers(data) in ("none", "equal")


def test_bmp_probes_of_cv2_rules():
    """cv2's rules, held as numbers: an index past a 4-entry table is black;
    16-bit channels are shifted with no bit replication; 16-bit masks other
    than 565 and 555 refuse the file; 32-bit masks apply only under a header
    of 56 bytes or more; a cut RLE stream refuses the file."""
    pal = bmp_palette(4, 0)
    data = bmp_bytes(4, 1, 8, 0, bytes([0, 1, 200, 7]), pal, clrused=4)
    assert port_decode(data)[0, 2:].tolist() == [[0, 0, 0], [0, 0, 0]]
    d555 = bmp_bytes(2, 1, 16, 0, struct.pack("<2H", 0x7FFF, 0))
    assert port_decode(d555)[0, 0].tolist() == [248, 248, 248]
    d565 = bmp_bytes(2, 1, 16, 3, struct.pack("<2H", 0x07E0, 0), masks=(0xF800, 0x7E0, 0x1F))
    assert port_decode(d565)[0, 0].tolist() == [0, 252, 0]
    assert port_decode(bmp_bytes(2, 1, 16, 3, bytes(4), masks=(0xF00, 0xF0, 0xF))) is None
    rgba = (0xFF, 0xFF00, 0xFF0000, 0)
    assert port_decode(bmp_bytes(1, 1, 32, 3, bytes([1, 2, 3, 4]), masks=rgba[:3]))[0, 0].tolist() == [1, 2, 3]
    assert port_decode(bmp_bytes(1, 1, 32, 3, bytes([1, 2, 3, 4]), hdr=108, masks=rgba))[0, 0].tolist() == [3, 2, 1]
    rle = bmp_bytes(4, 2, 8, 1, bytes([4, 1, 0, 0, 4, 2, 0, 1]), pal, clrused=4)
    assert port_decode(rle) is not None and port_decode(rle[:-3]) is None
    # end of bitmap with a row left: RLE8 fills it with entry 0, RLE4 takes
    # it for an end of line and runs out of data
    eob8 = bmp_bytes(4, 2, 8, 1, bytes([4, 1, 0, 1]), pal, clrused=4)
    assert port_decode(eob8)[0].tolist() == [pal[0, :3].tolist()] * 4
    eob4 = bmp_bytes(4, 2, 4, 2, bytes([4, 0x12, 0, 1]), pal, clrused=4)
    assert port_decode(eob4) is None
    for data in (data, d555, d565, rle, rle[:-3], eob8, eob4):
        assert answers(data) in ("none", "equal")


GARBLED_BMP = ["8bit_5x13", "4bit_9x33", "pil_1", "24bit_hdr124", "32bit_bitfields_10bit_v4",
               "16bit_565_bitfields", "8bit_5x13_os2", "rle8_16x40", "rle4_16x40"]


@pytest.mark.parametrize("name", GARBLED_BMP)
def test_garbled_bmps_answer_as_cv2(name):
    """100 seeded files per kind, 1–3 bytes changed anywhere past "BM":
    file header, info header, masks, colour table and pixels."""
    data = bmp_cases()[name]
    assert_all_equal_cv2(garbled(data, 100, seed=GARBLED_BMP.index(name)), f"garbled {name}")


@pytest.mark.parametrize("bits", [8, 4])
def test_every_rle_cut_answers_as_cv2(bits):
    data = bmp_cases()[f"rle{bits}_7x21"]
    assert_all_equal_cv2([data[:k] for k in range(2, len(data) + 1)], f"rle{bits} cuts")


def scene_bmps(scene: np.ndarray) -> dict:
    """A BGR scene as a 24-bit BMP beside its PNG, and its grey as an RLE8
    BMP (a grey ramp palette) beside the grey's PNG: each pair decodes to
    the same pixels."""
    h, w, _ = scene.shape
    body24 = b"".join(np.pad(r.reshape(-1), (0, -w * 3 % 4)).tobytes() for r in scene[::-1])
    grey = scene.mean(axis=2).astype(np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
    ramp[:, 3] = 0
    return {"bgr": (bmp_bytes(w, h, 24, 0, body24), imcodec.encode_png(scene)),
            "grey_rle8": (bmp_bytes(w, h, 8, 1, rle_bytes(grey, 8, seed=0, skips=False), ramp),
                          imcodec.encode_png(np.repeat(grey[..., None], 3, axis=2)))}


def test_a_bmp_payload_gives_the_png_payloads_words(tmp_path):
    """The port's service on the CPU answers a parity scene sent as a
    24-bit BMP, and its grey as an RLE8 BMP, with the words of the same
    pixels sent as PNG."""
    import base64

    import torch

    from ppocr_tpu_torch.serve import OCRIPCClient, OCRIPCService
    from test_torch_serve import run_service, small_config, stop_service

    scene = assets.load_scenes()["parity"][0]
    pairs = scene_bmps(scene)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several test processes at once
    svc = OCRIPCService(model_dir=str(assets.make_jumbo_model_dir(tmp_path / "jumbo")),
                        socket_path=str(tmp_path / "svc.sock"), config=small_config(), device="cpu",
                        request_timeout_ms=0)
    t = run_service(svc)
    try:
        with OCRIPCClient(svc.socket_path, timeout_ms=120000) as c:
            def words(data):
                r = c.send_request({"command": "recognize", "image_data": base64.b64encode(data).decode()})
                assert r["success"], r
                return r["words"]

            for name, (bmp, png) in pairs.items():
                assert (port_decode(bmp) == port_decode(png)).all() and answers(bmp) == "equal", name
                got = words(bmp)
                assert got and got == words(png), name
    finally:
        stop_service(svc, t)
        torch.set_num_threads(threads)


# -- PNG: damaged zlib streams under valid CRCs ------------------------------------


def png_damaged(ctype, depth, interlace, seed, n=40, size=(13, 21), wbits=15, chunk=None):
    """``n`` PNGs whose zlib stream has 1–3 bytes changed, the IDAT CRCs
    made valid again: half anywhere, half in the last 40 bytes (the last
    rows, the end-of-block code, the Adler-32 trailer), then the stream
    cut short, with junk after it, and with a zeroed trailer. ``chunk``
    splits the stream into IDATs of that many bytes; ``wbits`` is the
    window the stream declares."""
    from test_torch_decode_parity import ADAM7, CHANNELS, _filtered, _pack

    h, w = size
    rng = np.random.default_rng(seed + 100 * ctype + depth)
    nch = CHANNELS[ctype]
    palette = None
    if ctype == 3:
        k = min(1 << depth, 200)
        palette = rng.integers(0, 256, (k, 3))
        samples = rng.integers(0, k, (h, w, 1))
    else:  # mostly one colour: long matches, so damage can reach far back
        samples = rng.integers(0, 1 << depth, (h, w, nch))
        samples = np.where(rng.random((h, w, 1)) < 0.7, samples[:1, :1], samples)
    raw = b"".join(_filtered(_pack(samples[y0::dy, x0::dx], depth), max(1, nch * depth // 8), rng)
                   for x0, y0, dx, dy in (ADAM7 if interlace else [(0, 0, 1, 1)])
                   if samples[y0::dy, x0::dx].size)
    c = zlib.compressobj(6, zlib.DEFLATED, wbits)
    z = c.compress(raw) + c.flush()

    def chunk_(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    head = imcodec.PNG_MAGIC + chunk_(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        head += chunk_(b"PLTE", palette.astype(np.uint8).tobytes())
    streams = []
    for i in range(n):
        zz = bytearray(z)
        lo = 0 if i % 2 else max(0, len(z) - 40)
        for at in rng.integers(lo, len(zz), rng.integers(1, 4)):
            zz[at] = rng.integers(0, 256)
        streams.append(bytes(zz))
    streams += [z[:-k] for k in (1, 3, 5, 9)] + [z + b"\x00\x17junk", z[:-4] + bytes(4)]
    out = []
    for zz in streams:
        parts = [zz] if chunk is None else [zz[i : i + chunk] for i in range(0, len(zz), chunk)]
        out.append(head + b"".join(chunk_(b"IDAT", p) for p in parts) + chunk_(b"IEND", b""))
    return out


PNG_DAMAGE = ([(ct, d, il) for ct, ds in ((0, (1, 8, 16)), (2, (8, 16)), (3, (1, 4, 8)), (4, (8,)), (6, (8, 16)))
               for d in ds for il in (False, True)])


@pytest.mark.parametrize("ctype,depth,interlace", PNG_DAMAGE,
                         ids=[f"type{c}-{d}bit-{'adam7' if i else 'plain'}" for c, d, i in PNG_DAMAGE])
def test_damaged_zlib_pngs_answer_as_cv2(ctype, depth, interlace):
    """libpng reads a damaged stream row by row: an error while a row is
    filled refuses the image, an error in the drain after the last row is
    a warning and the image stands, with whatever rows the damage made."""
    datas = png_damaged(ctype, depth, interlace, seed=len(PNG_DAMAGE))
    assert_all_equal_cv2(datas, "damaged png")


@pytest.mark.parametrize("wbits,chunk,size", [(15, 5000, (60, 120)), (15, 20000, (70, 150)), (9, None, (40, 300)),
                                              (10, 700, (50, 70)), (9, 100, (40, 150))],
                         ids=["32k-idat5000", "32k-idat20000", "512-window", "1k-window-idat700",
                              "512-window-idat100"])
def test_damaged_zlib_pngs_over_slices_and_small_windows_answer_as_cv2(wbits, chunk, size):
    """Streams over several IDATs and 8192-byte slices, and streams that
    declare a window smaller than the image: libpng's per-row inflate calls
    see fewer bytes back than one call over the whole stream would."""
    for interlace in (False, True):
        datas = png_damaged(2 if wbits == 15 else 0, 8, interlace, seed=wbits, n=60, size=size, wbits=wbits,
                            chunk=chunk)
        assert_all_equal_cv2(datas, "damaged png")


def png_far(wbits, period, w, h, seed):
    """A grey PNG ``h`` rows of ``w`` bytes whose first row repeats a
    random run of ``period`` bytes (the other rows are random), deflated
    with a 32 KiB window under a header that declares ``1 << wbits``
    bytes: its matches reach further back than the declared window."""
    rng = np.random.default_rng(seed)
    rows = [np.resize(rng.integers(0, 256, period, dtype=np.uint8), w)]
    rows += [rng.integers(0, 256, w, dtype=np.uint8) for _ in range(h - 1)]
    z = bytearray(zlib.compress(b"".join(b"\x00" + r.tobytes() for r in rows), 6))
    z[0] = (wbits - 8) << 4 | 8
    z[1] = (z[1] & 0xE0) | (31 - ((z[0] << 8 | (z[1] & 0xE0)) % 31))

    def chunk_(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    return (imcodec.PNG_MAGIC + chunk_(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk_(b"IDAT", bytes(z)) + chunk_(b"IEND", b""))


PNG_FAR = [(wbits, period, w, h) for wbits in (8, 9, 10, 14) for period, w in ((700, 33000), (3000, 40000),
                                                                              (20000, 70000)) for h in (1, 2)]


@pytest.mark.parametrize("wbits,period,w,h", PNG_FAR, ids=[f"window{1 << b}-period{p}-{w}x{h}"
                                                           for b, p, w, h in PNG_FAR])
def test_rows_over_32k_under_a_small_window_answer_as_cv2(wbits, period, w, h):
    """A row longer than 32 KiB is one inflate call in libpng: past its
    first 32 KiB every distance is in reach, whatever window the stream
    declares, and across rows only the window is. (Python's ``zlib``
    splits such a call's output at 32 KiB, which would refuse these.)"""
    assert_all_equal_cv2([png_far(wbits, period, w, h, seed=wbits * 100 + h)], "far png")


# -- netpbm: PBM, PGM, PPM (P1–P6) and PAM (P7) --------------------------------------


def ascii_body(values, per_line=7) -> bytes:
    flat = [str(int(v)) for v in np.asarray(values).reshape(-1)]
    return "\n".join(" ".join(flat[i : i + per_line]) for i in range(0, len(flat), per_line)).encode() + b"\n"


def pam_bytes(w, h, depth, maxval, tupltype, body, extra=b"") -> bytes:
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n".encode() + extra
    if tupltype:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + b"ENDHDR\n" + body


def netpbm_cases() -> dict:
    """{name: file}: every P kind, maxval below and above 255, comments,
    the 16-bit and the PAM rules, and what cv2 refuses."""
    rng = np.random.default_rng(5)
    cases = {}
    img = rng.integers(0, 256, (7, 11, 3)).astype(np.uint8)
    for ext in (".ppm", ".pam"):
        cases[f"cv2{ext}"] = cv2.imencode(ext, img)[1].tobytes()
    cases["cv2.pgm"] = cv2.imencode(".pgm", img[..., 0])[1].tobytes()
    cases["cv2.pbm"] = cv2.imencode(".pbm", (img[..., 0] > 127).astype(np.uint8) * 255)[1].tobytes()
    for h, w in ((5, 13), (1, 1), (3, 17)):
        bits = rng.integers(0, 2, (h, w))
        cases[f"p1_{h}x{w}"] = f"P1\n{w} {h}\n".encode() + ascii_body(bits)
        cases[f"p4_{h}x{w}"] = f"P4\n{w} {h}\n".encode() + np.packbits(bits.astype(np.uint8), axis=1).tobytes()
    cases["p1_packed_digits"] = b"P1\n# no spaces\n5 2\n0101110010"
    cases["p1_junk"] = b"P1\n3 1\n0 x 1\n"
    for maxval in (1, 100, 255, 1000, 65535):
        g = rng.integers(0, maxval + 1, (4, 6))
        c = rng.integers(0, maxval + 1, (4, 6, 3))
        wide = ">u2" if maxval > 255 else np.uint8
        cases[f"p2_max{maxval}"] = f"P2\n6 4\n{maxval}\n".encode() + ascii_body(g)
        cases[f"p3_max{maxval}"] = f"P3\n6 4\n{maxval}\n".encode() + ascii_body(c)
        cases[f"p5_max{maxval}"] = f"P5\n6 4\n{maxval}\n".encode() + g.astype(wide).tobytes()
        cases[f"p6_max{maxval}"] = f"P6\n6 4\n{maxval}\n".encode() + c.astype(wide).tobytes()
    cases["p2_above_maxval"] = b"P2\n3 1\n100\n50 200 100\n"
    cases["p5_above_maxval"] = b"P5\n3 1\n100\n" + bytes([50, 200, 100])
    cases["p2_comments"] = b"P2\n# a\n3 # b\n1\n255 # c\n 1 #d\n2\n3\n"
    cases["p2_no_final_byte"] = b"P2\n2 1\n255\n1 2"
    cases["p2_digit_then_comment"] = b"P2\n2 1\n255\n1#x\n 2\n"
    cases["p6_space_header"] = b"P6 2 1 255 " + bytes(range(6))
    cases["p6_comment_after_maxval"] = b"P6\n2 1\n255#" + bytes(range(6))
    cases["p5_short"] = b"P5\n6 4\n255\n" + bytes(23)
    cases["p6_16bit_short"] = b"P6\n2 2\n1000\n" + bytes(23)
    cases["p5_maxval0"] = b"P5\n2 1\n0\n\x01\x02"
    cases["p5_maxval70000"] = b"P5\n2 1\n70000\n\x01\x02\x03\x04"
    cases["p5_width0"] = b"P5\n0 1\n255\n\x01"
    cases["p5_huge"] = b"P5\n3000000 1\n255\n" + bytes(16)
    cases["p3_no_header_end"] = b"P3\n2 1\n255"
    # PAM
    for depth, tupl in ((1, b"GRAYSCALE"), (2, b"GRAYSCALE_ALPHA"), (3, b"RGB"), (4, b"RGB_ALPHA"), (1, b""),
                        (3, b""), (1, b"BLACKANDWHITE")):
        for maxval in ((1,) if tupl == b"BLACKANDWHITE" else (255, 1000)):
            if not tupl and maxval > 255 and depth == 3:
                continue
            v = rng.integers(0, maxval + 1, (5, 9 * depth))
            body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            cases[f"pam_{tupl.decode() or 'none'}_{depth}_max{maxval}"] = pam_bytes(9, 5, depth, maxval, tupl, body)
    cases["pam_rgb_maxval1"] = pam_bytes(9, 2, 3, 1, b"RGB", rng.integers(0, 2, 54).astype(np.uint8).tobytes())
    cases["pam_comment_hex_width"] = pam_bytes(0, 2, 1, 255, b"GRAYSCALE", bytes(range(16)), b"# c\n").replace(
        b"WIDTH 0", b"WIDTH 0x8")
    cases["pam_rgb_depth1"] = pam_bytes(2, 1, 1, 255, b"RGB", bytes(2))
    cases["pam_depth2_no_tupltype"] = pam_bytes(2, 1, 2, 255, b"", bytes(4))
    cases["pam_depth5"] = pam_bytes(2, 1, 5, 255, b"", bytes(10))
    cases["pam_unknown_tupltype"] = pam_bytes(2, 1, 1, 255, b"GREY", bytes(2))
    cases["pam_unknown_field"] = pam_bytes(2, 1, 1, 255, b"GRAYSCALE", bytes(2), b"SIZE 4\n")
    cases["pam_twice"] = pam_bytes(2, 1, 1, 255, b"GRAYSCALE", bytes(2), b"WIDTH 2\n")
    cases["pam_no_depth"] = b"P7\nWIDTH 2\nHEIGHT 1\nMAXVAL 255\nENDHDR\n" + bytes(2)
    cases["pam_short"] = pam_bytes(4, 2, 3, 255, b"RGB", bytes(23))
    cases["pam_space_after_p7"] = b"P7 " + pam_bytes(1, 1, 1, 255, b"GRAYSCALE", b"\x05")[3:]
    return cases


NETPBM_CASES = list(netpbm_cases())


@pytest.mark.parametrize("name", NETPBM_CASES)
def test_netpbm_kinds_answer_as_cv2(name):
    assert answers(netpbm_cases()[name]) in ("none", "equal")


def test_netpbm_probes_of_cv2_rules():
    """cv2's rules, held as numbers: 16-bit samples keep their high byte
    with no rescale; P1's 1 is black; a PAM RGB tuple lands in B, G, R as
    stored; ASCII samples below 256 are scaled to 0–255, binary ones are
    not; short data refuses the file."""
    assert port_decode(b"P2\n2 1\n1000\n500 1000\n")[0, :, 0].tolist() == [1, 3]
    assert port_decode(b"P5\n1 1\n65535\n\x01\x01")[0, 0, 0] == 1
    assert port_decode(b"P1\n3 1\n0 1 0\n")[0, :, 0].tolist() == [255, 0, 255]
    assert port_decode(pam_bytes(1, 1, 3, 255, b"RGB", b"\x01\x02\x03"))[0, 0].tolist() == [1, 2, 3]
    assert port_decode(b"P2\n2 1\n100\n50 100\n")[0, :, 0].tolist() == [127, 255]
    assert port_decode(b"P5\n2 1\n100\n\x32\x64")[0, :, 0].tolist() == [50, 100]
    assert port_decode(b"P5\n2 1\n255\n\x01") is None


@pytest.mark.parametrize("name", ["cv2.ppm", "cv2.pgm", "cv2.pbm", "p2_max255", "p3_max1000", "p6_max65535",
                                  "pam_RGB_3_max255", "pam_GRAYSCALE_ALPHA_2_max1000", "pam_BLACKANDWHITE_1_max1"])
def test_garbled_and_cut_netpbm_answer_as_cv2(name):
    data = netpbm_cases()[name]
    assert_all_equal_cv2(garbled(data, 60, seed=NETPBM_CASES.index(name)), f"garbled {name}")
    assert_all_equal_cv2([data[:k] for k in range(2, len(data) + 1, max(1, len(data) // 60))], f"cut {name}")


# -- Sun raster ------------------------------------------------------------------------


def ras_bytes(w, h, bpp, rtype, body, maptype=0, cmap=b"") -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, bpp, len(body), rtype, maptype, len(cmap)) + cmap + body


def ras_rows(w, h, bpp, seed) -> bytes:
    rng = np.random.default_rng(seed)
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    return rng.integers(0, 256, h * pitch).astype(np.uint8).tobytes()


def sunraster_cases() -> dict:
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (5, 9, 3)).astype(np.uint8)
    cases = {"cv2_color": cv2.imencode(".ras", img)[1].tobytes(),
             "cv2_grey": cv2.imencode(".ras", img[..., 0])[1].tobytes()}
    for rtype in (0, 1):
        for bpp in (1, 8, 24, 32):
            for w in (9, 16, 1):
                cases[f"type{rtype}_{bpp}bit_w{w}"] = ras_bytes(w, 4, bpp, rtype, ras_rows(w, 4, bpp, bpp + w))
        cases[f"type{rtype}_1bit_cmap"] = ras_bytes(9, 4, 1, rtype, ras_rows(9, 4, 1, 1), 1, bytes([9, 200, 8, 100, 7, 50]))
        cases[f"type{rtype}_8bit_cmap256"] = ras_bytes(9, 4, 8, rtype, ras_rows(9, 4, 8, 2), 1,
                                                       rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        cases[f"type{rtype}_8bit_cmap5"] = ras_bytes(9, 4, 8, rtype, ras_rows(9, 4, 8, 3), 1,
                                                     rng.integers(0, 256, 15).astype(np.uint8).tobytes())
        cases[f"type{rtype}_8bit_cmap_not3"] = ras_bytes(9, 4, 8, rtype, ras_rows(9, 4, 8, 3), 1, bytes(range(16)))
    # refused by cv2 5.0: byte-encoded and RGB rasters, other depths and maps
    rle = bytes([0x80, 20, 7, 1, 2, 0x80, 0, 0x80, 40, 9])
    cases["type2_rle_8bit"] = ras_bytes(9, 4, 8, 2, rle * 4)
    cases["type2_rle_24bit"] = ras_bytes(9, 4, 24, 2, rle * 16)
    cases["type3_rgb_24bit"] = ras_bytes(9, 4, 24, 3, ras_rows(9, 4, 24, 4))
    cases["type4_tiff"] = ras_bytes(9, 4, 24, 4, ras_rows(9, 4, 24, 4))
    cases["4bit"] = ras_bytes(9, 4, 4, 1, ras_rows(9, 4, 4, 5))
    cases["16bit"] = ras_bytes(9, 4, 16, 1, ras_rows(9, 4, 16, 5))
    cases["24bit_cmap"] = ras_bytes(9, 4, 24, 1, ras_rows(9, 4, 24, 5), 1, bytes(6))
    cases["raw_map"] = ras_bytes(9, 4, 8, 1, ras_rows(9, 4, 8, 5), 2, bytes(6))
    cases["1bit_cmap_too_long"] = ras_bytes(9, 4, 1, 1, ras_rows(9, 4, 1, 5), 1, bytes(9))
    cases["no_map_with_length"] = ras_bytes(9, 4, 8, 1, ras_rows(9, 4, 8, 5), 0, bytes(3))
    cases["cut_rows"] = ras_bytes(9, 4, 8, 1, ras_rows(9, 4, 8, 5)[:-1])
    cases["cut_header"] = ras_bytes(9, 4, 8, 1, b"")[:20]
    cases["height0"] = ras_bytes(9, 0, 8, 1, b"")
    return cases


SUNRASTER_CASES = list(sunraster_cases())


@pytest.mark.parametrize("name", SUNRASTER_CASES)
def test_sunraster_kinds_answer_as_cv2(name):
    assert answers(sunraster_cases()[name]) in ("none", "equal")


@pytest.mark.parametrize("name", ["cv2_color", "cv2_grey", "type0_1bit_w9", "type1_8bit_cmap5", "type1_32bit_w9"])
def test_garbled_and_cut_sunraster_answer_as_cv2(name):
    data = sunraster_cases()[name]
    assert_all_equal_cv2(garbled(data, 60, seed=SUNRASTER_CASES.index(name), first=4), f"garbled {name}")
    assert_all_equal_cv2([data[:k] for k in range(4, len(data) + 1)], f"cut {name}")


# -- PFM ---------------------------------------------------------------------------------


def pfm_bytes(values, scale=b"-1", sep=b"\n", header=None) -> bytes:
    """A PFM of ``values`` ([H, W, 3] RGB or [H, W] grey, top row first),
    rows written bottom-up, little-endian under a negative scale."""
    v = np.asarray(values, np.float32)
    h, w = v.shape[:2]
    order = ">" if not scale.startswith(b"-") else "<"
    head = header if header is not None else f"{w} {h}\n".encode() + scale + b"\n"
    return (b"PF" if v.ndim == 3 else b"Pf") + sep + head + np.ascontiguousarray(v[::-1]).astype(order + "f4").tobytes()


def pfm_cases() -> dict:
    """{name: file}: cv2's own files, grey and colour under each byte order
    and scale, exact halves, NaN and infinities, the header's number
    rules, and what cv2 refuses."""
    rng = np.random.default_rng(13)
    img = (rng.random((5, 7, 3)) * 300).astype(np.float32)
    cases = {"cv2_color": cv2.imencode(".pfm", img)[1].tobytes(),
             "cv2_grey": cv2.imencode(".pfm", img[..., 0])[1].tobytes()}
    for grey in (False, True):
        kind = "grey" if grey else "color"
        for scale in (b"-1", b"1", b"-2.5", b"0.5", b"-0.003", b"1e2", b"-1.0"):
            v = rng.random((4, 6) if grey else (4, 6, 3)) * rng.choice([1, 300, 1e4])
            cases[f"{kind}_scale{scale.decode()}"] = pfm_bytes(v, scale)
    cases["unit_floats"] = pfm_bytes(rng.random((3, 5, 3)))
    cases["halves"] = pfm_bytes((np.arange(-2, 268).reshape(10, 9, 3) + 0.5).astype(np.float32))
    cases["specials"] = pfm_bytes(np.array([[np.nan, np.inf, -np.inf, -5, 300, 1e10, 2.0**31, 2147483520.0, -2.2e9,
                                             255.49, 255.5, 256]], np.float32).reshape(1, 4, 3))
    body = pfm_bytes(img[:2, :3])[len(b"PF\n3 2\n-1\n"):]
    for name, head in {"newlines": b"3\n2\n-1\n", "junk_suffixes": b"3x 2y -1z\n", "width_2^32+3": b"4294967299 2 -1\n",
                       "plus_signs": b"+3 +2 -1\n", "hex_scale": b"3 2 -0x1p0\n", "nul_in_width": b"3\x009 2 -1\n",
                       "leading_space": b" 3 2 -1\n", "byte_above_127": b"3\x80 2 -1\n", "scale_0": b"3 2 0\n",
                       "scale_minus0": b"3 2 -0\n", "scale_nan": b"3 2 nan\n", "scale_inf": b"3 2 -inf\n",
                       "scale_junk": b"3 2 abc\n", "width_0": b"0 2 -1\n", "height_minus2": b"3 -2 -1\n",
                       "huge": b"3000000 2 -1\n"}.items():
        cases[f"header_{name}"] = b"PF\n" + head + body
    for name, sep in (("cr", b"\r"), ("space", b" "), ("tab", b"\t")):
        cases[f"signature_then_{name}"] = pfm_bytes(img[:2, :3], sep=sep)
    cases["short"] = pfm_bytes(img[:2, :3])[:-1]
    cases["extra"] = pfm_bytes(img[:2, :3]) + b"tail"
    cases["header_only"] = b"PF\n3 2 -1"
    return cases


PFM_CASES = list(pfm_cases())


@pytest.mark.parametrize("name", PFM_CASES)
def test_pfm_kinds_answer_as_cv2(name):
    assert answers(pfm_cases()[name]) in ("none", "equal")


def test_pfm_probes_of_cv2_rules():
    """cv2's PFM rules, held as numbers: values are divided by |scale| and
    rounded half to even with no ×255; NaN, ±inf and anything at or past
    2^31 give 0; a positive scale is big-endian; rows are stored bottom-up
    and RGB; a grey file gives [H, W]; ``P[Ff]`` and any whitespace is a
    PFM, refused unless it is a line break."""
    halves = port_decode(pfm_bytes(np.array([[[0.5, 1.5, 2.5], [254.5, 255.5, -0.5]]])))
    assert halves.tolist() == [[[2, 2, 0], [0, 255, 254]]]
    specials = port_decode(pfm_bytes(np.array([[[np.nan, np.inf, -np.inf], [1e10, 2.0**31, 2147483520.0]]])))
    assert specials.tolist() == [[[0, 0, 0], [255, 0, 0]]]
    assert port_decode(pfm_bytes(np.array([[[100, 101, 102]]]), b"-2"))[0, 0].tolist() == [51, 50, 50]
    assert port_decode(pfm_bytes(np.array([[[100, 101, 102]]]), b"4"))[0, 0].tolist() == [26, 25, 25]
    assert port_decode(pfm_bytes(np.array([[1.0, 2.0], [3.0, 4.0]]))).tolist() == [[1, 2], [3, 4]]
    assert port_decode(pfm_bytes(np.array([[[0.4, 0.6, 1.0]]])))[0, 0].tolist() == [1, 1, 0]
    for sep in (b"\r", b" ", b"\t", b"\x0b", b"\x0c"):
        data = pfm_bytes(np.ones((1, 1, 3)), sep=sep)
        assert imcodec.sniff_format(data) == "pfm" and port_decode(data) is None and cv2_decode(data) is None
    assert imcodec.sniff_format(b"PFx") == "unknown"


def test_a_grey_pfm_request_gets_the_jax_services_answer(tmp_path):
    """cv2 decodes a grey PFM to [H, W] under ``IMREAD_COLOR`` and refuses
    it under ``imread``. Sent as data, the JAX service hands the 2-D array
    to its worker, which answers an error; sent by path, it answers that
    the file cannot be loaded. The port's service answers both requests
    with the same responses, fused, staged and through the batching
    dispatcher, and ``FinetuneDataset`` refuses such a crop as the JAX one
    does."""
    import asyncio
    import base64
    import dataclasses
    import json

    import torch

    from ppocr_tpu.serve.service import OCRIPCService as JaxService
    from ppocr_tpu.train.finetune import FinetuneDataset as JaxDataset
    from ppocr_tpu_torch.serve import OCRIPCService
    from ppocr_tpu_torch.train.finetune import FinetuneDataset
    from test_torch_goldens import jax_config
    from test_torch_serve import small_config

    grey = cv2.cvtColor(assets.load_scenes()["parity"][0], cv2.COLOR_BGR2GRAY)
    pfm = pfm_bytes(grey.astype(np.float32))
    assert cv2_decode(pfm).shape == grey.shape and (port_decode(pfm) == grey).all()
    path = tmp_path / "grey.pfm"
    path.write_bytes(pfm)
    assert cv2.imread(str(path)) is None and imcodec.read_image(str(path)) is None
    lines = [json.dumps({"command": "recognize", "image_data": base64.b64encode(pfm).decode()}).encode(),
             json.dumps({"command": "recognize", "image_path": str(path)}).encode()]
    model_dir = str(assets.make_jumbo_model_dir(tmp_path / "jumbo"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite runs several test processes at once
    try:
        for changes in ({}, {"fast_path": False}, {"request_batch_buckets": (1, 2)}):
            cfg = small_config(**changes)
            # no request timeout: the test is about the answer, and a loaded
            # machine can take longer than the default 30 s over the first request
            jax_svc = JaxService(model_dir, socket_path=str(tmp_path / "j.sock"),
                                 config=jax_config(dataclasses.asdict(cfg)), request_timeout_ms=0)
            svc = OCRIPCService(model_dir=model_dir, socket_path=str(tmp_path / "p.sock"), config=cfg, device="cpu",
                                request_timeout_ms=0)
            for line in lines:
                want, got = (asyncio.run(s.process_request(line)) for s in (jax_svc, svc))
                for r in (want, got):
                    r.pop("processing_time_ms", None)
                assert got == want and not got["success"], (changes, got, want)
            assert "could not broadcast" in want["error"] or "Failed to load" in want["error"]
    finally:
        torch.set_num_threads(threads)
    labels = tmp_path / "labels.txt"
    labels.write_text("grey.pfm\t1\n")
    keys = assets.JUMBO_BUNDLE["rec/ppocr_keys_v1.txt"]
    for dataset in (JaxDataset, FinetuneDataset):
        with pytest.raises(FileNotFoundError, match="cannot read crop"):
            dataset(str(labels), str(keys))


# -- Radiance HDR ------------------------------------------------------------------------


def rgbe_pixels(h, w, seed, emax=140):
    """[h, w, 4] RGBE bytes, runs and noise mixed: RLE has both to write."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    px[..., 3] = rng.integers(120, emax, (h, w))
    runs = np.repeat(px[:, ::5], 5, axis=1)[:, :w]
    return np.where(rng.random((h, w, 1)) < 0.6, runs, px).astype(np.uint8)


def rle_channel(vals: bytes, rng) -> bytes:
    """New-style RLE of one channel: runs of 3 or more as (128 + n, v),
    the rest as literal spans of random length."""
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, vals[i]])
            i = j
        else:
            k = min(n - i, int(rng.integers(1, 129)))
            out += bytes([k]) + vals[i : i + k]
            i += k
    return bytes(out)


HDR_HEAD = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def hdr_bytes(px, head=HDR_HEAD, res=None, rle=True, seed=0) -> bytes:
    """A Radiance HDR of the RGBE pixels ``px`` [h, w, 4]: new-style RLE
    scanlines where the width allows (8..32767), else flat."""
    rng = np.random.default_rng(seed)
    h, w, _ = px.shape
    out = bytearray(head + (res or f"-Y {h} +X {w}\n".encode()))
    for y in range(h):
        if rle and 8 <= w <= 0x7FFF:
            out += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                out += rle_channel(px[y, :, c].tobytes(), rng)
        else:
            out += px[y].tobytes()
    return bytes(out)


def hdr_cases() -> dict:
    """{name: file}: cv2's own file, RLE and flat scanlines, a switch to
    flat mid-image, the header's lines and resolution strings, exponents
    from 0 to 255, and what cv2 refuses."""
    rng = np.random.default_rng(17)
    cases = {"cv2": cv2.imencode(".hdr", (rng.random((5, 20, 3)) * 3).astype(np.float32))[1].tobytes()}
    for h, w in ((3, 10), (2, 40), (4, 8), (2, 129)):
        px = rgbe_pixels(h, w, h * w)
        cases[f"rle_{h}x{w}"] = hdr_bytes(px, seed=w)
        cases[f"flat_{h}x{w}"] = hdr_bytes(px, rle=False)
    px = rgbe_pixels(3, 10, 1)
    cases["width5_flat"] = hdr_bytes(rgbe_pixels(2, 5, 2))
    cases["rle_then_flat"] = hdr_bytes(px[:1]).replace(b"-Y 1", b"-Y 3") + px[1:].tobytes()
    exps = np.zeros((1, 8, 4), np.uint8)
    exps[0, :, :3] = [[255, 1, 128]]
    exps[0, :, 3] = [0, 1, 128, 129, 135, 136, 200, 255]
    cases["exponents"] = hdr_bytes(exps)
    for name, head in {"rgbe_signature": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n",
                       "more_lines": b"#?RADIANCE\n#made by hand\nEXPOSURE=2\nGAMMA=1\nFORMAT=32-bit_rle_rgbe\n\n",
                       "long_line": b"#?RADIANCE\n" + b"x" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n",
                       "signature_tail": b"#?RADIANCEjunk\nFORMAT=32-bit_rle_rgbe\n\n",
                       "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n", "no_format": b"#?RADIANCE\n\n",
                       "blank_before_format": b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n",
                       "no_blank_after_format": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",
                       "format_trailing_space": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n",
                       "crlf": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n"}.items():
        cases[f"head_{name}"] = hdr_bytes(px, head=head)
    for name, res in {"minus_y_plus_x": b"-Y 3 +X 10 tail\n", "no_spaces": b"-Y3 +X10\n",
                      "plus_signs": b"-Y +3 +X +10\n",
                      "plus_y": b"+Y 3 +X 10\n", "minus_x": b"-Y 3 -X 10\n", "x_first": b"+X 10 -Y 3\n",
                      "no_width": b"-Y 3\n", "width_11": b"-Y 3 +X 11\n", "height_2": b"-Y 2 +X 10\n",
                      "height_4": b"-Y 4 +X 10\n", "height_0": b"-Y 0 +X 10\n", "huge": b"-Y 3 +X 3000000\n"}.items():
        cases[f"res_{name}"] = hdr_bytes(px, res=res)
    rle = hdr_bytes(px)
    at = len(HDR_HEAD) + len(b"-Y 3 +X 10\n")
    cases["bad_run_zero"] = rle[: at + 4] + b"\x00" + rle[at + 5 :]
    cases["run_past_channel"] = rle[: at + 4] + b"\xff\x07" + rle[at + 6 :]
    cases["cut"] = rle[:-3]
    cases["extra"] = rle + b"tail"
    return cases


HDR_CASES = list(hdr_cases())


@pytest.mark.parametrize("name", HDR_CASES)
def test_hdr_kinds_answer_as_cv2(name):
    assert answers(hdr_cases()[name]) in ("none", "equal")


def test_hdr_probes_of_cv2_rules():
    """cv2's HDR rules, held as numbers: ``clip(rint(m · 2^(E-136) · 255))``
    in float, RGB stored, BGR out; E = 0 is black, and a value at or past
    2^31 gives 0, not 255; only ``-Y H +X W`` and ``32-bit_rle_rgbe`` are
    read, the sizes as ``sscanf`` stores them; there are no old-style
    runs."""
    px = np.array([[[255, 1, 128, e] for e in (0, 128, 129, 136, 200, 255)] + [[3, 5, 7, 129]] * 2], np.uint8)
    got = port_decode(hdr_bytes(px))
    assert got[0, :6].tolist() == [[0, 0, 0], [128, 1, 254], [255, 2, 255], [255, 255, 255], [0, 0, 0], [0, 0, 0]]
    assert got[0, 6].tolist() == [14, 10, 6]
    for res in (b"+Y 1 +X 8\n", b"-Y 1 -X 8\n", b"+X 8 -Y 1\n"):
        assert port_decode(hdr_bytes(px, res=res)) is None
    assert port_decode(hdr_bytes(px, head=b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n")) is None
    # the resolution's numbers wrap as sscanf's %d stores them: 2^32 + 1 rows is 1
    assert port_decode(hdr_bytes(px, res=b"-Y 4294967297 +X 8\n")).shape == (1, 8, 3)
    # no old-style runs: (1, 1, 1, n) in flat data is a pixel, not a repeat of the one before
    flat = np.array([[[10, 20, 30, 137], [1, 1, 1, 3], [40, 50, 60, 137]]], np.uint8)
    assert port_decode(hdr_bytes(flat)).tolist() == [[[255, 255, 255], [0, 0, 0], [255, 255, 255]]]
    for data in (hdr_bytes(px, res=b"-Y 4294967297 +X 8\n"), hdr_bytes(flat)):
        assert answers(data) == "equal"


# -- GIF ----------------------------------------------------------------------------------


def lzw_codes(idx, mcs, clear_at=4095):
    """[(code, bits)] of a GIF LZW stream of the byte indices ``idx``:
    clear first, end of information last, a clear whenever the next code
    would be ``clear_at`` (4096: the table fills and codes go on at 12 bits,
    a deferred clear)."""
    clear, eoi = 1 << mcs, (1 << mcs) + 1
    out, size, nxt = [(clear, mcs + 1)], mcs + 1, eoi + 1
    table = {bytes([i]): i for i in range(min(clear, 256))}
    w = b""
    for c in np.asarray(idx, np.uint8).reshape(-1).tobytes():
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        out.append((table[w], size))
        if nxt < min(clear_at, 4096):
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        elif clear_at < 4096:
            out.append((clear, size))
            size, nxt = mcs + 1, eoi + 1
            table = {bytes([i]): i for i in range(min(clear, 256))}
        w = bytes([c])
    if w:
        out.append((table[w], size))
    return out + [(eoi, size)]


def pack_codes(codes) -> bytes:
    acc = n = 0
    out = bytearray()
    for code, bits in codes:
        acc |= code << n
        n += bits
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    return bytes(out + (bytes([acc]) if n else b""))


def sub_blocks(data: bytes, n=255) -> bytes:
    return b"".join(bytes([len(data[i : i + n])]) + data[i : i + n] for i in range(0, len(data), n)) + b"\x00"


def gif_table(colours):
    """A colour table's flag bits and bytes (RGB, padded to a power of two)."""
    k = max(0, int(np.ceil(np.log2(max(2, len(colours))))) - 1)
    pal = np.zeros((2 << k, 3), np.uint8)
    pal[: len(colours)] = colours
    return 0x80 | k, pal.tobytes()


def gif_image(idx, left=0, top=0, mcs=8, local=None, interlace=False, data=None, block=255) -> bytes:
    """An image descriptor, its local table and LZW data of [h, w] ``idx``
    (or the packed codes ``data``)."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    flags, lct = (0, b"") if local is None else gif_table(local)
    flags |= 0x40 if interlace else 0
    if data is None:
        rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]]) if interlace else idx
        data = pack_codes(lzw_codes(rows, mcs))
    return struct.pack("<BHHHHB", 0x2C, left, top, w, h, flags) + lct + bytes([mcs]) + sub_blocks(data, block)


def gif_gce(transparent=None, disposal=0) -> bytes:
    return struct.pack("<BBBBHBB", 0x21, 0xF9, 4, disposal << 2 | (transparent is not None), 0, transparent or 0, 0)


def gif_bytes(w, h, blocks, glob=None, bg=0, version=b"GIF89a", trailer=b";") -> bytes:
    flags, gct = (0x70, b"") if glob is None else gif_table(glob)
    return version + struct.pack("<HHBBB", w, h, flags | 0x70, bg, 0) + gct + b"".join(blocks) + trailer


NETSCAPE = b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"


def gif_cases() -> dict:
    """{name: file}: PIL's and cv2's files (palettes of 2 to 256, interlaced,
    transparent, animated), frames smaller than the screen with and without
    a global table, transparency, local and missing tables, every LZW code
    size, a full table with and without clears, end-of-information
    mid-stream, the pixel count cv2 takes, the extensions it reads, and
    what it refuses."""
    rng = np.random.default_rng(19)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    cases = {"cv2": cv2.imencode(".gif", rng.integers(0, 256, (5, 9, 3)).astype(np.uint8))[1].tobytes()}
    for n, (h, w) in ((2, (5, 13)), (16, (9, 7)), (256, (11, 4))):
        a = pattern(h, w, n, n).astype(np.uint8)
        im = Image.fromarray(a, "P")
        im.putpalette(pal[:n].tobytes())
        for kind, kw in (("", {}), ("_interlaced", {"interlace": True}),
                         ("_transparent", {"transparency": int(a[0, 0])})):
            buf = io.BytesIO()
            im.save(buf, "GIF", **kw)
            cases[f"pil_{n}colours{kind}"] = buf.getvalue()
    frames = [Image.fromarray(rng.integers(0, 256, (6, 8, 3)).astype(np.uint8)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=50, loop=0, disposal=2)
    cases["pil_animated"] = buf.getvalue()
    a = rng.integers(0, 16, (3, 4))
    cases["subframe_on_background"] = gif_bytes(6, 5, [gif_image(a, 1, 2, mcs=4)], pal[:16], bg=5)
    cases["subframe_no_global"] = gif_bytes(6, 5, [gif_image(a, 2, 1, mcs=4, local=pal[:16])], bg=5)
    cases["subframe_disposal3"] = gif_bytes(6, 5, [gif_gce(disposal=3), gif_image(a, 1, 1, mcs=4)], pal[:16], bg=2)
    cases["transparent"] = gif_bytes(4, 3, [gif_gce(int(a[0, 0])), gif_image(a, mcs=4)], pal[:16], bg=7)
    cases["transparent_no_global"] = gif_bytes(4, 3, [gif_gce(int(a[0, 0])), gif_image(a, mcs=4, local=pal[:16])])
    past = np.where(a == a[0, 0], 9, a % 4)  # the transparent index is the only one past the table
    cases["transparent_past_table"] = gif_bytes(4, 3, [gif_gce(9), gif_image(past, mcs=4)], pal[:4])
    cases["no_table"] = gif_bytes(4, 3, [gif_image(a, mcs=4)])
    cases["no_table_256"] = gif_bytes(256, 1, [gif_image(np.arange(256)[None])])
    cases["local_over_global"] = gif_bytes(4, 3, [gif_image(a, mcs=4, local=pal[100:116])], pal[:16])
    cases["short_local_long_global"] = gif_bytes(4, 3, [gif_image(a, mcs=4, local=pal[:2])], pal[:16])
    cases["index_past_tables"] = gif_bytes(4, 3, [gif_image(a, mcs=4)], pal[:4])
    for mcs in (2, 3, 5, 8, 9, 11):
        cases[f"code_size{mcs}"] = gif_bytes(7, 5, [gif_image(rng.integers(0, min(1 << mcs, 256), (5, 7)), mcs=mcs)],
                                             pal if mcs > 3 else pal[: 1 << mcs])
    big = rng.integers(0, 256, (60, 90))
    cases["full_table_cleared"] = gif_bytes(90, 60, [gif_image(big)], pal)
    cases["full_table_deferred"] = gif_bytes(90, 60, [gif_image(big, data=pack_codes(lzw_codes(big, 8, 4096)))], pal)
    cases["one_byte_blocks"] = gif_bytes(4, 3, [gif_image(a, mcs=4, block=1)], pal[:16])
    lit = lambda *cs: pack_codes([(c, 5) for c in cs])  # noqa: E731  (code size 5 throughout: mcs 4, < 32 entries)
    c, e = 16, 17
    for name, codes in {"eoi_mid_stream": (c, 1, 2, 3, e, 4, 5, 6, 7, 8, 9, 10, 11, 12, e),
                        "eoi_then_kwkwk": (c, 1, 2, 3, e, 4, 18, 7, 8, 9, 10, 11, 12),
                        "no_eoi": (c, *range(1, 13)), "no_clear": (*range(1, 13), e),
                        "one_pixel_more": (c, *range(1, 14)),
                        "two_pixels_more": (c, *range(1, 15)), "one_pixel_short": (c, *range(1, 12), e),
                        "string_past_end": (c, *range(1, 12), 18), "code_past_table": (c, 1, 2, 25, *range(4, 13), e),
                        "first_code_past_table": (c, 18, *range(1, 12), e)}.items():
        cases[f"lzw_{name}"] = gif_bytes(4, 3, [gif_image(a, mcs=4, data=lit(*codes))], pal[:16])
    img = gif_image(a, mcs=4)
    xmp = b"\x21\xff\x0bXMP DataXMP<x/>" + bytes([1, *range(255, -1, -1)]) + b"\x00"  # with XMP's magic trailer
    for name, ext in {"netscape": NETSCAPE, "xmp": xmp,
                      "animexts_3byte_block": b"\x21\xff\x0bANIMEXTS1.0\x03\x01\x00\x00\x00",
                      "animexts_2byte_read": b"\x21\xff\x0bANIMEXTS1.0\x03\x01\x00\x00",
                      "comment": b"\x21\xfe\x05hello\x00", "plain_text": b"\x21\x01\x0c" + bytes(12) + b"\x02ab\x00",
                      "unknown_type": b"\x21\x77\x02ab\x00", "gce_size5": b"\x21\xf9\x05\x01\x00\x00\x03\x00\x00",
                      "disposal5": gif_gce(disposal=5), "two_gce": gif_gce(3) + gif_gce()}.items():
        cases[f"ext_{name}_before"] = gif_bytes(4, 3, [ext, img], pal[:16])
        cases[f"ext_{name}_after"] = gif_bytes(4, 3, [img, ext, img], pal[:16])
    cases["second_frame_outside"] = gif_bytes(4, 3, [img, gif_image(a, 2, 0, mcs=4)], pal[:16])
    cases["gif87a"] = gif_bytes(4, 3, [img], pal[:16], version=b"GIF87a")
    cases["gif90a"] = gif_bytes(4, 3, [img], pal[:16], version=b"GIF90a")
    cases["background_past_table"] = gif_bytes(4, 3, [img], pal[:16], bg=20)
    cases["frame_outside_screen"] = gif_bytes(4, 3, [gif_image(a, 1, 0, mcs=4)], pal[:16])
    cases["no_trailer"] = gif_bytes(4, 3, [img], pal[:16], trailer=b"")
    cases["junk_after_trailer"] = gif_bytes(4, 3, [img], pal[:16], trailer=b";junk")
    cases["unknown_block"] = gif_bytes(4, 3, [img, b"\x99"], pal[:16])
    cases["trailer_only"] = gif_bytes(4, 3, [], pal[:16])
    cases["code_size1"] = gif_bytes(4, 3, [gif_image(a % 2, mcs=1, data=pack_codes(lzw_codes(a % 2, 1)))], pal[:2])
    cases["screen_0"] = gif_bytes(0, 3, [img], pal[:16])
    return cases


GIF_CASES = list(gif_cases())


@pytest.mark.parametrize("name", GIF_CASES)
def test_gif_kinds_answer_as_cv2(name):
    assert answers(gif_cases()[name]) in ("none", "equal")


def test_gif_probes_of_cv2_rules():
    """cv2's GIF rules, held as numbers: the screen outside the first frame
    and under its transparent pixels is the global table's background
    colour (black without a global table), whatever the disposal method;
    with no table at all an index is a grey level, 1 white; an index past
    the tables refuses the file; only the first frame counts; cv2 takes one
    pixel more than the frame but not two; a cut file is refused."""
    pal = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90], [100, 110, 120]], np.uint8)
    a = np.array([[0, 1], [2, 3]])
    sub = port_decode(gif_bytes(3, 2, [gif_image(a[:1], 1, 1, mcs=2)], pal, bg=2))
    assert sub.tolist() == [[[90, 80, 70]] * 3, [[90, 80, 70], [30, 20, 10], [60, 50, 40]]]
    transparent = port_decode(gif_bytes(2, 2, [gif_gce(1, disposal=1), gif_image(a, mcs=2)], pal, bg=3))
    assert transparent[0].tolist() == [[30, 20, 10], [120, 110, 100]]
    assert port_decode(gif_bytes(3, 2, [gif_image(a[:1], mcs=2, local=pal)], bg=2))[1].tolist() == [[0, 0, 0]] * 3
    assert port_decode(gif_bytes(4, 1, [gif_image(np.array([[0, 1, 2, 200]]))]))[0, :, 0].tolist() == [0, 255, 2, 200]
    assert port_decode(gif_bytes(2, 2, [gif_image(a, mcs=2)], pal[:2])) is None
    frames = gif_bytes(2, 2, [gif_image(a, mcs=2), gif_image(a[::-1], mcs=2)], pal)
    assert (port_decode(frames) == pal[a][..., ::-1]).all()
    lit = lambda *cs: pack_codes([(c, 5) for c in cs])  # noqa: E731  (code size 4: clear 16, 5-bit codes)
    one_more, two_more = (gif_bytes(2, 2, [gif_image(a, mcs=4, data=lit(16, 0, 1, 2, 3, *extra))], pal)
                          for extra in ((1,), (1, 1)))
    assert (port_decode(one_more) == pal[a][..., ::-1]).all() and port_decode(two_more) is None
    assert answers(one_more) == "equal" and answers(two_more) == "none"
    assert all(port_decode(frames[:k]) is None for k in range(3, len(frames)))
    assert imcodec.sniff_format(b"GIF90a") == "gif" and port_decode(b"GIF90a" + frames[6:]) is None


def lzw_streams(seed, n=400):
    """``n`` GIFs whose LZW streams are changed at random: codes replaced,
    dropped, added, clears and ends of information put in, the stream cut,
    bytes appended, split over sub-blocks of 1 to 255 bytes; some frames
    large enough to fill the table."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mcs = int(rng.integers(2, 9))
        big = rng.random() < 0.1
        w, h = int(rng.integers(1, 9)) * (70 if big else 1), int(rng.integers(1, 6)) * (20 if big else 1)
        if rng.random() < 0.5:
            idx = rng.integers(0, 1 << mcs, w * h)
        else:
            idx = np.repeat(rng.integers(0, 1 << mcs, w * h // 3 + 1), 3)[: w * h]
        codes = lzw_codes(idx, mcs)
        for _ in range(int(rng.integers(0, 4))):
            if len(codes) < 2:
                break
            op, at = int(rng.integers(0, 5)), int(rng.integers(0, len(codes)))
            bits = codes[at][1]
            if op == 0:
                codes[at] = (int(rng.integers(0, 1 << bits)), bits)
            elif op == 1:
                del codes[at]
            elif op == 2:
                codes.insert(at, (int(rng.integers(0, 1 << bits)), bits))
            elif op == 3:
                codes.insert(at, ((1 << mcs) + int(rng.integers(0, 2)), bits))
            else:
                codes = codes[: max(at, 1)]
        data = pack_codes(codes) + bytes([int(rng.choice([0, 255]))] * int(rng.integers(0, 3)))
        img = gif_image(np.zeros((h, w)), mcs=mcs, data=data, block=int(rng.choice([1, 2, 3, 255])))
        out.append(gif_bytes(w, h, [img]))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_changed_lzw_streams_answer_as_cv2(seed):
    """cv2's LZW reader on damaged streams: codes past the table, strings
    past the frame, ends of information mid-stream, counts one or two past
    the frame or short of it, a full table."""
    assert_all_equal_cv2(lzw_streams(seed), "changed lzw stream")


@pytest.mark.parametrize("fmt", ["bmp", "hdr", "gif", "tiff"])
def test_a_run_length_bmp_hdr_or_gif_raises_when_its_decoder_cannot_be_built(fmt, monkeypatch):
    """A missing compiler is not a bad image: the decode raises, as a
    JPEG's does, and never falls back."""
    from ppocr_tpu_torch.ops import native

    def no_compiler(source=None):
        raise RuntimeError("no C++ compiler")

    from test_torch_tiff import tiff_cases_cached

    data = {"bmp": lambda: bmp_cases()["rle8_7x21"], "hdr": lambda: hdr_cases()["rle_3x10"],
            "gif": lambda: gif_cases()["pil_16colours"], "tiff": lambda: tiff_cases_cached()["cv2_colour"]}[fmt]()
    for lib in ("_bmp_rle_lib", "_hdr_lib", "_gif_lib", "_tiff_lib"):
        monkeypatch.setattr(native, lib, None)
    monkeypatch.setattr(native, "build", no_compiler)
    with pytest.raises(RuntimeError, match="compiler"):
        imcodec.decode_image(data)


# -- garbled and cut, the three formats -------------------------------------------------

GARBLED_PFM_HDR_GIF = [f"pfm_{n}" for n in ("cv2_color", "cv2_grey", "color_scale1", "grey_scale-2.5")] + [
    f"hdr_{n}" for n in ("cv2", "rle_3x10", "flat_2x40", "width5_flat", "head_more_lines")] + [
    f"gif_{n}" for n in ("cv2", "pil_16colours", "pil_256colours_interlaced", "pil_2colours_transparent",
                         "pil_animated", "subframe_on_background", "ext_netscape_before", "code_size9")]


def pfm_hdr_gif_case(name):
    fmt, case = name.split("_", 1)
    return {"pfm": pfm_cases, "hdr": hdr_cases, "gif": gif_cases}[fmt]()[case]


@pytest.mark.parametrize("name", GARBLED_PFM_HDR_GIF)
def test_garbled_and_cut_pfm_hdr_gif_answer_as_cv2(name):
    """100 seeded files per kind with 1–3 bytes changed past the signature
    (past a GIF's screen size, which could ask both decoders for gigabytes:
    the size rules have cases of their own), then every cut (at most 120 of
    them, evenly spaced)."""
    data = pfm_hdr_gif_case(name)
    first = {"pfm": 3, "hdr": 6, "gif": 10}[name[:3]]
    assert_all_equal_cv2(garbled(data, 100, seed=GARBLED_PFM_HDR_GIF.index(name), first=first), f"garbled {name}")
    assert_all_equal_cv2([data[:k] for k in range(3, len(data) + 1, max(1, len(data) // 120))], f"cut {name}")


# -- refusals --------------------------------------------------------------------------


def test_every_refusal_logs_one_line_naming_format_and_reason(caplog):
    """Each ``None`` of the cases above (and of a cut PNG and a lossless
    JPEG) comes with exactly one warning from ``imcodec`` that names the
    format and gives a reason."""
    from test_torch_tiff import tiff_cases_cached

    refused = {**bmp_cases(), **netpbm_cases(), **sunraster_cases(),
               **{f"tiff_{k}": v for k, v in tiff_cases_cached().items()},
               **{f"{fmt}_{k}": v for fmt, cases in (("pfm", pfm_cases), ("hdr", hdr_cases), ("gif", gif_cases))
                  for k, v in cases().items()}}
    refused["png_cut"] = imcodec.encode_png(np.zeros((4, 4, 3), np.uint8))[:-20]
    refused["png_damaged"] = next(d for d in png_damaged(2, 8, False, seed=1) if cv2_decode(d) is None)
    jpeg = bytearray(cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))[1].tobytes())
    jpeg[jpeg.index(b"\xff\xc0") + 1] = 0xC3
    refused["jpeg_lossless"] = bytes(jpeg)
    names = {"bmp": "BMP", "pnm": "PPM/PGM/PBM/PAM", "sunraster": "Sun raster", "png": "PNG", "jpeg": "JPEG",
             "pfm": "PFM", "hdr": "Radiance HDR", "gif": "GIF", "tiff": "TIFF"}
    seen = 0
    for name, data in refused.items():
        caplog.clear()
        with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
            img = imcodec.decode_image(data)
        if img is not None:
            assert not caplog.records, name
            continue
        seen += 1
        assert len(caplog.records) == 1, (name, caplog.text)
        msg = caplog.records[0].getMessage()
        fmt = names[imcodec.sniff_format(data)]
        assert msg.startswith(f"{fmt} payload not decoded: ") and len(msg) > len(fmt) + 25, (name, msg)
    assert seen >= 40


# -- the committed cases' writer --------------------------------------------------------


def sun_rle(raw: bytes) -> bytes:
    """RT_BYTE_ENCODED: a run of 3 or more equal bytes (or any 0x80) as
    0x80, count - 1, value; a single 0x80 as 0x80, 0."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 256:
            j += 1
        if j - i >= 3 or raw[i] == 0x80:
            out += bytes([0x80, 0]) if (raw[i] == 0x80 and j - i == 1) else bytes([0x80, j - i - 1, raw[i]])
        else:
            out += raw[i:j]
        i = j
    return bytes(out)


def scene_gif(scene: np.ndarray) -> bytes:
    """A scene of at most 256 colours as a GIF that keeps every pixel."""
    colours, idx = np.unique(scene.reshape(-1, 3), axis=0, return_inverse=True)
    assert len(colours) <= 256, len(colours)
    h, w, _ = scene.shape
    return gif_bytes(w, h, [gif_image(idx.reshape(h, w))], colours[:, ::-1])


def scene_payloads(scene: np.ndarray) -> dict:
    """A serving scene as the smoke run's timing inputs: a 24-bit BMP, its
    grey as an RLE8 BMP, a binary PPM, a standard Sun raster and a
    byte-encoded one (which cv2 5.0 refuses), a PFM, cv2's run-length
    Radiance HDR of the scene / 255, a GIF (the scene has 256 colours) and
    cv2's own TIFFs: uncompressed, LZW with the horizontal predictor,
    PackBits and deflate (384 strips of 2 rows each); the scene thresholded
    to 1 bit as PIL's G4, G3 1D, G3 2D (T4Options 1) and CCITT RLE TIFFs and
    as an RLEW TIFF of the fax coder here, and the same at a fax page's
    1728×2304 (nearest) as PIL's G4; the scene as YCbCr JPEG TIFFs (q95
    4:2:0, abbreviated streams under one JPEGTables tag) in 64-row strips
    and in 256×256 tiles, and the committed ``jpeg_cases.npz`` scene0 JPEG
    (the same q95 4:2:0 stream) as the one strip of a TIFF; the scene as
    cv2's default (lossless) WebP, and its grey in 16 levels as one, which
    the encoder codes with colour indexing, two pixels a byte; the scene as
    cv2's q90 lossy WebP (VP8), and with its grey in 4 levels as a fourth
    channel as one (VP8X, a lossless ALPH chunk, VP8)."""
    from test_torch_tiff_fax import fax_tiff, pil_fax
    from test_torch_tiff_jpeg import jpeg, jpeg_tiff, split_tables, undefined

    h, w, _ = scene.shape
    black = (cv2.cvtColor(scene, cv2.COLOR_BGR2GRAY) <= 128).astype(np.uint8)
    fax = {f"scene0_tiff_{name}": pil_fax(black, comp, info) for name, comp, info in (
        ("g4", "group4", None), ("g3", "group3", None), ("g3_2d", "group3", {292: 1}), ("rle", "tiff_ccitt", None))}
    fax["scene0_tiff_rlew"] = fax_tiff(black, "rlew", rows=64)
    fax["page_tiff_g4"] = pil_fax(cv2.resize(black, (1728, 2304), interpolation=cv2.INTER_NEAREST), "group4")
    bmps = scene_bmps(scene)
    rows = np.pad(scene.reshape(h, -1), ((0, 0), (0, -w * 3 % 2))).tobytes()
    tiffs = {f"scene0_tiff_{name}": cv2.imencode(".tiff", scene, [cv2.IMWRITE_TIFF_COMPRESSION, c])[1].tobytes()
             for name, c in (("none", 1), ("lzw", 5), ("packbits", 32773), ("deflate", 8))}
    rgb = scene[..., ::-1]
    tables = split_tables(jpeg(rgb[:64], quality=95))[0]
    strips = [split_tables(jpeg(rgb[y : y + 64], quality=95))[1] for y in range(0, h, 64)]
    tiles = [split_tables(jpeg(rgb[y : y + 256, x : x + 256], quality=95))[1] for y in range(0, h, 256)
             for x in range(0, w, 256)]
    assert h % 256 == 0 and w % 256 == 0 and all(split_tables(jpeg(rgb[y : y + 64], quality=95))[0] == tables
                                                 for y in range(0, h, 64))
    jpegs = {"scene0_tiff_jpeg": jpeg_tiff(rgb, strips, rows=64, sub=(2, 2), tables=undefined(tables)),
             "scene0_tiff_jpeg_tiles": jpeg_tiff(rgb, tiles, tile=(256, 256), sub=(2, 2), tables=undefined(tables)),
             "scene0_tiff_jpeg_onestrip": jpeg_tiff(rgb, [assets.load_jpeg_cases()[0]["scene0"][0]], sub=(2, 2))}
    return {**tiffs, **fax, **jpegs, "scene0_bmp24": bmps["bgr"][0], "scene0_grey_rle8": bmps["grey_rle8"][0],
            "scene0_ppm": f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(scene[..., ::-1]).tobytes(),
            "scene0_ras": ras_bytes(w, h, 24, 1, rows), "scene0_ras_rle": ras_bytes(w, h, 24, 2, sun_rle(rows)),
            "scene0_pfm": pfm_bytes(scene[..., ::-1].astype(np.float32)),
            "scene0_hdr_rle": cv2.imencode(".hdr", scene.astype(np.float32) / 255)[1].tobytes(),
            "scene0_gif": scene_gif(scene), "scene0_webp": cv2.imencode(".webp", scene)[1].tobytes(),
            "scene0_webp_palette": cv2.imencode(".webp", scene_grey16(scene))[1].tobytes(),
            "scene0_webp_q90": cv2.imencode(".webp", scene, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes(),
            "scene0_webp_q90_alpha": cv2.imencode(".webp", scene_with_alpha(scene), [cv2.IMWRITE_WEBP_QUALITY, 90])[
                1].tobytes()}


def scene_with_alpha(scene: np.ndarray) -> np.ndarray:
    """The scene as BGRA, its grey in 4 levels as the alpha channel."""
    grey = cv2.cvtColor(scene, cv2.COLOR_BGR2GRAY) // 64 * 85
    return np.concatenate([scene, grey[..., None]], axis=2)


def scene_grey16(scene: np.ndarray) -> np.ndarray:
    """The scene's grey in 16 levels, as BGR: at most 16 colours."""
    grey = cv2.cvtColor(scene, cv2.COLOR_BGR2GRAY) // 16 * 17
    return np.repeat(grey[..., None], 3, axis=2)


def write():
    """Rewrite ``image_cases.npz``: every BMP, netpbm, Sun raster, PFM,
    Radiance HDR and GIF case above and every TIFF kind of
    ``tests/test_torch_tiff.py``, ``tests/test_torch_tiff_fax.py`` and
    ``tests/test_torch_tiff_jpeg.py``, every lossless WebP case of
    ``tests/test_torch_webp.py`` and every written lossy one of
    ``tests/test_torch_webp_lossy.py`` with cv2's and PIL's lossy files of
    its sizes, garbled and cut ones among them (and
    TIFFs with damaged strip data or JPEG headers, cut JPEG blocks, and
    mutated WebPs), the JPEG 2000 spread of ``tests/test_torch_jpeg2000.py``
    (``written_cases``: mutated and cut files among them), the AVIF spread
    of ``tests/test_torch_avif.py`` (``written_cases``: cv2's lossless files,
    the tool corpus, the box cases, the unported kinds, mutated and cut
    files), of ``tests/test_torch_avif_lossy.py`` (lossy 4:4:4 streams
    with the filters off, their encoder options, monochrome and alpha,
    mutated and cut files), of ``tests/test_torch_avif_chroma.py`` (4:2:0
    and 4:2:2 streams, lossless and lossy, screen content, options, mutated
    and cut files), of ``tests/test_torch_avif_deblock.py`` (deblocked
    and CDEF-filtered files of cv2 and Pillow, the written frames, mutated
    and cut files) and of ``tests/test_torch_avif_restoration.py``
    (loop-restored files of cv2 and Pillow, the written frames, edge
    sizes, mutated and cut files), damaged PNGs (decoded and refused) and the first
    serving scene as each timing payload (the JPEG 2000 ones from
    ``tests/test_torch_jpeg2000.py``'s ``scene_payloads``, the lossless AVIF
    from ``tests/test_torch_avif.py``'s ``scene_payload``, the lossy one
    from ``tests/test_torch_avif_lossy.py``'s, cv2's quality-95 4:2:0 one
    from ``tests/test_torch_avif_chroma.py``'s, cv2's and Pillow's default
    ones from ``tests/test_torch_avif_deblock.py``'s, cv2's speed-4 one
    from ``tests/test_torch_avif_restoration.py``'s, Pillow's film-grain
    one from ``tests/test_torch_avif_grain.py``'s), each beside cv2's decode (a grey PFM's is [H, W]) or a
    flag that cv2 gave ``None``. Of a PAM of DEPTH
    2 or 4 the columns cv2 does not write are stored as 0, as the port
    gives them."""
    cases = {**{f"bmp_{k}": v for k, v in bmp_cases().items()},
             **{f"netpbm_{k}": v for k, v in netpbm_cases().items()},
             **{f"sunras_{k}": v for k, v in sunraster_cases().items()
                if not k.startswith("type0_") or k in ("type0_8bit_w9", "type0_1bit_cmap")}}
    for i, (name, src) in enumerate((("rle8", "rle8_16x40"), ("rle4", "rle4_16x40"), ("8bit", "8bit_5x13"),
                                     ("v4", "32bit_bitfields_10bit_v4"))):
        for k, data in enumerate(garbled(bmp_cases()[src], 4, seed=i + 70)):
            cases[f"bmp_garbled_{name}_{k}"] = data
    rle = bmp_cases()["rle8_7x21"]
    for k in np.linspace(struct.unpack("<I", rle[10:14])[0], len(rle), 8).astype(int):
        cases[f"bmp_cut_rle8_{k}"] = rle[:k]
    for i, (name, src) in enumerate((("ppm", "cv2.ppm"), ("pam", "pam_RGB_3_max255"), ("ras", "cv2_color"))):
        data = {**netpbm_cases(), **sunraster_cases()}[src]
        for k, g in enumerate(garbled(data, 4, seed=i + 80)):
            cases[f"{name}_garbled_{k}"] = g
    for fmt, kinds in (("pfm", pfm_cases), ("hdr", hdr_cases), ("gif", gif_cases)):
        cases.update({f"{fmt}_{k}": v for k, v in kinds().items()})
    for i, name in enumerate(GARBLED_PFM_HDR_GIF):
        data = pfm_hdr_gif_case(name)
        for k, g in enumerate(garbled(data, 4, seed=i + 90, first={"pfm": 3, "hdr": 6, "gif": 10}[name[:3]])):
            cases[f"{name}_garbled_{k}"] = g
        for k in np.linspace(3, len(data) - 1, 3).astype(int):
            cases[f"{name}_cut_{k}"] = data[:k]
    for ct, d, il in ((0, 8, False), (2, 8, True), (3, 1, True), (4, 8, False)):
        decoded = refused = 0
        for k, data in enumerate(png_damaged(ct, d, il, seed=ct + d)):
            none = cv2_decode(data) is None
            if (refused if none else decoded) < (2 if none else 5):
                cases[f"png_damaged_type{ct}_{d}bit_{'adam7' if il else 'plain'}_{k}"] = data
                refused, decoded = refused + none, decoded + (not none)
    for wbits, period, w, h in ((9, 3000, 40000, 1), (10, 700, 33000, 1)):
        cases[f"png_far_window{1 << wbits}_period{period}_{w}x{h}"] = png_far(wbits, period, w, h, seed=wbits)
    from test_torch_tiff import COMPRESSIONS, GARBLED, noise, small_enough, tiff_bytes, tiff_cases_cached
    from test_torch_tiff import garbled as tiff_garbled

    cases.update({f"tiff_{k}": v for k, v in tiff_cases_cached().items()})
    for i, name in enumerate(GARBLED):
        data = tiff_cases_cached()[name]
        kept = [g for g in tiff_garbled(data, 8, seed=i + 110) if small_enough(g)][:4]
        cases.update({f"tiff_{name}_garbled_{k}": g for k, g in enumerate(kept)})
        for k in np.linspace(8, len(data) - 1, 3).astype(int):
            cases[f"tiff_{name}_cut_{k}"] = data[:k]
    for i, codec in enumerate(COMPRESSIONS):  # damaged strip data
        data = tiff_bytes(noise(40, 50, 3, 8, seed=5), rows=3, **COMPRESSIONS[codec])
        ifd = struct.unpack("<I", data[4:8])[0]
        for k, g in enumerate(tiff_garbled(data, 3, seed=i + 130, first=8, last=ifd)):
            cases[f"tiff_damaged_{codec}_{k}"] = g
    from test_torch_tiff_fax import GARBLED as FAX_GARBLED
    from test_torch_tiff_fax import damaged as fax_damaged
    from test_torch_tiff_fax import fax_cases_cached

    cases.update({f"tiff_fax_{k}": v for k, v in fax_cases_cached().items()})
    for i, name in enumerate(FAX_GARBLED):
        data = fax_cases_cached()[name]
        kept = [g for g in tiff_garbled(data, 8, seed=i + 150) if small_enough(g)][:3]
        cases.update({f"tiff_fax_{name}_garbled_{k}": g for k, g in enumerate(kept)})
        cases.update({f"tiff_fax_{name}_damaged_{k}": g for k, g in enumerate(fax_damaged(data, 3, seed=i + 170))})
    from test_torch_tiff_jpeg import GARBLED as JPEG_GARBLED
    from test_torch_tiff_jpeg import cut_blocks, damaged, jpeg_tiff_cases_cached

    cases.update({f"tiff_jpeg_{k}": v for k, (v, _) in jpeg_tiff_cases_cached().items()})
    for i, name in enumerate(JPEG_GARBLED):
        data = jpeg_tiff_cases_cached()[name][0]
        kept = [g for g in tiff_garbled(data, 8, seed=i + 190) if small_enough(g)][:2]
        cases.update({f"tiff_jpeg_{name}_garbled_{k}": g for k, g in enumerate(kept)})
        cases.update({f"tiff_jpeg_{name}_headers_{k}": g for k, g in enumerate(damaged(data, 2, i + 210, True))})
        cases.update({f"tiff_jpeg_{name}_cut_block_{k}": g for k, g in enumerate(cut_blocks(data, 1, i + 230))})
    import test_torch_webp as webp

    cases.update({f"webp_{k}": v for k, v in webp.WRITTEN.items()})
    cases.update({f"webp_{k}": v for k, v in webp.CONTAINERS.items()})
    cases.update({f"webp_encoded_{k}_{e}": webp.encode(webp.kind_image(k, i), e) for i, k in enumerate(webp.KINDS)
                  for e in ("cv2", "pil_m6")})
    import test_torch_webp_lossy as lossy

    cases.update({f"webp_lossy_{k}": v for k, v in lossy.WRITTEN.items()})
    for size in lossy.SIZES:
        for q in lossy.QUALITIES:
            for channels in (3, 4):
                img = lossy.encoded_image(size, list(lossy.SIZES).index(size), channels)
                cases[f"webp_lossy_cv2_{size}_q{q}_{channels}"] = lossy.cv2_lossy(img, q)
    for method in range(7):
        buf = io.BytesIO()
        Image.fromarray(lossy.noise_image(37, 45, method, 4)[..., [2, 1, 0, 3]]).save(
            buf, "WEBP", quality=15 * method, method=method, alpha_quality=50 * (method % 3))
        cases[f"webp_lossy_pil_m{method}"] = buf.getvalue()
    frame = lossy.vp8_bytes(40, 35, 80)  # its last 19 cuts, the sizes written to match
    cases.update({f"webp_lossy_cut_{k}": lossy.still(frame[:k]) for k in range(len(frame) - 18, len(frame))})
    for i, (name, data) in enumerate(webp.fuzz_bases().items()):
        if i % 4 == 0 or name.startswith("lossy_"):
            mutated = webp.mutations(data, 3, seed=i + 250)
            cases.update({f"webp_{name}_mutated_{k}": m for k, m in enumerate(mutated)})
    import test_torch_jpeg2000 as j2k

    cases.update({f"jpeg2000_{k}": v for k, v in j2k.written_cases().items()})
    import test_torch_avif as avif
    import test_torch_avif_chroma as avif_chroma
    import test_torch_avif_deblock as avif_filtered
    import test_torch_avif_lossy as avif_lossy
    import test_torch_avif_grain as avif_grain
    import test_torch_avif_restoration as avif_restored
    import test_torch_avif_superres as avif_superres

    cases.update({f"avif_{k}": v for k, v in avif.written_cases().items()})
    cases.update({f"avif_{k}": v for k, v in avif_lossy.written_cases().items()})
    cases.update({f"avif_{k}": v for k, v in avif_chroma.written_cases().items()})
    cases.update({f"avif_{k}": v for k, v in avif_filtered.written_cases().items()})
    cases.update({f"avif_{k}": v for k, v in avif_restored.written_cases().items()})
    cases.update({f"avif_{k}": v for k, v in avif_grain.written_cases().items()})
    cases.update({f"avif_{k}": v for k, v in avif_superres.written_cases().items()})
    cases.update(scene_payloads(assets.load_scenes()["serving"][0]))
    cases.update(j2k.scene_payloads(assets.load_scenes()["serving"][0]))
    cases.update(avif.scene_payload(assets.load_scenes()["serving"][0]))
    cases.update(avif_lossy.scene_payload(assets.load_scenes()["serving"][0]))
    cases.update(avif_chroma.scene_payload(assets.load_scenes()["serving"][0]))
    cases.update(avif_filtered.scene_payload(assets.load_scenes()["serving"][0]))
    cases.update(avif_restored.scene_payload(assets.load_scenes()["serving"][0]))
    cases.update(avif_grain.scene_payload(assets.load_scenes()["serving"][0]))
    out = {}
    for name, data in cases.items():
        out[f"{name}/bytes"] = np.frombuffer(data, np.uint8)
        want = cv2_decode(data)
        if want is None:
            out[f"{name}/none"] = np.array(True)
            continue
        want = want.copy()
        want[:, written_columns(data, want.shape[1]):] = 0
        same = next((k for k in out if k.endswith("/cv2") and out[k].shape == want.shape
                     and (out[k] == want).all()), None)
        if same is not None and (want.size > 100_000 or name.startswith("tiff_jpeg_")):  # many decode alike
            out[f"{name}/same_as"] = np.array(same.rsplit("/", 1)[0])
        else:
            out[f"{name}/cv2"] = want
    np.savez_compressed(assets.IMAGE_CASES, **out)
    refused = sum(f"{n}/none" in out for n in cases)
    print(f"wrote {assets.IMAGE_CASES} ({os.path.getsize(assets.IMAGE_CASES)} bytes, "
          f"{len(cases)} cases, {refused} refused by cv2, cv2 {cv2.__version__})")


def test_the_committed_cases_equal_cv2_today_and_the_port():
    cases = assets.load_image_cases()
    assert len(cases) >= 1080
    for name, (data, want) in cases.items():
        got = port_decode(data)
        if want is None:
            assert cv2_decode(data) is None and got is None, name
        else:
            now = cv2_decode(data).copy()
            now[:, written_columns(data, now.shape[1]):] = 0
            assert (now == want).all() and got is not None and (got == want).all(), name


def fuzz(rounds: int) -> int:
    """The PFM, HDR, GIF and TIFF decoders against cv2 on ``rounds`` seeded
    passes: every kind above with 1–3 bytes changed (``rounds`` × 200
    copies each) and every cut, ``rounds`` × 3,000 changed LZW streams, and
    the TIFF kinds of ``tests/test_torch_tiff.py``'s garbled test (200
    changed copies each, those declaring over 4 Mpixels dropped, and every
    cut) and 300 files with damaged strip or tile data per codec and
    layout, and the same of the fax kinds of
    ``tests/test_torch_tiff_fax.py`` (its garbled test's kinds, and 300
    files with damaged coded rows per fax compression and layout), and of
    the JPEG kinds of ``tests/test_torch_tiff_jpeg.py`` (its garbled test's
    kinds: 200 changed copies each and every cut; then 150 copies with the
    JPEG headers damaged, 150 with the blocks damaged anywhere, 100 with a
    block's byte count cut, and 100 with the JPEGTables tag's bytes changed
    or cut, where the kind has the tag), and 300 mutations (RIFF and chunk
    sizes, VP8X flags and canvas, ANMF fields, bit flips and cuts inside
    the VP8L data, random bytes; in the lossy files VP8 partition sizes,
    frame header bits, flips in the first and the token partitions, cuts
    and ALPH header bytes) of each base of
    ``tests/test_torch_webp.py``'s ``fuzz_bases`` (4,000 of each lossy
    base), the JPEG 2000 family of ``tests/test_torch_jpeg2000.py``
    (``fuzz_files``: 3,000 mutations of each of its 14 bases and every cut,
    ~50,000 files a round) and the AVIF family of ``tests/test_torch_avif.py``
    (``fuzz_files``: 2,000 mutations of each of its 8 bases and every cut
    of the small ones, ~25,000 files a round) with the lossy bases of
    ``tests/test_torch_avif_lossy.py`` (2,000 mutations of each of its 6,
    12,000 files a round) and the 4:2:0 and 4:2:2 bases of
    ``tests/test_torch_avif_chroma.py`` (2,000 mutations of each of its 6,
    12,000 files a round) and the deblocked and CDEF-filtered bases of
    ``tests/test_torch_avif_deblock.py`` (cv2's and Pillow's defaults,
    CDEF in 4:4:4, 4:2:2 and 4:2:0, cdef_bits > 0, a written frame: 2,000
    mutations of each of its 7, 14,000 files a round) and the loop-restored
    bases of ``tests/test_torch_avif_restoration.py`` (Wiener, self-guided
    and switchable units in 4:4:4 and 4:2:0, both superblock sizes: 2,000
    mutations of each of its 7, 14,000 files a round) and the film-grain
    bases of ``tests/test_torch_avif_grain.py`` (Pillow's test vectors in
    4:2:0 and 4:4:4, regrained 4:2:2, chroma from luma and monochrome:
    2,000 mutations of each of its 5, 10,000 files a round) and the
    superres bases of ``tests/test_torch_avif_superres.py`` (4:4:4 and
    4:2:0 with loop restoration, two tile columns, CDEF, coded lossless:
    2,000 mutations of each of its 5, 10,000 files a round). Prints the counts;
    returns the number of files that differ (a TIFF, WebP, JPEG 2000 or
    AVIF file of a kind the port names as not decoded, which garbling can
    reach, is counted apart)."""
    from test_torch_tiff import COMPRESSIONS, GARBLED, noise, small_enough, tiff_bytes, tiff_cases_cached
    from test_torch_tiff import answers as tiff_answers
    from test_torch_tiff import garbled as tiff_garbled
    from test_torch_tiff_fax import COMPRESSION as FAX_KINDS
    from test_torch_tiff_fax import GARBLED as FAX_GARBLED
    from test_torch_tiff_fax import damaged as fax_damaged
    from test_torch_tiff_fax import fax_cases_cached, fax_tiff, page
    from test_torch_tiff_jpeg import GARBLED as JPEG_GARBLED
    from test_torch_tiff_jpeg import cut_blocks, damaged, jpeg_tiff_cases_cached, tables_changed

    import test_torch_webp as webp

    import test_torch_jpeg2000 as j2k

    import test_torch_avif as avif
    import test_torch_avif_chroma as avif_chroma
    import test_torch_avif_deblock as avif_filtered
    import test_torch_avif_lossy as avif_lossy
    import test_torch_avif_grain as avif_grain
    import test_torch_avif_restoration as avif_restored
    import test_torch_avif_superres as avif_superres

    files = bad = known = fax_files = jpeg_files = webp_files = lossy_files = j2k_files = j2k_bad = 0
    avif_files = avif_bad = avif_lossy_files = avif_lossy_bad = avif_chroma_files = avif_chroma_bad = 0
    avif_filtered_files = avif_filtered_bad = avif_restored_files = avif_restored_bad = 0
    avif_grain_files = avif_grain_bad = avif_superres_files = avif_superres_bad = 0
    webp_bases = webp.fuzz_bases()
    for r in range(rounds):
        tiffs = []
        for i, name in enumerate(GARBLED):
            data = tiff_cases_cached()[name]
            tiffs += [g for g in tiff_garbled(data, 200, seed=1000 * r + i + 500) if small_enough(g)]
            tiffs += [data[:k] for k in range(4, len(data))]
        for i, codec in enumerate(COMPRESSIONS):
            for blocks in (dict(rows=3), dict(tile=(16, 16))):
                data = tiff_bytes(noise(40, 50, 3, 8, seed=r), **COMPRESSIONS[codec], **blocks)
                tiffs += tiff_garbled(data, 300, seed=1000 * r + i + 700, first=8,
                                      last=struct.unpack("<I", data[4:8])[0])
        n_tiffs = len(tiffs)
        for i, name in enumerate(FAX_GARBLED):
            data = fax_cases_cached()[name]
            tiffs += [g for g in tiff_garbled(data, 200, seed=1000 * r + i + 900) if small_enough(g)]
            tiffs += [data[:k] for k in range(4, len(data))]
        for i, kind in enumerate(FAX_KINDS):
            for blocks in (dict(rows=8), dict(tile=(32, 16))):
                data = fax_tiff(page(40, 50, seed=r), kind, **blocks)
                tiffs += fax_damaged(data, 300, seed=1000 * r + i + 950)
        fax_files += len(tiffs) - n_tiffs
        n_tiffs = len(tiffs)
        for i, name in enumerate(JPEG_GARBLED):
            data = jpeg_tiff_cases_cached()[name][0]
            seed = 1000 * r + 20 * i + 1100
            tiffs += [g for g in tiff_garbled(data, 200, seed=seed) if small_enough(g)]
            tiffs += [data[:k] for k in range(4, len(data))]
            tiffs += damaged(data, 150, seed + 1, True) + damaged(data, 150, seed + 2, False)
            tiffs += cut_blocks(data, 100, seed + 3) + tables_changed(data, 100, seed + 4)
        jpeg_files += len(tiffs) - n_tiffs
        files += len(tiffs)
        got = [tiff_answers(d) for d in tiffs]
        bad += sum(a not in ("none", "equal", "known") for a in got)
        known += got.count("known")
        for fmt, kinds in (("pfm", pfm_cases), ("hdr", hdr_cases), ("gif", gif_cases)):
            for i, data in enumerate(kinds().values()):
                first = {"pfm": 3, "hdr": 6, "gif": 10}[fmt]
                datas = garbled(data, 200, seed=1000 * r + i, first=first) + [data[:k] for k in range(3, len(data))]
                files += len(datas)
                bad += sum(answers(d) not in ("none", "equal") for d in datas)
        datas = [d for k in range(5) for d in lzw_streams(100 * r + k + 10, 600)]
        files += len(datas)
        bad += sum(answers(d) not in ("none", "equal") for d in datas)
        datas = [m for i, (name, data) in enumerate(webp_bases.items())
                 for m in webp.mutations(data, 4000 if name.startswith("lossy_") else 300, 1000 * r + i + 3000)]
        lossy_files += sum(4000 for name in webp_bases if name.startswith("lossy_"))
        webp_files += len(datas)
        files += len(datas)
        got = [tiff_answers(d) for d in datas]
        bad += sum(a not in ("none", "equal", "known") for a in got)
        known += got.count("known")
        datas = j2k.fuzz_files(r)
        j2k_files += len(datas)
        files += len(datas)
        got = [tiff_answers(d) for d in datas]
        j2k_bad += sum(a not in ("none", "equal", "known") for a in got)
        bad += sum(a not in ("none", "equal", "known") for a in got)
        known += got.count("known")
        lossy_datas = avif_lossy.fuzz_files(r)
        chroma_datas = avif_chroma.fuzz_files(r)
        filtered_datas = avif_filtered.fuzz_files(r)
        restored_datas = avif_restored.fuzz_files(r)
        grain_datas = avif_grain.fuzz_files(r)
        superres_datas = avif_superres.fuzz_files(r)
        tail = grain_datas + superres_datas  # counted apart, after the others
        datas = avif.fuzz_files(r) + lossy_datas + chroma_datas + filtered_datas + restored_datas + tail
        avif_files += len(datas)
        avif_lossy_files += len(lossy_datas)
        avif_chroma_files += len(chroma_datas)
        avif_filtered_files += len(filtered_datas)
        avif_restored_files += len(restored_datas)
        avif_grain_files += len(grain_datas)
        avif_superres_files += len(superres_datas)
        files += len(datas)
        logging.disable(logging.NOTSET)  # "known" is told by the refusal's log line
        try:
            got = [tiff_answers(d) for d in datas]
        finally:
            logging.disable(logging.WARNING)
        avif_bad += sum(a not in ("none", "equal", "known") for a in got)
        got, got_tail = got[:len(got) - len(tail)], got[len(got) - len(tail):]
        avif_grain_bad += sum(a not in ("none", "equal", "known") for a in got_tail[:len(grain_datas)])
        avif_superres_bad += sum(a not in ("none", "equal", "known") for a in got_tail[len(grain_datas):])
        n_lossy, n_chroma, n_filtered = len(lossy_datas), len(chroma_datas), len(filtered_datas)
        n_restored = len(restored_datas)
        end_chroma = len(got) - n_filtered - n_restored
        avif_lossy_bad += sum(a not in ("none", "equal", "known")
                              for a in got[end_chroma - n_chroma - n_lossy:end_chroma - n_chroma])
        avif_chroma_bad += sum(a not in ("none", "equal", "known") for a in got[end_chroma - n_chroma:end_chroma])
        avif_filtered_bad += sum(a not in ("none", "equal", "known") for a in got[end_chroma:len(got) - n_restored])
        avif_restored_bad += sum(a not in ("none", "equal", "known") for a in got[len(got) - n_restored:])
        got += got_tail
        bad += sum(a not in ("none", "equal", "known") for a in got)
        known += got.count("known")
        print(f"round {r + 1}: {files} files ({fax_files} fax TIFFs, {jpeg_files} JPEG TIFFs, {webp_files} WebPs, "
              f"{lossy_files} of them of the lossy bases, {j2k_files} JPEG 2000 files, {j2k_bad} of them differing, "
              f"{avif_files} AVIF files, {avif_bad} of them differing, {avif_lossy_files} of them of the lossy bases, "
              f"{avif_lossy_bad} of those differing, {avif_chroma_files} of the 4:2:0 and 4:2:2 bases, "
              f"{avif_chroma_bad} of those differing, {avif_filtered_files} of the deblocked and CDEF bases, "
              f"{avif_filtered_bad} of those differing, {avif_restored_files} of the loop-restored bases, "
              f"{avif_restored_bad} of those differing, {avif_grain_files} of the film-grain bases, "
              f"{avif_grain_bad} of those differing, {avif_superres_files} of the superres bases, "
              f"{avif_superres_bad} of those differing), {bad} differ from cv2 {cv2.__version__} "
              f"({known} TIFFs, WebPs, JPEG 2000 or AVIF files of a kind named as not decoded)", flush=True)
    return bad


if __name__ == "__main__":
    logging.disable(logging.WARNING)
    if sys.argv[1:] == ["--write"]:
        write()
    elif sys.argv[1:2] == ["--fuzz"] and len(sys.argv) == 3:
        sys.exit(1 if fuzz(int(sys.argv[2])) else 0)
    else:
        sys.exit("usage: python tests/test_torch_image_formats.py --write | --fuzz ROUNDS")
