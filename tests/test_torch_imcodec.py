"""The port's image decoder (``utils/imcodec.py``: zlib + numpy) against
``cv2.imdecode(..., IMREAD_COLOR)`` on PNGs and BMPs written by cv2 and
PIL (JPEG: ``tests/test_torch_jpeg.py``), on PNGs whose every row uses one given filter type, and on what it
must refuse. All comparisons are exact."""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch import assets
from ppocr_tpu_torch.utils import imcodec


def cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def noise(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def smooth(h=37, w=53, c=3):
    """A gradient with some noise: encoders pick varied filters on it."""
    yy, xx = np.mgrid[:h, :w]
    base = (yy * 3 + xx * 2)[..., None] + np.arange(c) * 40
    return ((base + noise((h, w, c), 1) % 7) % 256).astype(np.uint8)


def png_with_filter(px: np.ndarray, ftype: int, color_type: int) -> bytes:
    """A PNG whose every row is filtered with ``ftype`` (0..4), written by
    the textbook per-byte rule: the test's own reference encoder."""
    h, w, nch = px.shape
    raw = px.reshape(h, w * nch).astype(np.int32)
    lines = bytearray()
    prev = np.zeros(w * nch, np.int32)
    for r in range(h):
        row = raw[r]
        left = np.concatenate([np.zeros(nch, np.int32), row[:-nch]])
        upleft = np.concatenate([np.zeros(nch, np.int32), prev[:-nch]])
        if ftype == 0:
            pred = np.zeros_like(row)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        lines.append(ftype)
        lines += ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    return (
        imcodec.PNG_MAGIC
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(bytes(lines)))
        + chunk(b"IEND", b"")
    )


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels,color_type", [(1, 0), (3, 2), (4, 6)], ids=["grey", "rgb", "rgba"])
def test_png_each_filter_type_equals_cv2(ftype, channels, color_type):
    px = smooth(23, 31, channels)
    data = png_with_filter(px, ftype, color_type)
    want = cv2_decode(data)
    assert want is not None
    got = imcodec.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, want)


def test_png_mixed_filters_per_row_equal_cv2():
    """Rows of all five types in one image: the wavefront path takes each
    row's own filter."""
    px = smooth(25, 18, 3)
    parts = [png_with_filter(px, f, 2) for f in range(5)]
    # rebuild one stream: row r filtered with type r % 5 against the true
    # previous row (filtering never depends on how that row was filtered)
    rows = []
    for f, data in enumerate(parts):
        flat = zlib.decompress(data[data.index(b"IDAT") + 4 : data.index(b"IEND") - 8])
        rows.append(np.frombuffer(flat, np.uint8).reshape(25, 1 + 18 * 3))
    mixed = np.stack([rows[r % 5][r] for r in range(25)])
    assert sorted(set(mixed[:, 0].tolist())) == [0, 1, 2, 3, 4]

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    data = (
        imcodec.PNG_MAGIC
        + chunk(b"IHDR", struct.pack(">IIBBBBB", 18, 25, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(mixed.tobytes()))
        + chunk(b"IEND", b"")
    )
    np.testing.assert_array_equal(imcodec.decode_image(data), cv2_decode(data))
    np.testing.assert_array_equal(imcodec.decode_image(data), px[..., ::-1])


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1"])
def test_png_written_by_pil_equals_cv2(mode):
    img = Image.fromarray(smooth(40, 61, 3)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(imcodec.decode_image(data), cv2_decode(data))


@pytest.mark.parametrize("colors", [2, 7, 16, 200])
def test_png_palette_bit_depths_equal_cv2(colors):
    img = Image.fromarray(smooth(33, 45, 3)).convert("P", palette=Image.ADAPTIVE, colors=colors)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(imcodec.decode_image(data), cv2_decode(data))


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4), (1, 1, 3), (5, 300, 3)])
def test_png_written_by_cv2_equals_cv2(shape):
    for img in (noise(shape), smooth(*shape[:2], shape[2] if len(shape) == 3 else 1).reshape(shape)):
        ok, enc = cv2.imencode(".png", img)
        assert ok
        np.testing.assert_array_equal(imcodec.decode_image(enc.tobytes()), cv2_decode(enc.tobytes()))


def test_png_16_bit_equals_cv2():
    img = np.random.default_rng(2).integers(0, 65536, (20, 30, 3)).astype(np.uint16)
    for arr in (img, img[..., 0]):
        ok, enc = cv2.imencode(".png", arr)
        assert ok
        np.testing.assert_array_equal(imcodec.decode_image(enc.tobytes()), cv2_decode(enc.tobytes()))


def test_a_committed_scene_round_trips():
    scene = assets.load_scenes()["serving"][0]
    ok, enc = cv2.imencode(".png", scene)
    np.testing.assert_array_equal(imcodec.decode_image(enc.tobytes()), scene)
    ours = imcodec.encode_png(scene)
    assert len(ours) < 600 * 1024  # small enough for the client to inline
    np.testing.assert_array_equal(cv2_decode(ours), scene)
    np.testing.assert_array_equal(imcodec.decode_image(ours), scene)


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (9, 13, 4), (1, 7, 3), (64, 1, 3)])
def test_encode_png_round_trip_through_cv2_pil_and_ours(shape):
    img = smooth(*shape[:2], shape[2] if len(shape) == 3 else 1).reshape(shape)
    data = imcodec.encode_png(img)
    want = img if img.ndim == 3 else img[..., None]
    want = np.repeat(want, 3, axis=2) if want.shape[2] == 1 else want[..., :3]
    np.testing.assert_array_equal(cv2_decode(data), want)
    np.testing.assert_array_equal(imcodec.decode_image(data), want)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(pil[..., ::-1], want)
    flat = zlib.decompress(data[data.index(b"IDAT") + 4 : data.index(b"IEND") - 8])
    stride = 1 + shape[1] * (shape[2] if len(shape) == 3 else 1)
    assert set(flat[::stride]) <= {0, 1, 2}  # the encoder's filter types


def test_encode_png_rejects_what_it_cannot_write():
    with pytest.raises(ValueError):
        imcodec.encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        imcodec.encode_png(np.zeros((4, 4, 2), np.uint8))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_bmp_written_by_pil_equals_cv2(mode):
    img = Image.fromarray(smooth(21, 34, 3)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "BMP")
    data = buf.getvalue()
    np.testing.assert_array_equal(imcodec.decode_image(data), cv2_decode(data))


@pytest.mark.parametrize("shape", [(21, 34, 3), (21, 33, 3), (21, 34), (2, 1, 3)])
def test_bmp_written_by_cv2_equals_cv2(shape):
    ok, enc = cv2.imencode(".bmp", noise(shape, 3))
    assert ok
    np.testing.assert_array_equal(imcodec.decode_image(enc.tobytes()), cv2_decode(enc.tobytes()))


def test_bmp_top_down_rows():
    img = noise((6, 5, 3), 4)
    ok, enc = cv2.imencode(".bmp", img)
    data = bytearray(enc.tobytes())
    data[22:26] = struct.pack("<i", -6)  # negative height: rows top to bottom
    np.testing.assert_array_equal(imcodec.decode_image(bytes(data)), img[::-1])


def test_jpeg_is_not_decoded_and_is_logged_by_format(caplog):
    """A lossless JPEG (SOF3), which the decoder refuses by name (the ones
    it decodes: ``tests/test_torch_jpeg.py``)."""
    ok, enc = cv2.imencode(".jpg", smooth())
    data = bytearray(enc.tobytes())
    data[data.index(b"\xff\xc0") + 1] = 0xC3
    assert imcodec.sniff_format(bytes(data)) == "jpeg"
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(bytes(data)) is None
    assert "JPEG" in caplog.text and "lossless" in caplog.text


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"hello world",
        imcodec.PNG_MAGIC,
        imcodec.PNG_MAGIC + b"\x00\x00\x00\x0dIHDR" + b"\x00" * 8,
        b"BM" + b"\x00" * 10,
        b"GIF89a" + b"\x00" * 20,
    ],
    ids=["empty", "text", "png-magic-only", "png-truncated", "bmp-truncated", "gif"],
)
def test_garbage_gives_none(data):
    assert imcodec.decode_image(data) is None


def test_png_with_a_bad_crc_or_a_cut_stream_gives_none():
    ok, enc = cv2.imencode(".png", smooth())
    data = bytearray(enc.tobytes())
    assert imcodec.decode_image(bytes(data[: len(data) // 2])) is None
    data[len(data) // 2] ^= 0xFF  # inside IDAT: the CRC no longer matches
    assert imcodec.decode_image(bytes(data)) is None


def test_interlaced_png_is_refused():
    """The Adam7 flag over rows laid out without interlacing: the first
    pass's filter bytes are pixel bytes, and cv2 refuses it as well
    (Adam7 PNGs themselves: ``tests/test_torch_decode_parity.py``)."""
    data = bytearray(png_with_filter(smooth(8, 8, 3), 0, 2))
    at = data.index(b"IHDR")
    data[at + 4 + 12] = 1  # interlace method: Adam7
    data[at + 4 + 13 : at + 4 + 17] = struct.pack(">I", zlib.crc32(bytes(data[at : at + 4 + 13])))
    assert cv2_decode(bytes(data)) is None
    assert imcodec.decode_image(bytes(data)) is None


def test_read_image_reads_files_and_survives_missing_ones(tmp_path):
    img = smooth()
    path = tmp_path / "a.png"
    path.write_bytes(imcodec.encode_png(img))
    np.testing.assert_array_equal(imcodec.read_image(str(path)), img)
    np.testing.assert_array_equal(imcodec.read_image(str(path)), cv2.imread(str(path)))
    assert imcodec.read_image(str(tmp_path / "missing.png")) is None
    (tmp_path / "b.jpg").write_bytes(cv2.imencode(".jpg", img)[1].tobytes())
    np.testing.assert_array_equal(imcodec.read_image(str(tmp_path / "b.jpg")),
                                  cv2.imread(str(tmp_path / "b.jpg")))
    (tmp_path / "c.jpg").write_bytes(
        cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes())
    np.testing.assert_array_equal(imcodec.read_image(str(tmp_path / "c.jpg")),
                                  cv2.imread(str(tmp_path / "c.jpg")))
    lossless = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
    lossless[lossless.index(b"\xff\xc0") + 1] = 0xC3
    (tmp_path / "d.jpg").write_bytes(bytes(lossless))
    assert imcodec.read_image(str(tmp_path / "d.jpg")) is None
