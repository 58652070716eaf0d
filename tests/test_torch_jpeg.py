"""The port's JPEG decoder (``csrc/jpeg.cpp`` through ``utils/imcodec.py``)
against ``cv2.imdecode(..., IMREAD_COLOR)`` (libjpeg-turbo), and a JPEG
request to the port's service against the JAX engine.

JPEGs are written by ``cv2.imencode`` at qualities 50/75/95 with 4:4:4,
4:2:2, 4:2:0, 4:4:0 and 4:1:1 sampling, grey, sizes that are not
multiples of the MCU, restart intervals, and EXIF orientations 1–8 in an
APP1 segment put in front of the file. Every decode must equal cv2's
exactly: the decoder repeats libjpeg-turbo's integer arithmetic. What it
refuses (lossless, 12-bit, a frame without a scan, data that ends too
soon) gives ``None`` and a log line, never a crash. Progressive,
arithmetic, CMYK, cut and corrupt files against cv2:
``tests/test_torch_decode_parity.py``.

``python tests/test_torch_jpeg.py --write`` rewrites the committed cases
(``ppocr_tpu_torch/assets/jpeg_cases.npz``) that the card's smoke run
decodes: it has no cv2 to make or decode images.
"""

import base64
import dataclasses
import io
import os
import pathlib
import struct
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import cv2
import numpy as np
import pytest
from PIL import Image

from ppocr_tpu_torch import assets
from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.utils import imcodec

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}


def cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def image(h, w, seed=0, grey=False):
    """A gradient with noise on it: every block has AC terms, and the
    chroma planes vary."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (yy * 5 + xx * 3)[..., None] + np.arange(3) * 70
    img = ((base + rng.integers(0, 40, (h, w, 3))) % 256).astype(np.uint8)
    return img[..., 0] if grey else img


def encode(img, quality=75, sampling="420", restart=0, progressive=False) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def with_exif(data: bytes, orientation: int, big_endian=False) -> bytes:
    """``data`` with an APP1 segment right after SOI whose IFD0 holds the
    orientation tag (0x0112, SHORT)."""
    e = ">" if big_endian else "<"
    tiff = (b"MM\x00\x2a" if big_endian else b"II\x2a\x00") + struct.pack(e + "I", 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def sof_at(data: bytes) -> int:
    """Index of the SOF0 marker's code byte."""
    at = data.index(b"\xff\xc0")
    return at + 1


def assert_equals_cv2(data: bytes):
    want = cv2_decode(data)
    got = imcodec.decode_image(data)
    assert got is not None and got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


# -- equal to cv2 -------------------------------------------------------------


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_sampling_quality_and_size_equal_cv2(quality, sampling, size):
    assert_equals_cv2(encode(image(*size, seed=quality), quality, sampling))


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_768x1024_equals_cv2(sampling):
    assert_equals_cv2(encode(image(768, 1024, seed=1), 95 if sampling == "420" else 75, sampling))


def test_411_sampling_is_replicated_as_libjpeg_does():
    assert_equals_cv2(encode(image(19, 45, seed=2), 80, "411"))


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 33), (64, 48)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_grey_gives_three_equal_channels(size):
    data = encode(image(*size, seed=3, grey=True), 75)
    assert_equals_cv2(data)
    got = imcodec.decode_image(data)
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("restart", [1, 2, 5])
def test_restart_intervals_equal_cv2(restart, sampling):
    data = encode(image(33, 65, seed=4), 75, sampling, restart=restart)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_equals_cv2(data)


@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_applied_as_cv2_does(orientation, big_endian):
    data = with_exif(encode(image(17, 33, seed=5), 90, "420"), orientation, big_endian)
    want = cv2_decode(data)
    assert want.shape[:2] == ((33, 17) if orientation >= 5 else (17, 33))
    assert_equals_cv2(data)


def test_read_image_reads_jpeg_files_as_imread(tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(with_exif(encode(image(40, 24, seed=6), 85, "422"), 6))
    np.testing.assert_array_equal(imcodec.read_image(str(path)), cv2.imread(str(path)))


# -- the committed cases --------------------------------------------------------


def test_the_committed_cases_equal_cv2_today_and_the_port():
    cases, texts = assets.load_jpeg_cases()
    assert os.path.getsize(assets.JPEG_CASES) < 400_000
    crops = [n for n in cases if n.startswith("crop")]
    assert len(crops) == len(texts) >= 6 and all(texts)
    assert {"scene0", "scene1", "exif6", "rst2", "grey", "progressive_scene0", "cmyk_ycck",
            "arith_sof10_420", "adam7_type2_8bit_33x17"} <= set(cases)
    refused = [n for n, (_, stored) in cases.items() if stored is None]
    assert 20 <= len(refused) <= 50 and all(n.startswith(("cut", "garbled")) for n in refused)
    for name, (data, stored) in cases.items():
        if stored is None:
            assert cv2_decode(data) is None, name
            assert imcodec.decode_image(data) is None, name
            continue
        np.testing.assert_array_equal(cv2_decode(data), stored, err_msg=name)
        np.testing.assert_array_equal(imcodec.decode_image(data), stored, err_msg=name)
    scenes = assets.load_scenes()["serving"]
    assert cases["scene0"][1].shape == scenes[0].shape


# -- refused ------------------------------------------------------------------


def patched(data: bytes, at: int, value: int) -> bytes:
    out = bytearray(data)
    out[at] = value
    return bytes(out)


def refused_cases():
    base = encode(image(16, 16, seed=7), 75, "420")
    sof = sof_at(base)
    four = (b"\xff\xd8\xff\xc0\x00\x14\x08\x00\x10\x00\x10\x04"
            + b"".join(bytes([i, 0x11, 0]) for i in range(1, 5)) + b"\xff\xd9")
    return {
        "progressive": (encode(image(16, 16, seed=7), 75, "420", progressive=True), None),
        "arithmetic": (patched(base, sof, 0xC9), None),
        "lossless": (patched(base, sof, 0xC3), "lossless"),
        "12-bit": (patched(base, sof + 3, 12), "precision"),
        "cmyk": (four, "a frame header without a scan"),
    }


@pytest.mark.parametrize("name", ["progressive", "arithmetic", "lossless", "12-bit", "cmyk"])
def test_unsupported_jpegs_give_none_and_a_log_line(name, caplog):
    """The five files this decoder once refused. cv2 decodes the
    progressive one and the arithmetic-coded one (SOF9 over Huffman data),
    and so does the port, pixel for pixel. cv2 refuses the lossless and
    the 12-bit file and a 4-component header without a scan, and the port
    gives ``None`` and a log line naming the reason; a real CMYK file
    (PIL's) decodes as cv2 decodes it."""
    data, reason = refused_cases()[name]
    assert imcodec.sniff_format(data) == "jpeg"
    if reason is None:
        assert_equals_cv2(data)
        return
    assert cv2_decode(data) is None
    with caplog.at_level("WARNING", logger="ppocr_tpu_torch.utils.imcodec"):
        assert imcodec.decode_image(data) is None
    assert "JPEG payload not decoded" in caplog.text and reason in caplog.text
    if name == "cmyk":
        from test_torch_decode_parity import cmyk_jpeg

        real = cmyk_jpeg(40, 56, seed=0)
        assert cv2_decode(real).shape == (40, 56, 3)
        assert_equals_cv2(real)


def test_truncated_jpegs_give_none():
    data = encode(image(48, 64, seed=8), 90, "420", restart=2)
    sos = data.index(b"\xff\xda")
    for cut in (3, 20, sos, sos + 20, (sos + len(data)) // 2, len(data) - 40):
        assert imcodec.decode_image(data[:cut]) is None, cut


def test_garbled_jpegs_never_crash():
    """Random byte changes anywhere in the file: the decoder returns None
    or an image of the header's size, never reads out of bounds."""
    rng = np.random.default_rng(9)
    for data in (encode(image(24, 40, seed=10), 75, "420"),
                 encode(image(24, 40, seed=11), 60, "444", restart=1)):
        for _ in range(300):
            bad = bytearray(data)
            for at in rng.integers(2, len(bad), rng.integers(1, 4)):
                bad[at] = rng.integers(0, 256)
            got = imcodec.decode_image(bytes(bad))
            assert got is None or (got.ndim == 3 and got.shape[2] == 3)
        for cut in range(2, len(data), 7):
            got = imcodec.decode_image(data[:cut])
            assert got is None or got.shape == (24, 40, 3)


def test_a_jpeg_raises_when_the_decoder_cannot_be_built(monkeypatch):
    def no_compiler(source=None):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(native, "_jpeg_lib", None)
    monkeypatch.setattr(native, "build", no_compiler)
    with pytest.raises(RuntimeError, match="compiler"):
        imcodec.decode_image(encode(image(8, 8), 75))


# -- through the service --------------------------------------------------------


def test_a_jpeg_request_answers_the_jax_engines_words(tmp_path):
    """A parity scene sent as JPEG (baseline and progressive) to the
    port's service gets the words the JAX engine gives on
    ``cv2.imdecode`` of the same bytes."""
    from ppocr_tpu.pipeline import OCREngine as JaxEngine
    from ppocr_tpu.pipeline import OCRWorker as JaxWorker
    from ppocr_tpu_torch.serve import OCRIPCClient, OCRIPCService
    from test_torch_goldens import assert_words_match, jax_config
    from test_torch_serve import run_service, small_config, stop_service

    model_dir = str(assets.make_jumbo_model_dir(tmp_path / "jumbo"))
    cfg = small_config()
    scenes = assets.load_scenes()["parity"][:2]
    jax_worker = JaxWorker(JaxEngine(model_dir, jax_config(dataclasses.asdict(cfg))), 0)
    svc = OCRIPCService(model_dir=model_dir, socket_path=str(tmp_path / "svc.sock"),
                        config=cfg, device="cpu", request_timeout_ms=0)
    t = run_service(svc)
    try:
        with OCRIPCClient(svc.socket_path, timeout_ms=120000) as c:
            for i, scene in enumerate(scenes):
                for data in (encode(scene, 95, "444"), encode(scene, 90, "420", progressive=True)):
                    got = c.send_request({"command": "recognize",
                                          "image_data": base64.b64encode(data).decode()})
                    want = jax_worker.process(cv2_decode(data), i)
                    assert got["success"] and want["success"], (got, want)
                    assert len(got["words"]) >= 2
                    assert_words_match(got["words"], want["words"], 2e-3)
            path = tmp_path / "scene.jpg"
            path.write_bytes(encode(scenes[0], 95, "444"))
            by_path = c.send_request({"command": "recognize", "image_path": str(path)})
            assert by_path["success"] and by_path["words"]
    finally:
        stop_service(svc, t)


# -- the committed cases' writer --------------------------------------------------


def write():
    """Rewrite ``jpeg_cases.npz``: the serving scenes, crops of their
    golden words, the baseline decoder's edge cases, and (each with its
    name's prefix) progressive, CMYK / YCCK, arithmetic-coded, Adam7 PNG,
    cut and garbled payloads, each beside cv2's decode or a flag that cv2
    gave ``None``."""
    from test_torch_decode_parity import adobe_variants, cmyk_jpeg, garbled, patch_sof, png_case

    scenes = assets.load_scenes()["serving"]
    words = assets.load_goldens()["words"]["serving"]
    cases = {
        "scene0": encode(scenes[0], 95, "420"),  # the smoke run's timing input
        "scene1": encode(scenes[1], 90, "422"),
        "progressive_scene0": encode(scenes[0], 95, "420", progressive=True),
    }
    texts = []
    samplings = ["444", "422", "420", "440"]
    picked = [(0, j) for j in range(0, len(words[0]), 3)] + [(1, j) for j in range(1, len(words[1]), 3)]
    for k, (s, j) in enumerate(picked):
        w = words[s][j]
        box = np.asarray(w["box"])
        x0, y0 = np.maximum(box.min(axis=0), 0)
        x1, y1 = box.max(axis=0)
        crop = np.ascontiguousarray(scenes[s][y0 : y1 + 1, x0 : x1 + 1])
        if k == len(picked) - 1:
            crop = cv2.cvtColor(crop, cv2.COLOR_BGR2GRAY)
        cases[f"crop{k}"] = encode(crop, 90, samplings[k % 4])
        texts.append(w["text"])
    small = image(17, 33, seed=12)
    for name in SAMPLING:
        cases[f"sampling{name}"] = encode(small, 75, name)
    cases["grey"] = encode(image(17, 33, seed=13, grey=True), 75)
    cases["tiny1x1"] = encode(image(1, 1, seed=14), 95, "420")
    cases["odd7x13"] = encode(image(7, 13, seed=15), 50, "420")
    cases["rst2"] = encode(image(33, 65, seed=16), 75, "420", restart=2)
    for o in range(1, 9):
        cases[f"exif{o}"] = with_exif(encode(small, 90, "420"), o, big_endian=o % 2 == 0)
    for name in ("420", "444"):
        for q in (50, 95):
            cases[f"progressive_{name}_q{q}"] = encode(image(17, 33, seed=q), q, name, progressive=True)
    cases["progressive_rst1"] = encode(image(24, 40, seed=17), 75, "444", restart=1, progressive=True)
    for name, data in adobe_variants(cmyk_jpeg(40, 56, seed=0)).items():
        cases[f"cmyk_{name}"] = data
    cases["cmyk_progressive_420"] = cmyk_jpeg(17, 33, seed=1, subsampling=2, progressive=True)
    buf = io.BytesIO()  # a golden-word crop as CMYK, for the smoke run's service check
    Image.fromarray(np.ascontiguousarray(scenes[0][100:260, 0:400, ::-1])).convert("CMYK").save(
        buf, "JPEG", quality=90)
    cases["cmyk_scene0_crop"] = buf.getvalue()
    cases["arith_sof9_420"] = patch_sof(encode(image(17, 33, seed=18), 75, "420"), 0xC9)
    cases["arith_sof9_444_rst2"] = patch_sof(encode(image(17, 33, seed=19), 75, "444", restart=2), 0xC9)
    cases["arith_sof10_420"] = patch_sof(encode(image(17, 33, seed=20), 75, "420", progressive=True), 0xCA)
    for ctype, depth, size in [(0, 1, (3, 5)), (0, 16, (33, 17)), (2, 8, (33, 17)), (3, 4, (33, 17)),
                               (4, 8, (1, 1)), (6, 16, (3, 5))]:
        cases[f"adam7_type{ctype}_{depth}bit_{size[0]}x{size[1]}"] = png_case(ctype, depth, *size)
    # a small corrupt set, 16 cuts and 48 garbled files, about half
    # refused; 16×24, since the decode of corrupt data does not compress
    yy, xx = np.mgrid[:16, :24]
    quiet = ((yy * 5 + xx * 3)[..., None] + np.arange(3) * 70
             + np.random.default_rng(23).integers(0, 6, (16, 24, 3))) % 256
    base = encode(quiet.astype(np.uint8), 75, "420")
    prog = encode(quiet[::-1].astype(np.uint8), 75, "444", restart=1, progressive=True)
    for k, cut in enumerate(np.linspace(len(base) - 12, len(base), 8).astype(int)):
        cases[f"cut_baseline_{k}"] = base[:cut]
    for k, cut in enumerate(np.linspace(len(prog) // 2, len(prog), 8).astype(int)):
        cases[f"cut_progressive_{k}"] = prog[:cut]
    for k, data in enumerate(garbled(base, 24, seed=21) + garbled(prog, 24, seed=22)):
        cases[f"garbled_{k}"] = data
    out = {"crop_texts": np.array(texts)}
    for name, data in cases.items():
        out[f"{name}/bytes"] = np.frombuffer(data, np.uint8)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if want is None:
            out[f"{name}/none"] = np.array(True)
        elif name == "progressive_scene0":
            # the same quantized coefficients as scene0: the same pixels
            assert (want == out["scene0/cv2"]).all()
            out[f"{name}/same_as"] = np.array("scene0")
        else:
            out[f"{name}/cv2"] = want
    np.savez_compressed(assets.JPEG_CASES, **out)
    refused = sum(f"{n}/none" in out for n in cases)
    print(f"wrote {assets.JPEG_CASES} ({os.path.getsize(assets.JPEG_CASES)} bytes, "
          f"{len(cases)} cases, {refused} refused by cv2, cv2 {cv2.__version__})")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_jpeg.py --write")
    write()
