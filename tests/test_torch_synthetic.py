"""The port's synthetic training data against the JAX package's, on the CPU.

``ppocr_tpu_torch.train.synthetic`` draws with the committed glyph atlas
(``train/text_render.py``); ``ppocr_tpu.train.synthetic`` draws with
Pillow, the DejaVu faces and cv2. With the same seeds they must give:

* exactly the same texts (``sample_text``, a few thousand draws each, in
  the ``jumbo`` mode, with ``hard_frac`` > 0 over ``jumbo_hard_chars()``,
  and in the ``ascii`` and ``full`` modes over a charset file written
  here), the same placed ``(text, box)`` lists, shrink masks and scene
  pixels;
* exactly ``ImageDraw.textbbox`` from ``measure``, on 10,000 random
  strings of 1–8 characters a face (drawn from the jumbo characters it
  maps) at each of the four sizes;
* exactly the ``det_batch`` images (the 192 → 96 downscale is cv2's exact
  2× area path in ``resize_bilinear_u8``) and labels;
* exactly the same ``SceneCropRecDataset`` batches (images, labels,
  paddings and texts), with and without ``aug_rotate_deg=8``: the port's
  ``warp_affine`` replays cv2 5.0's arithmetic (``csrc/warp.cpp``) and is
  held bit for bit to ``cv2.warpAffine`` here, on every ``width mod 16``,
  1, 3 and 4 channels, grey and colour borders and angles of 0° and ±45°;
* exactly the same ``ctc_greedy_decode_np``, ``homoglyph_normalize``,
  ``jumbo_homoglyph_map``, ``render_glyph_families``,
  ``build_jumbo_alphabet`` and ``dejavu_alphabet``. Here the JAX package's
  own results also equal their pinned files (``weights/jumbo_keys.txt``,
  ``weights/jumbo_homoglyphs.txt``); the port is held to the JAX result.

The cv2 Hershey-font half (``render_line``, ``SyntheticRecDataset`` and
the digit ``SyntheticSceneDataset``, drawn through ``train/cv2_text.py``)
must give exactly the JAX package's pixels, texts, boxes, det batches,
shrink masks and ``SceneCropRecDataset`` batches (rotated too), for
``render_line`` at img_h 32, 48 and 64 and ``SyntheticRecDataset`` over
digits and ASCII; over the ``full`` alphabet (Greek: cv2 draws it from
WenQuanYi) it raises ``CV2FallbackFaceNotPorted`` (ROADMAP A17) before any
draw. ``assets/synthetic_digest.json`` holds the texts, boxes and pixel
hashes of 16 jumbo scenes the JAX package renders, and the hashes of 2
rotated ``SceneCropRecDataset`` batches it makes; under "cv2", 16 digit
scenes, 2 ``SyntheticRecDataset`` batches and 2 digit
``SceneCropRecDataset`` batches. The smoke run holds the port to them on
the card's host; ``python tests/test_torch_synthetic.py --write`` rewrites
it.
"""

import functools
import hashlib
import itertools
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

import ppocr_tpu.ops.ctc as jax_ctc
import ppocr_tpu.train.synthetic as J
import ppocr_tpu_torch.ops.ctc as torch_ctc
import ppocr_tpu_torch.train.synthetic as T
from ppocr_tpu.train.finetune import charset_classes
from ppocr_tpu_torch.assets import SYNTHETIC_DIGEST, load_synthetic_digest, rec_batch_sha256
from ppocr_tpu_torch.ops.geometry import get_rotation_matrix_2d, warp_affine
from ppocr_tpu_torch.train.text_render import LayoutUnsupported, load_atlas

DIGEST_SEEDS = (0, 7, 11, 2026)  # 4 scenes each: 16
FACES = T.DEJAVU_FONTS

# a reference-style charset: ASCII, DejaVuSans-covered and uncovered
# non-ASCII entries, and a multi-character entry dejavu_alphabet skips
CHARSET_LINES = list(J.ASCII_ALPHABET) + list("αβΩЖжéÅ€±→∑□") + ["中", "ab", "ĳ", "ﬁ"]


@pytest.fixture
def charset_file(tmp_path, monkeypatch):
    """A small charset file: the port is given its path, the JAX package
    (which reads a fixed path by default) has its ``dejavu_alphabet``
    pointed at it."""
    path = tmp_path / "keys.txt"
    path.write_text("\n".join(CHARSET_LINES) + "\n", encoding="utf-8")
    monkeypatch.setattr(J, "dejavu_alphabet", functools.partial(J.dejavu_alphabet, str(path)))
    return str(path)


def datasets(mode, seed, charset_file=None, **kw):
    if kw.pop("hard", False):
        kw.update(hard_frac=0.3, hard_chars=J.jumbo_hard_chars())
        assert T.jumbo_hard_chars() == kw["hard_chars"]
    return (J.text_scene_dataset(mode, seed=seed, **kw),
            T.text_scene_dataset(mode, seed=seed, charset_file=charset_file, **kw))


CASES = [("jumbo", 0, False), ("jumbo", 5, False), ("jumbo", 3, True),
         ("ascii", 1, False), ("full", 2, False)]


@pytest.mark.parametrize("mode,seed,hard", CASES)
def test_sample_text_matches_jax(charset_file, mode, seed, hard):
    a, b = datasets(mode, seed, charset_file, hard=hard)
    assert b.alphabet == a.alphabet and b.core_alphabet == a.core_alphabet
    assert [a.sample_text() for _ in range(3000)] == [b.sample_text() for _ in range(3000)]
    assert a.rng.integers(1 << 30) == b.rng.integers(1 << 30)  # the streams stay in step


@pytest.mark.parametrize("mode,seed,hard", CASES)
def test_scenes_match_jax(charset_file, mode, seed, hard):
    """Placed lists, shrink masks and pixels, scene by scene."""
    a, b = datasets(mode, seed, charset_file, hard=hard)
    for _ in range(150):
        (img_a, placed_a), (img_b, placed_b) = a.sample_scene(), b.sample_scene()
        assert placed_b == placed_a
        np.testing.assert_array_equal(img_b, img_a)
        boxes = [box for _, box in placed_a]
        np.testing.assert_array_equal(b.shrink_mask(boxes), a.shrink_mask(boxes))


@pytest.mark.parametrize("seed", [0, 9])
def test_det_batch_matches_jax(seed):
    a, b = datasets("jumbo", seed)
    for _ in range(2):
        (want, scenes_a), (got, scenes_b) = a.det_batch(8), b.det_batch(8)
        np.testing.assert_array_equal(got["images"], want["images"])
        np.testing.assert_array_equal(got["masks"], want["masks"])
        assert [p for _, p in scenes_b] == [p for _, p in scenes_a]


@pytest.mark.parametrize("face", FACES)
def test_measure_is_textbbox(face):
    """``measure`` against ``draw.textbbox((0, 0), ...)`` on 10,000 random
    jumbo strings the face covers, at every size."""
    atlas_face = load_atlas().faces[face]
    chars = [c for c in J.jumbo_alphabet() if ord(c) in atlas_face.cmap]
    rng = np.random.default_rng(sum(map(ord, face)))
    texts = ["".join(chars[i] for i in rng.integers(len(chars), size=int(rng.integers(1, 9))))
             for _ in range(10_000)]
    ours = T.AtlasTextRenderer(fonts=(face,))
    path = f"{T.DEJAVU_DIR}/{face}"
    draw = ImageDraw.Draw(Image.new("L", (1, 1)))
    for size in (24, 28, 32, 36):
        pil, font = ImageFont.truetype(path, size), ours._fonts[(path, size)]
        for text in texts:
            assert ours.measure(text, font) == draw.textbbox((0, 0), text, font=pil), (
                face, size, text)


@pytest.mark.parametrize("rotate", [0.0, 8.0])
def test_scene_crop_batches_match_jax(rotate):
    charset = charset_classes(list(J.jumbo_alphabet()))
    a = J.SceneCropRecDataset(charset, J.text_scene_dataset("jumbo", seed=7),
                              img_h=48, img_w=256, aug_rotate_deg=rotate)
    b = T.SceneCropRecDataset(charset, T.text_scene_dataset("jumbo", seed=7),
                              img_h=48, img_w=256, aug_rotate_deg=rotate)
    for _ in range(3):
        (want, texts_a), (got, texts_b) = a.batch(48), b.batch(48)
        assert texts_b == texts_a
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["label_paddings"], want["label_paddings"])
        assert got["images"].shape == want["images"].shape == (48, 48, 256, 3)
        np.testing.assert_array_equal(got["images"], want["images"])


@pytest.mark.parametrize("angle", [-8.0, -3.3, 0.7, 5.0, 8.0])
def test_warp_affine_rotation_matches_cv2(angle):
    rng = np.random.default_rng(int(angle * 10) + 100)
    img = rng.integers(0, 256, (37, 121, 3), dtype=np.uint8)
    center = (121 / 2, 37 / 2)
    m = get_rotation_matrix_2d(center, angle, 1.0)
    np.testing.assert_array_equal(m, cv2.getRotationMatrix2D(center, angle, 1.0))
    want = cv2.warpAffine(img, m, (121, 37), borderValue=(255, 255, 255))
    got = warp_affine(img, m, 121, 37, border_value=(255, 255, 255))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("tail", range(16))
def test_warp_affine_every_row_tail_matches_cv2(tail, channels):
    """cv2 maps each row in blocks of 16 columns and finishes the last
    ``width mod 16`` in scalar code that rounds otherwise: every remainder,
    each channel count, a grey and a colour border, angles of 0°, ±45° and
    small ones, scaled and shifted, output sizes other than the input's,
    and pixels whose taps straddle the border."""
    rng = np.random.default_rng(16 * channels + tail)
    borders = [(255, 255, 255, 255), (128,) * 4, (17, 201, 90, 3)]
    for k in range(12):
        h, w = int(rng.integers(3, 60)), 16 * int(rng.integers(0, 12)) + tail
        w = w if w >= 2 else w + 16
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        angle = [0.0, 45.0, -45.0, float(rng.uniform(-8, 8))][k % 4]
        scale = 1.0 if k < 8 else float(rng.uniform(0.6, 1.6))
        center = (w / 2 + float(rng.uniform(-3, 3)) * (k >= 4), h / 2)
        m = get_rotation_matrix_2d(center, angle, scale)
        np.testing.assert_array_equal(m, cv2.getRotationMatrix2D(center, angle, scale))
        m[:, 2] += rng.uniform(-5, 5, 2) * (k % 3 == 2)
        out_w = w if k % 2 else 16 * int(rng.integers(0, 10)) + tail or 16
        border = borders[k % 3][:channels] if channels > 1 else borders[k % 3][0]
        want = cv2.warpAffine(img, m, (out_w, h), borderValue=border)
        got = warp_affine(img, m, out_w, h, border_value=border)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{k}: {shape} angle {angle}")


def test_warp_affine_border_value_is_read_as_cv2_reads_a_scalar():
    img = np.full((9, 20, 3), 100, np.uint8)
    m = np.array([[1.0, 0, 8.5], [0, 1, 0]])
    for border in (200, (7, 8), (300.6, -5, 7.5, 1)):
        np.testing.assert_array_equal(warp_affine(img, m, 20, 9, border_value=border),
                                      cv2.warpAffine(img, m, (20, 9), borderValue=border))
    np.testing.assert_array_equal(warp_affine(img[..., 0], m, 20, 9, border_value=200),
                                  cv2.warpAffine(img[..., 0], m, (20, 9), borderValue=200))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_greedy_decode_np_matches_jax(seed):
    rng = np.random.default_rng(seed)
    charset = ["blank"] + list("abcdefg") + [" "]
    probs = rng.random((5, 12, len(charset))).astype(np.float32)
    probs[0] = 0.0
    probs[0, :, 0] = 1.0  # all blank: "" and NaN
    probs[1, 3:6] = probs[1, 3:6].max(-1, keepdims=True)  # ties take the first index
    want = jax_ctc.ctc_greedy_decode_np(probs, charset)
    got = torch_ctc.ctc_greedy_decode_np(probs, charset)
    assert got[0] == want[0] and got[0][0] == ""
    np.testing.assert_array_equal(got[1], want[1])


def test_homoglyph_helpers_match_jax():
    assert T.HOMOGLYPHS == J.HOMOGLYPHS
    text = "lI|O0Ο3З′´─—\"”xyz" + J.jumbo_alphabet()[::97]
    assert T.homoglyph_normalize(text) == J.homoglyph_normalize(text)
    assert T.jumbo_homoglyph_map() == J.jumbo_homoglyph_map()
    assert T.homoglyph_normalize(text, T.jumbo_homoglyph_map()) == J.homoglyph_normalize(
        text, J.jumbo_homoglyph_map())
    assert T.jumbo_alphabet() == J.jumbo_alphabet()
    assert T.jumbo_hard_chars() == J.jumbo_hard_chars()
    assert T.ASCII_ALPHABET == J.ASCII_ALPHABET


def test_render_glyph_families_matches_jax():
    want = J.render_glyph_families(J.jumbo_alphabet())
    assert T.render_glyph_families(T.jumbo_alphabet()) == want
    pinned = [line.rstrip("\n") for line in open(J.JUMBO_HOMOGLYPHS_FILE, encoding="utf-8")
              if line.rstrip("\n")]
    assert want == pinned  # the JAX package's result is its pinned file here


def test_build_jumbo_alphabet_matches_jax():
    want = J.build_jumbo_alphabet()
    assert T.build_jumbo_alphabet() == want
    assert want == J.jumbo_alphabet()  # and its pinned weights/jumbo_keys.txt


@pytest.mark.parametrize("ascii_only", [True, False])
def test_dejavu_alphabet_matches_jax(charset_file, ascii_only):
    want = J.dejavu_alphabet(ascii_only=ascii_only)
    assert T.dejavu_alphabet(charset_file, ascii_only=ascii_only) == want
    assert ("α" in want) != ascii_only and "中" not in want


@pytest.mark.parametrize("call", [
    lambda: T.dejavu_alphabet(),
    lambda: T.text_scene_dataset("ascii"),
    lambda: T.text_scene_dataset("full", seed=3),
], ids=["dejavu_alphabet", "ascii", "full"])
def test_the_reference_charset_modes_want_its_path(call):
    with pytest.raises(T.ReferenceCharsetMissing, match="ppocr_keys_v1.txt"):
        call()


# the four entry points of the cv2 Hershey fonts, each drawing something
# the JAX package draws too
CV2_ENTRY_POINTS = {
    "render_line": lambda M: M.render_line("1234567", 48, 320, np.random.default_rng(5)),
    "SyntheticRecDataset": lambda M: M.SyntheticRecDataset(list("0123456789"), seed=4).batch(8),
    "scene_dataset_default": lambda M: M.SyntheticSceneDataset(seed=0).sample_scene(),
    "scene_dataset_no_renderer": lambda M: M.SyntheticSceneDataset(alphabet="0123", renderer=None,
                                                                   seed=1).det_batch(4),
}


def assert_equal_results(got, want):
    """Two results made of arrays, dicts, lists, tuples and scalars."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_equal_results(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal_results(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("name", CV2_ENTRY_POINTS)
def test_cv2_font_entry_points_match_jax(name):
    call = CV2_ENTRY_POINTS[name]
    assert_equal_results(call(T), call(J))


@pytest.mark.parametrize("img_h", [32, 48, 64])
def test_render_line_matches_jax(img_h):
    rng = np.random.default_rng(img_h)
    for _ in range(40):
        text = "".join(rng.choice(list("0123456789"), int(rng.integers(1, 9))))
        seed = int(rng.integers(1 << 30))
        np.testing.assert_array_equal(T.render_line(text, img_h, 320, np.random.default_rng(seed)),
                                      J.render_line(text, img_h, 320, np.random.default_rng(seed)))


@pytest.mark.parametrize("alphabet", ["digits", "ascii"])
def test_rec_dataset_batches_match_jax(alphabet):
    chars = "0123456789" if alphabet == "digits" else J.ASCII_ALPHABET
    charset = charset_classes(list(J.ASCII_ALPHABET))
    a = J.SyntheticRecDataset(charset, alphabet=chars, img_w=192, seed=11)
    b = T.SyntheticRecDataset(charset, alphabet=chars, img_w=192, seed=11)
    for _ in range(3):
        (want, texts_a), (got, texts_b) = a.batch(32), b.batch(32)
        assert texts_b == texts_a
        assert_equal_results(got, want)


def test_rec_dataset_refuses_an_alphabet_rubik_lacks():
    """The ``full`` alphabet's Greek is WenQuanYi's in cv2 (A17): refused
    at construction, before any draw from the seed."""
    alphabet = J.ASCII_ALPHABET + "αβΩ"
    with pytest.raises(T.CV2FallbackFaceNotPorted, match="A17"):
        T.SyntheticRecDataset(list(alphabet), alphabet=alphabet)
    with pytest.raises(T.CV2FallbackFaceNotPorted, match="A17"):
        T.SyntheticSceneDataset(alphabet="12α", seed=0)


@pytest.mark.parametrize("seed", [0, 3, 424])
def test_digit_scenes_match_jax(seed):
    a, b = J.SyntheticSceneDataset(seed=seed), T.SyntheticSceneDataset(seed=seed)
    for _ in range(60):
        (img_a, placed_a), (img_b, placed_b) = a.sample_scene(), b.sample_scene()
        assert placed_b == placed_a
        np.testing.assert_array_equal(img_b, img_a)
        boxes = [box for _, box in placed_a]
        np.testing.assert_array_equal(b.shrink_mask(boxes), a.shrink_mask(boxes))
    (want, scenes_a), (got, scenes_b) = a.det_batch(8), b.det_batch(8)
    assert_equal_results(got, want)
    assert [p for _, p in scenes_b] == [p for _, p in scenes_a]


@pytest.mark.parametrize("rotate", [0.0, 8.0])
def test_digit_scene_crop_batches_match_jax(rotate):
    charset = charset_classes(list("0123456789"))
    a = J.SceneCropRecDataset(charset, J.SyntheticSceneDataset(seed=7), aug_rotate_deg=rotate)
    b = T.SceneCropRecDataset(charset, T.SyntheticSceneDataset(seed=7), aug_rotate_deg=rotate)
    for _ in range(3):
        (want, texts_a), (got, texts_b) = a.batch(32), b.batch(32)
        assert texts_b == texts_a
        assert_equal_results(got, want)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown scene-dataset mode"):
        T.text_scene_dataset("digits")


TONES = "˥˦˧˨˩"


@pytest.mark.parametrize("face", FACES)
def test_tone_letter_runs_are_drawn_as_pillow_draws_them(face):
    """Every run of 2–3 Chao tone letters, alone, inside Latin text and
    beside an Arabic sign, a Hebrew sign (right-to-left runs, laid out
    reversed), an Extended Arabic-Indic digit (a right-to-left run HarfBuzz
    keeps in order) and an N'Ko sign (whose shaper leaves them), at every
    size: the Sans faces give them contextual contour forms, the others do
    not. Box and pixels exactly."""
    runs = ["".join(r) for n in (2, 3) for r in itertools.product(TONES, repeat=n)]
    around = (("", ""), ("a", "b"), ("\u0606", ""), ("\ufb29", ""), ("\u06f1", ""),
              ("\u07f8", ""))
    texts = [x + r + y for r in runs for x, y in around]
    path = f"{T.DEJAVU_DIR}/{face}"
    for size in (24, 28, 32, 36):
        pil, font = ImageFont.truetype(path, size), load_atlas().font(path, size)
        for text in texts:
            if any(font.face.cmap.get(ord(c)) not in font.face.slot_of for c in text):
                continue
            assert font.getbbox(text) == pil.getbbox(text), (face, size, text)
            canvas = np.full((64, 160, 3), 255, np.uint8)
            img = Image.fromarray(canvas.copy())
            ImageDraw.Draw(img).text((5, 9), text, font=pil, fill=(0, 0, 0))
            T.draw_text(canvas, (5, 9), text, font, (0, 0, 0))
            np.testing.assert_array_equal(canvas, np.asarray(img), err_msg=f"{face} {size} {text}")


def test_layout_refuses_a_character_the_face_lacks():
    with pytest.raises(LayoutUnsupported, match="lacks"):
        load_atlas().font(f"{T.DEJAVU_DIR}/DejaVuSansMono.ttf", 28).getbbox("a中")


def digest_scenes(module):
    """The digest's 16 scenes, rendered by ``module``'s jumbo dataset."""
    out = []
    for seed in DIGEST_SEEDS:
        ds = module.text_scene_dataset("jumbo", seed=seed)
        for index in range(4):
            img, placed = ds.sample_scene()
            out.append({"seed": seed, "index": index,
                        "placed": [[t, list(b)] for t, b in placed],
                        "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()})
    return out


def test_digest_is_the_jax_render():
    assert load_synthetic_digest()["scenes"] == digest_scenes(J)


def test_port_renders_the_digest():
    assert digest_scenes(T) == load_synthetic_digest()["scenes"]


ROTATED = {"seed": 7, "img_h": 48, "img_w": 256, "aug_rotate_deg": 8.0, "batch": 48, "batches": 2}


def digest_batches(module, spec=ROTATED) -> list:
    """``rec_batch_sha256`` of the first ``spec["batches"]`` batches of
    ``module``'s rotated ``SceneCropRecDataset`` over the jumbo classes."""
    charset = charset_classes(list(module.jumbo_alphabet()))
    ds = module.SceneCropRecDataset(
        charset, module.text_scene_dataset("jumbo", seed=spec["seed"]), img_h=spec["img_h"],
        img_w=spec["img_w"], aug_rotate_deg=spec["aug_rotate_deg"])
    return [rec_batch_sha256(*ds.batch(spec["batch"])) for _ in range(spec["batches"])]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_rotated_batches_equal_the_digest(package):
    rotated = load_synthetic_digest()["rotated_batches"]
    spec = {k: v for k, v in rotated.items() if k != "sha256"}
    assert spec == ROTATED
    assert digest_batches(J if package == "jax" else T, spec) == rotated["sha256"]


# the cv2 section: digit scenes, SyntheticRecDataset batches (digits, the
# rec script's 48x192) and digit SceneCropRecDataset batches (48x160, ±8°)
CV2_REC = {"seed": 3, "img_h": 48, "img_w": 192, "batch": 48, "batches": 2}
CV2_CROPS = {"seed": 7, "img_h": 48, "img_w": 160, "aug_rotate_deg": 8.0, "batch": 48, "batches": 2}


def digit_scenes(module):
    """The cv2 digest's 16 digit scenes, drawn by ``module``."""
    out = []
    for seed in DIGEST_SEEDS:
        ds = module.SyntheticSceneDataset(seed=seed)
        for index in range(4):
            img, placed = ds.sample_scene()
            out.append({"seed": seed, "index": index,
                        "placed": [[t, list(b)] for t, b in placed],
                        "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()})
    return out


def digit_rec_batches(module, spec=CV2_REC) -> list:
    ds = module.SyntheticRecDataset(charset_classes(list("0123456789")), img_h=spec["img_h"],
                                    img_w=spec["img_w"], seed=spec["seed"])
    return [rec_batch_sha256(*ds.batch(spec["batch"])) for _ in range(spec["batches"])]


def digit_crop_batches(module, spec=CV2_CROPS) -> list:
    ds = module.SceneCropRecDataset(charset_classes(list("0123456789")),
                                    module.SyntheticSceneDataset(seed=spec["seed"]), img_h=spec["img_h"],
                                    img_w=spec["img_w"], aug_rotate_deg=spec["aug_rotate_deg"])
    return [rec_batch_sha256(*ds.batch(spec["batch"])) for _ in range(spec["batches"])]


def cv2_digest(module) -> dict:
    return {"scene": "SyntheticSceneDataset(seed=seed).sample_scene()", "scenes": digit_scenes(module),
            "rec_batches": {**CV2_REC, "sha256": digit_rec_batches(module)},
            "crop_batches": {**CV2_CROPS, "sha256": digit_crop_batches(module)}}


@pytest.mark.parametrize("package", ["jax", "port"])
def test_digit_renders_equal_the_digest(package):
    assert cv2_digest(J if package == "jax" else T) == load_synthetic_digest()["cv2"]


def write_digest() -> None:
    digest = {"mode": "jumbo", "scene": "text_scene_dataset('jumbo', seed).sample_scene()",
              "seeds": list(DIGEST_SEEDS), "scenes": digest_scenes(J),
              "rotated_batches": {**ROTATED, "sha256": digest_batches(J)}, "cv2": cv2_digest(J)}
    SYNTHETIC_DIGEST.write_text(json.dumps(digest, ensure_ascii=False, indent=1) + "\n",
                                encoding="utf-8")
    print(f"wrote {SYNTHETIC_DIGEST}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        write_digest()
    else:
        sys.exit("usage: python tests/test_torch_synthetic.py --write")
