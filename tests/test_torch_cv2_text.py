"""``train/cv2_text.py`` against cv2 5.0.0's ``putText`` / ``getTextSize``,
bit for bit, on the CPU.

cv2 5.0 draws its Hershey fonts as the upright Rubik face it embeds, at a
whole pixel size (``round(fontScale * 100 / 3.7)`` for SIMPLEX, DUPLEX,
COMPLEX and TRIPLEX) and a weight the font and the thickness select
(400, 600 or 800). The port draws from ``assets/cv2_text.npz`` through
``csrc/cv2_text.cpp``. Held here:

* ``get_text_size`` for fonts 0, 2, 3 and 4 at thickness 1, 2 and 5, on
  both sides of every size boundary in scale [0.5, 2.0] (the last double
  of one size and the first of the next);
* every character upright Rubik maps, alone, at three sizes and each of
  the three weights;
* 200 seeded random digit strings and 100 ASCII strings a weight, and the
  strings of a 480-string sweep (fonts 0 and 2; scales 0.9, 1.05, 1.2,
  1.3) whose glyphs overlap (26), pinned by their seeds: there the darker of
  the glyphs drawn one by one is not cv2's pixel (cv2 blends each glyph
  over the last), and the port must still be;
* strings cut at each edge and corner of the image, a pen at and past
  the right edge (cv2 draws nothing from an org.x there, though a mark
  or a side bearing would reach back in), coloured text on a
  random background, images of 1 (2-D and [H, W, 1]), 3 and 4 channels,
  ``bottomLeftOrigin``, a view that is not contiguous, size 0 and the
  empty string;
* the refusals (ROADMAP A17): 'α' and '中' (WenQuanYi Micro Hei in cv2),
  'ก' (cv2's missing-glyph fallback), a line break, ``FONT_ITALIC`` and
  the script fonts raise ``CV2FallbackFaceNotPorted`` before anything is
  drawn.

``python tests/test_torch_cv2_text.py --fuzz N`` runs N rounds of 2,000
random strings (the whole cmap, sizes 1–160 px, origins inside and
outside the image, random backgrounds and colours, 1, 3 and 4 channels)
against cv2 and prints the count of cases and of differences.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import cv2
import numpy as np
import pytest

from ppocr_tpu_torch.train import cv2_text as C

UPRIGHT = (C.FONT_HERSHEY_SIMPLEX, C.FONT_HERSHEY_DUPLEX, C.FONT_HERSHEY_COMPLEX, C.FONT_HERSHEY_TRIPLEX)
# the Hershey call that selects each weight
WEIGHT_CALL = {400: (C.FONT_HERSHEY_SIMPLEX, 1), 600: (C.FONT_HERSHEY_SIMPLEX, 2),
               800: (C.FONT_HERSHEY_DUPLEX, 2)}
ASCII = "".join(chr(c) for c in range(32, 127))


def cv2_draw(img, text, org, font, scale, color, thick, bottom_left=False):
    return cv2.putText(img.copy(), text, org, font, scale, color, thick, cv2.LINE_AA, bottom_left)


def port_draw(img, text, org, font, scale, color, thick, bottom_left=False):
    return C.put_text(img.copy(), text, org, font, scale, color, thick, C.LINE_AA, bottom_left)


def assert_same(text, org, font, scale, thick, shape=(120, 420, 3), bg=255, color=(0, 0, 0), bottom_left=False):
    img = np.full(shape, bg, np.uint8) if np.isscalar(bg) else bg
    want = cv2_draw(img, text, org, font, scale, color, thick, bottom_left)
    got = port_draw(img, text, org, font, scale, color, thick, bottom_left)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = int((got != want).sum())
    assert diff == 0, f"{text!r} at {org}, font {font}, scale {scale!r}, thickness {thick}: {diff} pixels"
    (w, h), base = cv2.getTextSize(text, font, scale, thick)
    assert C.get_text_size(text, font, scale, thick) == ((w, h), base), text


def size_boundaries(lo=0.5, hi=2.0, divisor=3.7):
    """(last scale of a size, first scale of the next) for every size
    boundary of ``round(scale * 100 / divisor)`` in [lo, hi]."""
    out = []
    for n in range(int(lo * 100 / divisor), int(hi * 100 / divisor) + 1):
        b = (n + 0.5) * divisor / 100
        first = b
        while round(np.nextafter(first, 0) * 100 / divisor) > n:
            first = np.nextafter(first, 0)
        while round(first * 100 / divisor) <= n:
            first = np.nextafter(first, np.inf)
        if lo <= first <= hi:
            out.append((float(np.nextafter(first, 0)), float(first)))
    return out


def test_size_boundaries_are_found():
    bounds = size_boundaries()
    assert len(bounds) == 40
    assert all(round(a * 100 / 3.7) + 1 == round(b * 100 / 3.7) for a, b in bounds)


@pytest.mark.parametrize("thick", [1, 2, 5])
@pytest.mark.parametrize("font", UPRIGHT)
def test_get_text_size_at_every_size_boundary(font, thick):
    for below, above in size_boundaries():
        for scale in (below, above):
            for text in ("0123456789", "Wg_|", "i.", " "):
                want = cv2.getTextSize(text, font, scale, thick)
                assert C.get_text_size(text, font, scale, thick) == (tuple(want[0]), want[1]), (text, scale)


@pytest.mark.parametrize("size", [13, 32, 71])
@pytest.mark.parametrize("weight", [400, 600, 800])
def test_every_character_alone(weight, size):
    font, thick = WEIGHT_CALL[weight]
    scale = size * 3.7 / 100
    assert C.hershey_to_truetype(font, scale, thick) == (size, weight)
    bg = np.full((2 * size + 40, 3 * size + 60), 255, np.uint8)
    org = (size // 2 + 10, 3 * size // 2 + 10)
    for cp in sorted(C.load_face().cmap):
        ch = chr(cp)
        want = cv2_draw(bg, ch, org, font, scale, (0,), thick)
        got = port_draw(bg, ch, org, font, scale, (0,), thick)
        assert np.array_equal(got, want), f"U+{cp:04X} {ch!r}: {int((got != want).sum())} pixels"
        (w, h), base = cv2.getTextSize(ch, font, scale, thick)
        assert C.get_text_size(ch, font, scale, thick) == ((w, h), base), f"U+{cp:04X}"


def random_text(rng, pool, lo=1, hi=8):
    return "".join(rng.choice(list(pool), int(rng.integers(lo, hi + 1))))


@pytest.mark.parametrize("kind,count", [("digits", 200), ("ascii", 100)])
@pytest.mark.parametrize("weight", [400, 600, 800])
def test_random_strings(weight, kind, count):
    font, thick = WEIGHT_CALL[weight]
    rng = np.random.default_rng(weight + len(kind))
    pool = "0123456789" if kind == "digits" else ASCII
    for _ in range(count):
        text = random_text(rng, pool)
        scale = float(rng.uniform(0.5, 2.0))
        assert_same(text, (int(rng.integers(2, 30)), int(rng.integers(60, 100))), font, scale, thick)


def sweep_case(seed):
    """The overlap sweep's string ``seed``: fonts 0 and 2 at thickness 2,
    scales 0.9, 1.05, 1.2 and 1.3, digits and letters."""
    rng = np.random.default_rng(seed)
    text = random_text(rng, "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz", 2, 8)
    return text, [0, 2][seed % 2], [0.9, 1.05, 1.2, 1.3][seed // 2 % 4]


def glyph_by_glyph(text, org, font, scale, thick, shape):
    """cv2 drawing each glyph alone at its pen position, merged by the
    darker pixel: what a per-glyph atlas would give."""
    out = np.full(shape, 255, np.uint8)
    x = org[0]
    for ch in text:
        out = np.minimum(out, cv2_draw(np.full(shape, 255, np.uint8), ch, (x, org[1]), font, scale, (0,), thick))
        x += cv2.getTextSize(ch, font, scale, thick)[0][0] - 1
    return out


# the sweep's strings (of seeds 0–479) whose glyph-by-glyph merge differs
# from cv2 (found by test_overlap_seeds_are_all_the_sweep_finds)
OVERLAP_SEEDS = (8, 9, 73, 79, 85, 99, 143, 169, 179, 183, 185, 242, 249, 255, 258, 289, 307, 308, 317, 347,
                 355, 360, 368, 417, 449, 477)
SWEEP = 480
SWEEP_SHAPE = (80, 420)


def test_overlap_seeds_are_all_the_sweep_finds():
    found = []
    for seed in range(SWEEP):
        text, font, scale = sweep_case(seed)
        want = cv2_draw(np.full(SWEEP_SHAPE, 255, np.uint8), text, (5, 55), font, scale, (0,), 2)
        if not np.array_equal(glyph_by_glyph(text, (5, 55), font, scale, 2, SWEEP_SHAPE), want):
            found.append(seed)
    assert tuple(found) == OVERLAP_SEEDS


@pytest.mark.parametrize("seed", OVERLAP_SEEDS)
def test_overlapping_glyphs(seed):
    text, font, scale = sweep_case(seed)
    assert_same(text, (5, 55), font, scale, 2, shape=SWEEP_SHAPE, bg=255, color=(0,))


EDGES = {"left": (-9, 40), "right": (300, 40), "top": (5, 12), "bottom": (5, 68), "top_left": (-11, 9),
         "top_right": (305, 10), "bottom_left": (-7, 71), "bottom_right": (301, 75), "outside": (-400, 40)}


@pytest.mark.parametrize("edge", EDGES)
def test_strings_cut_at_an_edge(edge):
    for font in UPRIGHT:
        for thick in (1, 2):
            assert_same("8WgÅ0j", EDGES[edge], font, 1.2, thick, shape=(64, 320, 3))


@pytest.mark.parametrize("text,x", [("jָ", 320), ("jָ", 319), ("jָ", 330), ("ָ", 347), ("aĭ", 295),
                                    ("aĭ", 296)],
                         ids=["j_at_the_edge", "j_inside", "j_past", "mark_past", "breve_at_the_edge",
                              "breve_past"])
def test_a_pen_at_the_right_edge(text, x):
    """A string whose org.x is at or past the right edge draws nothing,
    not even the marks and side bearings that reach back into the image;
    a later glyph whose pen has passed the edge is still drawn."""
    assert_same(text, (x, 40), C.FONT_HERSHEY_SIMPLEX, 1.5, 2, shape=(60, 320, 3))


@pytest.mark.parametrize("shape", [(70, 300), (70, 300, 1), (70, 300, 3), (70, 300, 4)],
                         ids=["grey", "grey1", "bgr", "bgra"])
def test_colour_on_a_random_background(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    for i in range(20):
        bg = rng.integers(0, 256, shape, dtype=np.uint8)
        color = tuple(float(c) for c in rng.uniform(-20, 280, 4))
        text = random_text(rng, ASCII + "ÅЖжé", 2, 9)
        assert_same(text, (int(rng.integers(-5, 60)), int(rng.integers(20, 75))), UPRIGHT[i % 4],
                    float(rng.uniform(0.5, 1.6)), int(rng.integers(1, 4)), bg=bg, color=color)


def test_bottom_left_origin_and_a_strided_view():
    assert_same("Ab1,Жq", (10, 20), C.FONT_HERSHEY_DUPLEX, 1.1, 2, shape=(60, 200, 3), bottom_left=True)
    # cv2's binding draws only into contiguous arrays: its answer for the
    # view is its drawing of the view's copy
    base = np.random.default_rng(3).integers(0, 256, (60, 400, 3), dtype=np.uint8)
    want, got = base.copy(), base.copy()
    want[:, ::2] = cv2.putText(np.ascontiguousarray(want[:, ::2]), "0123", (5, 40), 0, 1.0, (9, 30, 90), 2,
                               cv2.LINE_AA)
    assert C.put_text(got[:, ::2], "0123", (5, 40), 0, 1.0, (9, 30, 90), 2, C.LINE_AA).base is got
    np.testing.assert_array_equal(got, want)


def test_size_zero_and_the_empty_string():
    for text, scale in (("0123", 0.01), ("", 1.0), ("", 0.01)):
        assert_same(text, (5, 30), 0, scale, 2, shape=(40, 100, 3))


@pytest.mark.parametrize("text,font", [("α1", 0), ("中", 0), ("7ก", 0), ("1\n2", 0), ("12", 0 | 16),
                                       ("12", 2 | 16), ("12", 6), ("12", 7)],
                         ids=["greek", "cjk", "thai", "newline", "italic", "duplex_italic", "script_simplex",
                              "script_complex"])
def test_fallback_faces_are_refused_before_drawing(text, font):
    img = np.full((40, 120, 3), 255, np.uint8)
    with pytest.raises(C.CV2FallbackFaceNotPorted, match="A17"):
        C.put_text(img, text, (5, 30), font, 1.0, (0, 0, 0), 2)
    assert (img == 255).all()
    with pytest.raises(C.CV2FallbackFaceNotPorted, match="A17"):
        C.get_text_size(text, font, 1.0, 2)
    assert isinstance(C.CV2FallbackFaceNotPorted("x"), C.CV2FontsNotPorted)


def test_rubik_covers():
    assert C.rubik_covers("0123456789" + ASCII + "ÅéЖжЁ")
    assert not C.rubik_covers("α") and not C.rubik_covers("中") and not C.rubik_covers("\n")


def fuzz(rounds: int, seed: int = 0) -> int:
    """``rounds`` × 2,000 random strings against cv2; returns the count of
    differing cases (each one printed)."""
    rng = np.random.default_rng(seed)
    chars = "".join(chr(c) for c in sorted(C.load_face().cmap))
    bad = n = 0
    for _ in range(rounds):
        for i in range(2000):
            pool = (chars, ASCII, "0123456789")[i % 3]
            text = random_text(rng, pool, 0, 12)
            font = int(rng.choice(UPRIGHT + (C.FONT_HERSHEY_PLAIN, C.FONT_HERSHEY_COMPLEX_SMALL)))
            scale = float(rng.uniform(0.0, 6.0) if i % 10 == 0 else rng.uniform(0.3, 2.0))
            thick = int(rng.integers(-1, 9))
            h, w = int(rng.integers(1, 200)), int(rng.integers(1, 400))
            shape = [(h, w), (h, w, 1), (h, w, 3), (h, w, 4)][i % 4]
            bg = rng.integers(0, 256, shape, dtype=np.uint8)
            color = tuple(float(c) for c in rng.uniform(-10, 270, 4))
            org = (int(rng.integers(-100, w + 50)), int(rng.integers(-50, h + 150)))
            n += 1
            want = cv2_draw(bg, text, org, font, scale, color, thick, bool(i % 7 == 0))
            got = port_draw(bg, text, org, font, scale, color, thick, bool(i % 7 == 0))
            size_ok = C.get_text_size(text, font, scale, thick) == (
                lambda r: (tuple(r[0]), r[1]))(cv2.getTextSize(text, font, scale, thick))
            if not np.array_equal(got, want) or not size_ok:
                bad += 1
                print(f"differs: {text!r} font {font} scale {scale!r} thickness {thick} at {org} on {shape}")
    print(f"fuzz: {n} cases, {bad} differences")
    return bad


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--fuzz":
        sys.exit(1 if fuzz(int(sys.argv[2])) else 0)
    sys.exit("usage: python tests/test_torch_cv2_text.py --fuzz N")
