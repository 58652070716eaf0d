"""The port's ``utils/draw.py`` and ``utils/visualize.py`` against cv2 5.0
and the JAX package's ``visualize_boxes``, on the CPU.

Tolerance everywhere: 0 differing pixels. ``draw.polylines`` is held to
``cv2.polylines`` (LINE_8, shift 0) on thousands of random closed
polygons from a numpy seed, thickness 0–8, on [H, W], [H, W, 3] and
[H, W, 4] canvases of 1×1 to 200×300, and on one named case per rule its
docstring lists; ``visualize_boxes`` is held to the JAX function on the
four 192×192 scenes with their golden words.

    python tests/test_torch_visualize.py --write

rewrites ``ppocr_tpu_torch/assets/visualize_mask.npz``: the pixels that
``cv2.polylines`` draws for the golden words of the first serving scene,
packed one bit a pixel, which ``chip_smoke.py`` holds the port to on a
machine without cv2.
"""

import pathlib
import sys

import cv2
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ppocr_tpu_torch import assets  # noqa: E402
from ppocr_tpu_torch.utils import draw  # noqa: E402
from ppocr_tpu_torch.utils.imcodec import read_image  # noqa: E402
from ppocr_tpu_torch.utils.visualize import visualize_boxes  # noqa: E402

GREEN = (0, 255, 0)


def both(canvas, polys, thickness, color=GREEN):
    """cv2's and the port's drawing of ``polys`` on copies of ``canvas``."""
    polys = [np.asarray(p, np.int32).reshape(-1, 1, 2) for p in polys]
    want = cv2.polylines(canvas.copy(), polys, True, color, thickness)
    got = draw.polylines(canvas.copy(), polys, color, thickness)
    return want, got


def assert_same(canvas, polys, thickness, **kw):
    want, got = both(canvas, polys, thickness, **kw)
    diff = np.argwhere((want != got).reshape(want.shape[0], want.shape[1], -1).any(-1))
    assert not len(diff), f"{len(diff)} pixels differ, first (row, col) {diff[:5].tolist()}"


def random_polygon(rng, h, w):
    """Axis-aligned and rotated rects, free polygons of 1–6 points and
    polygons with a repeated point, in float, reaching past the canvas."""
    kind = int(rng.integers(0, 4))
    if kind == 0:
        cx, cy = rng.uniform(-0.2 * w, 1.2 * w), rng.uniform(-0.2 * h, 1.2 * h)
        a, bw, bh = rng.uniform(0, np.pi), rng.uniform(0, w), rng.uniform(0, h)
        c, s = np.cos(a), np.sin(a)
        return np.array([[cx + c * dx - s * dy, cy + s * dx + c * dy]
                         for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2),
                                        (bw / 2, bh / 2), (-bw / 2, bh / 2))])
    if kind == 1:
        x0, x1 = sorted(rng.uniform(-0.3 * w, 1.3 * w, 2))
        y0, y1 = sorted(rng.uniform(-0.3 * h, 1.3 * h, 2))
        return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    n = int(rng.choice([1, 2, 3, 4, 4, 5, 6]))
    pts = np.stack([rng.uniform(-0.3 * w, 1.3 * w, n), rng.uniform(-0.3 * h, 1.3 * h, n)], 1)
    if kind == 3 and n > 1:
        pts[rng.integers(0, n)] = pts[rng.integers(0, n)]
    return pts


@pytest.mark.parametrize("channels", [None, 3, 4])
@pytest.mark.parametrize("thickness", range(9))
def test_polylines_equals_cv2_on_random_polygons(thickness, channels):
    rng = np.random.default_rng(1000 * thickness + (channels or 1))
    for i in range(160):
        if i % 3 == 0:
            h, w = int(rng.integers(1, 13)), int(rng.integers(1, 13))
        else:
            h, w = int(rng.integers(1, 201)), int(rng.integers(1, 301))
        shape = (h, w) if channels is None else (h, w, channels)
        canvas = rng.integers(0, 256, shape, dtype=np.uint8)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        polys = [np.asarray(random_polygon(rng, h, w), np.int32) for _ in range(int(rng.integers(1, 4)))]
        assert_same(canvas, polys, thickness, color=color)


# -- one case per rule -----------------------------------------------------------


def test_thickness_0_and_1_draw_the_8_connected_line_without_caps():
    canvas = np.zeros((40, 60), np.uint8)
    quad = [[3, 4], [50, 9], [41, 37], [6, 30]]
    for t in (0, 1):
        want, got = both(canvas, [quad], t, color=255)
        np.testing.assert_array_equal(got, want)
    thin = both(canvas, [quad], 1, color=255)[1]
    np.testing.assert_array_equal(both(canvas, [quad], 0, color=255)[1], thin)
    # one pixel per step of the longer axis, each vertex shared by two
    # segments: 8-connected, no caps
    assert (thin > 0).sum() == 47 + 28 + 35 + 26


def test_each_vertex_gets_one_round_cap():
    """A single point is a zero-length segment: only its cap is drawn, a
    filled circle of radius (t·2^15 + 2^15) >> 16; thickness 2 gives a
    plus of 5 pixels."""
    canvas = np.zeros((21, 21), np.uint8)
    for t in range(2, 9):
        want, got = both(canvas, [[[10, 10]]], t, color=255)
        np.testing.assert_array_equal(got, want)
    plus = both(canvas, [[[10, 10]]], 2, color=255)[1]
    assert np.argwhere(plus).tolist() == [[9, 10], [10, 9], [10, 10], [10, 11], [11, 10]]


@pytest.mark.parametrize("thickness", range(2, 9))
def test_thick_segments_near_the_axes_at_45_degrees_and_of_zero_length(thickness):
    """The quadrilateral's corners are the end points ± cvRound of the
    normal scaled to (t·2^15 + (t & 1)·2^15)/|d| in 16-bit fixed point;
    which boundary pixels its fill and Line2 edges take shows on segments
    near horizontal, near vertical, at 45° and of zero length."""
    canvas = np.zeros((60, 80, 3), np.uint8)
    segments = [
        [[5, 30], [70, 30]], [[5, 30], [70, 31]], [[5, 30], [70, 29]],
        [[40, 3], [40, 55]], [[40, 3], [41, 55]], [[40, 3], [39, 55]],
        [[10, 10], [50, 50]], [[10, 50], [50, 10]], [[10, 10], [49, 50]],
        [[30, 30], [30, 30]], [[30, 30], [31, 30]], [[30, 30], [31, 31]],
    ]
    for seg in segments:
        assert_same(canvas, [seg], thickness)
    for quad in ([[10, 10], [60, 10], [60, 40], [10, 40]], [[10, 10], [60, 11], [59, 40], [11, 39]]):
        assert_same(canvas, [quad], thickness)


def test_odd_thickness_widens_by_half_a_pixel():
    """The normal's length is t/2 + (t & 1)/2 pixels: a horizontal segment
    of thickness 3 covers 5 rows, as does 4, and 5 covers 7."""
    canvas = np.zeros((50, 50), np.uint8)
    widths = []
    for t in (3, 4, 5):
        want, got = both(canvas, [[[5, 25], [45, 25]]], t, color=255)
        np.testing.assert_array_equal(got, want)
        widths.append(int((got[:, 25] > 0).sum()))
    assert widths == [5, 5, 7]


@pytest.mark.parametrize("thickness", [1, 2, 5, 8])
def test_coordinates_past_the_canvas_and_negative_ones(thickness):
    """A thick segment is first cut to the canvas grown by the thickness
    (integer ``clipLine``): its direction then changes by the cut's
    rounding, and its end cap moves to the cut point."""
    canvas = np.zeros((40, 60, 3), np.uint8)
    for quad in ([[5, 8], [70, 33], [20, 90], [-40, -7]],
                 [[-100, -100], [200, -80], [180, 150], [-90, 160]],
                 [[-30, 10], [-5, 10], [-5, 30], [-30, 30]],
                 [[5, 8], [3000, 1360], [4, 30]]):
        assert_same(canvas, [quad], thickness)


def test_float_coordinates_truncate_toward_zero():
    from ppocr_tpu.utils.visualize import visualize_boxes as jax_visualize

    img = np.full((50, 60, 3), 90, np.uint8)
    words = [{"text": "a", "confidence": 1.0,
              "box": [[-0.7, 4.9], [40.99, 5.5], [41.2, -1.6], [3.5, 30.999]]}]
    np.testing.assert_array_equal(visualize_boxes(img, words), jax_visualize(img, words))
    trunc = [{"box": np.trunc(np.array(words[0]["box"])).astype(int).tolist()}]
    np.testing.assert_array_equal(visualize_boxes(img, words), visualize_boxes(img, trunc))


def test_grey_canvas_takes_the_first_component_and_bgra_a_zero_alpha():
    quad = [[4, 4], [30, 6], [28, 20], [3, 18]]
    grey = np.full((25, 35), 200, np.uint8)
    want, got = both(grey, [quad], 2, color=(7, 255, 0))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {7, 200}
    bgra = np.full((25, 35, 4), 200, np.uint8)
    want, got = both(bgra, [quad], 2)
    np.testing.assert_array_equal(got, want)
    assert got[4, 10].tolist() == [0, 255, 0, 0]


@pytest.mark.parametrize("n_points", [1, 2, 3, 5, 6])
def test_polygons_of_other_than_four_points_are_one_closed_polyline(n_points):
    rng = np.random.default_rng(n_points)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    box = rng.uniform(-5, 85, (n_points, 2)).tolist()
    from ppocr_tpu.utils.visualize import visualize_boxes as jax_visualize

    words = [{"text": "x", "confidence": 0.5, "box": box}]
    np.testing.assert_array_equal(visualize_boxes(img, words), jax_visualize(img, words))


@pytest.mark.parametrize("thickness", [-1, -5, 32768])
def test_a_thickness_outside_cv2s_range_raises(thickness):
    canvas = np.zeros((10, 10, 3), np.uint8)
    quad = np.array([[1, 1], [8, 1], [8, 8]], np.int32).reshape(-1, 1, 2)
    with pytest.raises(cv2.error, match="thickness"):
        cv2.polylines(canvas.copy(), [quad], True, GREEN, thickness)
    with pytest.raises(ValueError, match="thickness"):
        draw.polylines(canvas.copy(), [quad], GREEN, thickness)
    want, got = both(canvas, [quad], 32767)  # the largest accepted
    np.testing.assert_array_equal(got, want)


def test_an_empty_box_draws_nothing():
    img = np.full((20, 20, 3), 50, np.uint8)
    words = [{"text": "", "confidence": 0.0, "box": []}]
    from ppocr_tpu.utils.visualize import visualize_boxes as jax_visualize

    np.testing.assert_array_equal(jax_visualize(img, words), img)
    np.testing.assert_array_equal(visualize_boxes(img, words), img)
    np.testing.assert_array_equal(visualize_boxes(img, []), img)


# -- visualize_boxes --------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes():
    return assets.load_scenes()


@pytest.fixture(scope="module")
def goldens():
    return assets.load_goldens()


def test_visualize_boxes_equals_jax_on_the_scenes(scenes, goldens):
    from ppocr_tpu.utils.visualize import visualize_boxes as jax_visualize

    for scene, words in zip(scenes["parity"], goldens["words"]["small"]):
        assert words
        np.testing.assert_array_equal(visualize_boxes(scene, words), jax_visualize(scene, words))
    for scene, words in zip(scenes["serving"], goldens["words"]["serving"]):
        np.testing.assert_array_equal(visualize_boxes(scene, words), jax_visualize(scene, words))


def test_visualize_boxes_on_the_jax_packages_own_case(tmp_path):
    """``tests/test_utils.py::test_visualize_boxes``' case."""
    from ppocr_tpu.utils.visualize import visualize_boxes as jax_visualize

    img = np.zeros((60, 80, 3), np.uint8)
    words = [{"text": "x", "confidence": 0.9, "box": [[5, 5], [40, 5], [40, 20], [5, 20]]}]
    canvas = visualize_boxes(img, words, str(tmp_path / "vis.png"))
    assert (tmp_path / "vis.png").exists()
    assert canvas[5, 20].tolist() == [0, 255, 0]
    np.testing.assert_array_equal(canvas, jax_visualize(img, words))
    assert img.max() == 0  # the input is not drawn on


@pytest.mark.parametrize("name", ["vis.png", "VIS.PNG"])
def test_the_written_file_reads_back_as_the_canvas(scenes, goldens, tmp_path, name):
    scene, words = scenes["parity"][1], goldens["words"]["small"][1]
    out = tmp_path / name
    canvas = visualize_boxes(scene, words, str(out))
    np.testing.assert_array_equal(cv2.imread(str(out)), canvas)
    np.testing.assert_array_equal(read_image(str(out)), canvas)
    grey = visualize_boxes(scene[..., 0].copy(), words, str(tmp_path / "grey.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "grey.png"), cv2.IMREAD_UNCHANGED), grey)


@pytest.mark.parametrize("name", ["vis.jpg", "vis.bmp", "vis", "missing/dir/vis.png"])
def test_what_it_cannot_write_raises_ioerror(tmp_path, name):
    img = np.zeros((10, 10, 3), np.uint8)
    words = [{"text": "x", "confidence": 1.0, "box": [[1, 1], [8, 1], [8, 8], [1, 8]]}]
    with pytest.raises(IOError, match="cannot write visualization"):
        visualize_boxes(img, words, str(tmp_path / name))
    assert not (tmp_path / name).exists()


# -- the committed mask ------------------------------------------------------------


def golden_mask(scenes, goldens) -> np.ndarray:
    """Where ``cv2.polylines`` draws the first serving scene's golden words
    (green, thickness 2), as ``visualize_boxes`` calls it."""
    h, w = scenes["serving"][0].shape[:2]
    quads = [np.asarray(wd["box"], np.int32).reshape(-1, 1, 2) for wd in goldens["words"]["serving"][0]]
    drawn = cv2.polylines(np.zeros((h, w, 3), np.uint8), quads, True, GREEN, 2)
    return drawn[..., 1] > 0


def test_the_committed_mask_is_cv2s_and_the_ports(scenes, goldens):
    mask = assets.load_visualize_mask()
    np.testing.assert_array_equal(mask, golden_mask(scenes, goldens))
    scene = scenes["serving"][0]
    want = scene.copy()
    want[mask] = GREEN
    np.testing.assert_array_equal(visualize_boxes(scene, goldens["words"]["serving"][0]), want)
    assert assets.VISUALIZE_MASK.stat().st_size < 50_000


def write_mask():
    scenes, goldens = assets.load_scenes(), assets.load_goldens()
    mask = golden_mask(scenes, goldens)
    np.savez_compressed(assets.VISUALIZE_MASK, shape=np.array(mask.shape), bits=np.packbits(mask))
    print(f"wrote {assets.VISUALIZE_MASK} ({assets.VISUALIZE_MASK.stat().st_size} bytes, "
          f"{int(mask.sum())} pixels drawn)")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        write_mask()
    else:
        print(__doc__)
