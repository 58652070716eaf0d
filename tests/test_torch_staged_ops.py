"""The host ops of the port's staged path against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX package's function (on
cv2) and its numpy / C++ counterpart in ``ppocr_tpu_torch.ops``.
Tolerances:

* ``boxes_from_bitmap`` (the C++ core) against the JAX package's cv2
  version: those of ``tests/test_native.py``. On random blob maps the box
  counts differ by at most one per map (a box whose mean score sits on
  ``box_thresh`` may flip) and ≥ 90 % of the boxes have every corner within
  2 px; on clean rotated and axis-aligned blobs every corner is within
  1 px (and the axis-aligned ones equal their closed form); the four
  cv2 / C++ divergences found earlier agree exactly in their box counts;
* ``filter_tag_det_res``, ``binarize_np`` with and without the dilation,
  ``bounding_crop``, ``sort_boxes``, ``iou_float``, ``xyxyxyxy2xyxy``,
  ``pack_batch``, ``order_points_clockwise``: exact;
* ``crnn_resize`` / ``cls_resize``: exact;
* ``get_perspective_transform``: bit-equal to cv2's matrix (cv2's own LU
  solve, replayed); ``warp_perspective`` and ``get_rotate_crop_image``:
  exact (``csrc/warp.cpp`` replays cv2 5.0's arithmetic).
"""

import json
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest

from ppocr_tpu.ops import db_postprocess as jax_db
from ppocr_tpu.ops import geometry as jax_geo
from ppocr_tpu.ops import normalize as jax_norm
from ppocr_tpu.ops import resize as jax_resize
from ppocr_tpu_torch.ops import db_postprocess as torch_db
from ppocr_tpu_torch.ops import geometry as torch_geo
from ppocr_tpu_torch.ops import native
from ppocr_tpu_torch.ops import normalize as torch_norm
from ppocr_tpu_torch.ops import resize as torch_resize

REPO = pathlib.Path(__file__).resolve().parent.parent


def rotated_patch(rng, bw, bh, val, margin):
    patch = np.full((bh, bw), val, np.float32)
    m = cv2.getRotationMatrix2D((bw / 2, bh / 2), float(rng.uniform(-40, 40)), 1.0)
    canvas = np.zeros((bh + 2 * margin, bw + 2 * margin), np.float32)
    canvas[margin : margin + bh, margin : margin + bw] = patch
    return cv2.warpAffine(canvas, m, (bw + 2 * margin, bh + 2 * margin))


def random_blob_map(rng, h=96, w=160, n_blobs=4):
    """The maps of ``tests/test_native.py``: axis-aligned and rotated
    rectangles of constant probability."""
    prob = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        bw = int(rng.integers(8, 60))
        bh = int(rng.integers(5, 25))
        x = int(rng.integers(0, w - bw))
        y = int(rng.integers(0, h - bh))
        val = float(rng.uniform(0.5, 0.95))
        patch = np.full((bh, bw), val, np.float32)
        if rng.random() < 0.5:
            patch = rotated_patch(rng, bw, bh, val, 10)
            bh, bw = patch.shape
            y = min(y, h - bh)
            x = min(x, w - bw)
        prob[y : y + bh, x : x + bw] = np.maximum(prob[y : y + bh, x : x + bw], patch)
    return prob


def bitmap_of(prob, thresh):
    return ((prob * 255).astype(np.uint8) > int(thresh * 255)).astype(np.uint8) * 255


def both(prob, thresh=0.2, score_mode="fast", **kw):
    bmp = bitmap_of(prob, thresh)
    ref = jax_db.boxes_from_bitmap(prob, bmp, 0.4, 1.8, score_mode, **kw)
    got, scores = native.boxes_from_bitmap(prob, bmp, 0.4, 1.8, score_mode, **kw)
    assert len(scores) == len(got)
    return ref, got


# -- the C++ core ------------------------------------------------------------


def test_the_library_is_built_under_the_ports_build_dir():
    lib = native.build()
    assert lib.parent == REPO / "ppocr_tpu_torch" / "_build" and lib.exists()
    assert lib.name.startswith("libdbpost-") and lib.suffix == ".so"
    assert native.build() == lib  # found by its hash, not rebuilt
    assert not (REPO / "native" / "libdbpost.so").exists()


BUILD_AND_CALL = """
import json, pathlib, sys
import numpy as np
from ppocr_tpu_torch.ops import native
native.BUILD_DIR = pathlib.Path(sys.argv[1])
prob = np.zeros((32, 64), np.float32)
prob[8:20, 10:50] = 0.9
bmp = (prob > 0.2).astype(np.uint8) * 255
boxes, _ = native.boxes_from_bitmap(prob, bmp, 0.4, 1.8, "fast")
print(json.dumps([str(native.build()), [b.tolist() for b in boxes]]))
"""


def test_two_processes_booting_together_build_one_library(tmp_path):
    """Two worker processes that find no library build it under the lock
    and both load a whole file."""
    build_dir = tmp_path / "_build"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", BUILD_AND_CALL, str(build_dir)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        results.append(json.loads(out.splitlines()[-1]))
    assert results[0] == results[1] and len(results[0][1]) == 1
    built = sorted(f.name for f in build_dir.iterdir())
    assert built == ["dbpost.lock", pathlib.Path(results[0][0]).name]


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "dbpost.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert [f.name for f in (tmp_path / "_build").iterdir()] == ["dbpost.lock"]


def test_min_area_rect_matches_cv2():
    rng = np.random.default_rng(1)
    for _ in range(20):
        pts = (rng.normal(0, 15, (int(rng.integers(4, 60)), 2)) + 60).astype(np.float32)
        (rc, rs, _), (nc, ns, _) = cv2.minAreaRect(pts), native.min_area_rect(pts)
        assert sorted(np.round(rs, 3)) == pytest.approx(sorted(np.round(ns, 3)), abs=1e-2)
        assert rc == pytest.approx(nc, abs=1e-2)


@pytest.mark.parametrize("score_mode", ["fast", "slow"])
def test_boxes_from_bitmap_on_random_blob_maps(score_mode):
    rng = np.random.default_rng(7)
    agree = total = 0
    for trial in range(12):
        ref, got = both(random_blob_map(rng), score_mode=score_mode)
        assert abs(len(ref) - len(got)) <= 1, f"trial {trial}: {len(ref)} vs {len(got)}"
        for rb in ref:
            dists = [np.abs(np.sort(g, axis=0) - np.sort(rb, axis=0)).max() for g in got]
            total += 1
            agree += bool(dists) and min(dists) <= 2
    assert total > 20 and agree / total >= 0.9


def thin_staircase():
    prob = np.zeros((40, 60), np.float32)
    for i in range(20):
        prob[10 + i // 2, 10 + i] = 0.9
    return prob, {}, 1


def exact_45_line():
    prob = np.zeros((40, 60), np.float32)
    for i in range(20):
        prob[10 + i, 10 + i] = 0.9
    return prob, {}, 0


def corner_touching_holes():
    prob = np.zeros((40, 40), np.float32)
    prob[5:35, 5:35] = 0.9
    prob[10:15, 10:15] = 0.0
    prob[15:20, 15:20] = 0.0
    return prob, {}, 3


def stacked_bars():
    prob = np.zeros((60, 30), np.float32)
    for y0 in (2, 17, 32, 47):
        prob[y0 : y0 + 8, 5:25] = 0.9
    return prob, {"max_candidates": 2}, 2


@pytest.mark.parametrize(
    "case", [thin_staircase, exact_45_line, corner_touching_holes, stacked_bars]
)
def test_known_cv2_divergences_agree(case):
    """The four cases in which the C++ core once disagreed with cv2: a 1 px
    slope-1/2 line is kept, an exact 45° line is dropped, holes that touch
    at a corner stay apart, and ``max_candidates`` keeps cv2's subset."""
    prob, kw, n = case()
    ref, got = both(prob, **kw)
    assert len(ref) == len(got) == n
    assert [b[:, 1].min() for b in ref] == [b[:, 1].min() for b in got]


def test_rotated_blob_corners_within_one_pixel():
    rng = np.random.default_rng(7)
    worst = n = 0
    for _ in range(20):
        prob = np.zeros((96, 160), np.float32)
        bw, bh = int(rng.integers(15, 50)), int(rng.integers(8, 20))
        x, y = int(rng.integers(0, 100)), int(rng.integers(0, 60))
        patch = rotated_patch(rng, bw, bh, 0.9, 12)
        ph, pw = patch.shape
        y, x = min(y, 96 - ph), min(x, 160 - pw)
        prob[y : y + ph, x : x + pw] = np.maximum(prob[y : y + ph, x : x + pw], patch)
        ref, got = both(prob)
        assert len(ref) == len(got)
        for rb, nb in zip(ref, got):
            worst = max(worst, int(np.abs(np.sort(rb, 0) - np.sort(nb, 0)).max()))
            n += 1
    assert n >= 20 and worst <= 1, worst


def test_axis_aligned_blobs_give_the_closed_form_box():
    """A rectangle of ink has a known answer: its pixel-centre extent grown
    by d = area·ratio/perimeter on every side, rounded half away from zero
    and clamped. The C++ core gives exactly that (it keeps the rect's edge
    direction as a vector: through cos and sin of a float angle a corner
    came out as 10.999999, the unclip truncated it to 10, and the box
    tilted by a pixel). cv2's own minAreaRect returns 21.999996 for some of
    these rects, so the JAX package's boxes are held within 1 px only."""
    rng = np.random.default_rng(14)
    f = np.float32
    for _ in range(40):
        prob = np.zeros((96, 160), np.float32)
        bw, bh = int(rng.integers(6, 90)), int(rng.integers(4, 30))
        x, y = int(rng.integers(0, 160 - bw)), int(rng.integers(0, 96 - bh))
        prob[y : y + bh, x : x + bw] = 0.9
        ref, got = both(prob)
        assert len(ref) == len(got) == 1
        w, h = f(bw - 1), f(bh - 1)
        d = w * h * f(1.8) / (f(2) * (w + h))
        xs = f(x) + w / f(2) + np.array([-1, 1], f) * (w + f(2) * d) / f(2)
        ys = f(y) + h / f(2) + np.array([-1, 1], f) * (h + f(2) * d) / f(2)
        xs = np.clip(torch_db._roundf(xs / f(160) * f(160)), 0, 160).astype(np.int64)
        ys = np.clip(torch_db._roundf(ys / f(96) * f(96)), 0, 96).astype(np.int64)
        want = [[xs[0], ys[0]], [xs[1], ys[0]], [xs[1], ys[1]], [xs[0], ys[1]]]
        np.testing.assert_array_equal(got[0], want)
        assert np.abs(got[0] - ref[0]).max() <= 1


def test_mismatched_bitmap_shape_rejected():
    prob = np.zeros((40, 40), np.float32)
    with pytest.raises(ValueError, match="same-resolution"):
        native.boxes_from_bitmap(prob, np.zeros((20, 20), np.uint8), 0.4, 1.8, "fast")


@pytest.mark.parametrize("use_dilation", [False, True])
def test_db_postprocess_equals_the_cv2_backend_on_a_clean_map(use_dilation):
    prob = np.zeros((96, 160), np.float32)
    prob[30:50, 40:120] = 0.9
    prob[60:80, 10:70] = 0.7
    kw = dict(thresh=0.2, box_thresh=0.4, unclip_ratio=1.8, score_mode="fast",
              use_dilation=use_dilation)
    ref = jax_db.DBPostProcess(backend="cv2", **kw)(prob, 192, 320, 0.5, 0.5)
    got = torch_db.DBPostProcess(**kw)(prob, 192, 320, 0.5, 0.5)
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    # every backend runs the C++ core (tests/test_torch_db_helpers.py)
    assert torch_db.DBPostProcess().backend == "auto"


# -- numpy halves of the postprocess -----------------------------------------


@pytest.mark.parametrize("use_dilation", [False, True])
def test_binarize_np_equals_cv2(use_dilation):
    rng = np.random.default_rng(3)
    prob = rng.random((37, 53)).astype(np.float32)
    prob[0, :] = 0.9  # ink on every border: the replicated edge matters
    prob[:, -1] = 0.9
    for thresh in (0.2, 0.3, 0.5):
        want = jax_db.DBPostProcess(thresh=thresh, use_dilation=use_dilation).binarize_np(prob)
        got = torch_db.DBPostProcess(thresh=thresh, use_dilation=use_dilation).binarize_np(prob)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_filter_tag_det_res_equals_jax():
    rng = np.random.default_rng(4)
    boxes = []
    for _ in range(40):
        c = rng.uniform(-5, 100, 2)
        wh = rng.uniform(1, 40, 2)
        quad = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * wh / 2 + c
        boxes.append(rng.permutation(quad).astype(np.int64))
    for ratio_h, ratio_w in ((0.5, 0.5), (0.75, 0.3333), (1.0, 1.7)):
        want = jax_db.filter_tag_det_res(boxes, ratio_h, ratio_w, 120, 150)
        got = torch_db.filter_tag_det_res(boxes, ratio_h, ratio_w, 120, 150)
        assert 0 < len(want) < len(boxes) and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_roundf_is_half_away_from_zero():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4999, -2.5001])
    np.testing.assert_array_equal(torch_db._roundf(x), [1, 2, 3, -1, -2, 2, -3])
    np.testing.assert_array_equal(torch_db._roundf(x), jax_db._roundf(x))


def test_order_points_clockwise_equals_jax():
    rng = np.random.default_rng(5)
    for _ in range(30):
        pts = rng.integers(0, 50, (4, 2))
        np.testing.assert_array_equal(
            torch_db.order_points_clockwise(pts), jax_db.order_points_clockwise(pts)
        )


# -- geometry ----------------------------------------------------------------

IMG = np.random.default_rng(6).integers(0, 256, (60, 80, 3)).astype(np.uint8)


@pytest.mark.parametrize(
    "box",
    [
        [[10, 12], [40, 10], [42, 30], [9, 28]],  # inside
        [[-7, -3], [20, -5], [22, 14], [-6, 15]],  # negative origin
        [[60, 40], [90, 42], [88, 70], [58, 66]],  # past the far edges
        [[79, 59], [79, 59], [79, 59], [79, 59]],  # one pixel at the corner
        [[90, 10], [120, 10], [120, 30], [90, 30]],  # wholly outside
        [[-30, -30], [-5, -30], [-5, -10], [-30, -10]],  # outside, negative
    ],
    ids=["inside", "negative-origin", "far-edge", "corner-pixel", "outside", "outside-negative"],
)
def test_bounding_crop_equals_jax(box):
    want = jax_geo.bounding_crop(IMG, box)
    got = torch_geo.bounding_crop(IMG, box)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_box_helpers_equal_jax():
    rng = np.random.default_rng(8)
    boxes = []
    for _ in range(25):
        tl = rng.integers(0, 200, 2)
        boxes.append(np.array([tl, tl + [30, 0], tl + [30, 12], tl + [0, 12]]))
    assert torch_geo.sort_boxes(boxes) == jax_geo.sort_boxes(boxes)
    assert torch_geo.sort_boxes([]) == [] and torch_geo.sort_boxes(boxes[:1]) == [0]
    for b in boxes:
        assert torch_geo.xyxyxyxy2xyxy(b) == jax_geo.xyxyxyxy2xyxy(b)
    rects = rng.uniform(0, 50, (40, 4))
    rects[:, 2:] += rects[:, :2] * rng.choice([1.0, -0.2], (40, 1))  # some inverted
    for a, b in zip(rects[::2], rects[1::2]):
        assert torch_geo.iou_float(a, b) == jax_geo.iou_float(a, b)
    assert torch_geo.iou_float([0, 0, 10, 10], [0, 0, 10, 10]) == pytest.approx(1.0)
    assert torch_geo.iou_float([0, 0, 0, 0], [0, 0, 0, 0]) == 0.0


def test_perspective_transform_matches_cv2():
    rng = np.random.default_rng(9)
    for _ in range(20):
        w, h = rng.uniform(5, 120), rng.uniform(5, 40)
        src = (np.array([[0, 0], [w, 0], [w, h], [0, h]]) + rng.uniform(-4, 4, (4, 2))).astype(
            np.float32
        )
        dst = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
        np.testing.assert_array_equal(
            torch_geo.get_perspective_transform(src, dst),
            cv2.getPerspectiveTransform(src, dst),
        )
    for _ in range(40):  # any four points onto any four
        src, dst = rng.uniform(-50, 300, (2, 4, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            torch_geo.get_perspective_transform(src, dst),
            cv2.getPerspectiveTransform(src, dst),
        )


def random_quad(rng, img_w, img_h):
    cx, cy = rng.uniform(40, img_w - 40), rng.uniform(40, img_h - 40)
    w, h = rng.uniform(6, 120), rng.uniform(6, 60)
    a = rng.uniform(-1.5, 1.5)
    c, s = np.cos(a), np.sin(a)
    pts = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
    pts = pts @ np.array([[c, s], [-s, c]]) + [cx, cy] + rng.uniform(-3, 3, (4, 2))
    return np.clip(pts, [0, 0], [img_w - 1, img_h - 1]).astype(np.int64)


@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_rotate_crop_image_within_one_grey_level_of_cv2(smooth):
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (200, 300, 3)).astype(np.uint8)
    if smooth:
        img = cv2.GaussianBlur(img, (9, 9), 3)
    total = tall = 0
    for _ in range(150):
        box = random_quad(rng, 300, 200)
        try:
            want = jax_geo.get_rotate_crop_image(img, box)
        except cv2.error:  # a quad with a side shorter than 1 px
            with pytest.raises(ValueError, match="empty output size"):
                torch_geo.get_rotate_crop_image(img, box)
            continue
        got = torch_geo.get_rotate_crop_image(img, box)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        total += got.size
        side_w = np.hypot(*(box[0] - box[1]))
        tall += np.hypot(*(box[0] - box[3])) >= 1.5 * side_w
    assert total > 500_000 and tall > 10  # the rotate-90° branch was met


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_warp_perspective_matches_cv2(channels):
    """Random quads (convex and not) warped onto rects of every ``width
    mod 16`` (cv2's scalar row tail), taps straddling the border."""
    rng = np.random.default_rng(20 + channels)
    for k in range(48):
        h, w = int(rng.integers(4, 70)), int(rng.integers(4, 260))
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
        quad = (corners + rng.uniform(-0.35, 0.35, (4, 2)) * [w, h]).astype(np.float32)
        out_w, out_h = 16 * int(rng.integers(0, 12)) + k % 16 or 16, int(rng.integers(1, 60))
        rect = np.array([[0, 0], [out_w, 0], [out_w, out_h], [0, out_h]], np.float32)
        m = torch_geo.get_perspective_transform(quad, rect)
        np.testing.assert_array_equal(m, cv2.getPerspectiveTransform(quad, rect))
        np.testing.assert_array_equal(torch_geo.warp_perspective(img, m, out_w, out_h),
                                      cv2.warpPerspective(img, m, (out_w, out_h)))


# -- resize and packing --------------------------------------------------------


def crops(rng, n=40):
    out = []
    for _ in range(n):
        h, w = int(rng.integers(5, 80)), int(rng.integers(5, 400))
        out.append(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    out.append(np.full((48, 256, 3), 200, np.uint8))  # already at size
    out.append(rng.integers(0, 256, (96, 512, 3)).astype(np.uint8))  # the exact 2× path
    return out


@pytest.mark.parametrize("shape", [(3, 48, 256), (3, 28, 192), (3, 48, 320)])
def test_crnn_resize_within_one_grey_level(shape):
    rng = np.random.default_rng(11)
    padded = capped = 0
    for im in crops(rng):
        for ratio in (shape[2] / shape[1], 448 / shape[1]):
            want = jax_resize.crnn_resize(im, ratio, shape)
            got = torch_resize.crnn_resize(im, ratio, shape)
            assert got.shape == want.shape == (shape[1], int(shape[1] * ratio), 3)
            np.testing.assert_array_equal(got, want)
            content = min(int(np.ceil(shape[1] * im.shape[1] / im.shape[0])), got.shape[1])
            assert not got[:, content:].any()  # the black right pad
            padded += content < got.shape[1]
            capped += np.ceil(shape[1] * im.shape[1] / im.shape[0]) > got.shape[1]
    assert padded and capped


def test_cls_resize_within_one_grey_level():
    rng = np.random.default_rng(12)
    for im in crops(rng):
        want = jax_resize.cls_resize(im, (3, 48, 192))
        got = torch_resize.cls_resize(im, (3, 48, 192))
        assert got.shape == want.shape and got.shape[0] == 48 and got.shape[1] <= 192
        np.testing.assert_array_equal(got, want)


def test_pack_batch_equals_jax():
    rng = np.random.default_rng(13)
    images = [rng.integers(0, 256, (48, w, 3)).astype(np.uint8) for w in (256, 100, 31)]
    np.testing.assert_array_equal(
        torch_norm.pack_batch(images, 256), jax_norm.pack_batch(images, 256)
    )
    grey = [im[..., 0] for im in images]
    got = torch_norm.pack_batch(grey, 320)
    np.testing.assert_array_equal(got, jax_norm.pack_batch(grey, 320))
    assert got.shape == (3, 48, 320, 1) and not got[1, :, 100:].any()
    for name in ("IMAGENET_MEAN", "IMAGENET_SCALE", "HALF_MEAN", "HALF_SCALE"):
        assert getattr(torch_norm, name) == getattr(jax_norm, name)
