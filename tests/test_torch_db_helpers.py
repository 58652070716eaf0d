"""The DB postprocess helpers of ``ppocr_tpu_torch.ops`` against the JAX
package's cv2 ones, on the CPU: ``get_mini_boxes``, ``unclip_rect``,
``boxes_from_bitmap`` (with ``min_size``), ``DBPostProcess(backend=...)``,
and the pin of ``ops.__all__``.

Tolerances:

* ``box_points`` and ``get_mini_boxes``: exactly cv2's float32 corners
  and order, and the same ssid, on random rects and on the min-area rects
  of the staged goldens' quads;
* ``min_area_rect``: cv2's rect exactly on ≥ 99 % of truncated quads and
  random point sets (99.3 % measured); the rest differ by float32 ulps
  or, on near-ties of two hull edges (near-squares), pick the other
  edge: corners within the staged 2 px on all;
* ``unclip_rect``: the same ``None``s, corners after ``get_mini_boxes``
  within 1e-4 in the same order on ≥ 99.5 % (99.57 % measured), within
  the staged 2 px on all;
* ``boxes_from_bitmap`` (the C++ core) against the cv2 contours:
  ``tests/test_torch_staged_ops.py``'s tolerances (box counts within one,
  ≥ 90 % of the boxes with every corner within 2 px), for ``min_size``
  1, 3 and 6;
* ``DBPostProcess``: every ``backend`` gives the same boxes, and those of
  the JAX package's ``backend`` on a clean map.
"""

import cv2
import numpy as np
import pytest

import ppocr_tpu.ops as jax_ops
import ppocr_tpu_torch.ops as torch_ops
from ppocr_tpu.ops import db_postprocess as jax_db
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.ops import db_postprocess as torch_db
from ppocr_tpu_torch.pipeline import OCREngine, PipelineConfig


def random_rects(rng, n):
    rects = []
    for i in range(n):
        angle = float(rng.choice([0.0, 90.0, -90.0, 45.0])) if i % 4 == 0 else float(rng.uniform(-90, 90))
        rects.append(((float(rng.uniform(-20, 400)), float(rng.uniform(-20, 400))),
                      (float(rng.uniform(0, 120)), float(rng.uniform(0, 120))), angle))
    return rects


@pytest.fixture(scope="module")
def golden_rects():
    """cv2's min-area rects of the staged goldens' word quads."""
    goldens = assets.load_goldens()
    quads = [np.array(w["box"], np.float32) for name in ("small-staged", "serving-staged")
             for scene in goldens["words"][name] for w in scene]
    assert len(quads) > 20
    return [cv2.minAreaRect(q) for q in quads]


def test_box_points_are_cv2s():
    rng = np.random.default_rng(0)
    for rect in random_rects(rng, 5000):
        np.testing.assert_array_equal(torch_db.box_points(rect), cv2.boxPoints(rect))


def test_get_mini_boxes_equals_jax(golden_rects):
    rng = np.random.default_rng(1)
    for rect in golden_rects + random_rects(rng, 5000):
        want, want_ssid = jax_db.get_mini_boxes(rect)
        got, got_ssid = torch_db.get_mini_boxes(rect)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got_ssid == want_ssid


def truncated_quads(rng, n):
    out = []
    for rect in random_rects(rng, n):
        quad = jax_db.get_mini_boxes(rect)[0]
        if cv2.contourArea(np.trunc(quad)) > 0:
            out.append(quad)
    return out


def test_min_area_rect_is_cv2s():
    rng = np.random.default_rng(2)
    quads = [np.trunc(q) for q in truncated_quads(rng, 2000)]
    quads += [rng.integers(0, 40, (int(rng.integers(3, 12)), 2)).astype(np.float32) for _ in range(1000)]
    exact = n = 0
    for pts in quads:
        if cv2.contourArea(cv2.convexHull(pts)) <= 0:
            continue
        want, got = cv2.minAreaRect(pts), torch_db.min_area_rect(pts)
        n += 1
        exact += want == got
        err = np.abs(np.sort(cv2.boxPoints(want), 0) - np.sort(cv2.boxPoints(got), 0)).max()
        assert err <= 2, (pts.tolist(), want, got)
    assert n > 2500 and exact >= 0.99 * n


def test_unclip_rect_equals_jax(golden_rects):
    rng = np.random.default_rng(3)
    quads = [jax_db.get_mini_boxes(r)[0] for r in golden_rects] + truncated_quads(rng, 3000)
    quads += [np.zeros((4, 2), np.float32), np.array([[0, 0], [5, 0], [10, 0], [5, 0]], np.float32)]
    close = n = 0
    for quad in quads:
        for ratio in (1.5, 2.0):
            want, got = jax_db.unclip_rect(quad, ratio), torch_db.unclip_rect(quad, ratio)
            assert (want is None) == (got is None), quad.tolist()
            if want is None:
                continue
            err = np.abs(jax_db.get_mini_boxes(want)[0] - torch_db.get_mini_boxes(got)[0]).max()
            assert err <= 2, (quad.tolist(), want, got)
            close += err <= 1e-4
            n += 1
    assert n > 5000 and close >= 0.995 * n


def random_blob_map(rng, h=96, w=160, n_blobs=4):
    """Axis-aligned and sheared rectangles of constant probability."""
    prob = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        bw, bh = int(rng.integers(2, 60)), int(rng.integers(2, 25))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        shift = float(rng.uniform(-0.5, 0.5)) if rng.random() < 0.5 else 0.0
        val = np.float32(rng.uniform(0.5, 0.95))
        for r in range(bh):
            x0 = min(max(int(x + shift * r), 0), w - bw)
            prob[y + r, x0 : x0 + bw] = val
    return prob


@pytest.fixture(scope="module")
def golden_prob_maps(tmp_path_factory):
    """The det prob maps of the four 192×192 golden scenes (small-staged
    config, the port's det on the CPU), as the staged path hands them to
    the postprocess."""
    cfg = PipelineConfig.from_dict(assets.load_goldens()["configs"]["small-staged"])
    engine = OCREngine(str(assets.make_jumbo_model_dir(tmp_path_factory.mktemp("jumbo"))), cfg, device="cpu")
    maps = []
    post = engine.post

    def record(prob, *args, **kw):
        maps.append(prob.copy())
        return post(prob, *args, **kw)

    engine.post = record
    for scene in assets.load_scenes()["parity"]:
        engine.detect(scene)
    return maps


def held_to_staged_tolerance(ref, got):
    assert abs(len(ref) - len(got)) <= 1, f"{len(ref)} vs {len(got)}"
    near = sum(bool(got) and min(np.abs(np.sort(g, 0) - np.sort(r, 0)).max() for g in got) <= 2 for r in ref)
    return near, len(ref)


@pytest.mark.parametrize("min_size", [1, 3, 6])
def test_boxes_from_bitmap_equals_jax(min_size, golden_prob_maps):
    rng = np.random.default_rng(4 + min_size)
    maps = golden_prob_maps + [random_blob_map(rng) for _ in range(12)]
    near = total = 0
    for prob in maps:
        bitmap = ((prob * 255).astype(np.uint8) > int(0.2 * 255)).astype(np.uint8) * 255
        for mode in ("fast", "slow"):
            ref = jax_db.boxes_from_bitmap(prob, bitmap, 0.4, 1.8, mode, min_size=min_size)
            got = torch_db.boxes_from_bitmap(prob, bitmap, 0.4, 1.8, mode, min_size=min_size)
            assert all(g.dtype == np.int64 and g.shape == (4, 2) for g in got)
            a, b = held_to_staged_tolerance(ref, got)
            near, total = near + a, total + b
    assert total > 50 and near >= 0.9 * total


def test_min_size_reaches_the_core():
    """A 3×4 blob: its contour's min-area rect is 3×2 px, unclipped 5.16 ×
    4.16: kept up to min_size 3, dropped from 4 on (the core's bounds were
    fixed at 3 and 5); a 2×3 blob (2×1 px) only with min_size 1."""
    prob = np.zeros((20, 20), np.float32)
    prob[8:11, 8:12] = 0.9
    prob[15:17, 2:5] = 0.9
    bitmap = (prob > 0.2).astype(np.uint8) * 255
    for min_size, n in ((1, 2), (2, 1), (3, 1), (4, 0), (6, 0)):
        ref = jax_db.boxes_from_bitmap(prob, bitmap, 0.4, 1.8, "fast", min_size=min_size)
        got = torch_db.boxes_from_bitmap(prob, bitmap, 0.4, 1.8, "fast", min_size=min_size)
        assert len(ref) == len(got) == n
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("backend", ["native", "auto", "cv2"])
def test_db_postprocess_takes_the_jax_backends(backend):
    """Every backend runs the C++ core here; on a clean map that equals the
    JAX package's answer (its "native" needs ``native/libdbpost.so``,
    which is never built here, so its "auto" and "cv2" both run cv2)."""
    prob = np.zeros((96, 160), np.float32)
    prob[30:50, 40:120] = 0.9
    prob[60:80, 10:70] = 0.7
    prob[10:20, 100:150] = 0.8
    kw = dict(thresh=0.2, box_thresh=0.4, unclip_ratio=1.8, score_mode="fast")
    want = jax_db.DBPostProcess(backend="cv2" if backend == "native" else backend, **kw)(
        prob, 192, 320, 0.5, 0.5)
    got = torch_db.DBPostProcess(backend=backend, **kw)(prob, 192, 320, 0.5, 0.5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    core = torch_db.DBPostProcess(**kw)(prob, 192, 320, 0.5, 0.5)
    assert all(np.array_equal(g, c) for g, c in zip(got, core))


def test_ops_exports_the_jax_names_but_the_greedy_numpy_decoder():
    """Everything ``ppocr_tpu.ops`` exports, the port exports too, the
    greedy numpy decoder included."""
    assert torch_ops.__all__ == jax_ops.__all__
    for name in torch_ops.__all__:
        assert getattr(torch_ops, name) is not None
