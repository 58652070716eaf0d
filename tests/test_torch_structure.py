"""The port's structure postprocess (``ops/structure.py``), its table
resizes (``ops/resize.py``: ``table_resize``, ``table_pad``,
``resize_hw``) and host normalizers (``ops/normalize.py``) against the JAX
package, on the CPU.

Tolerances: every function of ``ops.structure`` exactly equal, on the
cases of ``tests/test_structure.py`` and on random decoder outputs from a
seed; the resizes the same shape and ratio and within one grey level of
the JAX functions' cv2 pixels (``resize_bilinear_u8``'s own tolerance);
the normalizers within 1e-6.

    python tests/test_torch_structure.py --write

rewrites ``ppocr_tpu_torch/assets/host_cases.npz``: small inputs of these
functions and of the DB helpers (``get_mini_boxes``, ``unclip_rect``,
``boxes_from_bitmap``) beside the JAX package's answers, which
``chip_smoke.py`` holds the port to on a machine without cv2 or JAX.
"""

import json
import pathlib
import sys

import cv2
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ppocr_tpu.ops import db_postprocess as jax_db  # noqa: E402
from ppocr_tpu.ops import normalize as jax_norm  # noqa: E402
from ppocr_tpu.ops import resize as jax_resize  # noqa: E402
from ppocr_tpu.ops import structure as jax_structure  # noqa: E402
from ppocr_tpu_torch import assets  # noqa: E402
from ppocr_tpu_torch.ops import normalize as torch_norm  # noqa: E402
from ppocr_tpu_torch.ops import resize as torch_resize  # noqa: E402
from ppocr_tpu_torch.ops import structure as torch_structure  # noqa: E402

LABELS = ["sos", "<thead>", "<tr>", "<td></td>", "<td", ' colspan="2"', "</tr>", "eos"]
LAYOUT_LABELS = ["text", "title", "table"]


def random_table_outputs(rng, b=2, t=14, c=len(LABELS), p=4):
    """Softmax-like structure probs with an eos somewhere, and box
    regressions in [0, 1]."""
    logits = rng.normal(0, 2, (b, t, c)).astype(np.float32)
    for i in range(b):
        logits[i, int(rng.integers(3, t)), c - 1] += 9.0  # an eos
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return probs.astype(np.float32), rng.random((b, t, p)).astype(np.float32)


def random_picodet_outputs(rng, in_hw=(64, 64), strides=(8, 16, 32, 64), reg_max=8):
    cls, reg = [], []
    for s in strides:
        n = int(np.ceil(in_hw[0] / s)) * int(np.ceil(in_hw[1] / s))
        cls.append(rng.random((n, len(LAYOUT_LABELS))).astype(np.float32) ** 3)
        reg.append(rng.normal(0, 2, (n, 4 * reg_max)).astype(np.float32))
    return cls, reg


def layout(boxes):
    return [(b.box, b.type, b.confidence) for b in boxes]


# -- ops.structure ---------------------------------------------------------------


def test_table_decode_on_the_jax_tests_cases():
    labels = ["sos", "<tr>", "<td></td>", "</tr>", "eos"]
    probs = np.zeros((1, 6, 5), np.float32)
    for t, c in enumerate([0, 1, 2, 2, 3, 4]):
        probs[0, t, c] = 0.9
    loc = np.zeros((1, 6, 4), np.float32)
    loc[0, 2] = [0.1, 0.2, 0.5, 0.6]
    loc[0, 3] = [0.5, 0.2, 0.9, 0.6]
    want = jax_structure.table_decode(probs, loc, labels, widths=[100], heights=[50])
    assert torch_structure.table_decode(probs, loc, labels, widths=[100], heights=[50]) == want
    assert want[1][0] == [[10, 10, 50, 30], [50, 10, 90, 30]]
    labels = ["sos", "<tr>", "</tr>", "eos"]
    probs = np.zeros((1, 3, 4), np.float32)
    probs[0, 0, 1] = probs[0, 1, 2] = probs[0, 2, 3] = 0.8
    loc = np.zeros((1, 3, 4), np.float32)
    want = jax_structure.table_decode(probs, loc, labels, [10], [10])
    assert torch_structure.table_decode(probs, loc, labels, [10], [10]) == want
    assert want[2] == [-1.0]


def test_table_decode_on_random_outputs():
    rng = np.random.default_rng(11)
    for _ in range(50):
        probs, loc = random_table_outputs(rng, b=int(rng.integers(1, 4)), t=int(rng.integers(4, 30)))
        widths = rng.integers(1, 1000, len(probs)).tolist()
        heights = rng.integers(1, 1000, len(probs)).tolist()
        want = jax_structure.table_decode(probs, loc, LABELS, widths, heights)
        assert torch_structure.table_decode(probs, loc, LABELS, widths, heights) == want


def test_load_table_labels_keeps_blank_lines_and_strips_cr(tmp_path):
    path = tmp_path / "table_dict.txt"
    path.write_bytes(b"<thead>\r\n\r\n<tr>\n<td>\n<td\n</tr>\n")
    for merge in (True, False):
        want = jax_structure.load_table_labels(str(path), merge)
        assert torch_structure.load_table_labels(str(path), merge) == want
    assert "" in want and "<td>" in want


def test_dis_pred_to_bbox_and_hard_nms_on_random_inputs():
    rng = np.random.default_rng(12)
    for _ in range(200):
        pred = rng.normal(0, 3, 32).astype(np.float32)
        args = (int(rng.integers(0, 8)), int(rng.integers(0, 8)), int(rng.choice([8, 16, 32])), 64, 96, 8)
        assert torch_structure.dis_pred_to_bbox(pred, *args) == jax_structure.dis_pred_to_bbox(pred, *args)
    for _ in range(30):
        boxes = []
        for _ in range(int(rng.integers(0, 12))):
            x, y = rng.uniform(0, 50, 2)
            w, h = rng.uniform(0, 30, 2)
            boxes.append((float(x), float(y), float(x + w), float(y + h), float(rng.random())))
        make = lambda cls: [cls([a, b, c, d], "text", s) for a, b, c, d, s in boxes]  # noqa: E731
        thr = float(rng.uniform(0.1, 0.9))
        want = layout(jax_structure.hard_nms(make(jax_structure.LayoutBox), thr))
        assert layout(torch_structure.hard_nms(make(torch_structure.LayoutBox), thr)) == want


def test_picodet_decode_on_the_jax_tests_case():
    cls = np.zeros((64, 2), np.float32)
    cls[9, 1] = 0.95
    reg = np.full((64, 32), -10.0, np.float32)
    for side in range(4):
        reg[9, side * 8 + 1] = 10.0
    kw = dict(ori_shape=(128, 128), resize_shape=(64, 64), fpn_stride=(8,), score_threshold=0.4, reg_max=8)
    want = layout(jax_structure.picodet_decode([cls], [reg], ["text", "table"], **kw))
    assert layout(torch_structure.picodet_decode([cls], [reg], ["text", "table"], **kw)) == want
    assert len(want) == 1 and want[0][1] == "table"


def test_picodet_decode_on_random_outputs():
    rng = np.random.default_rng(13)
    n_boxes = 0
    for _ in range(10):
        cls, reg = random_picodet_outputs(rng)
        ori = (int(rng.integers(32, 400)), int(rng.integers(32, 400)))
        kw = dict(ori_shape=ori, resize_shape=(64, 64), score_threshold=float(rng.uniform(0.2, 0.6)),
                  nms_threshold=float(rng.uniform(0.2, 0.7)))
        want = layout(jax_structure.picodet_decode(cls, reg, LAYOUT_LABELS, **kw))
        assert layout(torch_structure.picodet_decode(cls, reg, LAYOUT_LABELS, **kw)) == want
        n_boxes += len(want)
    assert n_boxes > 20


# -- table resizes and normalizers ------------------------------------------------


def smooth_image(rng, shape):
    """An image with gradients and noise (not flat: the resize taps show)."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 60 * np.sin(xx / 3.0) * np.cos(yy / 5.0)
    img = base.reshape(shape[:2] + (1,) * (len(shape) - 2)) + rng.normal(0, 25, shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(30, 50, 3), (50, 30, 3), (200, 77), (13, 640, 3), (600, 600, 4), (1, 1, 3)])
@pytest.mark.parametrize("max_len", [64, 488])
def test_table_resize_and_pad_within_one_grey_level_of_cv2(shape, max_len):
    img = smooth_image(np.random.default_rng(shape[0] + max_len), shape)
    want, want_ratio = jax_resize.table_resize(img, max_len)
    got, got_ratio = torch_resize.table_resize(img, max_len)
    assert got.shape == want.shape and got_ratio == want_ratio
    assert np.abs(got.astype(int) - want).max() <= 1
    padded = torch_resize.table_pad(got, max_len)
    assert padded.shape == jax_resize.table_pad(want, max_len).shape
    np.testing.assert_array_equal(padded[: got.shape[0], : got.shape[1]], got)
    assert padded.sum() == got.astype(np.int64).sum()  # zeros below and to the right


def test_resize_hw_within_one_grey_level_of_cv2():
    rng = np.random.default_rng(5)
    for shape, (h, w) in [((40, 60, 3), (20, 90)), ((40, 60), (41, 59)), ((100, 30, 3), (7, 300))]:
        img = smooth_image(rng, shape)
        want, got = jax_resize.resize_hw(img, h, w), torch_resize.resize_hw(img, h, w)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1


def test_what_cv2_refuses_raises():
    img = np.zeros((500, 300, 3), np.uint8)
    with pytest.raises(cv2.error):
        jax_resize.table_pad(img, 488)  # a negative border
    with pytest.raises(ValueError, match="does not fit"):
        torch_resize.table_pad(img, 488)
    thin = np.zeros((1000, 2, 3), np.uint8)  # its width rounds to 0
    with pytest.raises(cv2.error):
        jax_resize.table_resize(thin)
    with pytest.raises(ValueError, match="empty"):
        torch_resize.table_resize(thin)
    with pytest.raises(ValueError, match="empty"):
        torch_resize.resize_hw(img, 0, 5)


def test_normalizers_within_1e_6():
    rng = np.random.default_rng(6)
    for img in (rng.integers(0, 256, (17, 23, 3), dtype=np.uint8), rng.random((8, 9, 3)) * 255):
        want = jax_norm.normalize_imagenet_np(img)
        got = torch_norm.normalize_imagenet_np(img)
        assert got.dtype == np.float32 and got.shape == want.shape and got.flags.c_contiguous
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        mean, scale = (0.5, 0.4, 0.3), (2.0, 3.0, 1.5)
        np.testing.assert_allclose(torch_norm.normalize_chw_np(img, mean, scale),
                                   jax_norm.normalize_chw_np(img, mean, scale), rtol=0, atol=1e-6)


# -- the committed host cases ---------------------------------------------------------


def blob_map(rng, h=64, w=96, n_blobs=5):
    """Rectangles of constant probability, some rotated by a shear of rows."""
    prob = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        bw, bh = int(rng.integers(3, 40)), int(rng.integers(2, 14))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        shift = float(rng.uniform(-0.4, 0.4))
        for r in range(bh):
            x0 = min(max(int(x + shift * r), 0), w - bw)
            prob[y + r, x0 : x0 + bw] = np.float32(rng.uniform(0.5, 0.95))
    return prob


def host_cases() -> dict:
    """Inputs of the host utilities and the JAX package's answers."""
    rng = np.random.default_rng(2024)
    probs, loc = random_table_outputs(rng, b=3, t=16)
    widths, heights = [480, 320, 96], [200, 488, 64]
    cls, reg = random_picodet_outputs(rng)
    table_img = smooth_image(rng, (30, 50, 3))
    norm_img = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    prob = blob_map(rng)
    bitmap = ((prob * 255).astype(np.uint8) > int(0.2 * 255)).astype(np.uint8) * 255
    rects = np.concatenate([rng.uniform(0, 300, (300, 2)), rng.uniform(1, 90, (300, 2)),
                            rng.uniform(-90, 90, (300, 1))], 1).astype(np.float32)
    rects[::4, 4] = rng.choice([0.0, 90.0, -90.0, 45.0], len(rects[::4]))
    quads = np.stack([jax_db.get_mini_boxes(((r[0], r[1]), (r[2], r[3]), r[4]))[0] for r in rects])

    resized, ratio = jax_resize.table_resize(table_img, 64)
    unclipped, unclip_none = [], []
    for q in quads:
        rect = jax_db.unclip_rect(q, 1.8)
        unclip_none.append(rect is None)
        unclipped.append(np.zeros((4, 2), np.float32) if rect is None else jax_db.get_mini_boxes(rect)[0])
    mini = [jax_db.get_mini_boxes(((r[0], r[1]), (r[2], r[3]), r[4])) for r in rects]
    answers = {
        "table": jax_structure.table_decode(probs, loc, LABELS, widths, heights),
        "picodet": layout(jax_structure.picodet_decode(cls, reg, LAYOUT_LABELS, ori_shape=(96, 128),
                                                       resize_shape=(64, 64), score_threshold=0.3)),
        "table_ratio": ratio,
        "boxes": {str(m): [b.tolist() for b in jax_db.boxes_from_bitmap(prob, bitmap, 0.4, 1.8, "fast",
                                                                        min_size=m)]
                  for m in (1, 3, 6)},
        "mini_ssid": [s for _, s in mini],
        "labels": LABELS, "layout_labels": LAYOUT_LABELS, "widths": widths, "heights": heights,
    }
    return {
        "answers": np.array(json.dumps(answers)),
        "table_probs": probs, "table_loc": loc,
        **{f"picodet_cls{i}": c for i, c in enumerate(cls)},
        **{f"picodet_reg{i}": r for i, r in enumerate(reg)},
        "table_img": table_img, "table_resized": resized, "table_padded": jax_resize.table_pad(resized, 64),
        "norm_img": norm_img, "norm_out": jax_norm.normalize_imagenet_np(norm_img),
        "db_prob": prob, "db_bitmap": bitmap,
        "rects": rects, "mini_boxes": np.stack([b for b, _ in mini]),
        "quads": quads, "unclipped": np.stack(unclipped), "unclip_none": np.array(unclip_none),
    }


def test_the_committed_host_cases_are_the_jax_answers():
    stored = assets.load_host_cases()
    fresh = host_cases()
    assert sorted(stored) == sorted(fresh)
    for k, v in fresh.items():
        if k == "answers":
            assert json.loads(str(stored[k])) == json.loads(str(v))
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    assert assets.HOST_CASES.stat().st_size < 100_000


def test_the_port_gives_the_committed_answers():
    """What ``chip_smoke.py`` checks on the card's machine, here."""
    from ppocr_tpu_torch.ops import db_postprocess as torch_db

    c = assets.load_host_cases()
    ans = json.loads(str(c["answers"]))
    tags, boxes, scores = torch_structure.table_decode(c["table_probs"], c["table_loc"], ans["labels"],
                                                       ans["widths"], ans["heights"])
    assert [tags, boxes, scores] == ans["table"]
    cls = [c[f"picodet_cls{i}"] for i in range(4)]
    reg = [c[f"picodet_reg{i}"] for i in range(4)]
    got = torch_structure.picodet_decode(cls, reg, ans["layout_labels"], ori_shape=(96, 128),
                                         resize_shape=(64, 64), score_threshold=0.3)
    assert [[b.box, b.type, b.confidence] for b in got] == ans["picodet"]
    resized, ratio = torch_resize.table_resize(c["table_img"], 64)
    assert ratio == ans["table_ratio"] and resized.shape == c["table_resized"].shape
    assert np.abs(resized.astype(int) - c["table_resized"]).max() <= 1
    assert torch_resize.table_pad(resized, 64).shape == c["table_padded"].shape
    np.testing.assert_allclose(torch_norm.normalize_imagenet_np(c["norm_img"]), c["norm_out"], atol=1e-6, rtol=0)
    for r, want, ssid in zip(c["rects"], c["mini_boxes"], ans["mini_ssid"]):
        got, got_ssid = torch_db.get_mini_boxes(((r[0], r[1]), (r[2], r[3]), r[4]))
        np.testing.assert_array_equal(got, want)
        assert got_ssid == ssid
    close = 0
    for q, want, none in zip(c["quads"], c["unclipped"], c["unclip_none"]):
        rect = torch_db.unclip_rect(q, 1.8)
        assert (rect is None) == bool(none)
        if rect is not None:
            err = np.abs(torch_db.get_mini_boxes(rect)[0] - want).max()
            assert err <= 2
            close += err <= 1e-4
    assert close >= 0.99 * (~c["unclip_none"]).sum()
    for min_size, want in ans["boxes"].items():
        got = torch_db.boxes_from_bitmap(c["db_prob"], c["db_bitmap"], 0.4, 1.8, "fast",
                                         min_size=int(min_size))
        assert abs(len(got) - len(want)) <= 1
        near = sum(any(np.abs(np.sort(g, 0) - np.sort(np.array(w), 0)).max() <= 2 for g in got) for w in want)
        assert near >= 0.9 * len(want)


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        np.savez_compressed(assets.HOST_CASES, **host_cases())
        print(f"wrote {assets.HOST_CASES} ({assets.HOST_CASES.stat().st_size} bytes)")
    else:
        print(__doc__)
