"""Every option of the port's fused path against the JAX package on CPU,
f32: the 2×2 dilation, the rotated sweep, ``rot180`` and scaled crop
sampling, beam decode, and the fused step and the worker's words for each
of ``enable_cls``, ``det.use_dilation``, ``fused_rotated_boxes``,
``fused_crop_src_mult=2``, ``rec.decode="beam"`` and for cls + rotated + m×
together. Tolerances as in ``test_torch_fused.py``: exact, except scores
and CTC probs (rtol 1e-4), crop pixels (atol 1e-3 on 0..255), the sweep's
theta/u/v (1e-4) and rotated quads (1 px: ``cos`` and ``sin`` differ in the
last ulp between XLA and PyTorch, and a corner at x.5 then rounds the other
way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppocr_tpu.ops import ctc as jax_ctc
from ppocr_tpu.pipeline import OCRWorker as JaxWorker
from ppocr_tpu.pipeline import fused as JF
from ppocr_tpu_torch.ops import ctc as torch_ctc
from ppocr_tpu_torch.ops import resize as torch_resize
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig
from ppocr_tpu_torch.pipeline import fused as TF

from test_torch_fused import (  # noqa: F401  (fixtures)
    CONF_TOL,
    _canvas_batch,
    few_torch_threads,
    goldens,
    model_dir,
    option_engines,
    parity_scenes,
)
from test_torch_goldens import MIN_CLS_MARGIN, OPTIONS, assert_words_match

SWEEP_ATOL = 1e-4
QUAD_TOL = 1  # px
# every option alone, and cls + rotated + the 2× crop source together
OPTION_SETS = [(o,) for o in OPTIONS] + [("cls", "rotated", "srcx2")]
OPTION_IDS = ["+".join(o) for o in OPTION_SETS]


def test_dilate2x2_equals_jax():
    fg = np.random.default_rng(6).random((3, 17, 23)) < 0.2
    fg[0, 0, 0] = fg[1, -1, -1] = True
    got = TF._dilate2x2(torch.from_numpy(fg)).numpy()
    want = np.stack([np.asarray(JF._dilate2x2(jnp.asarray(f))) for f in fg])
    np.testing.assert_array_equal(got, want)
    # ink spreads down and to the right
    one = np.zeros((1, 4, 4), bool)
    one[0, 1, 1] = True
    ys, xs = TF._dilate2x2(torch.from_numpy(one)).numpy()[0].nonzero()
    assert (ys.tolist(), xs.tolist()) == ([1, 1, 2, 2], [1, 2, 1, 2])


def _rotated_blob_maps():
    """Blobs the angle sweep must handle: tilted bars, an exact axis
    rectangle (equal area at the sweep's first and last angles), a one-row
    and a one-pixel-wide blob, a square."""
    h, w = 64, 96
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    maps = []
    for angle, (cy, cx), (hl, hw) in (
        (17.0, (20, 30), (18, 4)),
        (63.0, (40, 70), (16, 3)),
        (-8.0, (50, 25), (20, 3)),
    ):
        t = np.deg2rad(angle)
        u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
        v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
        maps.append((np.abs(u) <= hl) & (np.abs(v) <= hw))
    a = np.logical_or.reduce(maps)
    b = np.zeros((h, w), bool)
    b[5:15, 10:50] = True  # axis rectangle
    b[30, 5:40] = True  # one row: v extent 0
    b[35:60, 80] = True  # one column
    b[40:50, 40:50] = True  # square
    return np.stack([a, b])


def test_rotated_blob_stats_equal_jax():
    fg = _rotated_blob_maps()
    prob = np.random.default_rng(7).random(fg.shape).astype(np.float32)
    labels = TF._connected_components(torch.from_numpy(fg))
    got = TF._blob_stats(labels, torch.from_numpy(prob), max_boxes=6, rotated=True)
    bs = jax.jit(lambda l, p: JF._blob_stats(l, p, max_boxes=6, rotated=True))
    for b in range(fg.shape[0]):
        want = bs(jnp.asarray(labels[b].numpy()), jnp.asarray(prob[b]))
        for name in ("area", "x0", "x1", "y0", "y1", "root"):
            np.testing.assert_array_equal(got[name][b].numpy(), np.asarray(want[name]), err_msg=name)
        live = np.asarray(want["area"]) > 0  # empty slots hold sentinels
        assert live.sum() >= 3
        for name in ("theta", "u0", "u1", "v0", "v1"):
            np.testing.assert_allclose(
                got[name][b].numpy()[live], np.asarray(want[name])[live],
                atol=SWEEP_ATOL, rtol=0, err_msg=name,
            )
    # the axis rectangle keeps the sweep's first angle, the one-row blob
    # has no extent across its row
    roots = got["root"][1].tolist()
    rect, row = roots.index(5 * 96 + 10), roots.index(30 * 96 + 5)
    assert float(got["theta"][1, rect]) == 0.0
    assert float(got["theta"][1, row]) == 0.0
    assert float(got["v1"][1, row] - got["v0"][1, row]) == 0.0


def test_first_argmin_takes_the_first_of_equal_minima():
    x = torch.tensor([[3.0, 1.0, 5.0], [1.0, 1.0, 5.0], [1.0, 0.5, 5.0]])
    assert TF._first_argmin(x).tolist() == [1, 2, 0]
    assert TF._first_argmin(x).tolist() == np.argmin(x.numpy(), axis=0).tolist()


def _crop_case():
    rng = np.random.default_rng(8)
    b, k = 2, 5
    x0 = rng.uniform(0, 30, (b, k)).astype(np.float32)
    y0 = rng.uniform(0, 20, (b, k)).astype(np.float32)
    x1 = (x0 + rng.uniform(1, 29, (b, k))).astype(np.float32)
    y1 = (y0 + rng.uniform(1, 19, (b, k))).astype(np.float32)
    cw = np.ceil(16 * (x1 - x0 + 1) / (y1 - y0 + 1)).clip(max=64).astype(np.float32)
    rot = rng.random((b, k)) < 0.5
    rot[0, :2] = (True, False)
    return rng, x0, y0, x1, y1, cw, rot


@pytest.mark.parametrize("scale", [1, 2])
def test_crop_resize_with_rot180_and_scale_matches_jax(scale):
    rng, x0, y0, x1, y1, cw, rot = _crop_case()
    img = rng.integers(0, 256, (2, 40 * scale, 60 * scale, 3)).astype(np.float32)
    got = TF._crop_resize_bilinear(
        torch.from_numpy(img), *(torch.from_numpy(a) for a in (x0, y0, x1, y1, cw)), 16, 64,
        rot180=torch.from_numpy(rot), scale=float(scale),
    ).numpy()
    crop = jax.jit(
        jax.vmap(jax.vmap(
            lambda im, a, bb, c, d, w, r: JF._crop_resize_bilinear(
                im, a, bb, c, d, w, 16, 64, rot180=r, scale=float(scale)),
            in_axes=(None, 0, 0, 0, 0, 0, 0)))
    )
    want = np.asarray(crop(img, x0, y0, x1, y1, cw, rot))
    assert got.shape == want.shape == (2, 5, 16, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_rot180_sampling_equals_rotating_the_crop():
    """A mirrored grid samples what ``torch.rot90(crop, 2)`` of the
    unrotated content holds; the padding stays right and black."""
    rng, x0, y0, x1, y1, cw, _ = _crop_case()
    img = torch.from_numpy(rng.random((2, 40, 60, 3)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (x0, y0, x1, y1, cw)]
    plain = TF._crop_resize_bilinear(img, *args, 16, 64)
    mirrored = TF._crop_resize_bilinear(img, *args, 16, 64, rot180=torch.ones(2, 5, dtype=torch.bool))
    for b in range(2):
        for k in range(5):
            n = int(cw[b, k])
            want = torch.rot90(plain[b, k, :, :n], 2, dims=(0, 1))
            np.testing.assert_allclose(mirrored[b, k, :, :n].numpy(), want.numpy(), atol=1e-5)
            assert float(mirrored[b, k, :, n:].abs().max()) == 0.0 if n < 64 else True


def _lattice(rng, n=3, t=12, v=40, peaked=True):
    logits = rng.normal(size=(n, t, v)).astype(np.float32) * (3.0 if peaked else 1.0)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_ctc_beam_topk_device_equals_jax():
    probs = _lattice(np.random.default_rng(9))
    got = torch_ctc.ctc_beam_topk_device(torch.from_numpy(probs), 5)
    want = jax_ctc.ctc_beam_topk_device(jnp.asarray(probs), 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].dtype == torch.int32 and (got[0].numpy() != 0).all()  # blank never a candidate


def test_ctc_beam_topk_device_orders_ties_by_index():
    """Equal probabilities inside the k kept candidates come back in index
    order, as ``lax.top_k`` gives them (a tie at the k-th place is the one
    case the port does not promise)."""
    probs = np.full((1, 2, 12), 0.01, np.float32)
    probs[0, 0, [7, 3, 9]] = 0.2  # a three-way tie on top
    probs[0, 0, 5] = 0.1
    probs[0, 0, 2] = 0.05
    probs[0, 1, [4, 1]] = (0.3, 0.3)
    probs[0, 1, [8, 6, 10]] = (0.1, 0.09, 0.08)
    got = torch_ctc.ctc_beam_topk_device(torch.from_numpy(probs), 5)
    want = jax_ctc.ctc_beam_topk_device(jnp.asarray(probs), 5)
    assert got[0][0].tolist() == [[3, 7, 9, 5, 2], [1, 4, 8, 6, 10]]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("peaked", [True, False], ids=["peaked", "flat"])
def test_ctc_beam_search_equals_jax(peaked):
    probs = _lattice(np.random.default_rng(10), peaked=peaked)
    idx, val, blank = (np.asarray(a) for a in jax_ctc.ctc_beam_topk_device(jnp.asarray(probs), 5))
    blank = blank.copy()
    blank[0] = 1.0  # an all-blank row: empty prefix, NaN confidence
    val = val.copy()
    val[0] = 0.0
    got_k, got_c = torch_ctc.ctc_beam_search(idx, val, blank, beam_size=4)
    want_k, want_c = jax_ctc.ctc_beam_search(idx, val, blank, beam_size=4)
    np.testing.assert_array_equal(got_c, want_c)
    assert np.isnan(got_c[0]) and len(got_k[0]) == 0
    for g, w in zip(got_k, want_k):
        np.testing.assert_array_equal(g, w)


def test_order_points_clockwise_equals_jax():
    from ppocr_tpu.ops.db_postprocess import order_points_clockwise as jax_order
    from ppocr_tpu_torch.ops import order_points_clockwise

    rng = np.random.default_rng(11)
    for _ in range(20):
        pts = rng.integers(0, 50, (4, 2))
        np.testing.assert_array_equal(order_points_clockwise(pts), jax_order(pts))
    tie = np.array([[5, 9], [5, 2], [20, 2], [20, 9]])  # equal x within each pair
    np.testing.assert_array_equal(order_points_clockwise(tie), jax_order(tie))


def _jax_step_outputs(jax_eng, scenes):
    """The JAX fused step's outputs for ``scenes`` as one batch, with the
    m× crop source when the config asks for one."""
    cfg = jax_eng.config
    batch, content = _canvas_batch(scenes, cfg)
    fused = jax_eng.fused_ocr()
    args = [batch, content]
    src = None
    m = cfg.fused_crop_src_mult
    if m > 1:
        import cv2

        src = np.zeros((batch.shape[0], batch.shape[1] * m, batch.shape[2] * m, 3), np.uint8)
        for j, (scene, (rh, rw)) in enumerate(zip(scenes, content)):
            src[j, : rh * m, : rw * m] = cv2.resize(
                scene, (int(rw) * m, int(rh) * m), interpolation=cv2.INTER_LINEAR
            )
        args.append(src)
    want = jax.device_get(
        fused._step(jax_eng.det_params, jax_eng.rec_params, fused._cls_params(), *args)
    )
    return batch, content, src, want


@pytest.mark.parametrize("options", OPTION_SETS, ids=OPTION_IDS)
def test_fused_step_outputs_match_jax_for_each_option(option_engines, parity_scenes, options):
    jax_eng, torch_eng = option_engines(options)
    batch, content, src, want = _jax_step_outputs(jax_eng, parity_scenes[:2])
    got = torch_eng.fused_ocr().run_step(batch, content, src)
    rotated = "rotated" in options
    for name in ("valid", "ctc_idx", "roots"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("boxes", "quads"):
        np.testing.assert_allclose(
            getattr(got, name), np.asarray(getattr(want, name)),
            atol=QUAD_TOL if rotated else 0, rtol=0, err_msg=name,
        )
    for name in ("scores", "ctc_prob") + (("ctc_blank",) if "beam" in options else ()):
        np.testing.assert_allclose(
            getattr(got, name), np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-5, err_msg=name
        )
    if "beam" in options:
        assert got.ctc_idx.ndim == 4 and got.ctc_blank.shape == got.ctc_idx.shape[:3]
    else:
        assert got.ctc_blank is None and want.ctc_blank is None
    assert got.valid.sum() >= 6


@pytest.mark.parametrize("options", OPTION_SETS, ids=OPTION_IDS)
def test_worker_matches_jax_worker_for_each_option(option_engines, parity_scenes, goldens, options):
    jax_eng, torch_eng = option_engines(options)
    jw, tw = JaxWorker(jax_eng, 0), OCRWorker(torch_eng, 0)
    box_tol = QUAD_TOL if "rotated" in options else 0
    golden = goldens["words"].get("small+" + options[0]) if len(options) == 1 else None
    for i, scene in enumerate(parity_scenes):
        want, got = jw.process(scene, i), tw.process(scene, i)
        assert got["success"], got
        assert set(got) == set(want)
        assert len(got["words"]) >= 2
        assert_words_match(got["words"], want["words"], CONF_TOL, box_tol)
        if golden is not None:
            assert_words_match(got["words"], golden[i], CONF_TOL, box_tol)


def test_the_options_change_the_response(goldens):
    """Each option's golden differs from the base config's somewhere, so
    the cases above cannot pass by ignoring the option. (Beam search may
    read these clean scenes exactly as greedy does: its confidences are a
    different quantity, and they differ.)"""
    base = goldens["words"]["small"]
    for o in OPTIONS:
        assert goldens["words"][f"small+{o}"] != base, o


def test_cls_margins_match_the_goldens(option_engines, parity_scenes, goldens, monkeypatch):
    """The port's in-graph cls gives the golden |p1 − p0| of every valid
    crop, all of them far from a flip, and rotates the crops the JAX
    package rotates."""
    _, torch_eng = option_engines(("cls",))
    kept = []
    forward = TF.cls_forward

    def keeping(model, x):
        kept.append(forward(model, x))
        return kept[-1]

    monkeypatch.setattr(TF, "cls_forward", keeping)
    fused = TF.FusedOCR(torch_eng, max_boxes=torch_eng.config.fused_max_boxes)
    for scene, want in zip(parity_scenes, goldens["cls_margins"]):
        batch, content = _canvas_batch([scene], torch_eng.config)
        out = fused.run_step(batch, content)
        probs = kept.pop().numpy()[out.valid[0]]
        got = np.abs(probs[:, 1] - probs[:, 0])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        assert got.min() >= MIN_CLS_MARGIN


def test_cls_crops_pad_after_normalizing_and_rec_crops_before(option_engines, parity_scenes, monkeypatch):
    """A padded cls column is 0.0; a padded rec column is (0/255 − 0.5)/0.5
    = −1."""
    _, torch_eng = option_engines(("cls",))
    seen = {}
    cls_forward, rec_forward = TF.cls_forward, TF.rec_forward
    monkeypatch.setattr(TF, "cls_forward", lambda m, x: (seen.setdefault("cls", x), cls_forward(m, x))[1])
    monkeypatch.setattr(TF, "rec_forward", lambda m, x: (seen.setdefault("rec", x), rec_forward(m, x))[1])
    fused = TF.FusedOCR(torch_eng, max_boxes=torch_eng.config.fused_max_boxes)
    batch, content = _canvas_batch(parity_scenes[:1], torch_eng.config)
    out = fused.run_step(batch, content)
    assert out.valid[0, 0]
    assert float(seen["cls"][0, :, -1].abs().max()) == 0.0  # slot 0 is narrower than 192
    assert float(seen["rec"][0, :, -1].max()) == -1.0 == float(seen["rec"][0, :, -1].min())


def test_src_mult_source_comes_from_the_original_image(option_engines, monkeypatch):
    """The 2× crop source is resized from the request's image (not from the
    det canvas) and lands at [: rh·m, : rw·m] of a zero canvas."""
    _, torch_eng = option_engines(("srcx2",))
    fused = TF.FusedOCR(torch_eng, max_boxes=torch_eng.config.fused_max_boxes)
    rng = np.random.default_rng(12)
    image = rng.integers(0, 256, (150, 260, 3)).astype(np.uint8)  # det: 64×96 in a 64×96 canvas
    seen = {}
    dispatch = fused._dispatch
    monkeypatch.setattr(
        fused, "_dispatch", lambda b, c, s=None: (seen.update(batch=b, content=c, src=s), dispatch(b, c, s))[1]
    )
    assert fused.process(image, 0)["success"]
    rh, rw = seen["content"][0]
    assert seen["src"].shape == (1, 2 * seen["batch"].shape[1], 2 * seen["batch"].shape[2], 3)
    want = torch_resize.resize_bilinear_u8(image, 2 * rw, 2 * rh)
    np.testing.assert_array_equal(seen["src"][0, : 2 * rh, : 2 * rw], want)
    assert seen["src"][0, 2 * rh :].max(initial=0) == 0 and seen["src"][0, :, 2 * rw :].max(initial=0) == 0
    from_canvas = torch_resize.resize_bilinear_u8(seen["batch"][0, :rh, :rw], 2 * rw, 2 * rh)
    assert np.abs(want.astype(int) - from_canvas).max() > 8  # not an upsampled canvas


def test_blob_kernel_is_off_with_rotated_boxes(model_dir, goldens):
    cfg = PipelineConfig.from_dict(goldens["configs"]["small"])
    cfg.fused_blob_kernel = True
    eng = OCREngine(model_dir, cfg, device="cpu")
    assert TF.fused_part_kwargs(eng, 8)["blob_kernel"] is True
    cfg.fused_rotated_boxes = True
    assert TF.fused_part_kwargs(eng, 8)["blob_kernel"] is False


def test_enable_cls_without_cls_weights_raises(model_dir):
    cfg = PipelineConfig.serving()
    cfg.enable_cls = True
    with pytest.raises(FileNotFoundError, match="cls/weights.npz"):
        OCREngine(model_dir, cfg, device="cpu")


