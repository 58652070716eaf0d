"""The port's training path (``ppocr_tpu_torch.train``) against the JAX
package's on the same numpy inputs, on the CPU.

Held: the numpy inits draw for draw; the JAX-layout carry in both
directions; optax's CTC loss, infeasible rows included; every leaf's
gradient of the rec CTC loss and the det balanced BCE (BN mean and var
among them); three AdamW updates under optax's cosine schedule;
``finetune_rec`` end to end (the exported weights and charset, and the
texts the bundle reads in both engines); save, restore and resume; the
dataset's skip rules. Tolerances are stated where they are used.
"""

import copy
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ppocr_tpu.models import det_db as JD
from ppocr_tpu.models import rec_svtr as JR
from ppocr_tpu.parallel import make_mesh
from ppocr_tpu.pipeline import OCREngine as JaxEngine
from ppocr_tpu.pipeline import OCRWorker as JaxWorker
from ppocr_tpu.train import finetune as JF
from ppocr_tpu.train import trainer as JT
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.models import (
    det_from_jax,
    det_to_jax,
    init_det_params,
    init_rec_params,
    rec_from_jax,
    rec_to_jax,
    set_trainable,
)
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker, PipelineConfig
from ppocr_tpu_torch.pipeline.charset import load_charset
from ppocr_tpu_torch.train import finetune as TF
from ppocr_tpu_torch.train import trainer as TT
from ppocr_tpu_torch.utils import imcodec
from ppocr_tpu_torch.utils.checkpoint import (
    load_params_npz,
    restore_train_state,
    save_train_state,
)

from test_torch_goldens import few_torch_threads, jax_config  # noqa: F401  (fixture)

# Gradients: f32 on both sides, summed in another order through ~60
# layers. An element that is a small difference of large terms (a bias's
# sum over N·H·W) keeps the large terms' absolute error, so besides rtol
# 1e-4 an element may be off by 1e-4 of its leaf's largest gradient (and
# by 1e-6 anywhere; worst seen 1.7e-5 of the leaf, the rec's
# blocks[5].dw.b). A one-element leaf (a ``Lab`` scalar) is the sum over a
# whole activation map, 10^4–10^5 terms of both signs: rtol 1e-3 there
# (worst seen 2.15e-4, the rec's blocks[3].pw.lab2.b).
GRAD_RTOL, GRAD_ATOL, GRAD_LEAF_ATOL, GRAD_SCALAR_RTOL = 1e-4, 1e-6, 1e-4, 1e-3
# A label with no alignment in T frames: optax's forward variables sit near
# k·log_epsilon = −k·1e5, where f32 values are 2^-7 apart, so its own
# gradient of such a row carries relative errors up to ~2^-7 and the port's
# copy of the recursion rounds elsewhere (0.69 % seen). Held 4× looser.
INFEASIBLE_GRAD_RTOL = 4 * 2.0**-7
CPU = "cpu"


def leaves(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}, treedef


def assert_trees_close(got, want, rtol, atol, what=""):
    g, gdef = leaves(got)
    w, wdef = leaves(want)
    assert gdef == wdef, what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def assert_grads_close(got, want, what):
    """Gradient trees, at the tolerances ``GRAD_*`` above."""
    g, gdef = leaves(got)
    w, wdef = leaves(want)
    assert gdef == wdef, what
    for k in w:
        rtol = GRAD_SCALAR_RTOL if w[k].size == 1 else GRAD_RTOL
        atol = max(GRAD_ATOL, GRAD_LEAF_ATOL * float(np.abs(w[k]).max(initial=0.0)))
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def assert_adam_close(got, want, lr_sum, what):
    """Parameters after AdamW updates whose rates sum to ``lr_sum``. Adam
    divides each gradient element by its own running magnitude, so an
    element whose gradient is rounding noise (true value ~0) moves by up
    to the rate per update, in either direction, in each package alike.
    So can one whose gradient is under the two packages' agreement
    (``GRAD_LEAF_ATOL`` of its leaf's largest). Every element is held
    within 2·``lr_sum``, and all but 1 in 10^3 within rtol 1e-4 / atol
    2e-6 (seen: 1.05 in 10^4 after ``finetune_rec``'s 3 updates)."""
    g, gdef = leaves(got)
    w, wdef = leaves(want)
    assert gdef == wdef, what
    n = off = 0
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max(initial=0.0) <= 2 * lr_sum, f"{what} {k}: {d.max()}"
        off += int((d > 2e-6 + 1e-4 * np.abs(w[k])).sum())
        n += d.size
    assert off <= n * 1e-3, f"{what}: {off} of {n} elements differ"


def grad_tree(model, to_jax):
    """The ``.grad`` of every parameter, as a tree in the JAX layout."""
    g = copy.deepcopy(model)
    for p, q in zip(model.parameters(), g.parameters()):
        assert p.grad is not None
        q.data = p.grad.detach().clone()
    return to_jax(g)


@pytest.fixture(scope="module")
def jumbo():
    return load_params_npz(str(assets.WEIGHTS / "rec_scene_jumbo.npz"))


@pytest.fixture(scope="module")
def crops():
    """The committed JPEG crops of the serving scenes' golden words, decoded
    by the port, with their texts."""
    cases, texts = assets.load_jpeg_cases()
    imgs = [imcodec.decode_image(cases[f"crop{i}"][0]) for i in range(len(texts))]
    return imgs, texts


def rec_batch(crops, classes, width=64, n=4, seed=0):
    """Crops resized to 48×``width`` (T = width / 8), labels made from a
    seed: row 0 holds a repeated label, the rows after it are padded
    short, the last row has more labels than frames (no CTC alignment)."""
    from ppocr_tpu_torch.ops.resize import crnn_resize

    imgs, _ = crops
    t = width // 8
    x = np.stack([crnn_resize(imgs[i % len(imgs)], width / 48, (3, 48, width))
                  for i in range(n)])
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, len(classes), (n, t + 1)).astype(np.int32)
    pads = np.zeros((n, t + 1), np.float32)
    labels[0, 1] = labels[0, 2]
    pads[0, 4:] = 1.0
    pads[1:n - 1, 2:] = 1.0  # the rows between: padded short
    labels = np.where(pads > 0, 0, labels).astype(np.int32)
    images = ((x.astype(np.float32) / 255.0 - 0.5) * 2.0).astype(np.float32)
    return {"images": images, "labels": labels, "label_paddings": pads}


# -- inits and the layout carry -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("which", ["rec", "det"])
def test_inits_equal_the_jax_packages_bit_for_bit(which, seed):
    port, ref = {"rec": (init_rec_params, JR.init_rec_params),
                 "det": (init_det_params, JD.init_det_params)}[which]
    got, want = leaves(port(seed)), leaves(ref(seed))
    assert got[1] == want[1]
    for k, v in want[0].items():
        assert got[0][k].dtype == v.dtype and np.array_equal(got[0][k], v), k


@pytest.mark.parametrize("which", ["rec-init", "rec-jumbo", "det-init", "det-trained"])
def test_to_jax_undoes_from_jax_exactly(which, jumbo):
    tree = {
        "rec-init": lambda: init_rec_params(3),
        "rec-jumbo": lambda: jumbo,
        "det-init": lambda: init_det_params(3),
        "det-trained": lambda: load_params_npz(str(assets.WEIGHTS / "det_synthetic_text.npz")),
    }[which]()
    to_jax, from_jax = (rec_to_jax, rec_from_jax) if which.startswith("rec") else (
        det_to_jax, det_from_jax)
    back = to_jax(from_jax(tree))
    assert_trees_close(back, tree, 0, 0, which)


def test_to_jax_reads_every_parameter_once():
    model = rec_from_jax(init_rec_params(0))
    model.extra = torch.nn.Parameter(torch.zeros(1))
    with pytest.raises(ValueError, match="not carried out"):
        rec_to_jax(model)


def test_set_trainable_switches_every_parameter():
    model = det_from_jax(init_det_params(0))
    assert not any(p.requires_grad for p in model.parameters())
    set_trainable(model, True)
    assert all(p.requires_grad for p in model.parameters())
    assert model.stem_bn.mean.requires_grad and model.blocks[0].dw.lab1.s.requires_grad


# -- CTC ------------------------------------------------------------------------


def test_ctc_loss_is_optaxs_on_the_infeasible_example():
    """logits [3, 4, 6]; labels [1, 2], [1, 1, 2], [1, 2, 3, 4, 5]: the
    third has no alignment in 4 frames, optax gives ~1e5 and torch's own
    ``F.ctc_loss`` inf."""
    logits = np.random.default_rng(0).normal(size=(3, 4, 6)).astype(np.float32)
    labels = np.array([[1, 2, 0, 0, 0], [1, 1, 2, 0, 0], [1, 2, 3, 4, 5]], np.int32)
    pads = np.array([[0, 0, 1, 1, 1], [0, 0, 0, 1, 1], [0, 0, 0, 0, 0]], np.float32)
    want = np.asarray(optax.ctc_loss(logits, np.zeros((3, 4), np.float32), labels, pads))
    got = TT.ctc_loss(torch.from_numpy(logits), labels, pads).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[2] > 9e4 and np.isfinite(got).all()


@pytest.mark.parametrize("t", [3, 6, 12])
def test_ctc_loss_and_its_gradient_equal_optax(t):
    """Random logits, repeated labels, padding, an empty label and rows
    that cannot be aligned in ``t`` frames; loss rtol 1e-5, gradient as
    ``GRAD_RTOL`` / ``GRAD_ATOL``."""
    rng = np.random.default_rng(t)
    b, v, n = 6, 9, 6
    logits = rng.normal(size=(b, t, v)).astype(np.float32) * 2
    labels = rng.integers(1, v, (b, n)).astype(np.int32)
    labels[0, :3] = labels[0, 0]  # a run of three
    lens = np.array([3, 0, 6, 2, 5, 4])
    pads = (np.arange(n)[None, :] >= lens[:, None]).astype(np.float32)
    labels = np.where(pads > 0, 0, labels).astype(np.int32)

    def f(lg):
        return optax.ctc_loss(lg, jnp.zeros((b, t)), labels, pads)

    want = np.asarray(f(logits))
    want_g = np.asarray(jax.grad(lambda lg: f(lg).mean())(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = TT.ctc_loss(x, labels, pads)
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    infeasible = want > 5e4
    assert infeasible.any() == (t < 6)  # some rows have no alignment at the small t
    g = x.grad.numpy()
    np.testing.assert_allclose(g[~infeasible], want_g[~infeasible], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(g[infeasible], want_g[infeasible], rtol=INFEASIBLE_GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("rows", [4, 3], ids=["with-infeasible-row", "feasible"])
def test_rec_ctc_loss_and_every_gradient_equal_jax(rows, jumbo, crops):
    """The jumbo recognizer on 48×64 crops (T = 8), labels with a repeat
    and padding, and in the batch of four a row with no alignment: the
    loss to rtol 1e-5, and, on the three rows that align, every leaf's
    gradient, BN mean and var included, to ``GRAD_RTOL`` / ``GRAD_ATOL``
    (the fourth row's gradient: ``test_ctc_loss_and_its_gradient_equal_optax``)."""
    classes = load_charset(str(assets.WEIGHTS / "jumbo_keys.txt"))
    batch = {k: v[:rows] for k, v in rec_batch(crops, classes).items()}
    model = set_trainable(rec_from_jax(jumbo), True)
    got = TT.ctc_train_loss(model, {**batch, "images": torch.from_numpy(batch["images"])})
    if rows == 4:
        loss = jax.jit(JT.ctc_train_loss)(jumbo, batch)
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
        assert float(loss) > 2e4  # the infeasible row's optax penalty is in the mean
        return
    loss, grads = jax.jit(jax.value_and_grad(JT.ctc_train_loss))(jumbo, batch)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert_grads_close(grad_tree(model, rec_to_jax), jax.device_get(grads), "rec grad")


def det_batch(seed=0, size=64):
    scenes = assets.load_scenes()["parity"]
    img = scenes[seed % len(scenes)][:size, :size]
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    x = ((img[..., ::-1].astype(np.float32) / 255.0 - mean) / std)[None]
    masks = np.zeros((1, size, size), np.float32)
    masks[0, 10:20, 8:50] = 1.0
    masks[0, 40:46, 30:60] = 1.0
    return {"images": x.astype(np.float32), "masks": masks}


def test_det_loss_and_every_gradient_equal_jax():
    params = load_params_npz(str(assets.WEIGHTS / "det_synthetic_text.npz"))
    batch = det_batch()
    loss, grads = jax.jit(jax.value_and_grad(JT.det_train_loss))(params, batch)
    model = set_trainable(det_from_jax(params), True)
    got = TT.det_train_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert_grads_close(grad_tree(model, det_to_jax), jax.device_get(grads), "det grad")


# -- AdamW and the schedule -------------------------------------------------------


def test_three_adamw_updates_under_the_cosine_schedule_equal_optax():
    params = init_det_params(1)
    batches = [det_batch(seed=i) for i in range(3)]
    _, j_init, j_step = JT.make_det_train_step(
        make_mesh(1), learning_rate=optax.cosine_decay_schedule(1e-3, 3, alpha=0.02))
    _, t_init, t_step = TT.make_det_train_step(
        CPU, learning_rate=TT.cosine_decay_schedule(1e-3, 3, alpha=0.02))
    js, ts = j_init(params), t_init(params)
    for b in batches:
        js, jl = j_step(js, b)
        ts, tl = t_step(ts, b)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert ts.step == int(js.step) == 3
    lr = TT.cosine_decay_schedule(1e-3, 3, alpha=0.02)
    assert_adam_close(det_to_jax(ts.model), jax.device_get(js.params), sum(map(lr, range(3))),
                      "after 3 updates")


def test_the_schedule_is_optaxs_and_is_read_before_each_update():
    want = optax.cosine_decay_schedule(5e-4, 10, alpha=0.02)
    got = TT.cosine_decay_schedule(5e-4, 10, alpha=0.02)
    for count in range(13):
        assert abs(got(count) - float(want(count))) <= 1e-6 * 5e-4
    seen = []
    _, init_fn, step_fn = TT.make_det_train_step(CPU, learning_rate=lambda c: seen.append(c) or 1e-3)
    state = init_fn(init_det_params(0))
    for b in [det_batch(size=32)] * 2:
        state, _ = step_fn(state, b)
    assert seen[-2:] == [0, 1]  # the count before each update
    opt = state.optimizer.param_groups[0]
    assert (opt["betas"], opt["eps"], opt["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)


def test_the_batch_prefetcher_hands_over_batches_and_errors_in_order():
    made = iter(range(5))

    def make():
        i = next(made)
        if i == 3:
            raise ValueError("the fourth batch")
        return {"i": i}

    pf = TT.BatchPrefetcher(make, depth=2)
    assert [pf.next()["i"] for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="fourth"):
        pf.next()
    pf.close()
    assert not pf._t.is_alive()


def test_run_steps_calls_its_hooks_around_each_step_and_passes_errors_on():
    made, calls = iter(range(4)), []

    def make():
        i = next(made)
        if i == 3:
            raise ValueError("the fourth batch")
        return {"i": i}

    def step_fn(state, batch):
        calls.append(("step", batch["i"]))
        return state + 1, float(batch["i"])

    state = TT.run_steps(step_fn, 0, make, 3, on_batch=lambda k: calls.append(("batch", k)),
                         on_step=lambda k, st, loss: calls.append(("done", k, st, loss)))
    assert state == 3
    assert calls == [("batch", 1), ("step", 0), ("done", 1, 1, 0.0),
                     ("batch", 2), ("step", 1), ("done", 2, 2, 1.0),
                     ("batch", 3), ("step", 2), ("done", 3, 3, 2.0)]
    made = iter(range(4))
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="fourth"):
        TT.run_steps(step_fn, 0, make, 5)
    assert set(threading.enumerate()) <= before  # its prefetch thread has ended


def test_training_entry_points_refuse_a_mesh_and_default_to_the_card():
    """A mesh is taken (the steps over it: ``test_torch_parallel_train.py``)
    in place of a device, not beside one."""
    from ppocr_tpu_torch.parallel import MeshReplicas
    from ppocr_tpu_torch.parallel import make_mesh as torch_mesh

    mesh = torch_mesh(devices=[CPU] * 2)
    for make, params in ((TT.make_train_step, init_rec_params(0)),
                         (TT.make_det_train_step, init_det_params(0))):
        _, init_fn, _ = make(mesh=mesh)
        state = init_fn(params)
        assert isinstance(state.model, MeshReplicas) and len(state.model.rows) == 2
        with pytest.raises(ValueError, match="not both"):
            make(CPU, mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.make_train_step()


# -- checkpoints ----------------------------------------------------------------


def test_save_restore_and_resume_equal_an_uninterrupted_run(tmp_path, crops):
    classes = TF.charset_classes(list("abcdefgh"))
    params = TF.reinit_ctc_head(init_rec_params(2), len(classes), seed=2)
    batches = [rec_batch(crops, classes, width=32, n=2, seed=s) for s in range(4)]
    sched = TT.cosine_decay_schedule(1e-3, 4, alpha=0.02)
    _, init_fn, step_fn = TT.make_train_step(CPU, learning_rate=sched)

    straight = init_fn(params)
    for b in batches:
        straight, _ = step_fn(straight, b)

    first = init_fn(params)
    for b in batches[:2]:
        first, _ = step_fn(first, b)
    path = save_train_state(str(tmp_path / "ckpts"), first)
    assert path.endswith("step_2")
    assert json.loads((tmp_path / "ckpts" / "step_2" / "state.json").read_text())["updates"] == 2
    resumed = restore_train_state(path, init_fn(params))  # a fresh template
    assert resumed.step == 2
    for b in batches[2:]:
        resumed, _ = step_fn(resumed, b)
    assert_trees_close(rec_to_jax(resumed.model), rec_to_jax(straight.model), 0, 0, "resumed")
    # the checkpoint's params are the JAX layout, loadable by the JAX package
    j = load_params_npz(str(tmp_path / "ckpts" / "step_2" / "params.npz"))
    assert_trees_close(j, rec_to_jax(first.model), 0, 0, "params.npz")


def test_rotation_keeps_the_newest_and_drops_stray_temp_dirs(tmp_path):
    for name in ("step_1", "step_2", "step_10", "step_3.tmp-99"):
        (tmp_path / name).mkdir()
    TF._rotate_checkpoints(str(tmp_path), 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10", "step_2"]


# -- data ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def label_dir(tmp_path_factory, crops):
    """PNG crops of the golden words with their texts (``rec_gt.txt``), and
    the same plus lines the dataset must skip (``with_skips.txt``): a
    character outside any charset (U+0378, not assigned), the blank '#',
    an over-long label (with ``max_len`` 4) and a skipped line whose image
    does not exist."""
    imgs, texts = crops
    root = tmp_path_factory.mktemp("crops")
    lines = []
    for i, (img, text) in enumerate(zip(imgs, texts)):
        (root / f"c{i}.png").write_bytes(imcodec.encode_png(img))
        lines.append(f"c{i}.png\t{text}")
    (root / "rec_gt.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    lines += ["c0.png\t\u0378x", "c1.png\ta#b", "c2.png\tabcdefghij", "missing.png\t\u0378"]
    (root / "with_skips.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root, texts


def test_the_dataset_skips_and_batches_as_the_jax_one(label_dir):
    root, texts = label_dir
    classes = TF.charset_classes(TF.build_charset(texts + ["abcdefghij"]))
    kw = dict(classes=classes, img_h=48, img_w=64, max_len=8, seed=3)
    got = TF.FinetuneDataset(str(root / "with_skips.txt"), **kw)
    want = JF.FinetuneDataset(str(root / "with_skips.txt"), **kw)
    assert got.skipped == want.skipped == 4
    assert got.texts == want.texts == texts
    for a, b in zip(got.images, want.images):
        np.testing.assert_array_equal(a, b)
    for _ in range(2):
        gb, wb = got.batch(5), want.batch(5)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_the_dataset_reads_the_crops_cv2_reads(tmp_path, crops):
    """Crops stored as progressive, arithmetic-coded and CMYK JPEGs and as
    Adam7 PNGs: the JAX dataset reads them with ``cv2.imread``, and the
    port's reads the same pixels (it raised on each before the decoders
    answered as cv2 does)."""
    import io

    import cv2
    from PIL import Image
    from test_torch_decode_parity import patch_sof, png_bytes

    imgs, texts = crops
    lines = []
    for i, (img, text) in enumerate(zip(imgs, texts)):
        kind = i % 4
        if kind == 0:
            data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
        elif kind == 1:
            data = patch_sof(cv2.imencode(".jpg", img)[1].tobytes(), 0xC9)
        elif kind == 2:
            buf = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(img[..., ::-1])).convert("CMYK").save(buf, "JPEG")
            data = buf.getvalue()
        else:
            data = png_bytes(np.ascontiguousarray(img[..., ::-1]), 2, 8, interlace=True, seed=i)
        name = f"c{i}.{'png' if kind == 3 else 'jpg'}"
        (tmp_path / name).write_bytes(data)
        lines.append(f"{name}\t{text}")
    (tmp_path / "gt.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    kw = dict(classes=TF.charset_classes(TF.build_charset(texts)), img_h=48, img_w=64, max_len=40)
    got = TF.FinetuneDataset(str(tmp_path / "gt.txt"), **kw)
    want = JF.FinetuneDataset(str(tmp_path / "gt.txt"), **kw)
    assert got.texts == want.texts == texts
    for a, b in zip(got.images, want.images):
        np.testing.assert_array_equal(a, b)


def test_a_missing_image_on_a_kept_line_raises(tmp_path):
    (tmp_path / "gt.txt").write_text("nothere.png\tab\n")
    with pytest.raises(FileNotFoundError):
        TF.FinetuneDataset(str(tmp_path / "gt.txt"))


# -- finetune_rec end to end -----------------------------------------------------


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory, label_dir):
    """Both packages' ``finetune_rec`` from the jumbo weights with the jumbo
    charset (head kept), 3 steps of batch 4 at 48×64."""
    root, _ = label_dir
    out = tmp_path_factory.mktemp("ft")
    kw = dict(init_weights=str(assets.WEIGHTS / "rec_scene_jumbo.npz"),
              charset_file=str(assets.WEIGHTS / "jumbo_keys.txt"), steps=3, batch_size=4,
              img_w=64, log_every=1, seed=1)
    labels = str(root / "with_skips.txt")
    want = JF.finetune_rec(labels, str(out / "jax"), mesh=make_mesh(1), **kw)
    got = TF.finetune_rec(labels, str(out / "torch"), device=CPU, **kw)
    return out, got, want


def test_finetune_rec_exports_the_jax_packages_bundle(finetuned, jumbo):
    out, got, want = finetuned
    g, w = load_params_npz(got), load_params_npz(want)
    lr = TT.cosine_decay_schedule(5e-4, 3, alpha=0.02)
    assert_adam_close(g, w, sum(map(lr, range(3))), "weights.npz")
    moved = np.abs(g["head"]["fc"]["w"] - jumbo["head"]["fc"]["w"]).max()
    assert moved > 1e-4  # it trained
    keys = "ppocr_keys_v1.txt"
    assert (out / "torch" / keys).read_bytes() == (out / "jax" / keys).read_bytes()


def test_the_exported_bundle_reads_the_same_texts_in_both_engines(finetuned, tmp_path):
    out, got, _ = finetuned
    md = assets.make_jumbo_model_dir(tmp_path / "md")
    for name in ("weights.npz", "ppocr_keys_v1.txt"):
        (md / "rec" / name).write_bytes((out / "torch" / name).read_bytes())
    d = assets.load_goldens()["configs"]["small"]
    scenes = assets.load_scenes()["parity"][:2]
    jw = JaxWorker(JaxEngine(str(md), jax_config(d)), 0)
    tw = OCRWorker(OCREngine(str(md), PipelineConfig.from_dict(d), device=CPU), 0)
    n = 0
    for i, s in enumerate(scenes):
        a, b = tw.process(s, i), jw.process(s, i)
        assert [w["text"] for w in a["words"]] == [w["text"] for w in b["words"]]
        n += len(a["words"])
    assert n >= 4


def test_the_cli_fine_tunes_on_the_cpu_and_wants_a_card_by_default(label_dir, tmp_path, capsys):
    from ppocr_tpu_torch.cli.finetune_main import main

    root, _ = label_dir
    args = ["--label-file", str(root / "rec_gt.txt"), "--steps", "1", "--batch", "2",
            "--img-w", "32", "--out", str(tmp_path / "o")]
    assert main(args + ["--device", "cpu"]) == 0
    assert "exported serving bundle" in capsys.readouterr().out
    tree = load_params_npz(str(tmp_path / "o" / "weights.npz"))
    chars = (tmp_path / "o" / "ppocr_keys_v1.txt").read_text(encoding="utf-8").splitlines()
    assert tree["head"]["fc"]["b"].shape == (len(chars) + 2,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)

