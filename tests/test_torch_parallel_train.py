"""Training over a device mesh in the port (``ppocr_tpu_torch.parallel``
and the mesh steps of ``ppocr_tpu_torch.train``) against the JAX
package's mesh trainers on the suite's 8 virtual CPU devices, with the
same numpy inputs.

Held: ``param_shardings`` marks JAX's leaves; the recognizer split over a
grid row computes the unsplit forward; the rec step over data 4 × model 2
and over data 8 gives the JAX package's losses and updated parameters;
the det step over data 4, on a batch whose shards hold different numbers
of positive pixels, gives JAX's losses and gradient and the port's
one-device parameters; the rows' copies stay bit-equal; a mesh
checkpoint restores on one device and on a mesh; ``finetune_rec(mesh=)``
exports the one-device run's weights; the dry run gives JAX's mesh and
losses. Tolerances are ``test_torch_train``'s: losses rtol 1e-5, the TP
forward rtol 2e-4 / atol 1e-6 (``tests/test_parallel_train.py``'s), and
parameters after AdamW updates by ``assert_adam_close``.
"""

import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from ppocr_tpu.parallel import make_mesh as jax_make_mesh
from ppocr_tpu.train import trainer as JT
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.models import (
    det_to_jax,
    init_det_params,
    init_rec_params,
    rec_forward,
    rec_from_jax,
    rec_to_jax,
)
from ppocr_tpu_torch.ops import kernels as K
from ppocr_tpu_torch.parallel import (
    dryrun_multichip,
    make_mesh,
    param_shardings,
    shard_rec_params,
    sharded_rec_infer,
)
from ppocr_tpu_torch.parallel.mesh import DeviceThreads
from ppocr_tpu_torch.train import finetune as TF
from ppocr_tpu_torch.train import trainer as TT
from ppocr_tpu_torch.utils.checkpoint import (
    load_params_npz,
    restore_train_state,
    save_train_state,
)

from test_torch_goldens import few_torch_threads  # noqa: F401  (fixture)
from test_torch_train import (  # noqa: F401  (fixtures)
    assert_adam_close,
    assert_grads_close,
    assert_trees_close,
    crops,
    grad_tree,
    jumbo,
    label_dir,
    leaves,
    rec_batch,
)

CPU = "cpu"
REC_LR, DET_LR = 1e-4, 1e-3
REPO = pathlib.Path(__file__).resolve().parent.parent


def rec_step_batch(crops):
    """The jumbo scenes' word crops at 48×64 (T = 8), 8 of them, with the
    dry run's label shape [8, 4]: lengths 1–4 from a seed, a repeat in row
    0, no row without an alignment."""
    images = rec_batch(crops, list(range(100)), width=64, n=8)["images"]
    rng = np.random.default_rng(4)
    labels = rng.integers(1, 6625, (8, 4)).astype(np.int32)
    labels[0, 1] = labels[0, 0]
    lens = np.array([4, 3, 1, 2, 4, 2, 3, 1])
    pads = (np.arange(4)[None, :] >= lens[:, None]).astype(np.float32)
    return {"images": images, "labels": np.where(pads > 0, 0, labels).astype(np.int32),
            "label_paddings": pads}


def det_step_batch():
    """8 cuts of 64×64 from the parity scenes, det-normalized, with masks
    from their golden boxes, except for shard 1 of data 4 (rows 2 and 3),
    whose masks are empty: the shards hold 561, 0, 1,568 and 6,695
    positive pixels."""
    scenes = assets.load_scenes()["parity"]
    words = assets.load_goldens()["words"]["small"]
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    offsets = [(0, 0), (128, 64), (64, 0), (32, 96), (96, 32), (128, 128), (0, 64), (64, 128)]
    imgs, masks = [], []
    for i, (y0, x0) in enumerate(offsets):
        k = i % len(scenes)
        m = np.zeros(scenes[k].shape[:2], np.float32)
        for w in words[k]:
            b = np.asarray(w["box"])
            m[b[:, 1].min() : b[:, 1].max() + 1, b[:, 0].min() : b[:, 0].max() + 1] = 1.0
        x = (scenes[k][..., ::-1].astype(np.float32) / 255.0 - mean) / std
        imgs.append(x[y0 : y0 + 64, x0 : x0 + 64])
        masks.append(m[y0 : y0 + 64, x0 : x0 + 64] * (i // 2 != 1))
    return {"images": np.stack(imgs).astype(np.float32), "masks": np.stack(masks)}


def jax_state(make, params):
    """``init_fn(params)`` of a JAX trainer (``make`` its triple), with the
    leaves that the init leaves on one device (the step counts) replicated
    over the mesh, as the step returns them: the jitted step then compiles
    once, not again at the second call."""
    from jax.sharding import NamedSharding, PartitionSpec

    _, init_fn, _ = make
    state = init_fn(params)
    mesh = next(x.sharding.mesh for x in jax.tree.leaves(state)
                if isinstance(x.sharding, NamedSharding))
    return jax.tree.map(lambda x: x if isinstance(x.sharding, NamedSharding)
                        else jax.device_put(x, NamedSharding(mesh, PartitionSpec())), state)


def jax_axis(sharding):
    """The axis a JAX NamedSharding splits over "model", or None."""
    spec = tuple(sharding.spec)
    return spec.index("model") if "model" in spec else None


def flat_specs(tree):
    """path → axis or None, for every leaf (None included)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)
    return {jax.tree_util.keystr(k): v for k, v in flat}


def replicas_equal(state):
    rows = state.model.rows
    return all(torch.equal(a, b) for r in rows[1:]
               for a, b in zip(rows[0].parameters(), r.parameters()))


@pytest.fixture(scope="module")
def jax_rec_steps():
    """JAX's rec step over make_mesh(8, model=m), built once per m."""
    return {m: JT.make_train_step(jax_make_mesh(8, model=m), learning_rate=REC_LR)
            for m in (2, 1)}


@pytest.fixture(scope="module")
def jax_det_step():
    return JT.make_det_train_step(jax_make_mesh(8, model=2), learning_rate=DET_LR)


# -- the layout -------------------------------------------------------------------


@pytest.mark.parametrize("model", [1, 2, 3, 4, 8])
def test_param_shardings_mark_the_jax_packages_leaves(model):
    params = init_rec_params(0)
    want = jax.tree.map(jax_axis, JT.param_shardings(jax_make_mesh(data=1, model=model), params))
    got = param_shardings(make_mesh(devices=[CPU] * model, model=model), params)
    g, w = flat_specs(got), flat_specs(want)
    assert g == w and len(g) == len(leaves(params)[0])
    split = sorted(k for k, v in g.items() if v is not None)
    if model == 2:  # qkv w/b and fc1 w/b by column, proj w and fc2 w by row, in both blocks
        assert len(split) == 12 and all(k.startswith("['head']['blocks']") for k in split)
        assert g["['head']['fc']['w']"] is None


@pytest.mark.parametrize("n,model", [(8, 2), (8, 4), (6, 3)])
def test_the_split_recognizer_computes_the_unsplit_forward(n, model, jumbo, crops,
                                                            few_torch_threads):
    """The jumbo recognizer split over a row of ``model`` devices (by heads
    and hidden columns; with model 3 the 8 heads stay whole and the MLP is
    split) against ``rec_forward`` unsplit on the scenes' word crops, and
    ``sharded_rec_infer`` over the mesh against one rec step: the index
    equal wherever the top two probabilities differ by more than 1e-4."""
    whole = rec_from_jax(jumbo)
    x = torch.from_numpy(rec_batch(crops, list(range(100)), width=64, n=4)["images"])
    mesh = make_mesh(devices=[CPU] * n, model=model)
    (rec,) = shard_rec_params(mesh, whole).values()
    heads = [blk.heads for blk in rec.svtr]
    assert heads == ([8, 8] if model == 3 else [8 // model] * 2)
    assert all(len(blk.mlp) == model for blk in rec.svtr)
    with torch.inference_mode():
        ref = rec_forward(whole, x)
        got = rec_forward(rec, x)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-6)
    idx, val = sharded_rec_infer(mesh)(whole, x)
    one_idx, one_val = K.ctc_topk(ref)
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4
    assert torch.equal(idx[clear], one_idx[clear]) and clear.float().mean() > 0.9
    torch.testing.assert_close(val, one_val, rtol=2e-4, atol=0)


# -- the steps against JAX ----------------------------------------------------------


@pytest.mark.parametrize("model", [2, 1], ids=["data4-model2", "data8"])
def test_the_rec_step_over_a_mesh_equals_jaxs(model, jax_rec_steps, crops, few_torch_threads):
    """Three updates on one batch from ``init_rec_params(0)``: losses rtol
    1e-5, parameters by ``assert_adam_close``, the loss falls, the rows'
    copies bit-equal after every step."""
    batch = rec_step_batch(crops)
    params = init_rec_params(0)
    _, _, j_step = jax_rec_steps[model]
    _, t_init, t_step = TT.make_train_step(learning_rate=REC_LR,
                                           mesh=make_mesh(devices=[CPU] * 8, model=model))
    js, ts = jax_state(jax_rec_steps[model], params), t_init(params)
    assert len(ts.model.rows) == 8 // model
    losses = []
    for _ in range(3):
        js, jl = j_step(js, batch)
        ts, tl = t_step(ts, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert replicas_equal(ts)
        losses.append(float(tl))
    assert losses[2] < losses[0]
    assert ts.step == int(js.step) == 3
    assert_adam_close(rec_to_jax(ts.model), jax.device_get(js.params), 3 * REC_LR,
                      f"rec over model={model}")


def test_the_det_step_normalises_over_the_global_batch_as_jax(jax_det_step, few_torch_threads):
    """Data 4 (a "model" axis of 2 that carries nothing) on a batch whose
    shards hold 561, 0, 1,568 and 6,695 positive pixels. Each side of the
    balanced BCE is normalised over the whole batch, as in JAX: the mean
    of the shards' own balanced BCEs is another number (checked), so a
    step that normalised per shard would fail the loss check.

    Held to JAX: the loss at each of three updates (rtol 1e-5) and the
    first update's gradient, summed over the rows, against JAX's gradient
    of the global loss (``GRAD_*``). The parameters after three updates
    are held by ``assert_adam_close`` to the port's one-device step: held
    to JAX's they are over its 1 in 10^3 (1.0 %), as the JAX package's own
    step on ``make_mesh(1)`` is against its step on ``make_mesh(8,
    model=2)`` (1.0 %, the same elements: Adam's ±lr on the deep 5×5
    depthwise taps, whose gradient here is rounding noise)."""
    batch = det_step_batch()
    params = init_det_params(1)
    _, _, j_step = jax_det_step
    mesh = make_mesh(devices=[CPU] * 8, model=2)
    _, t_init, t_step = TT.make_det_train_step(learning_rate=DET_LR, mesh=mesh)
    _, o_init, o_step = TT.make_det_train_step(CPU, learning_rate=DET_LR)
    js, ts, one = jax_state(jax_det_step, params), t_init(params), o_init(params)
    assert len(ts.model.rows) == 4  # data rows; each a whole detector
    whole = ts.model.gather()
    per_shard = [float(TT.det_train_loss(whole, {k: torch.from_numpy(v[2 * r : 2 * r + 2])
                                                 for k, v in batch.items()}))
                 for r in range(4)]
    _, grads = jax.jit(jax.value_and_grad(JT.det_train_loss))(params, batch)
    for i in range(3):
        js, jl = j_step(js, batch)
        ts, tl = t_step(ts, batch)
        one, _ = o_step(one, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        if i == 0:
            assert abs(np.mean(per_shard) - float(jl)) > 1e-2 * float(jl), (per_shard, float(jl))
            assert_grads_close(grad_tree(ts.model.rows[0], det_to_jax), jax.device_get(grads),
                               "det data 4, first gradient")
        assert replicas_equal(ts)
    assert_adam_close(det_to_jax(ts.model), det_to_jax(one.model), 3 * DET_LR,
                      "det data 4 vs one device")


def test_the_device_threads_run_forwards_with_autograd_on_for_a_train_step():
    """A train step's row forwards on two distinct devices' threads (the
    CPU and the meta device name two threads here; the work is on the
    CPU): with ``grad=True`` their outputs enter one backward pass on the
    calling thread; the serving runner's inference mode gives tensors
    autograd cannot take."""
    import threading

    threads = DeviceThreads()
    w = torch.ones(3, requires_grad=True)
    jobs = [(torch.device(CPU), lambda: ((w * 2).sum(), threading.get_ident())),
            (torch.device("meta"), lambda: ((w * 3).sum(), threading.get_ident()))]
    (a, ta), (b, tb) = threads.run(jobs, grad=True)
    assert ta != tb and threading.get_ident() not in {ta, tb}
    (a + b).backward()
    assert w.grad.tolist() == [5.0, 5.0, 5.0]
    (a, _), (b, _) = threads.run(jobs)
    assert not a.requires_grad and a.is_inference() and b.is_inference()


def test_a_batch_that_does_not_split_over_the_rows_raises():
    _, init_fn, step_fn = TT.make_det_train_step(mesh=make_mesh(devices=[CPU] * 4))
    state = init_fn(init_det_params(0))
    batch = {"images": np.zeros((6, 32, 32, 3), np.float32), "masks": np.zeros((6, 32, 32),
                                                                              np.float32)}
    with pytest.raises(ValueError, match="does not split over data=4"):
        step_fn(state, batch)


# -- checkpoints and finetune_rec -----------------------------------------------------


@pytest.fixture
def one_torch_thread():
    """PyTorch's CPU convolutions on several threads can sum a weight's
    gradient in another order from one run to the next (one element 1 ulp
    apart seen, in a depthwise weight after four updates): the checks of
    bit-for-bit equal runs take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_mesh_checkpoint_restores_on_one_device_and_on_a_mesh(tmp_path, crops,
                                                                 one_torch_thread):
    """Data 2 × model 2: two updates, saved in the one-device files.
    Restored into a mesh, the run continues exactly as the one that was not
    stopped. Restored on one device, it holds the mesh's parameters, AdamW
    moments and count bit for bit, continues exactly as a one-device state
    handed the same values in memory, and its losses are the mesh run's
    (rtol 1e-5)."""
    classes = TF.charset_classes(list("abcdefgh"))
    params = TF.reinit_ctc_head(init_rec_params(2), len(classes), seed=2)
    batches = [rec_batch(crops, classes, width=32, n=2, seed=s) for s in range(4)]
    for b in batches:  # keep every row alignable in T = 4 frames
        b["label_paddings"][:, 2:] = 1.0
        b["labels"][:, 2:] = 0
    sched = TT.cosine_decay_schedule(1e-3, 4, alpha=0.02)
    mesh = make_mesh(devices=[CPU] * 4, model=2)
    _, m_init, m_step = TT.make_train_step(learning_rate=sched, mesh=mesh)
    _, o_init, o_step = TT.make_train_step(CPU, learning_rate=sched)

    straight, straight_losses = m_init(params), []
    for b in batches:
        straight, loss = m_step(straight, b)
        straight_losses.append(float(loss))
    first = m_init(params)
    for b in batches[:2]:
        first, _ = m_step(first, b)
    path = save_train_state(str(tmp_path / "ckpts"), first)
    saved = load_params_npz(str(pathlib.Path(path) / "params.npz"))
    assert_trees_close(saved, rec_to_jax(first.model), 0, 0, "params.npz")

    on_mesh = restore_train_state(path, m_init(params))
    on_one = restore_train_state(path, o_init(params))
    in_memory = o_init(rec_to_jax(first.model))
    in_memory.optimizer.load_state_dict(first.optimizer.state_dict())
    in_memory = in_memory._replace(step=first.step)
    assert on_mesh.step == on_one.step == 2
    assert_trees_close(rec_to_jax(on_one.model), saved, 0, 0, "restored on one device")
    one_opt, mesh_opt = on_one.optimizer.state_dict(), first.optimizer.state_dict()
    assert one_opt["state"].keys() == mesh_opt["state"].keys()
    for k, st in mesh_opt["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(one_opt["state"][k][key].cpu(), st[key].cpu()), (k, key)
    for b, want in zip(batches[2:], straight_losses[2:]):
        on_mesh, _ = m_step(on_mesh, b)
        on_one, loss = o_step(on_one, b)
        in_memory, _ = o_step(in_memory, b)
        np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    assert replicas_equal(on_mesh)
    assert_trees_close(rec_to_jax(on_mesh.model), rec_to_jax(straight.model), 0, 0, "resumed")
    assert_trees_close(rec_to_jax(on_one.model), rec_to_jax(in_memory.model), 0, 0,
                       "resumed on one device")


def test_finetune_rec_over_a_mesh_exports_the_one_device_runs_weights(tmp_path, label_dir,
                                                                      few_torch_threads):
    root, _ = label_dir
    kw = dict(init_weights=str(assets.WEIGHTS / "rec_scene_jumbo.npz"),
              charset_file=str(assets.WEIGHTS / "jumbo_keys.txt"), steps=3, batch_size=4,
              img_w=64, log_every=0, seed=1)
    labels = str(root / "with_skips.txt")
    one = TF.finetune_rec(labels, str(tmp_path / "one"), device=CPU, **kw)
    mesh = TF.finetune_rec(labels, str(tmp_path / "mesh"), mesh=make_mesh(devices=[CPU] * 2),
                           **kw)
    lr = TT.cosine_decay_schedule(5e-4, 3, alpha=0.02)
    assert_adam_close(load_params_npz(mesh), load_params_npz(one), sum(map(lr, range(3))),
                      "weights.npz over data 2")
    keys = "ppocr_keys_v1.txt"
    assert (tmp_path / "mesh" / keys).read_bytes() == (tmp_path / "one" / keys).read_bytes()


# -- the dry run ------------------------------------------------------------------------


def test_the_dry_run_gives_jaxs_mesh_and_losses(jax_rec_steps, jax_det_step, capsys,
                                                few_torch_threads):
    got = dryrun_multichip(8, [CPU] * 8)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh={'data': 4, 'model': 2}, ctc loss=")
    assert got["mesh"] == {"data": 4, "model": 2}
    # the JAX trainers on the same inputs (JAX's own dry run builds these)
    batch = {"images": np.zeros((8, 48, 64, 3), np.float32),
             "labels": np.tile(np.array([[5, 9, 0, 0]], np.int32), (8, 1)),
             "label_paddings": np.tile(np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), (8, 1))}
    _, want = jax_rec_steps[2][2](jax_state(jax_rec_steps[2], init_rec_params(0)), batch)
    _, dwant = jax_det_step[2](jax_state(jax_det_step, init_det_params(0)), {
        "images": np.zeros((8, 64, 64, 3), np.float32), "masks": np.zeros((8, 64, 64),
                                                                          np.float32)})
    np.testing.assert_allclose(got["ctc_loss"], float(want), rtol=1e-5)
    np.testing.assert_allclose(got["det_bce_loss"], float(dwant), rtol=1e-5)
    # the JAX dry run's recorded line (four decimals): ctc rtol 1e-4, det
    # within 1e-4, the bounds the chip smoke holds the card's run to
    tail = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
    ctc, det = map(float, re.search(r"ctc loss=([\d.]+), det bce loss=([\d.]+)", tail).groups())
    assert abs(got["ctc_loss"] - ctc) <= 1e-4 * ctc and abs(got["det_bce_loss"] - det) <= 1e-4
    with pytest.raises(RuntimeError, match="need 8 devices, have 4"):
        dryrun_multichip(8, [CPU] * 4)
