"""The port's kernel modules on CPU: plain versions against the Pallas
kernels (interpret mode) and the JAX formulations, and the CPU/CUDA
dispatch of the wrappers. The CUDA kernels themselves are checked against
these plain versions on the card by ``chip_smoke.py``.

Tolerances: CTC top-k index and value exact; blob stats area and
coordinates exact, prob mass rtol 1e-5 (f32 sums in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppocr_tpu.ops.pallas_kernels import blob_stats_pallas, ctc_topk_pallas
from ppocr_tpu.pipeline.fused import _blob_stats as jax_blob_stats
from ppocr_tpu.pipeline.fused import _connected_components as jax_cc
from ppocr_tpu_torch.ops import kernels as K
from ppocr_tpu_torch.pipeline.engine import OCREngine, resolve_device
from ppocr_tpu_torch.pipeline.config import PipelineConfig

PSUM_RTOL = 1e-5


def ctc_inputs(v, seed):
    rng = np.random.default_rng(seed)
    p = rng.random((3, 7, v)).astype(np.float32)
    p[0, 0, :] = 0.25  # whole-row tie → index 0
    p[0, 1, [min(3, v - 2), v - 2]] = 2.0  # two-way tie → the lower index
    p[1, 2, v // 2] = np.nan  # NaN row → (V-1, NaN)
    p[2, 3, :] = np.nan
    p[2, 4, :] = -np.inf  # all -inf → index 0, value -inf
    return p


CTC_WIDTHS = [4, 31, 333, 5007, 5008, 6625]  # 16-byte aligned rows or not, < one vector a thread


@pytest.mark.parametrize("v", CTC_WIDTHS)
def test_ctc_topk_plain_matches_pallas(v):
    p = ctc_inputs(v, seed=v)
    want_idx, want_val = (np.asarray(a) for a in ctc_topk_pallas(jnp.asarray(p), interpret=True))
    idx, val = K.ctc_topk_plain(torch.from_numpy(p))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(val.numpy(), want_val)  # NaN == NaN here
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    assert idx[1, 2] == v - 1 and idx[0, 1] == min(3, v - 2)


CTC_EDGES = {  # row → (columns set, value): where a peeled head or tail would sit
    "tie_first_last": ((0, -1), 2.0),
    "tie_last_two": ((-2, -1), 2.0),
    "nan_first": ((0,), np.nan),
    "nan_last": ((-1,), np.nan),
    "neg_inf_but_last": (slice(0, -1), -np.inf),
}


@pytest.mark.parametrize("edge", sorted(CTC_EDGES))
@pytest.mark.parametrize("v", CTC_WIDTHS)
def test_ctc_topk_plain_edges_match_pallas(v, edge):
    """Ties and NaN at the first and last columns, a single row."""
    cols, value = CTC_EDGES[edge]
    p = np.random.default_rng(v).random((1, 1, v)).astype(np.float32)
    p[0, 0, cols if isinstance(cols, slice) else list(cols)] = value
    want_idx, want_val = (np.asarray(a) for a in ctc_topk_pallas(jnp.asarray(p), interpret=True))
    idx, val = K.ctc_topk_plain(torch.from_numpy(p))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(val.numpy(), want_val)
    expect = {"tie_first_last": 0, "tie_last_two": v - 2, "nan_first": v - 1,
              "nan_last": v - 1, "neg_inf_but_last": v - 1}[edge]
    assert int(idx[0, 0]) == expect
    assert bool(torch.isnan(val[0, 0])) == edge.startswith("nan")


def blob_inputs(seed, b=2, h=40, w=70, k=8):
    """Rectangular blobs tagged by their root, with empty (-7, -1) and
    duplicate root slots."""
    rng = np.random.default_rng(seed)
    labels = np.full((b, h, w), h * w, np.int32)
    roots = np.full((b, k), -1, np.int32)
    for i in range(b):
        rs = []
        for _ in range(5):
            y0, x0 = int(rng.integers(0, h - 6)), int(rng.integers(0, w - 8))
            bh, bw = int(rng.integers(2, 6)), int(rng.integers(3, 8))
            labels[i, y0 : y0 + bh, x0 : x0 + bw] = y0 * w + x0
            rs.append(y0 * w + x0)
        roots[i, :6] = rs + [rs[0]]
        roots[i, 6] = -7
    prob = rng.random((b, h, w)).astype(np.float32)
    return labels, prob, roots


def assert_stats_close(got, want):
    area, psum, x0, x1, y0, y1 = (np.asarray(a) for a in got)
    w_area, w_psum, w_x0, w_x1, w_y0, w_y1 = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(area, w_area)
    np.testing.assert_allclose(psum, w_psum, rtol=PSUM_RTOL, atol=0)
    for g, w in ((x0, w_x0), (x1, w_x1), (y0, w_y0), (y1, w_y1)):
        np.testing.assert_array_equal(g, w)


def test_blob_stats_plain_matches_pallas():
    labels, prob, roots = blob_inputs(seed=3)
    got = K.blob_stats_plain(*(torch.from_numpy(a) for a in (labels, prob, roots)))
    for b in range(labels.shape[0]):
        want = blob_stats_pallas(
            jnp.asarray(labels[b]), jnp.asarray(prob[b]), jnp.asarray(roots[b]), interpret=True
        )
        assert_stats_close([g[b] for g in got], want)
    assert got[2][0, 7] == K.BIG and got[3][0, 7] == -K.BIG  # empty slot
    assert got[0][0, 5] == got[0][0, 0]  # duplicate root: full stats again


def blob_edge_inputs(kind, h, w, k, seed):
    """One image: ``blobs`` has min(k, 6) rectangles in raster order of
    their roots with slot 0 repeated in the last slot when k > 2 and a -1
    slot when k > 3; ``background`` has no blob pixel; ``one_blob`` is a
    single blob over the whole map (root 0) in every slot."""
    rng = np.random.default_rng(seed)
    labels = np.full((h, w), h * w, np.int32)
    roots = np.full((k,), -1, np.int32)
    if kind == "one_blob":
        labels[:] = 0
        roots[:] = 0
    elif kind == "blobs":
        n = min(k, 6)
        xs = np.linspace(0, w - 9, n).astype(int)
        for i, x0 in enumerate(xs):
            y0 = int(rng.integers(0, h - 4))
            bh, bw = int(rng.integers(1, 4)), int(rng.integers(2, 9))
            labels[y0 : y0 + bh, x0 : x0 + bw] = y0 * w + x0
            roots[i] = y0 * w + x0
        if k > 2:
            roots[-1] = roots[0]
        if k > 3:
            roots[-2] = -1
    else:
        roots[: min(k, 3)] = [5, 0, h * w - 1][: min(k, 3)]  # roots of nothing
    prob = rng.random((h, w)).astype(np.float32)
    return labels, prob, roots


@pytest.mark.parametrize("kind", ["blobs", "background", "one_blob"])
@pytest.mark.parametrize("w", [70, 500])
@pytest.mark.parametrize("k", [1, 8, 40])
def test_blob_stats_plain_edges_match_pallas(k, w, kind):
    h = 12
    labels, prob, roots = blob_edge_inputs(kind, h, w, k, seed=k * 1000 + w)
    got = K.blob_stats_plain(*(torch.from_numpy(a)[None] for a in (labels, prob, roots)))
    want = blob_stats_pallas(
        jnp.asarray(labels), jnp.asarray(prob), jnp.asarray(roots), interpret=True, tile_h=4
    )
    assert_stats_close([g[0] for g in got], want)
    area = got[0][0].numpy()
    if kind == "one_blob":
        assert (area == h * w).all() and (got[3][0] == w - 1).all() and (got[5][0] == h - 1).all()
    elif kind == "background":
        assert (area == 0).all() and (got[2][0] == K.BIG).all() and (got[5][0] == -K.BIG).all()
    else:
        assert area[0] > 0
        if k > 2:  # the duplicate of slot 0 has its full stats
            assert all(g[0, -1] == g[0, 0] for g in got)


def test_blob_stats_wrapper_on_cpu_keeps_its_contract():
    """Six [B, K] f32 tensors; empty slots hold count 0, mass 0 and the
    ±1e9 sentinels; a duplicate root has full stats in both slots."""
    labels, prob, roots = (torch.from_numpy(a) for a in blob_inputs(seed=9))
    out = K.blob_stats(labels, prob, roots)
    assert isinstance(out, tuple) and len(out) == 6
    for a in out:
        assert a.dtype == torch.float32 and tuple(a.shape) == tuple(roots.shape)
    area, psum, x0, x1, y0, y1 = out
    for slot in (6, 7):  # roots -7 and -1
        assert (area[:, slot] == 0).all() and (psum[:, slot] == 0).all()
        assert (x0[:, slot] == K.BIG).all() and (y0[:, slot] == K.BIG).all()
        assert (x1[:, slot] == -K.BIG).all() and (y1[:, slot] == -K.BIG).all()
    for a in out:
        assert torch.equal(a[:, 5], a[:, 0])
    assert (area[:, :5] > 0).all() and (x0[:, :5] <= x1[:, :5]).all()


def test_blob_stats_plain_matches_fused_formulation():
    """On a CC label map, the plain version's bbox and mass equal
    ``_blob_stats(use_pallas=False)`` at the roots that function picks."""
    rng = np.random.default_rng(5)
    fg = np.zeros((64, 96), bool)
    for y0, x0, hh, ww in ((4, 5, 9, 30), (20, 40, 12, 20), (40, 3, 8, 50), (50, 70, 6, 6)):
        fg[y0 : y0 + hh, x0 : x0 + ww] = True
    fg &= rng.random(fg.shape) > 0.1
    labels = jax.jit(jax_cc)(jnp.asarray(fg))
    prob = rng.random((64, 96)).astype(np.float32)
    ref = jax.jit(lambda l, p: jax_blob_stats(l, p, max_boxes=8))(labels, prob)
    got = K.blob_stats_plain(
        torch.from_numpy(np.array(labels))[None],
        torch.from_numpy(prob)[None],
        torch.from_numpy(np.array(ref["root"]))[None],
    )
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(ref["area"]))
    np.testing.assert_allclose(
        (got[1][0] / torch.clamp(got[0][0], min=1.0)).numpy(), np.asarray(ref["score"]), rtol=PSUM_RTOL
    )
    for i, name in enumerate(("x0", "x1", "y0", "y1")):
        np.testing.assert_array_equal(got[2 + i][0].numpy(), np.asarray(ref[name]))


def test_cpu_tensors_never_launch_a_kernel():
    K.reset_launch_counts()
    p = torch.from_numpy(ctc_inputs(333, seed=1))
    want = K.ctc_topk_plain(p)
    got = K.ctc_topk(p)
    labels, prob, roots = (torch.from_numpy(a) for a in blob_inputs(seed=4))
    want_b = K.blob_stats_plain(labels, prob, roots)
    got_b = K.blob_stats(labels, prob, roots)
    assert K.launch_counts() == {"ctc_topk": 0, "blob_stats": 0}
    for a, b in zip(list(got) + list(got_b), list(want) + list(want_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_wrappers_reject_other_devices_and_shapes():
    with pytest.raises(ValueError):
        K.ctc_topk(torch.zeros(2, 3, 4, device="meta"))
    with pytest.raises(ValueError):
        K.ctc_topk(torch.zeros(3, 4))
    with pytest.raises(ValueError):
        K.blob_stats(torch.zeros(2, 3, 4, dtype=torch.int32), torch.zeros(2, 3, 4), torch.zeros(3, 5))


def test_asking_for_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        OCREngine(str(tmp_path), PipelineConfig.serving())
    assert resolve_device("cpu") == torch.device("cpu")
