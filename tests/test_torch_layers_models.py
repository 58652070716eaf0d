"""The PyTorch port's layers and models against the JAX package on CPU.

Same numpy inputs (seeded) through both; f32 throughout. Tolerances:
layer ops atol 1e-5, whole det/rec forwards atol 1e-4 on probabilities
(summation order differs between XLA's and PyTorch's CPU convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppocr_tpu.models import layers as JL
from ppocr_tpu.models.det_db import det_forward as jax_det_forward
from ppocr_tpu.models.rec_svtr import rec_forward as jax_rec_forward
from ppocr_tpu.models.rec_svtr import rec_forward_logits as jax_rec_logits
from ppocr_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from ppocr_tpu_torch.models import (
    det_forward,
    det_from_jax,
    rec_forward,
    rec_forward_logits,
    rec_from_jax,
)
from ppocr_tpu_torch.models import layers as TL
from ppocr_tpu_torch.models.jax_params import _Loader
from ppocr_tpu_torch.utils.checkpoint import load_params_npz
from ppocr_tpu_torch.assets import WEIGHTS

DET_W = WEIGHTS / "det_synthetic_text.npz"
REC_W = WEIGHTS / "rec_scene_jumbo.npz"
OP_ATOL = 1e-5
MODEL_ATOL = 1e-4


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def load_into(module, fill, p):
    ld = _Loader(module)
    getattr(ld, fill)(module, p)
    assert not ld.pending, ld.pending
    return module


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize(
    "cin,cout,k,stride,groups,bias",
    [
        (3, 16, 3, (2, 2), 1, False),  # stem
        (32, 32, 3, (1, 1), 32, True),  # depthwise
        (64, 64, 5, (2, 1), 64, True),  # rec mixed stride
        (48, 12, 1, (1, 1), 1, True),  # pointwise
        (96, 24, (1, 3), (1, 1), 1, False),  # svtr 1×3
    ],
)
def test_conv2d(rng, cin, cout, k, stride, groups, bias):
    kh, kw = (k, k) if isinstance(k, int) else k
    x = rng.normal(size=(2, 9, 10, cin)).astype(np.float32)
    p = {"w": rng.normal(size=(kh, kw, cin // groups, cout)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=(cout,)).astype(np.float32)
    pad = ((kh // 2, kh // 2), (kw // 2, kw // 2))
    want = JL.conv2d(jnp.asarray(x), p["w"], stride, pad, groups, p.get("b"))
    m = load_into(TL.Conv(cin, cout, k, stride, groups=groups, bias=bias), "conv", p)
    got = nhwc(m(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=OP_ATOL, rtol=1e-5)


def test_conv_transpose2x2(rng):
    x = rng.normal(size=(2, 5, 7, 24)).astype(np.float32)
    p = {
        "w": rng.normal(size=(24, 2, 2, 6)).astype(np.float32),
        "b": rng.normal(size=(6,)).astype(np.float32),
    }
    want = JL.conv_transpose2x2(jnp.asarray(x), p["w"], p["b"])
    m = load_into(TL.ConvTranspose2x2(24, 6), "convt", p)
    np.testing.assert_allclose(nhwc(m(nchw(x))), np.asarray(want), atol=OP_ATOL)


def test_batch_norm_and_lab(rng):
    x = rng.normal(size=(2, 4, 5, 8)).astype(np.float32)
    bn = {
        "scale": rng.normal(size=8).astype(np.float32),
        "bias": rng.normal(size=8).astype(np.float32),
        "mean": rng.normal(size=8).astype(np.float32),
        "var": rng.random(8).astype(np.float32) + 0.5,
    }
    lab = {"s": np.array([1.3], np.float32), "b": np.array([-0.2], np.float32)}
    want = JL.lab(JL.batch_norm(jnp.asarray(x), bn), lab)
    m_bn = load_into(TL.BatchNorm(8), "bn", bn)
    m_lab = load_into(TL.Lab(), "lab", lab)
    np.testing.assert_allclose(
        nhwc(m_lab(m_bn(nchw(x)))), np.asarray(want), atol=OP_ATOL
    )


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm(rng, eps):
    x = rng.normal(size=(2, 7, 120)).astype(np.float32)
    p = {"scale": rng.normal(size=120).astype(np.float32), "bias": rng.normal(size=120).astype(np.float32)}
    want = JL.layer_norm(jnp.asarray(x), p, eps=eps)
    m = load_into(TL.LayerNorm(120, eps=eps), "ln", p)
    np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), np.asarray(want), atol=OP_ATOL)


def test_linear(rng):
    x = rng.normal(size=(2, 7, 120)).astype(np.float32)
    p = {"w": rng.normal(size=(120, 360)).astype(np.float32), "b": rng.normal(size=360).astype(np.float32)}
    want = JL.linear(jnp.asarray(x), p)
    m = load_into(TL.Linear(120, 360), "linear", p)
    np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), np.asarray(want), atol=OP_ATOL)


@pytest.mark.parametrize(
    "jax_fn,torch_fn",
    [
        (JL.hard_swish, TL.hard_swish),
        (JL.hard_sigmoid, TL.hard_sigmoid),
        (JL.swish, TL.swish),
    ],
    ids=["hard_swish", "hard_sigmoid", "swish"],
)
def test_activations(rng, jax_fn, torch_fn):
    x = (rng.normal(size=(4, 64)) * 4).astype(np.float32)
    np.testing.assert_allclose(
        torch_fn(torch.from_numpy(x)).numpy(), np.asarray(jax_fn(jnp.asarray(x))), atol=OP_ATOL
    )


@pytest.mark.parametrize("slope", [0.2, 1.0 / 6.0])
def test_se_module(rng, slope):
    c, mid = 16, 4
    x = rng.normal(size=(2, 5, 6, c)).astype(np.float32)
    p = {
        "conv1": {"w": rng.normal(size=(1, 1, c, mid)).astype(np.float32), "b": rng.normal(size=mid).astype(np.float32)},
        "conv2": {"w": rng.normal(size=(1, 1, mid, c)).astype(np.float32), "b": rng.normal(size=c).astype(np.float32)},
    }
    want = JL.se_module(jnp.asarray(x), p, slope=slope)
    m = load_into(TL.SE(c, mid, slope=slope), "se", p)
    np.testing.assert_allclose(nhwc(m(nchw(x))), np.asarray(want), atol=OP_ATOL)


@pytest.fixture(scope="module")
def det_tree():
    return jax_load_npz(str(DET_W))


@pytest.fixture(scope="module")
def rec_tree():
    return jax_load_npz(str(REC_W))


def test_npz_loader_matches_jax_loader(det_tree):
    ours = load_params_npz(str(DET_W))
    a, b = jax.tree.leaves(ours), jax.tree.leaves(det_tree)
    assert jax.tree.structure(ours) == jax.tree.structure(det_tree)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_det_forward_matches_jax(det_tree):
    x = np.random.default_rng(1).normal(size=(1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_det_forward)(det_tree, x))
    with torch.no_grad():
        got = det_forward(det_from_jax(det_tree), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 64, 96)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (2, 28, 96, 3)])
def test_rec_forward_matches_jax(rec_tree, shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    model = rec_from_jax(rec_tree)
    want = np.asarray(jax.jit(jax_rec_forward)(rec_tree, x))
    with torch.no_grad():
        got = rec_forward(model, torch.from_numpy(x)).numpy()
        logits = rec_forward_logits(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], shape[2] // 8, 5008)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=0)
    want_logits = np.asarray(jax.jit(jax_rec_logits)(rec_tree, x))
    np.testing.assert_allclose(logits, want_logits, atol=1e-3, rtol=1e-4)


def _unique_tree(tree, start):
    """The tree with every leaf refilled by distinct values."""
    if isinstance(tree, dict):
        return {k: _unique_tree(v, start) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unique_tree(v, start) for v in tree]
    n = np.size(tree)
    vals = np.arange(start[0], start[0] + n, dtype=np.float64).reshape(np.shape(tree))
    start[0] += n
    return vals.astype(np.float32)


@pytest.mark.parametrize("which", ["det", "rec"])
def test_weight_carry_over_round_trip(det_tree, rec_tree, which):
    """Every number of the JAX tree lands in exactly one module parameter:
    with distinct leaf values, the module holds the same multiset."""
    tree = _unique_tree(det_tree if which == "det" else rec_tree, [0])
    model = (det_from_jax if which == "det" else rec_from_jax)(tree)
    got = np.sort(np.concatenate([p.detach().numpy().ravel() for p in model.parameters()]))
    want = np.sort(np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)]))
    np.testing.assert_array_equal(got, want)


def test_carry_over_rejects_a_wrong_layout(det_tree):
    bad = jax.tree.map(lambda a: a, det_tree)
    bad["backbone"]["stem"]["w"] = np.transpose(bad["backbone"]["stem"]["w"], (3, 2, 1, 0))
    with pytest.raises(ValueError, match="stem"):
        det_from_jax(bad)
