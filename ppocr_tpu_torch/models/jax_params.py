"""Carry ``ppocr_tpu`` parameter pytrees into the port's modules.

The JAX package keeps its weights as nested dicts/lists of numpy arrays
(``utils.checkpoint.load_params_npz``) in NHWC/HWIO layouts. These
functions build the port's ``nn.Module`` and copy every leaf in,
transposed to PyTorch's layouts:

* conv HWIO [kh, kw, cin/g, cout] → OIHW (depthwise [k, k, 1, C] →
  [C, 1, k, k] is the same transpose);
* linear [in, out] → [out, in];
* 2×2 transposed conv (cin, 2, 2, cout) → a [cout·4, cin, 1, 1] 1×1 conv
  with output channels ordered (o, a, b) for ``pixel_shuffle``.

Every module parameter must be set exactly once and every tree leaf used
exactly once; anything else raises, so a layout slip cannot load silently.

``rec_to_jax`` and ``det_to_jax`` go the other way: a trained module back
to the JAX layout (what ``save_params_npz`` writes and either package
loads), each parameter read exactly once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from . import layers as L
from .cls_mv3 import ClsMV3
from .det_db import DetDB
from .rec_svtr import RecSVTR


class _Loader:
    def __init__(self, module: nn.Module):
        self.module = module
        self.pending = {id(p): n for n, p in module.named_parameters()}
        self.used = 0

    def put(self, param: nn.Parameter, value: np.ndarray):
        if id(param) not in self.pending:
            raise ValueError("parameter assigned twice or not in the module")
        t = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(
                f"{self.pending[id(param)]}: tree leaf {tuple(t.shape)} vs "
                f"module {tuple(param.shape)}"
            )
        param.data.copy_(t)
        del self.pending[id(param)]
        self.used += 1

    def conv(self, m: L.Conv, p: Dict):
        self.put(m.weight, np.transpose(p["w"], (3, 2, 0, 1)))
        if m.bias is not None:
            self.put(m.bias, p["b"])

    def bn(self, m: L.BatchNorm, p: Dict):
        for k in ("scale", "bias", "mean", "var"):
            self.put(getattr(m, k), p[k])

    def ln(self, m: L.LayerNorm, p: Dict):
        self.put(m.scale, p["scale"])
        self.put(m.bias, p["bias"])

    def lab(self, m: L.Lab, p: Dict):
        self.put(m.s, p["s"])
        self.put(m.b, p["b"])

    def linear(self, m: L.Linear, p: Dict):
        self.put(m.weight, np.transpose(p["w"]))
        self.put(m.bias, p["b"])

    def se(self, m: L.SE, p: Dict):
        self.conv(m.conv1, p["conv1"])
        self.conv(m.conv2, p["conv2"])

    def lcnet(self, m, p: Dict):
        self.conv(m.conv, p)
        self.lab(m.lab1, p["lab1"])
        if m.lab2 is not None:
            self.lab(m.lab2, p["lab2"])

    def convt(self, m: L.ConvTranspose2x2, p: Dict):
        w = np.asarray(p["w"])  # (cin, 2, 2, cout)
        cin, _, _, cout = w.shape
        self.put(m.weight, np.transpose(w, (3, 1, 2, 0)).reshape(cout * 4, cin, 1, 1))
        self.put(m.bias, p["b"])

    def finish(self, tree) -> nn.Module:
        n_leaves = _count_leaves(tree)
        if self.pending or self.used != n_leaves:
            raise ValueError(
                f"weight carry-over incomplete: {sorted(self.pending.values())} "
                f"unset, {self.used} of {n_leaves} tree leaves used"
            )
        return self.module.eval()


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_leaves(v) for v in tree)
    return 1


def _blocks(ld: _Loader, mods, trees):
    if len(mods) != len(trees):
        raise ValueError(f"{len(trees)} blocks in the tree, {len(mods)} in the module")
    for m, p in zip(mods, trees):
        ld.lcnet(m.dw, p["dw"])
        if m.se is not None:
            ld.se(m.se, p["se"])
        ld.lcnet(m.pw, p["pw"])


def det_from_jax(tree: Dict) -> DetDB:
    """JAX det pytree (``init_det_params`` layout) → :class:`DetDB`."""
    ld = _Loader(DetDB())
    m = ld.module
    bb, fpn, head = tree["backbone"], tree["fpn"], tree["head"]
    ld.conv(m.stem, bb["stem"])
    ld.bn(m.stem_bn, bb["stem"]["bn"])
    _blocks(ld, m.blocks, bb["blocks"])
    for mod, p in zip(m.reduce, fpn["reduce"]):
        ld.conv(mod, p)
    for mods, ps in ((m.rse_in, fpn["rse_in"]), (m.rse_out, fpn["rse_out"])):
        for mod, p in zip(mods, ps):
            ld.conv(mod.conv, p["conv"])
            ld.se(mod.se, p["se"])
    ld.conv(m.head_conv, head["conv"])
    ld.bn(m.head_bn, head["conv"]["bn"])
    ld.convt(m.up1, head["up1"])
    ld.bn(m.up1_bn, head["up1"]["bn"])
    ld.convt(m.up2, head["up2"])
    return ld.finish(tree)


def rec_from_jax(tree: Dict) -> RecSVTR:
    """JAX rec pytree (``init_rec_params`` layout) → :class:`RecSVTR`; the
    head width is read from ``head/fc/b``."""
    head = tree["head"]
    ld = _Loader(RecSVTR(num_classes=int(np.shape(head["fc"]["b"])[0])))
    m = ld.module
    bb = tree["backbone"]
    ld.conv(m.stem, bb["stem"])
    ld.bn(m.stem_bn, bb["stem"]["bn"])
    _blocks(ld, m.blocks, bb["blocks"])
    for name in ("conv1", "conv2", "conv3", "conv4", "conv1x1"):
        ld.conv(getattr(m, name).conv, head[name])
        ld.bn(getattr(m, name).bn, head[name]["bn"])
    for mod, p in zip(m.svtr, head["blocks"]):
        ld.ln(mod.norm1, p["norm1"])
        ld.ln(mod.norm2, p["norm2"])
        for name in ("qkv", "proj", "fc1", "fc2"):
            ld.linear(getattr(mod, name), p[name])
    ld.ln(m.norm, head["norm"])
    ld.linear(m.fc, head["fc"])
    return ld.finish(tree)


def cls_from_jax(tree: Dict) -> ClsMV3:
    """JAX cls pytree (``init_cls_params`` layout) → :class:`ClsMV3`."""
    ld = _Loader(ClsMV3())
    m = ld.module

    def conv_bn(mod, p):
        ld.conv(mod.conv, p)
        ld.bn(mod.bn, p["bn"])

    conv_bn(m.stem, tree["stem"])
    if len(m.blocks) != len(tree["blocks"]):
        raise ValueError(
            f"{len(tree['blocks'])} blocks in the tree, {len(m.blocks)} in the module"
        )
    for mod, p in zip(m.blocks, tree["blocks"]):
        conv_bn(mod.expand, p["expand"])
        conv_bn(mod.dw, p["dw"])
        if mod.se is not None:
            ld.se(mod.se, p["se"])
        conv_bn(mod.project, p["project"])
    conv_bn(m.last_conv, tree["last_conv"])
    ld.linear(m.fc, tree["fc"])
    return ld.finish(tree)


class _Saver:
    """The inverse of :class:`_Loader`: module parameters → tree leaves in
    the JAX layout, each parameter read exactly once."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.pending = {id(p): n for n, p in module.named_parameters()}

    def get(self, param: nn.Parameter) -> np.ndarray:
        if id(param) not in self.pending:
            raise ValueError("parameter read twice or not in the module")
        del self.pending[id(param)]
        return param.detach().to("cpu", torch.float32).numpy().copy()

    def conv(self, m: L.Conv, **extra) -> Dict:
        p = {"w": np.ascontiguousarray(np.transpose(self.get(m.weight), (2, 3, 1, 0)))}
        if m.bias is not None:
            p["b"] = self.get(m.bias)
        p.update(extra)
        return p

    def bn(self, m: L.BatchNorm) -> Dict:
        return {k: self.get(getattr(m, k)) for k in ("scale", "bias", "mean", "var")}

    def ln(self, m: L.LayerNorm) -> Dict:
        return {"scale": self.get(m.scale), "bias": self.get(m.bias)}

    def lab(self, m: L.Lab) -> Dict:
        return {"s": self.get(m.s), "b": self.get(m.b)}

    def linear(self, m: L.Linear) -> Dict:
        return {"w": np.ascontiguousarray(self.get(m.weight).T), "b": self.get(m.bias)}

    def se(self, m: L.SE) -> Dict:
        return {"conv1": self.conv(m.conv1), "conv2": self.conv(m.conv2)}

    def lcnet(self, m) -> Dict:
        p = self.conv(m.conv, lab1=self.lab(m.lab1))
        if m.lab2 is not None:
            p["lab2"] = self.lab(m.lab2)
        return p

    def convt(self, m: L.ConvTranspose2x2, **extra) -> Dict:
        w = self.get(m.weight)  # [cout·4, cin, 1, 1], channels (o, a, b)
        cout, cin = w.shape[0] // 4, w.shape[1]
        w = np.transpose(w.reshape(cout, 2, 2, cin), (3, 1, 2, 0))
        return {"w": np.ascontiguousarray(w), "b": self.get(m.bias), **extra}

    def blocks(self, mods) -> list:
        out = []
        for m in mods:
            blk = {"dw": self.lcnet(m.dw), "pw": self.lcnet(m.pw)}
            if m.se is not None:
                blk["se"] = self.se(m.se)
            out.append(blk)
        return out

    def finish(self, tree: Dict) -> Dict:
        if self.pending:
            raise ValueError(f"parameters not carried out: {sorted(self.pending.values())}")
        return tree


def whole_module(model: nn.Module) -> nn.Module:
    """``model``, or the whole module that a mesh's copies of it
    (``parallel.MeshReplicas``, which has ``gather``) gather to."""
    return model.gather() if hasattr(model, "gather") else model


def rec_to_jax(model: RecSVTR) -> Dict:
    """:class:`RecSVTR` (or a mesh's copies of one) → JAX rec pytree
    (``init_rec_params`` layout)."""
    model = whole_module(model)
    sv = _Saver(model)
    m = model
    backbone = {"stem": sv.conv(m.stem, bn=sv.bn(m.stem_bn)), "blocks": sv.blocks(m.blocks)}

    def cbn(mod):
        return sv.conv(mod.conv, bn=sv.bn(mod.bn))

    head = {"conv1": cbn(m.conv1), "conv2": cbn(m.conv2), "blocks": []}
    for mod in m.svtr:
        head["blocks"].append({
            "norm1": sv.ln(mod.norm1),
            "qkv": sv.linear(mod.qkv),
            "proj": sv.linear(mod.proj),
            "norm2": sv.ln(mod.norm2),
            "fc1": sv.linear(mod.fc1),
            "fc2": sv.linear(mod.fc2),
        })
    head["norm"] = sv.ln(m.norm)
    head["conv3"] = cbn(m.conv3)
    head["conv4"] = cbn(m.conv4)
    head["conv1x1"] = cbn(m.conv1x1)
    head["fc"] = sv.linear(m.fc)
    return sv.finish({"backbone": backbone, "head": head})


def det_to_jax(model: DetDB) -> Dict:
    """:class:`DetDB` (or a mesh's copies of one) → JAX det pytree
    (``init_det_params`` layout)."""
    model = whole_module(model)
    sv = _Saver(model)
    m = model
    backbone = {"stem": sv.conv(m.stem, bn=sv.bn(m.stem_bn)), "blocks": sv.blocks(m.blocks)}
    fpn = {
        "reduce": [sv.conv(mod) for mod in m.reduce],
        "rse_in": [{"conv": sv.conv(mod.conv), "se": sv.se(mod.se)} for mod in m.rse_in],
        "rse_out": [{"conv": sv.conv(mod.conv), "se": sv.se(mod.se)} for mod in m.rse_out],
    }
    head = {
        "conv": sv.conv(m.head_conv, bn=sv.bn(m.head_bn)),
        "up1": sv.convt(m.up1, bn=sv.bn(m.up1_bn)),
        "up2": sv.convt(m.up2),
    }
    return sv.finish({"backbone": backbone, "fpn": fpn, "head": head})
