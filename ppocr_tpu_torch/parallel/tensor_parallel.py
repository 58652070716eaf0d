"""Tensor parallelism over the SVTR mixer, and a model's copies over the
data rows of a mesh.

Counterpart of ``param_shardings`` in ``ppocr_tpu/train/trainer.py``. The
JAX package lays the recognizer's parameters out over the mesh's "model"
axis and lets GSPMD place the collectives. Here a recognizer is split by
hand over the devices of one grid row, Megatron style
(:class:`SplitSVTRBlock`):

* each SVTR block's ``qkv`` is cut by heads, q, k and v each at head
  boundaries, and ``fc1`` by columns; ``proj`` and ``fc2`` are cut by
  rows (their input dimension), so each shard's heads and hidden columns
  feed its own rows of the next matmul;
* the shards' partial outputs are summed on the row's first device, and
  the biases of ``proj`` and ``fc2`` are added once, after the sum;
* where the heads do not divide over the row (8 heads over 3 devices) the
  attention stays whole on the first device and only the MLP is split;
  a hidden width that does not divide keeps the MLP whole the same way.

Everything else (the backbone, the neck, the 120 → V CTC projection)
stays whole on the row's first device, as ``param_shardings`` replicates
it. :class:`MeshReplicas` holds one copy of a model per data row of a
mesh, gathers them back to one whole module and splits one into them, so
that checkpoints and exported weights have the layout of a one-device
run.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import swish
from ..models.rec_svtr import RecSVTR, SVTRBlock, attention

# (row parameter, dimension it is cut on or None when whole, the whole
# parameter's indices along that dimension)
Piece = Tuple[nn.Parameter, Optional[int], Optional[torch.Tensor]]


def param_shardings(mesh, params) -> Dict:
    """For each leaf of a JAX-layout parameter tree, the axis it splits on
    over the mesh's "model" axis, or ``None`` where it is replicated, by
    the JAX package's rule: a ``w`` or ``b`` under ``qkv`` or ``fc1`` splits
    on its last axis (column-parallel), a ``w`` under ``proj`` or ``fc2`` on
    its first (row-parallel), each where the axis divides by the model
    axis's width."""
    n_model = mesh.shape["model"]

    def spec(keys, leaf):
        shape = np.shape(leaf)
        if shape and keys[-1] in ("w", "b"):
            if any(k in keys for k in ("qkv", "fc1")) and shape[-1] % n_model == 0:
                return len(shape) - 1
            if (any(k in keys for k in ("proj", "fc2")) and keys[-1] == "w"
                    and shape[0] % n_model == 0):
                return 0
        return None

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, keys + [None]) for v in tree]
        return spec(keys, tree)

    return walk(params, [])


class _Shard(nn.Module):
    """One device's part of a column-parallel linear (``w_in`` [k, d_in],
    ``b_in`` [k]) and of the row-parallel weight that reads its k outputs
    (``w_out`` [d_out, k], no bias)."""

    def __init__(self, w_in, b_in, w_out, device, trainable: bool):
        super().__init__()
        for name, t in (("w_in", w_in), ("b_in", b_in), ("w_out", w_out)):
            setattr(self, name, nn.Parameter(t.to(device), requires_grad=trainable))


class SplitSVTRBlock(nn.Module):
    """An :class:`SVTRBlock` split over ``devices`` (a grid row); its input
    and output are on the first. Equal to the whole block up to the order
    of the sums."""

    def __init__(self, block: SVTRBlock, devices: Sequence[torch.device]):
        super().__init__()
        first, n = devices[0], len(devices)
        d = block.qkv.weight.shape[1]
        hd = d // block.heads
        hidden = block.fc1.weight.shape[0]
        attn_devices = list(devices) if block.heads % n == 0 else [first]
        mlp_devices = list(devices) if hidden % n == 0 else [first]
        self.heads = block.heads // len(attn_devices)  # heads per shard
        self.norm1 = copy.deepcopy(block.norm1).to(first)
        self.norm2 = copy.deepcopy(block.norm2).to(first)
        self.proj_b = nn.Parameter(block.proj.bias.detach().to(first).clone(),
                                   requires_grad=block.proj.bias.requires_grad)
        self.fc2_b = nn.Parameter(block.fc2.bias.detach().to(first).clone(),
                                  requires_grad=block.fc2.bias.requires_grad)
        self.attn, self.mlp = nn.ModuleList(), nn.ModuleList()
        # whole parameter name → its pieces' (shard parameter name, dim, index)
        self._cuts: Dict[str, List[Tuple[str, Optional[int], Optional[torch.Tensor]]]] = {
            name: [(name, None, None)] for name in ("norm1.scale", "norm1.bias", "norm2.scale",
                                                    "norm2.bias")}
        self._cuts["proj.bias"] = [("proj_b", None, None)]
        self._cuts["fc2.bias"] = [("fc2_b", None, None)]
        width = self.heads * hd
        for j, dev in enumerate(attn_devices):
            # q, k and v of heads [j·heads, (j+1)·heads): three runs of qkv's outputs
            rows = torch.cat([torch.arange(s * d + j * width, s * d + (j + 1) * width)
                              for s in range(3)])
            cols = torch.arange(j * width, (j + 1) * width)
            self._add(self.attn, f"attn.{j}", block.qkv, block.proj, rows, cols, dev,
                      ("qkv", "proj"))
        width = hidden // len(mlp_devices)
        for j, dev in enumerate(mlp_devices):
            cols = torch.arange(j * width, (j + 1) * width)
            self._add(self.mlp, f"mlp.{j}", block.fc1, block.fc2, cols, cols, dev, ("fc1", "fc2"))

    def _add(self, shards, prefix, col, row, rows, cols, dev, names):
        shards.append(_Shard(_cut((None, 0, rows), col.weight.detach()),
                             _cut((None, 0, rows), col.bias.detach()),
                             _cut((None, 1, cols), row.weight.detach()), dev,
                             col.weight.requires_grad))
        for name, cut in ((f"{names[0]}.weight", (f"{prefix}.w_in", 0, rows)),
                          (f"{names[0]}.bias", (f"{prefix}.b_in", 0, rows)),
                          (f"{names[1]}.weight", (f"{prefix}.w_out", 1, cols))):
            self._cuts.setdefault(name, []).append(cut)

    def cuts(self) -> Dict[str, List[Piece]]:
        """The whole block's parameter names → the pieces that hold them."""
        params = dict(self.named_parameters())
        return {name: [(params[p], dim, idx) for p, dim, idx in cut]
                for name, cut in self._cuts.items()}

    def forward(self, x):
        first = x.device

        def reduce(parts):
            out = parts[0].to(first)
            for p in parts[1:]:
                out = out + p.to(first)
            return out

        a = self.norm1(x)
        parts = [F.linear(attention(F.linear(a.to(s.w_in.device), s.w_in, s.b_in), self.heads),
                          s.w_out) for s in self.attn]
        x = x + (reduce(parts) + self.proj_b)
        h = self.norm2(x)
        parts = [F.linear(swish(F.linear(h.to(s.w_in.device), s.w_in, s.b_in)), s.w_out)
                 for s in self.mlp]
        return x + (reduce(parts) + self.fc2_b)


def split_rec(model: RecSVTR, devices: Sequence[torch.device]) -> RecSVTR:
    """A copy of the recognizer on ``devices[0]`` whose SVTR blocks are
    split over ``devices`` (a plain copy for one device)."""
    row = copy.deepcopy(model).to(devices[0])
    if len(devices) > 1:
        for i, blk in enumerate(row.svtr):
            row.svtr[i] = SplitSVTRBlock(blk, devices)
    return row


def _pieces(row: nn.Module) -> Dict[str, List[Piece]]:
    """The whole model's parameter names → the pieces of ``row`` (a copy
    made by :func:`split_rec`, or a plain copy) that hold them."""
    out: Dict[str, List[Piece]] = {}
    split = []
    for name, mod in row.named_modules():
        if isinstance(mod, SplitSVTRBlock):
            split.append(name + ".")
            out.update({f"{name}.{k}": v for k, v in mod.cuts().items()})
    for name, p in row.named_parameters():
        if not any(name.startswith(s) for s in split):
            out[name] = [(p, None, None)]
    return out


def _join(pieces: List[Piece], values: List[torch.Tensor], shape) -> torch.Tensor:
    """The whole tensor (on the CPU) from one value per piece."""
    if pieces[0][1] is None:
        return values[0].detach().cpu().clone()
    out = torch.empty(shape, dtype=values[0].dtype)
    for (_, dim, idx), v in zip(pieces, values):
        out.index_copy_(dim, idx, v.detach().cpu())
    return out


def _cut(piece: Piece, whole: torch.Tensor) -> torch.Tensor:
    """A new tensor holding the piece's part of ``whole``, on its device."""
    _, dim, idx = piece
    return whole.clone() if dim is None else whole.index_select(dim, idx.to(whole.device))


class MeshReplicas(nn.Module):
    """One copy of a model per data row of a mesh, on that row's first
    device; with ``split`` (a recognizer) each copy's SVTR blocks are split
    over its row's devices. The copies are separate modules even where
    rows share a device. A train step keeps them equal: every copy gets the
    gradients summed over all of them (:meth:`reduce_grads`) and makes the
    same update."""

    def __init__(self, whole: nn.Module, mesh, split: bool):
        super().__init__()
        self.rows = nn.ModuleList(
            split_rec(whole, row) if split else copy.deepcopy(whole).to(row[0])
            for row in mesh.grid)
        self._skeleton = [copy.deepcopy(whole).to("meta")]  # a list: not a submodule
        self._names = [name for name, _ in whole.named_parameters()]
        self._pieces = [_pieces(row) for row in self.rows]
        if any(sorted(p) != sorted(self._names) for p in self._pieces):
            raise ValueError("the split does not cover the model's parameters")

    def gather(self) -> nn.Module:
        """The whole model on the CPU, from the first row's copy."""
        whole = copy.deepcopy(self._skeleton[0]).to_empty(device="cpu")
        for name, p in whole.named_parameters():
            pieces = self._pieces[0][name]
            p.data.copy_(_join(pieces, [q for q, _, _ in pieces], p.shape))
        return whole.eval()

    def scatter(self, whole: nn.Module) -> None:
        """Copy a whole model's parameters into every row's copy."""
        for name, p in whole.named_parameters():
            for pieces in self._pieces:
                for piece in pieces[name]:
                    piece[0].data.copy_(_cut(piece, p.data))

    def reduce_grads(self) -> None:
        """Each parameter's gradient summed over the rows' copies on the
        first row's device, then handed to every copy (the same tensor
        where the device is the same), so that the copies stay equal."""
        if len(self.rows) == 1:
            return
        params = [[p for p in row.parameters() if p.grad is not None] for row in self.rows]
        total = [p.grad for p in params[0]]
        for ps in params[1:]:
            torch._foreach_add_(total, [p.grad.to(t.device) for p, t in zip(ps, total)])
        for ps in params[1:]:
            for p, t in zip(ps, total):
                p.grad = t if p.device == t.device else t.to(p.device)

    def optimizer_state(self, optimizers) -> Dict:
        """The rows' optimizers' ``state_dict`` in the layout of one
        optimizer over the whole model's parameters (the first row's)."""
        opt = optimizers[0]
        shapes = dict(self._skeleton[0].named_parameters())
        state = {}
        for k, name in enumerate(self._names):
            pieces = self._pieces[0][name]
            states = [opt.state.get(q) for q, _, _ in pieces]
            if not states[0]:
                continue
            state[k] = {}
            for key, v in states[0].items():
                if torch.is_tensor(v) and v.dim() > 0:  # shaped as the parameter
                    state[k][key] = _join(pieces, [s[key] for s in states], shapes[name].shape)
                else:  # the count of updates
                    state[k][key] = v.clone() if torch.is_tensor(v) else v
        (group,) = opt.state_dict()["param_groups"]
        return {"state": state,
                "param_groups": [{**group, "params": list(range(len(self._names)))}]}

    def load_optimizer_state(self, optimizers, state_dict: Dict) -> None:
        """Load a whole-model optimizer ``state_dict`` (as
        :meth:`optimizer_state` gives, or a one-device run's) into every
        row's optimizer."""
        (group,) = state_dict["param_groups"]
        for row, pieces, opt in zip(self.rows, self._pieces, optimizers):
            index = {id(p): i for i, p in enumerate(row.parameters())}
            state = {}
            for k, name in enumerate(self._names):
                whole = state_dict["state"].get(k)
                if whole is None:
                    continue
                for piece in pieces[name]:
                    # every copy gets tensors of its own: AdamW updates them in place
                    state[index[id(piece[0])]] = {
                        key: (_cut(piece, v) if torch.is_tensor(v) and v.dim() > 0
                              else v.clone() if torch.is_tensor(v) else v)
                        for key, v in whole.items()}
            opt.load_state_dict({"state": state, "param_groups": [
                {**group, "params": list(range(len(index)))}]})
