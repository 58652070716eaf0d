"""Load and save the npz parameter pytrees that ``ppocr_tpu`` uses, and the
port's train checkpoints.

The npz half is a copy of ``ppocr_tpu/utils/checkpoint.py``'s: keys are
``/``-joined pytree paths, list levels have keys ``0..n-1``, and an empty
subtree is stored as a ``__empty__`` marker array.

``save_train_state`` / ``restore_train_state`` keep a ``train.TrainState``
under ``step_N/``: ``params.npz`` (the module's parameters in the JAX
layout, loadable by either package), ``optimizer.pt`` (the AdamW
``state_dict``) and ``state.json`` (the model kind and the count of
updates made, which the learning-rate schedule reads). A state trained
over a mesh is saved whole, in the same files as a one-device run's, and
either kind of state restores from either. These are not the
JAX package's orbax checkpoints and neither package reads the other's;
``params.npz`` and an exported ``weights.npz`` are what cross over.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict

import numpy as np

_EMPTY = "__empty__"  # marker array for empty dict/list subtrees


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{_EMPTY}"] = np.array("dict")
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY}"] = np.array("list")
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if _EMPTY in node:
            return [] if str(node[_EMPTY]) == "list" else {}
        keys = list(node.keys())
        # a list only when the keys are exactly 0..n-1
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(keys))):
                return [fix(node[str(i)]) for i in idx]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def load_params_npz(path: str):
    """Load a param pytree (nested dicts/lists of numpy arrays)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat)


def save_params_npz(path: str, params) -> str:
    """Save a nested param pytree of numpy arrays to one compressed .npz at
    exactly ``path``, atomically (temp file in the same directory, then
    ``os.replace``). Returns the path."""
    flat = _flatten(params)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def save_train_state(ckpt_dir: str, state, step: int | None = None) -> str:
    """Write ``state`` (a ``train.TrainState``) to ``ckpt_dir/step_N``
    (N = ``step``, default the state's update count), replacing any
    earlier one of that name: the files go to a temporary directory first,
    which is renamed into place. Returns the checkpoint's path."""
    import torch

    from ..models.jax_params import det_to_jax, rec_to_jax, whole_module
    from ..models.rec_svtr import RecSVTR

    step = int(step if step is not None else state.step)
    model = whole_module(state.model)
    kind = "rec" if isinstance(model, RecSVTR) else "det"
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        tree = rec_to_jax(model) if kind == "rec" else det_to_jax(model)
        save_params_npz(os.path.join(tmp, "params.npz"), tree)
        torch.save(state.optimizer.state_dict(), os.path.join(tmp, "optimizer.pt"))
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump({"kind": kind, "updates": int(state.step)}, f)
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def restore_train_state(path: str, template):
    """Load a checkpoint written by :func:`save_train_state` into
    ``template`` (a ``TrainState`` of the same model kind and head width,
    e.g. from the trainer's ``init_fn``): its module's parameters and its
    optimizer's state are overwritten in place. Returns the restored
    ``TrainState``; further steps continue the saved run exactly."""
    import torch

    from ..models.jax_params import det_from_jax, rec_from_jax

    with open(os.path.join(path, "state.json")) as f:
        meta = json.load(f)
    tree = load_params_npz(os.path.join(path, "params.npz"))
    loaded = rec_from_jax(tree) if meta["kind"] == "rec" else det_from_jax(tree)
    if hasattr(template.model, "scatter"):  # a mesh's copies
        template.model.scatter(loaded)
    else:
        template.model.load_state_dict(loaded.state_dict())
    opt = torch.load(os.path.join(path, "optimizer.pt"), map_location="cpu", weights_only=True)
    template.optimizer.load_state_dict(opt)
    return type(template)(template.model, template.optimizer, int(meta["updates"]))
