"""Load and save the npz parameter pytrees that ``ppocr_tpu`` uses.

A copy of the numpy half of ``ppocr_tpu/utils/checkpoint.py``: keys are
``/``-joined pytree paths, list levels have keys ``0..n-1``, and an empty
subtree is stored as a ``__empty__`` marker array.
"""

from __future__ import annotations

import os
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
