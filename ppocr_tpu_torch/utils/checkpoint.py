"""Load the npz parameter pytrees that ``ppocr_tpu`` saves.

A copy of the numpy half of ``ppocr_tpu/utils/checkpoint.py``: keys are
``/``-joined pytree paths, list levels have keys ``0..n-1``, and an empty
subtree is stored as a ``__empty__`` marker array.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_EMPTY = "__empty__"  # marker array for empty dict/list subtrees


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
