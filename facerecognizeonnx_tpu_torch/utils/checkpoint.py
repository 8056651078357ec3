"""Parameter checkpoints: nested param trees ↔ flat-keyed `.npz`.

The port's own copy of `facerecognizeonnx_tpu/utils/checkpoint.py`'s
`.npz` format (keys are the tree path joined by "/", list positions as
decimal keys), so a file saved by either package loads in the other.
Numpy only. The orbax train-state functions come with the training
slice (ROADMAP.md Queue A item 17).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _flatten(tree, prefix=""):
    flat = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("/"): tree}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_params(path: str, params) -> None:
    """Write a param tree (leaves: numpy arrays or array-likes) to `path`."""
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str):
    """Read a param tree written by either package's `save_params`."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
