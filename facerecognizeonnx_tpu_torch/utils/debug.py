"""Numerics debugging helpers: trapping non-finite values and validating
parameters.

Port of `facerecognizeonnx_tpu/utils/debug.py` for the port's param trees
(nested dicts, lists and tuples of numpy arrays or tensors; an
`nn.Module` is taken as its `state_dict`). torch has no counterpart of
`jax_debug_nans`, so `nan_checks` is a global forward hook: while it is
open, the first module output that holds a NaN or an infinity raises and
names the module.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import numpy as np
import torch
from torch import nn


def _leaves_with_path(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(keystr-style path, leaf) pairs, dict keys in sorted order and None
    skipped, as `jax.tree_util.tree_leaves_with_path` walks a pytree."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _outputs(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _outputs(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _outputs(v)


def _check_finite(module: nn.Module, inputs, output) -> None:
    for t in _outputs(output):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            n_bad = int((~torch.isfinite(t)).sum())
            raise FloatingPointError(
                f"non-finite values in the output of {type(module).__name__}: "
                f"{n_bad}/{t.numel()} of a {tuple(t.shape)} {t.dtype} tensor"
            )


@contextlib.contextmanager
def nan_checks():
    """Inside the context every module's output is checked: the first one
    that holds a NaN or an infinity raises FloatingPointError naming the
    module. Each check reads the device, so this is for debugging only."""
    handle = nn.modules.module.register_module_forward_hook(_check_finite)
    try:
        yield
    finally:
        handle.remove()


def validate_params(params, name: str = "params") -> List[str]:
    """Return a list of problems (non-finite leaves, empty arrays)."""
    problems: List[str] = []
    for path, leaf in _leaves_with_path(params):
        arr = _as_numpy(leaf)
        key = name + path
        if arr.size == 0:
            problems.append(f"{key}: empty array")
        elif np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            problems.append(f"{key}: {n_bad}/{arr.size} non-finite values")
    return problems


def tree_summary(params) -> Tuple[int, int]:
    """(num_leaves, num_parameters)."""
    leaves = [leaf for _, leaf in _leaves_with_path(params)]
    return len(leaves), sum(int(_as_numpy(leaf).size) for leaf in leaves)
