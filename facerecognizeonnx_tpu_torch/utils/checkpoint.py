"""Parameter checkpoints: nested param trees ↔ flat-keyed `.npz`.

The port's own copy of `facerecognizeonnx_tpu/utils/checkpoint.py`'s
`.npz` format (keys are the tree path joined by "/", list positions as
decimal keys), so a file saved by either package loads in the other.
Numpy only, apart from the train-state functions.

Train states (`save_train_state` / `load_train_state`) are the port's
own format, not the JAX package's orbax directory: one `.npz` holding
the backbone tree under "params/" in JAX keys and layouts, the
"classifier", each optimizer tree under "opt/<name>/" (the momentum
trace, or Adam's mu and nu, in the same keys, with "classifier"), and
"opt/count" and "step". It is written to a temporary file and renamed.
A state whose classifier is split over a mesh's "model" axis is
gathered on save (the mesh's first rank writes) and split on load.
"""

from __future__ import annotations

import io
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


# ------------------------------------------------------- training states


def _gather_cols(t, mesh):
    """The whole (D, C) matrix from each "model" rank's block of columns."""
    import torch
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.train.trainer import mesh_axis

    group, _, n = mesh_axis(mesh, "model")
    if group is None:
        return t.detach()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _mesh_barrier(mesh) -> None:
    """Every rank of the mesh waits for its first rank (model axis, then
    data axis: a rank's data-axis peer has passed the first rank's row)."""
    import torch
    import torch.distributed as dist

    from facerecognizeonnx_tpu_torch.parallel.mesh import mesh_device
    from facerecognizeonnx_tpu_torch.train.trainer import mesh_axis

    for axis in ("model", "data"):
        group = mesh_axis(mesh, axis)[0]
        if group is not None:
            dist.all_reduce(torch.zeros(1, device=mesh_device(mesh)), group=group)


def save_train_state(path: str, state, mesh=None) -> None:
    """Write a train state (train/trainer.py `TrainState`, or any state of
    the same fields) to `path` (module docstring)."""
    import torch

    from facerecognizeonnx_tpu_torch.bridge import tree_from_module, tree_from_tensors

    flat = {f"params/{k}": v for k, v in _flatten(tree_from_module(state.model)).items()}
    flat["classifier"] = _gather_cols(state.classifier, mesh).cpu().numpy()
    for name, val in state.opt_state.items():
        if isinstance(val, dict):
            rest = {k: t for k, t in val.items() if k != "classifier"}
            tree = tree_from_tensors(state.model, rest)
            flat.update({f"opt/{name}/params/{k}": v for k, v in _flatten(tree).items()})
            flat[f"opt/{name}/classifier"] = _gather_cols(val["classifier"], mesh).cpu().numpy()
        else:
            flat[f"opt/{name}"] = np.asarray(torch.as_tensor(val).cpu())
    flat["step"] = np.asarray(torch.as_tensor(state.step).cpu())
    first = mesh is None or torch.distributed.get_rank() == int(mesh.mesh.flatten()[0])
    if first:
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in flat.items()})
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    if mesh is not None:
        _mesh_barrier(mesh)


def load_train_state(path: str, like, mesh=None):
    """Restore a state written by `save_train_state` into `like` (a state
    of the same model, e.g. a fresh `init_train_state`): its model and
    classifier are overwritten in place; returns the state."""
    import torch

    from facerecognizeonnx_tpu_torch.bridge import load_tree_into, tensors_from_tree
    from facerecognizeonnx_tpu_torch.train.trainer import column_block

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}

    def sub(prefix):
        return _unflatten({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})

    dev = like.classifier.device
    load_tree_into(like.model, sub("params/"))
    with torch.no_grad():
        like.classifier.copy_(column_block(torch.from_numpy(flat["classifier"]), mesh).to(dev))
    opt_state = {}
    for name, val in like.opt_state.items():
        if isinstance(val, dict):
            tensors = tensors_from_tree(like.model, sub(f"opt/{name}/params/"))
            cls = column_block(torch.from_numpy(flat[f"opt/{name}/classifier"]), mesh)
            opt_state[name] = {**tensors, "classifier": cls.to(dev)}
        else:
            opt_state[name] = torch.from_numpy(flat[f"opt/{name}"])
    return like._replace(opt_state=opt_state, step=torch.from_numpy(flat["step"]))
