"""Device mesh over the ranks of a `torch.distributed` process group.

Port of `facerecognizeonnx_tpu/parallel/mesh.py`, with one deviation
from JAX: a JAX `Mesh` holds devices and one process may drive several,
while here each rank of the process group drives ONE device —
cuda:{rank % device_count} on the card, the CPU when the caller asks
for it. A mesh is a `torch.distributed.device_mesh.DeviceMesh` with
named axes:

  "data"  — batch / frame parallelism (enrollment, video streams)
  "model" — the long model axis: gallery rows, recognizer channels

Every axis line is a process group of its own (NCCL on CUDA, Gloo on
the CPU, each with a 60 s timeout), reached by `mesh.get_group(name)`;
a rank's block along an axis is `mesh.get_local_rank(name)`. Meshes are
cached, so a program that asks for the same mesh twice does not build
its communicators twice.

The SPMD contract of the parallel package: every rank calls a function
with the same global arguments, computes its own block, and returns the
global result. A rank outside a mesh built on a subset of the ranks
takes the result from the mesh's first rank (`share_with_outsiders`).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from facerecognizeonnx_tpu_torch.config import resolve_device
from facerecognizeonnx_tpu_torch.parallel.distributed import (
    GROUP_TIMEOUT,
    backend_for,
    bind_device,
)

_MESHES: Dict[tuple, DeviceMesh] = {}
_WORLD_GROUPS: Dict[tuple, object] = {}


def ensure_process_group(device) -> None:
    """No process group yet → a one-rank group (rank 0 of 1, a HashStore,
    NCCL for a CUDA device and Gloo for the CPU)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = backend_for(dev.type)
    bind_device(dev.type, 0)
    dist.init_process_group(
        backend, store=dist.HashStore(), rank=0, world_size=1, timeout=GROUP_TIMEOUT
    )


def _pg_key():
    return id(dist.group.WORLD)  # a new default group invalidates the caches


def world_group(device_type: str):
    """A group of every rank on the backend of `device_type` (cached).
    Every rank must create it in the same order, as any group."""
    key = (_pg_key(), device_type)
    if key not in _WORLD_GROUPS:
        _WORLD_GROUPS[key] = dist.new_group(
            backend=backend_for(device_type), timeout=GROUP_TIMEOUT
        )
    return _WORLD_GROUPS[key]


def make_mesh(
    axis_names: Sequence[str] = ("data", "model"),
    shape: Optional[Sequence[int]] = None,
    ranks: Optional[Sequence[int]] = None,
    device="cuda",
) -> DeviceMesh:
    """Mesh over all ranks (or the given ones, the counterpart of
    `devices=jax.devices()[:n]`), one device each.

    shape=None puts every rank on the FIRST axis and 1 on the rest: the
    right default for one card (everything degenerates to local compute)
    and for pure data parallelism. Every rank of the process group must
    call it with the same arguments (creating groups is collective)."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    ranks = list(range(dist.get_world_size())) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    names = tuple(axis_names)
    key = (_pg_key(), dev.type, names, shape, tuple(ranks))
    if key in _MESHES:
        return _MESHES[key]
    backend = backend_for(dev.type)
    world_group(dev.type)  # created here, in SPMD order, for share_with_outsiders
    me = dist.get_rank()
    grid = np.asarray(ranks, np.int64).reshape(shape)
    groups = []
    for dim in range(len(shape)):
        mine = None
        for line in np.moveaxis(grid, dim, -1).reshape(-1, shape[dim]):
            g = dist.new_group(line.tolist(), timeout=GROUP_TIMEOUT, backend=backend)
            if me in line:
                mine = g
        groups.append(mine)
    mesh_t = torch.tensor(grid, dtype=torch.int)
    if me in ranks:
        bind_device(dev.type, me)
        if len(shape) == 1:
            mesh = DeviceMesh.from_group(groups[0], dev.type, mesh_dim_names=names)
        else:
            mesh = DeviceMesh.from_group(groups, dev.type, mesh=mesh_t, mesh_dim_names=names)
    else:  # a rank outside the mesh holds its layout, and no group of it
        mesh = DeviceMesh(dev.type, mesh_t, mesh_dim_names=names, _init_backend=False)
    _MESHES[key] = mesh
    return mesh


def mesh_ranks(mesh: DeviceMesh) -> List[int]:
    return mesh.mesh.flatten().tolist()


def in_mesh(mesh: DeviceMesh) -> bool:
    return dist.get_rank() in mesh_ranks(mesh)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis `name`, 1 when the mesh has no such axis (JAX's
    `mesh.shape.get(name, 1)`)."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def has_axis(mesh: DeviceMesh, name: str) -> bool:
    return name in (mesh.mesh_dim_names or ())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device(mesh.device_type)


def pad_rows(x, multiple: int):
    """Zero rows appended to a numpy array or tensor up to a multiple of
    `multiple` (JAX `_pad_rows`)."""
    return pad_to(x, -(-x.shape[0] // multiple) * multiple)


def pad_to(x, n_rows: int):
    """Zero rows appended to a numpy array or tensor up to `n_rows`."""
    rem = n_rows - x.shape[0]
    if rem <= 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
    return np.concatenate([x, np.zeros((rem,) + x.shape[1:], x.dtype)], axis=0)


def gather_rows(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Every rank's block of rows along `axis`, concatenated in axis
    order: one all-gather (an axis absent from the mesh returns `t`)."""
    if not has_axis(mesh, axis):
        return t
    n = axis_size(mesh, axis)
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    all_gather_into_tensor(out, t, mesh.get_group(axis))
    return out


def all_gather_into_tensor(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """`dist.all_gather_into_tensor`, the name every supported torch has.
    torch 2.13 marks it deprecated for a name older releases lack; that
    one warning is silenced (the filter is set again at each call, since
    test runners and callers reset the filters)."""
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*deprecated")
    dist.all_gather_into_tensor(out, t, group=group)


def block(x, mesh: DeviceMesh, axis: str):
    """This rank's contiguous block of rows of `x` along `axis` (all of
    `x` when the mesh has no such axis). len(x) must divide evenly."""
    if not has_axis(mesh, axis):
        return x
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} '{axis}' shards")
    rows = x.shape[0] // n
    r = mesh.get_local_rank(axis)
    return x[r * rows:(r + 1) * rows]


def share_with_outsiders(mesh: DeviceMesh, tensors: Optional[List[torch.Tensor]]):
    """A mesh on a subset of the ranks: its first rank broadcasts its
    result (shapes first) to every rank over the world group, so a rank
    outside the mesh returns the same global answer. `tensors` is None
    there. A mesh over every rank returns `tensors` as they are."""
    ranks = mesh_ranks(mesh)
    if len(ranks) == dist.get_world_size():
        return tensors
    group, src = world_group(mesh.device_type), ranks[0]
    meta = [[(tuple(t.shape), t.dtype) for t in tensors] if dist.get_rank() == src else None]
    dist.broadcast_object_list(meta, src=src, group=group)
    dev = mesh_device(mesh)
    if tensors is None:
        tensors = [torch.empty(s, dtype=d, device=dev) for s, d in meta[0]]
    tensors = [t.contiguous() for t in tensors]
    for t in tensors:
        dist.broadcast(t, src, group=group)
    return tensors
