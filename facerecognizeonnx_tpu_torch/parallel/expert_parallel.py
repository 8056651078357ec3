"""Expert parallelism: per-domain specialist recognizers over a mesh.

Port of `facerecognizeonnx_tpu/parallel/expert_parallel.py` on
`torch.distributed`. Several SPECIALIST recognizers of one architecture
(per-pose / per-camera fine-tunes) are spread over a mesh "expert" axis:
rank j keeps only experts [j·E/n, (j+1)·E/n) as modules on its device.
Each face crop is routed to its expert's rank in capacity-bucketed
buffers by one `all_to_all_single` (the tiled `lax.all_to_all` of the
JAX package), embedded there, and its feature comes back by a second
one. Ranks exchange crops and features, never weights.

Routing contract: `expert_ids` is any int array the caller computed (a
learned gate, a quality score, or `route_by_yaw`). Within one program
step, faces beyond an expert's capacity, or with an id outside [0, E),
are not embedded: their rows are zero and `routed` is False.
`ep_embed_crops` recovers overflow (overflow="rerun", the default) by
running the leftovers through the same program until every valid-id
face carries its expert's feature; ids outside [0, E) stay unrouted.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.parallel.mesh import (
    axis_size,
    gather_rows,
    in_mesh,
    make_mesh,
    mesh_device,
    pad_rows,
    share_with_outsiders,
)


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(t) for t in tree)
    return None


def _stack(trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(t0))]
    return np.stack([np.asarray(t) for t in trees])


def _index(tree, e: int):
    if isinstance(tree, dict):
        return {k: _index(v, e) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, e) for v in tree]
    return tree[e]


def stack_experts(params_list: Sequence) -> Tuple:
    """Stack E same-architecture recognizers (JAX-layout numpy trees or
    modules of the port) along a new leading axis of every leaf, on the
    host. Returns (stacked_tree, E); mixed architectures raise."""
    if not params_list:
        raise ValueError("need at least one expert")
    from facerecognizeonnx_tpu_torch.bridge import tree_from_module

    trees = [p if isinstance(p, dict) else tree_from_module(p) for p in params_list]
    structures = {_structure(t) for t in trees}
    if len(structures) != 1:
        raise ValueError(
            "experts must share one architecture (param tree structures "
            f"differ: {len(structures)} distinct)"
        )
    return _stack(trees), len(trees)


def route_by_yaw(kps, n_experts: int) -> torch.Tensor:
    """Demonstration router: bucket faces by head yaw from the 5 raw
    landmarks. The nose x relative to the eye span is a monotone yaw
    proxy (~0.5 frontal, toward 0 / 1 in profile); buckets split [0, 1]
    evenly. kps: (..., 5, 2) pixels, landmark order left eye, right eye,
    nose, mouth corners. Returns int32 ids in [0, n_experts)."""
    kps = torch.as_tensor(kps, dtype=torch.float32)
    le_x, re_x, nose_x = kps[..., 0, 0], kps[..., 1, 0], kps[..., 2, 0]
    span = re_x - le_x
    safe = torch.where(span == 0, torch.ones_like(span), span)
    r = torch.where(span.abs() > 1e-6, (nose_x - le_x) / safe, torch.full_like(span, 0.5))
    r = r.clamp(0.0, 1.0 - 1e-6)
    return (r * n_experts).to(torch.int32)


def _all_to_all(buf: torch.Tensor, group) -> torch.Tensor:
    """Equal blocks along dim 0: block j goes to rank j of `group`; dim 0
    of the result indexes the SOURCE rank."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf.contiguous(), group=group)
    return out


def _dispatch_combine(x, ids, local_models, n, local_E, capacity, group, embed_fn):
    """One rank's MoE step: dispatch → expert compute → combine.

    x: (b, S, S, 3) uint8 local crops; ids: (b,) global expert ids.
    Returns (feats (b, 512), routed (b,) bool). E = n·local_E experts,
    expert e resident on rank e // local_E of the `n`-rank group."""
    b, tail = x.shape[0], tuple(x.shape[1:])
    E = n * local_E
    dev = x.device
    valid_id = (ids >= 0) & (ids < E)
    ids_c = torch.where(valid_id, ids, torch.zeros_like(ids)).long()
    # position of each face in its expert's bucket: the count of earlier
    # faces for the same expert (invalid ids take no slot)
    oh = torch.nn.functional.one_hot(ids_c, E) * valid_id[:, None].long()
    pos = torch.gather(torch.cumsum(oh, dim=0), 1, ids_c[:, None])[:, 0] - 1
    keep = valid_id & (pos < capacity)
    buf = torch.zeros((E, capacity) + tail, dtype=x.dtype, device=dev)
    buf[ids_c[keep], pos[keep]] = x[keep]
    # rank j receives the blocks for its experts [j·local_E, (j+1)·local_E)
    recv = _all_to_all(buf.reshape((n, local_E * capacity) + tail), group)
    xbuf = recv.reshape((n, local_E, capacity) + tail).transpose(0, 1)
    xbuf = xbuf.reshape((local_E, n * capacity) + tail)
    feats = torch.stack([embed_fn(local_models[e], xbuf[e]) for e in range(local_E)])
    d = feats.shape[-1]
    # inverse route: features travel back to their faces' home ranks
    fbuf = feats.reshape(local_E, n, capacity, d).transpose(0, 1).reshape(n, local_E * capacity, d)
    fbuf = _all_to_all(fbuf, group).reshape(E, capacity, d)
    out = fbuf[ids_c, pos.clamp(0, capacity - 1)]
    out = torch.where(keep[:, None], out, torch.zeros_like(out))
    return out, keep


def make_ep_program(
    stacked_params,
    n_experts: int,
    cfg: PipelineConfig,
    mesh=None,
    axis: str = "expert",
    data_axis: Optional[str] = None,
    capacity_factor: float = 1.25,
    local_batch: int = 8,
    device="cuda",
):
    """Build the expert-parallel embed program ONCE; returns (program, mesh).

    `program(crops_u8, expert_ids)` takes the global (B, S, S, 3) uint8
    BGR crops and per-crop ids, B = local_batch × (data-axis size ×
    expert-axis size): the batch splits over both axes (the expert axis
    doubles as a data axis on the way in), then faces cross to their
    expert's rank. Returns the global ((B, 512) features, (B,) routed).
    Capacity: ceil(capacity_factor × local_batch / E) slots per expert
    per source rank. Rank j builds modules for its local experts only."""
    from facerecognizeonnx_tpu_torch.bridge import params_from_numpy
    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops

    if mesh is None:
        mesh = make_mesh((axis,), device=device)
    n = axis_size(mesh, axis)
    if n_experts % n != 0:
        raise ValueError(f"{n_experts} experts not divisible over {n} shards")
    local_E = n_experts // n
    batch_axes = (data_axis, axis) if data_axis else (axis,)
    n_batch_shards = int(np.prod([axis_size(mesh, a) for a in batch_axes]))
    capacity = max(1, math.ceil(capacity_factor * local_batch / n_experts))
    member = in_mesh(mesh)
    if member:
        dev = mesh_device(mesh)
        j = mesh.get_local_rank(axis)
        local_models = [
            params_from_numpy(_index(stacked_params, e), device=dev)
            for e in range(j * local_E, (j + 1) * local_E)
        ]
        shard = 0
        for a in batch_axes:  # row-major over (data, expert)
            shard = shard * axis_size(mesh, a) + mesh.get_local_rank(a)
        group = mesh.get_group(axis)

    def embed_fn(model, xs):
        return embed_crops(model, xs, cfg)

    def program(crops_u8, expert_ids):
        if not member:
            return tuple(share_with_outsiders(mesh, None))
        lo = shard * local_batch
        x = torch.as_tensor(np.asarray(crops_u8)[lo:lo + local_batch]).to(dev)
        ids = torch.as_tensor(np.asarray(expert_ids, np.int64)[lo:lo + local_batch]).to(dev)
        with torch.no_grad():
            feats, routed = _dispatch_combine(
                x, ids, local_models, n, local_E, capacity, group, embed_fn
            )
        for a in reversed(batch_axes):  # expert blocks first, then data
            feats, routed = gather_rows(feats, mesh, a), gather_rows(routed, mesh, a)
        return tuple(share_with_outsiders(mesh, [feats, routed]))

    program.batch = local_batch * n_batch_shards
    program.capacity = capacity
    return program, mesh


def ep_embed_crops(
    params_list: Sequence,
    expert_ids,
    crops_bgr,
    cfg: PipelineConfig,
    mesh=None,
    axis: str = "expert",
    data_axis: Optional[str] = None,
    capacity_factor: float = 1.25,
    overflow: str = "rerun",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Route B crops across E specialist recognizers sharded over the
    mesh's expert axis. Returns host numpy ((B, 512) features, (B,)
    routed).

    overflow="rerun" (default): capacity-overflowed faces are compacted
    and re-run through the same program until every valid-id face has its
    expert's feature (a pass that routes nothing stops the loop).
    overflow="drop": one pass; overflowed rows stay zero, routed False.
    Ids outside [0, E) never route. B is padded to the batch-shard
    multiple with id −1 rows, which take no capacity. With mesh=None the
    mesh is the largest number of ranks (≤ the world size) that E
    divides, on `device`."""
    if overflow not in ("rerun", "drop"):
        raise ValueError(f"overflow must be 'rerun' or 'drop', got {overflow!r}")
    stacked, E = stack_experts(params_list)
    if mesh is None:
        if data_axis is not None:
            raise ValueError(
                "data_axis requires an explicit mesh carrying both axes "
                "(make_mesh((data_axis, axis), shape))"
            )
        from facerecognizeonnx_tpu_torch.parallel.mesh import ensure_process_group

        ensure_process_group(device)
        world = dist.get_world_size()
        n = max(d for d in range(1, min(E, world) + 1) if E % d == 0)
        mesh = make_mesh((axis,), ranks=range(n), device=device)
    batch_axes = (data_axis, axis) if data_axis else (axis,)
    n_shards = int(np.prod([axis_size(mesh, a) for a in batch_axes]))

    crops_host = pad_rows(np.asarray(crops_bgr), n_shards)
    b_real = np.asarray(crops_bgr).shape[0]
    ids_host = np.full(crops_host.shape[0], -1, np.int64)
    ids_host[:b_real] = np.asarray(expert_ids, np.int64)

    program, mesh = make_ep_program(
        stacked, E, cfg, mesh=mesh, axis=axis, data_axis=data_axis,
        capacity_factor=capacity_factor, local_batch=crops_host.shape[0] // n_shards,
    )
    feats, routed = (t.cpu().numpy() for t in program(crops_host, ids_host))
    if overflow == "rerun":
        valid = (ids_host >= 0) & (ids_host < E)
        while True:
            left = np.nonzero(valid & ~routed)[0]
            if len(left) == 0:
                break
            sub_crops = np.zeros_like(crops_host)
            sub_ids = np.full(crops_host.shape[0], -1, np.int64)
            sub_crops[: len(left)] = crops_host[left]
            sub_ids[: len(left)] = ids_host[left]
            f2, r2 = (t.cpu().numpy()[: len(left)] for t in program(sub_crops, sub_ids))
            if not r2.any():  # cannot happen with capacity ≥ 1
                break
            feats[left[r2]] = f2[r2]
            routed[left[r2]] = True
    return feats[:b_real], routed[:b_real]
