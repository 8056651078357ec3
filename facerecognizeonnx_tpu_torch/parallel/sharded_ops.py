"""Sharded collective ops: 1:N gallery search, batched embedding and the
data-parallel fused identify step.

Port of `facerecognizeonnx_tpu/parallel/sharded_ops.py` on
`torch.distributed` (see `parallel/mesh.py` for what a mesh is here).
Every function is called by every rank with the same global arguments
and returns the global result on every rank. The gallery search shards
ROWS over the "model" axis: each rank multiplies the queries by its row
block, takes a local top-k, and one all-gather of k candidates per rank
feeds the final top-k; the all-gather moves O(n·k) scalars, not O(G)
similarities. The data-parallel functions run each rank's contiguous
block of the batch (after the zero padding of `pad_rows`) and gather the
outputs; weights are replicated, and no collective runs on the forward
path.

`pack_recognizer` of the JAX package is not ported: it carries a
`QuantizedRecognizer` object through shard_map, while a w8a8 recognizer
of the port (`models/quant.py`) is a module and passes through as it is.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.parallel.mesh import (
    axis_size,
    block,
    gather_rows,
    in_mesh,
    make_mesh,
    mesh_device,
    pad_rows,
    pad_to,
    share_with_outsiders,
)
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.types import Detections

def module_on(model, device: torch.device):
    """`model` on `device`: itself when it lies there already, else a
    copy (the caller's module is never moved). A JAX-layout numpy tree
    becomes the port's module (`bridge.params_from_numpy`)."""
    if isinstance(model, dict):
        from facerecognizeonnx_tpu_torch.bridge import params_from_numpy

        return params_from_numpy(model, device=device)
    tensors = list(model.parameters()) + list(model.buffers())
    if all(t.device == device for t in tensors):
        return model
    return copy.deepcopy(model).to(device)


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` (a copy only when
    it lies elsewhere)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device)


def sharded_topk_search(
    queries,
    gallery,
    top_k: int,
    mesh=None,
    axis: str = "model",
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) queries × (G, D) gallery → (sims (Q, k) float32, global
    row indices (Q, k) int64) on the (cos+1)/2 scale, ties lower row
    first as `lax.top_k` orders them. Gallery rows are sharded across
    `axis`, the queries replicated; any mesh size, 1 included. `device`
    picks the default mesh's device when `mesh` is None."""
    if mesh is None:
        mesh = make_mesh((axis,), device=device)
    n_real = gallery.shape[0]
    top_k = min(top_k, n_real)
    if not in_mesh(mesh):
        return tuple(share_with_outsiders(mesh, None))
    dev = mesh_device(mesh)
    n = axis_size(mesh, axis)
    rows = -(-n_real // n)  # rows per shard after padding to a multiple of n
    r = mesh.get_local_rank(axis)
    # only this rank's row block is padded and moved, never the whole bank
    g_local = pad_to(gallery[r * rows:(r + 1) * rows], rows)
    g_local = as_tensor(g_local, dev).to(torch.float32)
    q = as_tensor(queries, dev).to(torch.float32)
    sims = (torch.matmul(q, g_local.t()) + 1.0) * 0.5
    global_ids = torch.arange(rows, device=dev) + r * rows
    sims = torch.where(global_ids[None, :] < n_real, sims, torch.full_like(sims, -float("inf")))
    # local candidates: no more than this shard's rows, so the gather
    # always carries at least top_k real candidates
    s, i = topk_stable(sims, min(top_k, rows))
    gi = global_ids[i]
    nq, lk = s.shape

    def cat_cols(t):  # (Q, lk) per rank → (Q, n·lk) in rank order
        return gather_rows(t, mesh, axis).reshape(n, nq, lk).permute(1, 0, 2).reshape(nq, n * lk)

    s_fin, sel = topk_stable(cat_cols(s), top_k)
    gi_fin = torch.gather(cat_cols(gi), 1, sel)
    return tuple(share_with_outsiders(mesh, [s_fin, gi_fin]))


def sharded_batch_embed(
    params,
    crops_bgr,
    cfg,
    mesh=None,
    axis: str = "data",
    device="cuda",
) -> torch.Tensor:
    """Data-parallel batched embedding: (B, S, S, 3) aligned BGR crops →
    (B, 512) L2-normalized features. B is padded to a multiple of the
    axis size, each rank embeds its block, one all-gather joins them.
    `params` is a recognizer module or a JAX-layout numpy tree."""
    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops

    if mesh is None:
        mesh = make_mesh((axis,), device=device)
    if not in_mesh(mesh):
        return share_with_outsiders(mesh, None)[0]
    dev = mesh_device(mesh)
    model = module_on(params, dev)
    b_real = crops_bgr.shape[0]
    local = block(pad_rows(crops_bgr, axis_size(mesh, axis)), mesh, axis)
    with torch.no_grad():
        feats = embed_crops(model, as_tensor(local, dev), cfg)
    return share_with_outsiders(mesh, [gather_rows(feats, mesh, axis)[:b_real]])[0]


def make_dp_program(
    det_params,
    arc_params,
    cfg,
    mesh=None,
    axis: str = "data",
    max_faces_embed: int = 8,
    search_top_k: Optional[int] = None,
    device="cuda",
):
    """Build the data-parallel fused identify program ONCE; returns
    (program, mesh).

    `program(frames_u8)` takes the global (B, S, S, 3) uint8 batch, B a
    multiple of the axis size, runs `pipeline.fused.frames_to_features`
    on this rank's block, and returns the global (Detections, (B, K, 512)
    features). The detector and recognizer (modules, w8a8 copies
    included, or numpy trees) are placed on the rank's device here, once.

    search_top_k, when set, runs `frames_to_matches` instead, the gallery
    bank replicated: `program(frames, bank_padded, n_rows)` returns the
    global (Detections, feats, sims, idx)."""
    from facerecognizeonnx_tpu_torch.pipeline.fused import (
        frames_to_features,
        frames_to_matches,
    )

    if mesh is None:
        mesh = make_mesh((axis,), device=device)
    member = in_mesh(mesh)
    if member:
        dev = mesh_device(mesh)
        det, arc = module_on(det_params, dev), module_on(arc_params, dev)

    def _finish(outs):
        flat = None
        if outs is not None:
            flat = [gather_rows(t, mesh, axis) for t in list(outs[0]) + list(outs[1:])]
        flat = share_with_outsiders(mesh, flat)
        return (Detections(*flat[:4]),) + tuple(flat[4:])

    if search_top_k is None:

        def program(frames_u8):
            if not member:
                return _finish(None)
            x = as_tensor(block(frames_u8, mesh, axis), dev)
            with torch.no_grad():
                return _finish(frames_to_features(det, arc, x, cfg, max_faces_embed))

    else:

        def program(frames_u8, bank_padded, n_rows):
            if not member:
                return _finish(None)
            x = as_tensor(block(frames_u8, mesh, axis), dev)
            with torch.no_grad():
                return _finish(frames_to_matches(
                    det, arc, x, as_tensor(bank_padded, dev), int(n_rows), cfg,
                    max_faces_embed, search_top_k,
                ))

    return program, mesh


def sharded_frames_to_features(
    det_params,
    arc_params,
    frames_u8,
    cfg,
    mesh=None,
    axis: str = "data",
    max_faces_embed: int = 8,
    device="cuda",
):
    """One-shot convenience over make_dp_program: pad the batch to the
    axis size, run, return (Detections, (B, K, 512) features) for the
    REAL B frames (pad frames give valid=False slots and are dropped)."""
    program, mesh = make_dp_program(
        det_params, arc_params, cfg, mesh=mesh, axis=axis,
        max_faces_embed=max_faces_embed, device=device,
    )
    b_real = frames_u8.shape[0]
    dets, feats = program(pad_rows(frames_u8, axis_size(mesh, axis)))
    return Detections(*(t[:b_real] for t in dets)), feats[:b_real]
