"""Stage-pipelined (pipeline-parallel) frame → features inference.

Port of `facerecognizeonnx_tpu/parallel/pipeline_stage.py` on
`torch.distributed`. The fused step (`pipeline/fused.py`) splits into TWO
stages over a mesh "stage" axis of size 2:

  stage 0 — normalize → SCRFD → decode → NMS → align → warp (the warp
            kernel on the card), on the detector ranks;
  stage 1 — the recognizer → L2 norm, on the embed ranks.

Microbatches flow stage 0 → stage 1 by `batch_isend_irecv` (the
`lax.ppermute` of the JAX package): while stage 0 detects and aligns
microbatch t, stage 1 embeds microbatch t−1. Each rank runs only its
own stage's work and holds only its stage's weights: the recognizer
never sits on a stage-0 rank. The wire carries embed-ready crops and
fixed-shape Detections (valid as int32), each tensor behind a small
shape header. At the end stage 1's results are replicated over the
stage axis by a sum with stage 0's zeros, as the JAX `psum` does.

Composes with data parallelism on a ("data", "stage") mesh and with
tensor parallelism of the embed stage over a "model" axis
(`parallel/tensor_parallel.py`): the full dp × pp × tp mesh.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.embed.pipeline import align_faces_batch, embed_crops
from facerecognizeonnx_tpu_torch.models.layers import l2_normalize
from facerecognizeonnx_tpu_torch.parallel.mesh import (
    axis_size,
    block,
    gather_rows,
    has_axis,
    in_mesh,
    make_mesh,
    mesh_device,
    pad_rows,
    share_with_outsiders,
)
from facerecognizeonnx_tpu_torch.parallel.sharded_ops import module_on
from facerecognizeonnx_tpu_torch.pipeline.fused import detect_topk
from facerecognizeonnx_tpu_torch.types import Detections

N_STAGES = 2  # detect+align | embed
_MAX_DIMS = 6
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.uint8)


def _send(tensors: List[torch.Tensor], peer: int, group) -> None:
    """Each tensor behind a header (dtype code, ndim, dims) to global
    rank `peer`; returns when the sends are done."""
    ops = []
    for t in tensors:
        t = t.contiguous()
        head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64, device=t.device)
        head[0], head[1] = _DTYPES.index(t.dtype), t.dim()
        head[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        ops += [dist.P2POp(dist.isend, head, peer, group), dist.P2POp(dist.isend, t, peer, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _recv(n: int, peer: int, group, device) -> List[torch.Tensor]:
    out = []
    for _ in range(n):
        head = torch.empty(2 + _MAX_DIMS, dtype=torch.int64, device=device)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.irecv, head, peer, group)]):
            work.wait()
        code, ndim = int(head[0]), int(head[1])
        t = torch.empty(tuple(head[2:2 + ndim].tolist()), dtype=_DTYPES[code], device=device)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.irecv, t, peer, group)]):
            work.wait()
        out.append(t)
    return out


def _detect_align_stage(det, frames_mb, cfg: PipelineConfig, k: int):
    """Stage 0: (M, S, S, 3) uint8 frames → (embed-ready crops,
    Detections): the front half of `pipeline.fused.frames_to_features`."""
    dets, top = detect_topk(det, frames_mb, cfg, k)
    crops = align_faces_batch(
        frames_mb, top.kps, top.boxes, cfg,
        valid=top.valid if cfg.skip_invalid_faces else None, normalized=True,
    )
    return crops, dets


def _embed_stage(arc, crops, valid, cfg: PipelineConfig, tp=None):
    """Stage 1: (M, K, S, S, 3) crops → (M, K, 512) features; with `tp`
    (local module, group, n) the recognizer is channel-sharded."""
    m, k = crops.shape[0], crops.shape[1]
    flat = crops.reshape((m * k,) + tuple(crops.shape[2:]))
    if tp is None:
        feats = embed_crops(arc, flat, cfg, normalized=True)
    else:
        from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import tp_apply

        dt = cfg.torch_compute_dtype
        feats = l2_normalize(tp_apply(tp[0], flat.to(dt), tp[1], tp[2], dt))
    return feats.reshape(m, k, -1) * valid[..., None].to(torch.float32)


def _plain_recognizer(arc) -> bool:
    from facerecognizeonnx_tpu_torch.models.arcface import IResNet
    from facerecognizeonnx_tpu_torch.models.quant import is_quantized
    from facerecognizeonnx_tpu_torch.models.vit import ViT

    if isinstance(arc, dict):
        return True
    return isinstance(arc, (IResNet, ViT)) and not is_quantized(arc)


def pipelined_frames_to_features(
    det_params,
    arc_params,
    frames_u8,
    cfg: PipelineConfig,
    mesh=None,
    max_faces_embed: int = 8,
    n_micro: int = 2,
    data_axis: str = "data",
    stage_axis: str = "stage",
    model_axis: str = "model",
    device="cuda",
) -> Tuple[Detections, torch.Tensor]:
    """Stage-pipelined fused inference over `mesh[stage_axis]` (size 2).

    frames_u8: (B, S, S, 3) letterboxed BGR uint8. Returns what
    `pipeline.fused.frames_to_features` returns for the same inputs
    ((Detections over cfg.max_faces slots, (B, K, 512) features)): the
    pipelining is a schedule, not a semantic. With `data_axis` in the
    mesh frames also split over it (dp × pp); B is padded to
    n_data · n_micro and the pad frames dropped. With `model_axis` (size
    > 1) the embed stage runs tensor-parallel over it (dp × pp × tp),
    which needs a plain IResNet / ViT recognizer."""
    if mesh is None:
        from facerecognizeonnx_tpu_torch.parallel.mesh import ensure_process_group

        ensure_process_group(device)
        n = dist.get_world_size()
        mesh = make_mesh((data_axis, stage_axis), (n // N_STAGES, N_STAGES), device=device)
    if axis_size(mesh, stage_axis) != N_STAGES or not has_axis(mesh, stage_axis):
        raise ValueError(
            f"mesh axis {stage_axis!r} must have size {N_STAGES}, got "
            f"{axis_size(mesh, stage_axis)}"
        )
    n_data = axis_size(mesh, data_axis)
    n_model = axis_size(mesh, model_axis)
    has_model = n_model > 1
    if has_model and not _plain_recognizer(arc_params):
        raise ValueError(
            "tensor-parallel embed stage needs a plain native param "
            f"pytree (IResNet/ViT); got {type(arc_params).__name__}"
        )
    tp_tree = None
    if has_model:
        from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import (
            _as_tree,
            pack_tp_params,
            recognizer_param_specs,
            validate_tp_width,
        )

        tp_tree = pack_tp_params(_as_tree(arc_params))
        validate_tp_width(tp_tree, n_model, model_axis)
        recognizer_param_specs(tp_tree, model_axis)

    b_real = frames_u8.shape[0]
    chunk = n_data * n_micro
    frames = pad_rows(torch.as_tensor(frames_u8), chunk)
    local_b = frames.shape[0] // n_data
    micro = local_b // n_micro
    k = max_faces_embed
    if not in_mesh(mesh):
        flat = share_with_outsiders(mesh, None)
        return Detections(*flat[:4]), flat[4]

    dev = mesh_device(mesh)
    stage = mesh.get_local_rank(stage_axis)
    sgroup = mesh.get_group(stage_axis)
    peer = dist.get_global_rank(sgroup, 1 - stage)
    local = block(frames, mesh, data_axis).to(dev)
    with torch.no_grad():
        if stage == 0:
            det = module_on(det_params, dev)
            dets_all = []
            for t in range(n_micro):
                crops, dets = _detect_align_stage(det, local[t * micro:(t + 1) * micro], cfg, k)
                _send([crops, dets.boxes, dets.scores, dets.kps, dets.valid.to(torch.int32)],
                      peer, sgroup)
                dets_all.append(dets)
            # stage 0 contributes zeros to the replicating sum
            feats = torch.zeros((local_b, k, cfg.feature_dim), dtype=torch.float32, device=dev)
            outs = [torch.zeros_like(torch.cat(ts)) for ts in zip(*dets_all)]
            outs[3] = outs[3].to(torch.int32)
        else:
            if has_model:
                from facerecognizeonnx_tpu_torch.parallel.tensor_parallel import local_module

                tp = (local_module(tp_tree, mesh.get_local_rank(model_axis), n_model,
                                   model_axis, device=dev),
                      mesh.get_group(model_axis), n_model)
                arc = None
            else:
                tp, arc = None, module_on(arc_params, dev)
            feat_list, dets_list = [], []
            for _ in range(n_micro):
                crops, boxes, scores, kps, valid = _recv(5, peer, sgroup, dev)
                feat_list.append(_embed_stage(arc, crops, valid[:, :k].bool(), cfg, tp))
                dets_list.append((boxes, scores, kps, valid))
            feats = torch.cat(feat_list)
            outs = [torch.cat(ts) for ts in zip(*dets_list)]
        # replicate stage 1's results over the stage axis
        for t in outs + [feats]:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=sgroup)
    flat = [gather_rows(t, mesh, data_axis)[:b_real] for t in outs + [feats]]
    flat[3] = flat[3].bool()
    flat = share_with_outsiders(mesh, flat)
    return Detections(*flat[:4]), flat[4]
