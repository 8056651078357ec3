"""The frame→identity path: frames → detections → features → gallery top-k.

Port of `facerecognizeonnx_tpu/pipeline/fused.py`, the port's main
entry points: normalize → SCRFD → decode → top-k → NMS → per-face
Umeyama align → warp (the CUDA kernel with `warp_impl="cuda"`) →
the recognizer (IResNet, MobileFaceNet, ViT, or a w8a8 copy) → L2 norm,
and optionally the gallery similarity top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.detect.decode import decode_outputs
from facerecognizeonnx_tpu_torch.detect.pipeline import postprocess
from facerecognizeonnx_tpu_torch.embed.pipeline import align_faces_batch, embed_crops
from facerecognizeonnx_tpu_torch.match.similarity import similarity_matrix
from facerecognizeonnx_tpu_torch.ops.image import normalize_to_rgb
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.types import Detections
from facerecognizeonnx_tpu_torch.utils.observability import span


def detect_topk(
    det_model,
    frames_u8: torch.Tensor,
    cfg: PipelineConfig,
    max_faces_embed: int = 8,
    compute_dtype: Optional[torch.dtype] = None,
    valid_cap: Optional[int] = None,
) -> Tuple[Detections, Detections]:
    """Front half: frames → (all Detections, top-K Detections to embed).

    valid_cap is a BENCHMARK control: when set, exactly the first
    `valid_cap` of the K embed slots count as occupied, whatever the
    detector found. Leave None in production."""
    dtype = cfg.torch_compute_dtype if compute_dtype is None else compute_dtype
    with span("detect"):
        x = normalize_to_rgb(frames_u8, cfg.pixel_mean, cfg.pixel_scale, dtype=dtype)
        outputs = det_model(x, dtype)
    scores, boxes, kps = decode_outputs(outputs, cfg.det_input_size, cfg.num_anchors)
    dets = postprocess(scores, boxes, kps, 1.0, cfg)

    with span("nms"):  # the top-K slot cut
        k = max_faces_embed
        valid_k = dets.valid[:, :k]
        if valid_cap is not None:
            valid_k = (
                torch.arange(k, device=valid_k.device)[None, :] < valid_cap
            ).expand(valid_k.shape)
        top = Detections(
            boxes=dets.boxes[:, :k],
            scores=dets.scores[:, :k],
            kps=dets.kps[:, :k],
            valid=valid_k,
        )
    return dets, top


def frames_to_features(
    det_model,
    rec_model,
    frames_u8: torch.Tensor,
    cfg: PipelineConfig,
    max_faces_embed: int = 8,
    compute_dtype: Optional[torch.dtype] = None,
    valid_cap: Optional[int] = None,
) -> Tuple[Detections, torch.Tensor]:
    """(B, S, S, 3) letterboxed BGR uint8 frames → (Detections,
    (B, K, 512) features); invalid slots give zero features.

    The crops are always normalized by the warp (the CUDA kernel's bf16
    epilogue), whatever the compute dtype — as the JAX program does."""
    dtype = cfg.torch_compute_dtype if compute_dtype is None else compute_dtype
    dets, top = detect_topk(det_model, frames_u8, cfg, max_faces_embed, dtype, valid_cap)
    crops = align_faces_batch(
        frames_u8, top.kps, top.boxes, cfg,
        valid=top.valid if cfg.skip_invalid_faces else None,
        normalized=True,
    )
    b, kk = crops.shape[0], crops.shape[1]
    feats = embed_crops(
        rec_model, crops.reshape((b * kk,) + crops.shape[2:]), cfg, dtype,
        normalized=True,
    )
    feats = feats.reshape(b, kk, -1) * top.valid[..., None].to(torch.float32)
    return dets, feats


def frames_to_matches(
    det_model,
    rec_model,
    frames_u8: torch.Tensor,
    bank_padded: torch.Tensor,
    n_rows: Union[int, torch.Tensor],
    cfg: PipelineConfig,
    max_faces_embed: int = 8,
    top_k: int = 5,
    compute_dtype: Optional[torch.dtype] = None,
    valid_cap: Optional[int] = None,
):
    """Identify: frames → features → gallery top-k.

    bank_padded: (Gpad, D) L2-normalized gallery rows, zero-padded to a
    size bucket; rows ≥ n_rows are masked to sim −1 before the top-k.
    Returns (Detections, (B, K, D) feats, (B, K, top_k) sims on the
    (cos+1)/2 scale, (B, K, top_k) int32 row indices, as `lax.top_k`
    gives them); masked entries carry sim −1."""
    with span("identify"):
        dets, feats = frames_to_features(
            det_model, rec_model, frames_u8, cfg, max_faces_embed, compute_dtype,
            valid_cap,
        )
        b, k, d = feats.shape
        with span("match"):
            sims = similarity_matrix(feats.reshape(b * k, d), bank_padded)
            mask = torch.arange(bank_padded.shape[0], device=sims.device)[None, :] < n_rows
            sims = torch.where(mask, sims, torch.full_like(sims, -1.0))
            v, i = topk_stable(sims, top_k)
        return dets, feats, v.reshape(b, k, top_k), i.to(torch.int32).reshape(b, k, top_k)
