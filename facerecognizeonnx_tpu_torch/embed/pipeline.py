"""Batched alignment + embedding.

Port of `facerecognizeonnx_tpu/embed/pipeline.py`: K faces of each of B
frames align in one warp (the crop fallback for degenerate landmark fits
is an alternative affine matrix, so both share the warp), then embed;
and `embed_simple_program`, the whole-image embed.
"""

from __future__ import annotations

from typing import Optional

import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.models import recognizer_apply
from facerecognizeonnx_tpu_torch.models.layers import l2_normalize
from facerecognizeonnx_tpu_torch.ops.image import normalize_to_rgb, resize_bilinear
from facerecognizeonnx_tpu_torch.ops.umeyama import ARCFACE_DST_5PTS, umeyama
from facerecognizeonnx_tpu_torch.ops.warp import crop_resize_affine, warp_affine_batch
from facerecognizeonnx_tpu_torch.ops.warp_banded import warp_affine_banded
from facerecognizeonnx_tpu_torch.ops.warp_cuda import warp_affine_xm
from facerecognizeonnx_tpu_torch.utils.observability import span


def _align_matrices(kps, boxes, h, w, size):
    """Per-face warp matrices with the crop fallback selected per face."""
    M, valid = umeyama(kps, ARCFACE_DST_5PTS)
    clipped = torch.stack(
        [
            boxes[..., 0].clamp(0.0, w - 1.0),
            boxes[..., 1].clamp(0.0, h - 1.0),
            boxes[..., 2].clamp(1.0, float(w)),
            boxes[..., 3].clamp(1.0, float(h)),
        ],
        dim=-1,
    )
    M_fb = crop_resize_affine(clipped, size, size)
    return torch.where(valid[..., None, None], M, M_fb)


def align_faces_batch(
    frames_u8: torch.Tensor,
    kps: torch.Tensor,
    boxes: torch.Tensor,
    cfg: PipelineConfig,
    valid: Optional[torch.Tensor] = None,
    normalized: bool = False,
) -> torch.Tensor:
    """Align K faces of each of B frames → (B, K, S, S, 3).

    frames: (B, H, W, 3); kps: (B, K, 5, 2); boxes: (B, K, 4).
    normalized=True returns embed-ready (px-mean)/scale RGB instead of
    raw BGR crops (bf16 from the CUDA warp's fused epilogue, f32 from
    the gather and banded warps). valid (B, K): invalid slots are zeros
    in the output space (the CUDA warp skips their reads). warp_impl
    "pallas" runs the CUDA kernel, which has its semantics."""
    with span("align"):
        size = cfg.rec_input_size
        h, w = frames_u8.shape[1], frames_u8.shape[2]
        M_sel = _align_matrices(kps, boxes, h, w, size)
        if cfg.warp_impl in ("cuda", "pallas"):
            return warp_affine_xm(
                frames_u8.to(torch.uint8),
                M_sel,
                epilogue=(cfg.pixel_mean, cfg.pixel_scale) if normalized else None,
                valid=valid,
            )
        if cfg.warp_impl == "banded":
            crops = warp_affine_banded(frames_u8.to(torch.uint8), M_sel, size)
        else:
            crops = warp_affine_batch(frames_u8, M_sel, size, size)
        if normalized:
            crops = normalize_to_rgb(crops, cfg.pixel_mean, cfg.pixel_scale)
        if valid is not None:
            crops = crops * valid[..., None, None, None].to(crops.dtype)
        return crops


def align_faces(
    image_u8: torch.Tensor,
    kps: torch.Tensor,
    boxes: torch.Tensor,
    cfg: PipelineConfig,
) -> torch.Tensor:
    """Align K faces of one image → (K, 112, 112, 3) raw BGR crops.

    kps (K, 5, 2); boxes (K, 4) x1,y1,x2,y2, used only by the crop
    fallback when the similarity fit is degenerate."""
    return align_faces_batch(image_u8[None], kps[None], boxes[None], cfg)[0]


def embed_crops(
    model,
    crops: torch.Tensor,
    cfg: PipelineConfig,
    compute_dtype: Optional[torch.dtype] = None,
    normalized: bool = False,
) -> torch.Tensor:
    """(K, 112, 112, 3) crops → (K, 512) L2-normalized features.

    normalized=True: crops are already (px-mean)/scale RGB."""
    dtype = cfg.torch_compute_dtype if compute_dtype is None else compute_dtype
    with span("embed"):
        if normalized:
            x = crops.to(dtype)
        else:
            x = normalize_to_rgb(crops, cfg.pixel_mean, cfg.pixel_scale, dtype=dtype)
        return l2_normalize(recognizer_apply(model, x, dtype))


def embed_program(
    model,
    image_u8: torch.Tensor,
    kps: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    cfg: PipelineConfig,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Frame + K detections → (K, 512) features; invalid slots → zeros."""
    crops = align_faces_batch(
        image_u8[None], kps[None], boxes[None], cfg,
        valid=valid[None], normalized=True,
    )[0]
    feats = embed_crops(model, crops, cfg, compute_dtype, normalized=True)
    return feats * valid[:, None].to(feats.dtype)


def embed_simple_program(
    model,
    image_u8: torch.Tensor,
    cfg: PipelineConfig,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """extractFeatureSimple: whole image → bilinear resize to 112 →
    embed → (512,) feature (no detection or alignment)."""
    size = cfg.rec_input_size
    resized = resize_bilinear(image_u8, size, size)
    return embed_crops(model, resized[None], cfg, compute_dtype)[0]
