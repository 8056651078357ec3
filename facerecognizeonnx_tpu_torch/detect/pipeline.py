"""Batched detection: decoded anchors → fixed-K Detections.

Port of `facerecognizeonnx_tpu/detect/pipeline.py` (`postprocess`,
`detect_program`, `detect_batch_program`), with the batch dimension
written out:

  - strict `score > threshold` filter
  - coords rescaled by /scale to the original image
  - greedy NMS at IoU 0.4 on the top `pre_nms_topk` candidates
  - survivors compacted to the front in score order
"""

from __future__ import annotations

from typing import Optional

import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.detect.decode import decode_outputs
from facerecognizeonnx_tpu_torch.ops.image import letterbox, normalize_to_rgb
from facerecognizeonnx_tpu_torch.ops.nms import gather_rows, nms_fixed
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.types import Detections
from facerecognizeonnx_tpu_torch.utils.observability import span


def nms_candidates(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    kps: torch.Tensor,
    scale: float,
    cfg: PipelineConfig,
    score_threshold: Optional[float] = None,
):
    """Decoded anchors → the NMS input: the top `pre_nms_topk` anchors by
    score (descending, ties in index order) as (boxes, scores, kps,
    valid), coords divided by `scale`; valid = score > threshold."""
    score_thr = cfg.score_threshold if score_threshold is None else score_threshold
    ranked = torch.where(scores > score_thr, scores, torch.full_like(scores, -1.0))
    top_scores, idx = topk_stable(ranked, cfg.pre_nms_topk)
    inv = inv_k = 1.0 / scale
    if isinstance(scale, torch.Tensor):  # per-frame (B,) scales
        inv, inv_k = inv.reshape(-1, 1, 1), inv.reshape(-1, 1, 1, 1)
    top_boxes = gather_rows(boxes, idx) * inv
    top_kps = gather_rows(kps, idx) * inv_k
    return top_boxes, top_scores, top_kps, top_scores > score_thr


def postprocess(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    kps: torch.Tensor,
    scale: float,
    cfg: PipelineConfig,
    score_threshold: Optional[float] = None,
    nms_threshold: Optional[float] = None,
) -> Detections:
    """Decoded anchors → fixed-K Detections.

    scores (B, N), boxes (B, N, 4), kps (B, N, 5, 2) in letterboxed
    pixels; scale is one float or a (B,) float32 tensor of per-frame
    letterbox scales (coords are divided by it BEFORE NMS, as in the
    reference); returns (B, max_faces) slots.
    """
    with span("nms"):
        nms_thr = cfg.nms_threshold if nms_threshold is None else nms_threshold
        top_boxes, top_scores, top_kps, valid = nms_candidates(
            scores, boxes, kps, scale, cfg, score_threshold
        )
        # top-k output is already descending → skip the re-sort in NMS
        boxes_s, scores_s, keep, order = nms_fixed(
            top_boxes, top_scores, nms_thr, valid, assume_sorted=True,
            int_rects=cfg.nms_int_rects,
        )
        kps_s = gather_rows(top_kps, order)

        # compact survivors to the front (the stable sort keeps score order)
        sel = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)
        sel = sel[:, : cfg.max_faces]
        out_valid = gather_rows(keep, sel)
        zero = torch.zeros((), dtype=boxes_s.dtype, device=boxes_s.device)
        return Detections(
            boxes=torch.where(out_valid[..., None], gather_rows(boxes_s, sel), zero),
            scores=torch.where(out_valid, gather_rows(scores_s, sel), zero),
            kps=torch.where(out_valid[..., None, None], gather_rows(kps_s, sel), zero),
            valid=out_valid,
        )


def detect_program(
    model,
    image_u8: torch.Tensor,
    cfg: PipelineConfig,
    score_threshold: Optional[float] = None,
    nms_threshold: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Detections:
    """Full single-image detect: (H, W, 3) BGR uint8 → unbatched
    Detections in original-image pixels (letterbox on the image's
    device, /scale before NMS)."""
    dtype = cfg.torch_compute_dtype if compute_dtype is None else compute_dtype
    padded, scale = letterbox(image_u8, cfg.det_input_size)
    x = normalize_to_rgb(padded, cfg.pixel_mean, cfg.pixel_scale, dtype=dtype)[None]
    scores, boxes, kps = decode_outputs(
        model(x, dtype), cfg.det_input_size, cfg.num_anchors
    )
    dets = postprocess(scores, boxes, kps, scale, cfg, score_threshold, nms_threshold)
    return Detections(*(t[0] for t in dets))


def detect_batch_program(
    model,
    images_u8: torch.Tensor,
    cfg: PipelineConfig,
    score_threshold: Optional[float] = None,
    nms_threshold: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Detections:
    """Batched detect on pre-letterboxed (B, S, S, 3) BGR uint8 frames;
    coords in letterboxed pixels (scale=1)."""
    dtype = cfg.torch_compute_dtype if compute_dtype is None else compute_dtype
    x = normalize_to_rgb(images_u8, cfg.pixel_mean, cfg.pixel_scale, dtype=dtype)
    scores, boxes, kps = decode_outputs(
        model(x, dtype), cfg.det_input_size, cfg.num_anchors
    )
    return postprocess(scores, boxes, kps, 1.0, cfg, score_threshold, nms_threshold)
