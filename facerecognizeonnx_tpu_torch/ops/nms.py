"""Fixed-shape greedy NMS over batched candidate sets.

Port of `facerecognizeonnx_tpu/ops/nms.py`: greedy suppression in score
order, computed as the same fixpoint — keep[i] = no kept higher-scoring
box overlaps i — iterated until no frame's keep mask changes. The batch
dimension is written out instead of vmapped. The loop runs
`ITERS_PER_CHECK` iterations between host checks: iterating past the
fixpoint changes nothing, so the result is exact, and a call whose
suppression chains are shorter syncs with the host once. (The
reference's loop runs on the device, `lax.while_loop`; a loop without a
host check is ROADMAP.md Queue A item 18b.) `nms_fixed.iterations`
counts calls by the iterations the reference's loop would run (the
changing ones plus the one that confirms the fixpoint).

`int_rects=True` computes IoU on integer-truncated rects, as a C int
cast does: x=trunc(x1), y=trunc(y1), w=trunc(x2-x1), h=trunc(y2-y1).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional, Tuple

import torch

# fixpoint iterations between two host checks. chip_smoke.py's drive on
# the card saw 1 or 2 per call, and the reference puts real face layouts
# at 2-4, so a call checks the host once
ITERS_PER_CHECK = 4
_iterations_lock = threading.Lock()


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., M, 4) x1,y1,x2,y2 boxes
    → (..., N, M)."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = torch.clamp_min(ix2 - ix1, 0.0) * torch.clamp_min(iy2 - iy1, 0.0)
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def _int_rects(boxes: torch.Tensor) -> torch.Tensor:
    """Integer-truncated rects: (int)x1, (int)y1, (int)(x2-x1), (int)(y2-y1)."""
    x1 = torch.trunc(boxes[..., 0])
    y1 = torch.trunc(boxes[..., 1])
    w = torch.trunc(boxes[..., 2] - boxes[..., 0])
    h = torch.trunc(boxes[..., 3] - boxes[..., 1])
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) indexed along dim 1 by idx (B, K')."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    assume_sorted: bool = False,
    int_rects: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over fixed-size candidate sets.

    boxes: (B, K, 4); scores: (B, K); valid: optional (B, K) bool.
    assume_sorted=True skips the re-sort when
    the caller provides descending-score order. Returns (boxes, scores,
    keep, order): boxes/scores sorted by descending score (invalid
    scores are -inf), keep the survivor mask in that order, order the
    original indices.
    """
    B, K = scores.shape
    if valid is None:
        valid = torch.ones((B, K), dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    if assume_sorted:
        order = torch.arange(K, device=scores.device).expand(B, K)
        boxes_s, scores_s, valid_s = boxes, masked, valid
    else:
        order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
        boxes_s = gather_rows(boxes, order)
        scores_s = gather_rows(masked, order)
        valid_s = gather_rows(valid, order)

    iou_boxes = _int_rects(boxes_s) if int_rects else boxes_s
    iou = iou_matrix(iou_boxes, iou_boxes)
    # suppressor[b, j, i]: j ranks strictly above i and overlaps it
    suppressor = torch.triu(iou > iou_threshold, diagonal=1)

    keep, n_changed = valid_s, 0
    while True:
        changed = []
        for _ in range(ITERS_PER_CHECK):
            new_keep = valid_s & ~(suppressor & keep[:, :, None]).any(dim=1)
            changed.append((new_keep != keep).any())
            keep = new_keep
        # the changing iterations come first; once one changes nothing,
        # none after it does. One host sync per ITERS_PER_CHECK iterations.
        batch_changed = int(torch.stack(changed).sum())
        n_changed += batch_changed
        if batch_changed < ITERS_PER_CHECK:
            break
    with _iterations_lock:
        nms_fixed.iterations[n_changed + 1] += 1
    return boxes_s, scores_s, keep, order


nms_fixed.iterations = collections.Counter()
