"""SCRFD anchor-free decode across stride-8/16/32 heads.

Port of `facerecognizeonnx_tpu/detect/decode.py` (InsightFace SCRFD
semantics):

  centers: (x, y) = (ix, iy) * stride, row-major over the H×W grid,
           repeated num_anchors times per location (interleaved)
  bbox:    x1 = cx - l*s, y1 = cy - t*s, x2 = cx + r*s, y2 = cy + b*s
  kps:     px_i = cx + dx_i*s, py_i = cy + dy_i*s
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.utils import observability


@functools.lru_cache(maxsize=16)
def anchor_centers(input_size: int, stride: int, num_anchors: int = 2) -> np.ndarray:
    """(H*W*num_anchors, 2) anchor center pixels for one stride level;
    row-major (y outer, x inner), anchor index fastest."""
    hw = input_size // stride
    xs, ys = np.meshgrid(np.arange(hw), np.arange(hw))
    centers = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32) * stride
    centers = np.repeat(centers, num_anchors, axis=0)
    centers.setflags(write=False)
    return centers


def distance2bbox(points: torch.Tensor, distance: torch.Tensor) -> torch.Tensor:
    """(…, 2) centers + (…, 4) l,t,r,b distances → (…, 4) x1,y1,x2,y2."""
    return torch.stack(
        [
            points[..., 0] - distance[..., 0],
            points[..., 1] - distance[..., 1],
            points[..., 0] + distance[..., 2],
            points[..., 1] + distance[..., 3],
        ],
        dim=-1,
    )


def distance2kps(points: torch.Tensor, distance: torch.Tensor) -> torch.Tensor:
    """(…, 2) centers + (…, 2K) offsets → (…, K, 2) keypoints."""
    k = distance.shape[-1] // 2
    d = distance.reshape(*distance.shape[:-1], k, 2)
    return d + points[..., None, :]


def decode_outputs(
    outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    input_size: int,
    num_anchors: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """{stride: (scores, bbox, kps)} → scores (B, N), boxes (B, N, 4),
    kps (B, N, 5, 2) in letterboxed-input pixels.

    Each stride's anchor centres are uploaded from pageable host memory,
    a copy that waits for the device's stream (counted in `host_waits`)."""
    with observability.span("decode"):
        all_scores, all_boxes, all_kps = [], [], []
        for stride in sorted(outputs.keys()):
            scores, bbox, kps = outputs[stride]
            observability.host_wait(scores.device)
            centers = torch.from_numpy(
                anchor_centers(input_size, stride, num_anchors).copy()
            ).to(scores.device)
            all_scores.append(scores[..., 0])
            all_boxes.append(distance2bbox(centers, bbox * stride))
            all_kps.append(distance2kps(centers, kps * stride))
        return (
            torch.cat(all_scores, dim=-1),
            torch.cat(all_boxes, dim=-2),
            torch.cat(all_kps, dim=-3),
        )
