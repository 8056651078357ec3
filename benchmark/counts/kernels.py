"""Bytes (and operations) one call of each hand-written kernel needs,
from its shapes: every input byte read once, every output byte written
once, whatever the kernel reads again.

- `warp_xm_pyramid`: the frames read, pyramid levels 1-3 written.
- `warp_xm`: the affines and the valid mask read; for each valid face
  the source pixels its crop covers at the level chosen for it (the
  area of the output square mapped back, |det| · 112² / 4^level, three
  bytes a pixel); the bf16 crops of every slot and the 9-float face
  table written.
- `nms_greedy`: score-sorted boxes and the valid mask read, the keep
  mask written. Its IoU operations are not counted (they depend on the
  data); bytes bound it.
"""

from __future__ import annotations

import torch

OUT = 112
COVER = 110.0


def pyramid_bytes(batch: int, h: int, w: int) -> int:
    upper = sum(3 * (h >> lvl) * (w >> lvl) for lvl in range(1, 4))
    return batch * (h * w * 3 + upper)


def warp_xm_bytes(Ms: torch.Tensor, valid: torch.Tensor, h: int, w: int) -> float:
    """Ms (B, K, 2, 3) forward affines, valid (B, K) bool."""
    n = Ms.shape[0] * Ms.shape[1]
    m = Ms.reshape(-1, 2, 3).to(torch.float64)
    a, b, c, d = m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]
    det = (a * d - b * c).abs().clamp_min(1e-12)
    # the inverse's rows, as the level choice reads them
    extent = torch.maximum((OUT - 1) * (d.abs() + b.abs()) / det + 2.0,
                           (OUT - 1) * (c.abs() + a.abs()) / det + 2.0)
    level = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(extent / COVER, 1e-6))), 0, 3)
    area = (OUT * OUT / det) / 4.0 ** level
    cap = (h * w) / 4.0 ** level
    src = torch.minimum(area, cap) * 3.0
    src = float((src * valid.reshape(-1).to(torch.float64)).sum())
    return src + n * (6 * 4 + 1) + n * (OUT * OUT * 3 * 2 + 9 * 4)


def nms_bytes(batch: int, candidates: int) -> int:
    return batch * candidates * (16 + 1 + 1)
