"""Closed-form least-squares similarity transform (batched, float32).

Port of `facerecognizeonnx_tpu/ops/umeyama.py`: the 4-DOF fit
q ≈ [[a, -b], [b, a]] p + t that cv2.estimateAffinePartial2D solves,
in closed form, onto the canonical ArcFace 112x112 5-point template.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.utils import observability

# L-eye, R-eye, nose, L-mouth, R-mouth on the 112x112 crop
ARCFACE_DST_5PTS = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def umeyama(src: torch.Tensor, dst) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares similarity transform src→dst.

    src: (..., N, 2) source points; dst: (N, 2) or broadcastable.
    Returns (M (..., 2, 3) with dst ≈ M[:, :2] @ src + M[:, 2], valid
    (...,) bool — False when the fit is degenerate)."""
    src = src.to(torch.float32)
    if not (isinstance(dst, torch.Tensor) and dst.device == src.device):
        observability.host_wait(src.device)  # a copy from host memory waits for the stream
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device).expand(src.shape)

    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    ps = src - mu_s
    qd = dst - mu_d

    var_s = (ps * ps).sum(dim=(-1, -2))
    dot = (ps * qd).sum(dim=(-1, -2))
    cross = (ps[..., 0] * qd[..., 1] - ps[..., 1] * qd[..., 0]).sum(dim=-1)

    valid = (
        (var_s > 1e-6) & torch.isfinite(var_s) & torch.isfinite(dot)
        & torch.isfinite(cross)
    )
    safe_var = torch.where(valid, var_s, torch.ones_like(var_s))
    a = dot / safe_var
    b = cross / safe_var

    rot = torch.stack(
        [torch.stack([a, -b], dim=-1), torch.stack([b, a], dim=-1)], dim=-2
    )
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", rot, mu_s[..., 0, :])
    return torch.cat([rot, t[..., None]], dim=-1), valid
