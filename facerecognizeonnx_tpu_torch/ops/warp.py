"""Bilinear affine warp (cv2.warpAffine semantics), the portable path.

Port of `facerecognizeonnx_tpu/ops/warp.py`:
  - M maps src→dst; sampling runs through the inverse map
  - bilinear interpolation, constant-0 border ("zero") or replicated
    edges ("clamp", matching cv2.resize for the crop fallback)

`warp_affine_batch` is `warp_impl="gather"`: exact cv2 bilinear on any
device.
"""

from __future__ import annotations

import torch


def invert_affine(M: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices (|det| < 1e-12 → 1e-12)."""
    a, b, tx = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    c, d, ty = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    det = a * d - b * c
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = 1.0 / det
    ia, ib = d * inv_det, -b * inv_det
    ic, id_ = -c * inv_det, a * inv_det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def crop_resize_affine(box_xyxy: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Affine (src→dst) equivalent of crop-to-box then cv2.resize: dst
    center j maps to src (j+0.5)/a - 0.5 + x1 with a = out/w."""
    x1, y1, x2, y2 = box_xyxy.unbind(-1)
    w = torch.clamp_min(x2 - x1, 1e-3)
    h = torch.clamp_min(y2 - y1, 1e-3)
    ax = out_w / w
    ay = out_h / h
    tx = (0.5 - x1) * ax - 0.5
    ty = (0.5 - y1) * ay - 0.5
    zeros = torch.zeros_like(ax)
    row0 = torch.stack([ax, zeros, tx], dim=-1)
    row1 = torch.stack([zeros, ay, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def warp_affine_batch(
    frames: torch.Tensor,
    Ms: torch.Tensor,
    out_h: int,
    out_w: int,
    border: str = "zero",
) -> torch.Tensor:
    """Warp K faces from each of B frames in one gather.

    frames: (B, H, W, C); Ms: (B, K, 2, 3) forward affines.
    Returns (B, K, out_h, out_w, C) float32."""
    frames = frames.to(torch.float32)
    B, H, W, C = frames.shape
    K = Ms.shape[1]
    dev = frames.device

    Minv = invert_affine(Ms.to(torch.float32))[..., None, None]  # (B,K,2,3,1,1)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    src_x = Minv[:, :, 0, 0] * xs + Minv[:, :, 0, 1] * ys + Minv[:, :, 0, 2]
    src_y = Minv[:, :, 1, 0] * xs + Minv[:, :, 1, 1] * ys + Minv[:, :, 1, 2]
    if border == "clamp":
        src_x = src_x.clamp(0.0, W - 1.0)
        src_y = src_y.clamp(0.0, H - 1.0)

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    flat = frames.reshape(B * H * W, C)
    base = (torch.arange(B, device=dev) * (H * W))[:, None, None, None]

    def sample(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat[idx.reshape(-1)].reshape(B, K, out_h, out_w, C)
        if border == "zero":
            vals = vals * inb[..., None]
        return vals

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    return (
        v00 * ((1 - wy) * (1 - wx))
        + v01 * ((1 - wy) * wx)
        + v10 * (wy * (1 - wx))
        + v11 * (wy * wx)
    )
