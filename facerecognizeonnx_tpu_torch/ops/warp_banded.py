"""Banded affine warp: one band gather per output row, hat-weight matmuls.

Port of `facerecognizeonnx_tpu/ops/warp_banded.py` (`warp_impl="banded"`),
plain torch on any device:

  1. a 4-level mip pyramid of the frames (2x2 mean per level, rounded to
     uint8), each level at the top left of a zero (B, 4, H, W, 3) canvas;
     a face takes the level at which its source extent fits the band;
  2. one (band, band, 3) window per (face, output row), at the corner of
     the row's source bounding box;
  3. bilinear inside the window as the separable hat filter: a y-pass
     batched matmul with bf16 weights and an x-pass weighted sum in f32.
     The border is zero (missing neighbours contribute nothing).

Band values are exact in bf16 (uint8 range); the hat weights are rounded
to bf16, so level-0 faces agree with `warp_affine_batch` within about
one intensity unit.
"""

from __future__ import annotations

import torch

from facerecognizeonnx_tpu_torch.ops.warp import invert_affine

NUM_LEVELS = 4


def build_pyramid(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, 4, H, W, 3) uint8 canvases (levels 1x,
    1/2, 1/4, 1/8 at the top left, zeros elsewhere)."""
    B, H, W, C = frames_u8.shape
    level = frames_u8.to(torch.float32)
    canvases = [frames_u8.to(torch.uint8)]
    for _ in range(NUM_LEVELS - 1):
        h, w = level.shape[1] // 2, level.shape[2] // 2
        # the four taps of each 2x2 window, summed (exact: every value is
        # a multiple of 1/64 below 256), times 0.25
        level = level[:, : 2 * h, : 2 * w].reshape(B, h, 2, w, 2, C).sum(dim=(2, 4)) * 0.25
        canvas = torch.zeros((B, H, W, C), dtype=torch.float32, device=frames_u8.device)
        canvas[:, :h, :w] = level
        canvases.append((canvas + 0.5).to(torch.uint8))
    return torch.stack(canvases, dim=1)


def warp_affine_banded(
    frames_u8: torch.Tensor,
    Ms: torch.Tensor,
    out_size: int = 112,
    band: int = 128,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 + (B, K, 2, 3) forward affines →
    (B, K, out, out, 3) float32 BGR crops (zero border). Frames must be
    at least `band` pixels on each side."""
    B, H, W, C = frames_u8.shape
    K = Ms.shape[1]
    out = out_size
    N = B * K * out
    dev = frames_u8.device
    if H < band or W < band:
        raise ValueError(f"frames of {H}x{W} are smaller than the {band}-pixel band")

    pyramid = build_pyramid(frames_u8)
    Minv = invert_affine(Ms.to(torch.float32))
    a, b_, tx = Minv[..., 0, 0], Minv[..., 0, 1], Minv[..., 0, 2]
    c, d, ty = Minv[..., 1, 0], Minv[..., 1, 1], Minv[..., 1, 2]

    # mip level per face: the source extent across the output must fit the band
    s_col = torch.maximum(torch.hypot(a, c), torch.hypot(b_, d))
    extent = (out - 1) * s_col + 2.0
    level = torch.clamp(
        torch.ceil(torch.log2(torch.clamp_min(extent / (band - 2.0), 1e-6))), 0, NUM_LEVELS - 1
    )
    factor = torch.exp2(level)

    # the inverse map in mip coordinates (box mips align pixel centres as
    # (c + 0.5) / f - 0.5)
    af, bf, cf, df = (v / factor for v in (a, b_, c, d))
    txf = (tx + 0.5) / factor - 0.5
    tyf = (ty + 0.5) / factor - 0.5

    ii = torch.arange(out, dtype=torch.float32, device=dev)
    sx0 = bf[..., None] * ii + txf[..., None]  # (B, K, out): row starts
    sy0 = df[..., None] * ii + tyf[..., None]
    sx_end = sx0 + af[..., None] * (out - 1)
    sy_end = sy0 + cf[..., None] * (out - 1)

    big = 1e7
    x_min = torch.clamp(torch.minimum(sx0, sx_end), -big, big)
    y_min = torch.clamp(torch.minimum(sy0, sy_end), -big, big)
    Lw = (W / factor)[..., None]
    Lh = (H / factor)[..., None]
    x_lo = torch.minimum(torch.clamp_min(torch.floor(x_min), 0.0),
                         torch.clamp_min(Lw - band, 0.0))
    y_lo = torch.minimum(torch.clamp_min(torch.floor(y_min), 0.0),
                         torch.clamp_min(Lh - band, 0.0))

    # one window per (b, k, row); starts clamped into the canvas as a
    # gather's are
    bi = torch.arange(B, device=dev)[:, None, None].expand(B, K, out).reshape(N)
    li = level.to(torch.int64)[..., None].expand(B, K, out).reshape(N)
    y0 = y_lo.to(torch.int64).reshape(N).clamp(0, H - band)
    x0 = x_lo.to(torch.int64).reshape(N).clamp(0, W - band)
    r = torch.arange(band, device=dev)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    bands = pyramid[bi[:, None, None], li[:, None, None], rows, cols]  # (N, band, band, 3)

    jj = torch.arange(out, dtype=torch.float32, device=dev)
    lx = (af[..., None, None] * jj + (sx0 - x_lo)[..., None]).reshape(N, out)
    ly = (cf[..., None, None] * jj + (sy0 - y_lo)[..., None]).reshape(N, out)
    lx = torch.clamp(lx, -2.0, float(band) + 1.0)
    ly = torch.clamp(ly, -2.0, float(band) + 1.0)

    rf = r.to(torch.float32)
    Yw = torch.clamp_min(1.0 - (ly[..., None] - rf).abs(), 0.0).to(torch.bfloat16)
    Xw = torch.clamp_min(1.0 - (lx[..., None] - rf).abs(), 0.0).to(torch.bfloat16)

    # y-pass: bf16 weights times uint8 values are exact in f32, summed in f32
    T = torch.bmm(Yw.to(torch.float32), bands.reshape(N, band, band * C).to(torch.float32))
    T = T.reshape(N, out, band, C)
    # x-pass: weighted sum over the window's columns
    rows_out = (T * Xw.to(torch.float32)[..., None]).sum(dim=2)  # (N, out, 3)
    return rows_out.reshape(B, K, out, out, C)
