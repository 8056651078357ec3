"""The alignment warp's semantics in plain torch: the 5-point similarity
fit onto the ArcFace template (cv2.estimateAffinePartial2D in closed
form), the crop fallback for a degenerate fit, and the x-major resample
of the configuration's `warp: xmajor_pyramid` (a 4-level mip pyramid,
a level chosen per face against a 110 px coverage, a 128 x 256 window
whose origin is rounded to 16 / 128 px, fixed-point coefficients, bf16
y hat weights, f32 x-pass, the (px - 127.5) / 128 RGB epilogue in bf16).

A frozen transcription of those published semantics; it imports nothing
of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ARCFACE_DST_5PTS = (
    (38.2946, 51.6963), (73.5318, 51.5014), (56.0252, 71.7366),
    (41.5493, 92.3655), (70.7299, 92.2041),
)
OUT = 112
NUM_LEVELS = 4
COVER = 110.0
WIN_X, WIN_Y = 128, 256
ALIGN_X, ALIGN_Y = 16, 128
MAX_X_LO = float(((656 - WIN_X) // ALIGN_X) * ALIGN_X)
MAX_Y_LO = float(((768 - WIN_Y) // ALIGN_Y) * ALIGN_Y)
FP_COEF = float(1 << 20)
FP_TX = float(1 << 16)


def similarity_fit(src: torch.Tensor):
    """(..., 5, 2) landmarks → (M (..., 2, 3) src→template, ok (...,))."""
    src = src.to(torch.float32)
    dst = torch.tensor(ARCFACE_DST_5PTS, dtype=torch.float32, device=src.device).expand(src.shape)
    mu_s, mu_d = src.mean(-2, keepdim=True), dst.mean(-2, keepdim=True)
    ps, qd = src - mu_s, dst - mu_d
    var_s = (ps * ps).sum(dim=(-1, -2))
    dot = (ps * qd).sum(dim=(-1, -2))
    cross = (ps[..., 0] * qd[..., 1] - ps[..., 1] * qd[..., 0]).sum(dim=-1)
    ok = (var_s > 1e-6) & torch.isfinite(var_s) & torch.isfinite(dot) & torch.isfinite(cross)
    v = torch.where(ok, var_s, torch.ones_like(var_s))
    a, b = dot / v, cross / v
    rot = torch.stack([torch.stack([a, -b], -1), torch.stack([b, a], -1)], -2)
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", rot, mu_s[..., 0, :])
    return torch.cat([rot, t[..., None]], -1), ok


def crop_affine(box: torch.Tensor):
    """Box crop + resize to 112 as an affine (the fallback)."""
    x1, y1, x2, y2 = box.unbind(-1)
    ax = OUT / torch.clamp_min(x2 - x1, 1e-3)
    ay = OUT / torch.clamp_min(y2 - y1, 1e-3)
    z = torch.zeros_like(ax)
    return torch.stack([
        torch.stack([ax, z, (0.5 - x1) * ax - 0.5], -1),
        torch.stack([z, ay, (0.5 - y1) * ay - 0.5], -1),
    ], -2)


def align_matrices(kps, boxes, h: int, w: int):
    M, ok = similarity_fit(kps)
    clipped = torch.stack([
        boxes[..., 0].clamp(0.0, w - 1.0), boxes[..., 1].clamp(0.0, h - 1.0),
        boxes[..., 2].clamp(1.0, float(w)), boxes[..., 3].clamp(1.0, float(h)),
    ], -1)
    return torch.where(ok[..., None, None], M, crop_affine(clipped))


def _invert(M):
    a, b, tx = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    c, d, ty = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    det = a * d - b * c
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    r = 1.0 / det
    ia, ib, ic, id_ = d * r, -b * r, -c * r, a * r
    return ia, ib, -(ia * tx + ib * ty), ic, id_, -(ic * tx + id_ * ty)


def face_table(Ms: torch.Tensor) -> torch.Tensor:
    """(B, K, 2, 3) → (B·K, 9): level, x_lo, y_lo, a, b, c, d, tx, ty."""
    a, b, tx, c, d, ty = (v.reshape(-1) for v in _invert(Ms.to(torch.float32)))
    extent = torch.maximum((OUT - 1) * (a.abs() + b.abs()) + 2.0,
                           (OUT - 1) * (c.abs() + d.abs()) + 2.0)
    level = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(extent * (1.0 / COVER), 1e-6))),
                        0, NUM_LEVELS - 1)
    f = torch.exp2(level)
    a, b, c, d = a / f, b / f, c / f, d / f
    tx, ty = (tx + 0.5) / f - 0.5, (ty + 0.5) / f - 0.5
    zero = torch.zeros_like(a)
    x_min = torch.clamp(torch.minimum(a * (OUT - 1), zero) + torch.minimum(b * (OUT - 1), zero)
                        + tx, -1e7, 1e7)
    y_min = torch.clamp(torch.minimum(c * (OUT - 1), zero) + torch.minimum(d * (OUT - 1), zero)
                        + ty, -1e7, 1e7)
    x_lo = torch.clamp(torch.floor(x_min / ALIGN_X) * ALIGN_X, 0.0, MAX_X_LO)
    y_lo = torch.clamp(torch.floor(y_min / ALIGN_Y) * ALIGN_Y, 0.0, MAX_Y_LO)

    def fixed(v, scale, lim):
        return torch.round(torch.clamp(torch.nan_to_num(v), -lim, lim) * scale) * (1.0 / scale)

    return torch.stack([
        level, x_lo, y_lo, fixed(a, FP_COEF, 2000.0), fixed(b, FP_COEF, 2000.0),
        fixed(c, FP_COEF, 2000.0), fixed(d, FP_COEF, 2000.0),
        fixed(tx - x_lo, FP_TX, 30000.0), fixed(ty - y_lo, FP_TX, 30000.0),
    ], -1)


def pyramid(frames_u8: torch.Tensor):
    """Levels 0-3 as float32 (B, 3, H_l, W_l): each level the 2x2 mean of
    the unrounded level above it, stored rounded half to even."""
    lv = frames_u8.permute(0, 3, 1, 2).to(torch.float32)
    out, cur = [lv], lv
    for _ in range(1, NUM_LEVELS):
        cur = F.avg_pool2d(cur, 2)
        out.append(torch.round(cur))
    return out


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def warp_xm(frames_u8: torch.Tensor, Ms: torch.Tensor, valid: torch.Tensor):
    """(B, H, W, 3) uint8 BGR + (B, K, 2, 3) affines + (B, K) valid →
    (B, K, 112, 112, 3) bf16 normalized RGB crops, invalid slots zero."""
    B, H, W, _ = frames_u8.shape
    K = Ms.shape[1]
    dev = frames_u8.device
    prm = face_table(Ms)
    levels = pyramid(frames_u8)
    level = torch.nan_to_num(prm[:, 0]).long().clamp(0, NUM_LEVELS - 1)
    x_lo = torch.nan_to_num(prm[:, 1]).long()[:, None, None]
    y_lo = torch.nan_to_num(prm[:, 2]).long()[:, None, None]
    a, b, c, d, tx, ty = (prm[:, k, None, None] for k in range(3, 9))
    ii = torch.arange(OUT, dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(OUT, dtype=torch.float32, device=dev)[None, :]
    lx = (a * jj + b * ii + tx).clamp(-2.0, WIN_X + 1.0)
    ly = (c * jj + d * ii + ty).clamp(-2.0, WIN_Y + 1.0)
    x0, y0 = torch.floor(lx), torch.floor(ly)
    frame_of = torch.arange(B * K, device=dev) // K
    s = torch.zeros((B * K, OUT, OUT, 3), dtype=torch.float32, device=dev)
    for lvl in range(NUM_LEVELS):
        sel = (level == lvl).nonzero().flatten()
        if sel.numel() == 0:
            continue
        img = levels[lvl]  # (B, 3, Hl, Wl)
        hl, wl = img.shape[2], img.shape[3]
        acc = torch.zeros((sel.numel(), OUT, OUT, 3), dtype=torch.float32, device=dev)
        for dx in (0, 1):
            xw = x0[sel] + dx
            wx = torch.clamp_min(1.0 - (lx[sel] - xw).abs(), 0.0)
            t = torch.zeros_like(acc)
            for dy in (0, 1):
                yw = y0[sel] + dy
                wy = _bf16(torch.clamp_min(1.0 - (ly[sel] - yw).abs(), 0.0))
                gx, gy = x_lo[sel] + xw.long(), y_lo[sel] + yw.long()
                ok = (xw >= 0) & (xw < WIN_X) & (yw >= 0) & (yw < WIN_Y) & (gx < wl) & (gy < hl)
                px = img[frame_of[sel][:, None, None], :, gy.clamp(0, hl - 1), gx.clamp(0, wl - 1)]
                px = torch.where(ok[..., None], px, torch.zeros_like(px))
                t = t + wy[..., None] * px
            acc = acc + t * wx[..., None]
        s[sel] = acc
    crops = ((s - 127.5) * (1.0 / 128.0)).flip(-1).to(torch.bfloat16).reshape(B, K, OUT, OUT, 3)
    return torch.where(valid[..., None, None, None], crops, torch.zeros_like(crops))
