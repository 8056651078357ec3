"""SCRFD anchor-free face detector (det_500m class) as an nn.Module.

Port of `facerecognizeonnx_tpu/models/scrfd.py`, variant "500m" only:
a depthwise-separable backbone (widths 16/16/40/72/152/288), an FPN
neck and an FCOS-style head shared across strides with per-stride
output scales. Weights come from a JAX param tree through
`bridge.params_from_numpy`.

  input  (B, S, S, 3) normalized RGB, NHWC
  output {stride: (scores (B, H*W*2, 1), bbox (B, H*W*2, 4),
                   kps (B, H*W*2, 10))} for strides 8/16/32

Rows are [loc0_a0, loc0_a1, loc1_a0, ...] with locations row-major, the
anchor interleave `detect/decode.py` expects: the head output is
permuted to NHWC before its reshape.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch
from torch import nn

from facerecognizeonnx_tpu_torch.models.layers import Conv, ConvUnit

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2

# Only the det_500m class is ported; the 2.5g / 10g / tpu / 500m_s2d
# variants of the JAX package wait in ROADMAP.md Queue A item 3.
SCRFD_VARIANTS = {
    "500m": {
        "plan": (
            (16, 2), (16, 1), (40, 2), (40, 1), (72, 2), (72, 1),
            (152, 2), (152, 1), (288, 2), (288, 1),
        ),
        "neck": 64,
        "head": 64,
        "stacked": 2,
    },
}
UNPORTED_VARIANT = (
    "only SCRFD variant '500m' is ported; the others are queued in "
    "ROADMAP.md Queue A item 3"
)


def variant_taps(plan) -> Dict[int, str]:
    """{channel: tap_name} — the three largest widths are strides 8/16/32."""
    chans = sorted({c for c, _ in plan})[-3:]
    return dict(zip(chans, ("c3", "c4", "c5")))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x upsample of NCHW (FPN top-down path)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class DWSepBlock(nn.Module):
    """Depthwise 3x3 (stride s) unit then pointwise 1x1 unit."""

    def __init__(self, dw: ConvUnit, pw: ConvUnit):
        super().__init__()
        self.dw, self.pw = dw, pw

    def forward(self, x, compute_dtype):
        return self.pw(self.dw(x, compute_dtype), compute_dtype)


class SCRFD(nn.Module):
    def __init__(
        self,
        stem: ConvUnit,
        backbone: List[DWSepBlock],
        neck: Dict[str, Conv],
        head_convs: List[ConvUnit],
        cls: Conv,
        bbox: Conv,
        kps: Conv,
        scales: Dict[int, float],
        variant: str = "500m",
    ):
        super().__init__()
        if variant not in SCRFD_VARIANTS:
            raise NotImplementedError(UNPORTED_VARIANT)
        self.variant = variant
        self.plan = SCRFD_VARIANTS[variant]["plan"]
        self.stem = stem
        self.backbone = nn.ModuleList(backbone)
        self.neck = nn.ModuleDict(neck)
        self.head_convs = nn.ModuleList(head_convs)
        self.cls, self.bbox, self.kps = cls, bbox, kps
        self.scales = dict(scales)

    def forward(
        self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32
    ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        dt = compute_dtype
        y = self.stem(x.to(dt).permute(0, 3, 1, 2), dt)
        tap_names = variant_taps(self.plan)
        taps = {}
        for (cout, stride), blk in zip(self.plan[1:], self.backbone):
            y = blk(y, dt)
            if cout in tap_names and stride == 1:
                taps[tap_names[cout]] = y  # last stride-1 block per level

        n = self.neck
        p5 = n["lat_c5"](taps["c5"], dt)
        p4 = n["lat_c4"](taps["c4"], dt) + _upsample2x(p5)
        p3 = n["lat_c3"](taps["c3"], dt) + _upsample2x(p4)
        p3 = n["smooth_p3"](p3, dt)
        p4 = n["smooth_p4"](p4, dt)
        p5 = n["smooth_p5"](p5, dt)

        outputs = {}
        for stride, h in zip(STRIDES, (p3, p4, p5)):
            for unit in self.head_convs:
                h = unit(h, dt)
            scale = self.scales[stride]
            b, _, hh, ww = h.shape
            rows = hh * ww * NUM_ANCHORS

            def rows_of(t, k):
                # NCHW → NHWC before the reshape keeps the anchor interleave
                return t.to(torch.float32).permute(0, 2, 3, 1).reshape(b, rows, k)

            scores = torch.sigmoid(rows_of(self.cls(h, dt), 1))
            bbox = rows_of(self.bbox(h, dt), 4) * scale
            kps = rows_of(self.kps(h, dt), 10) * scale
            outputs[stride] = (scores, bbox, kps)
        return outputs


def fold_inference_params(model: SCRFD) -> SCRFD:
    """A copy of `model` with EVERY BatchNorm folded into its conv — all
    SCRFD BNs are post-conv, so the whole net folds exactly."""
    out = copy.deepcopy(model)
    out.stem = out.stem.fold()
    for blk in out.backbone:
        blk.dw, blk.pw = blk.dw.fold(), blk.pw.fold()
    out.head_convs = nn.ModuleList(u.fold() for u in out.head_convs)
    return out
