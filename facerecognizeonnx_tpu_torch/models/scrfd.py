"""SCRFD anchor-free face detector (the det_500m / 2.5g / 10g family) as
an nn.Module.

Port of `facerecognizeonnx_tpu/models/scrfd.py`: a backbone of
depthwise-separable blocks (dense 3x3 blocks for the "tpu" variant; a
stride-4 space-to-depth stem for "500m_s2d"), an FPN neck and an
FCOS-style head shared across strides with per-stride output scales.
Weights come from a JAX param tree through `bridge.params_from_numpy`.

  input  (B, S, S, 3) normalized RGB, NHWC
  output {stride: (scores (B, H*W*2, 1), bbox (B, H*W*2, 4),
                   kps (B, H*W*2, 10))} for strides 8/16/32

Rows are [loc0_a0, loc0_a1, loc1_a0, ...] with locations row-major, the
anchor interleave `detect/decode.py` expects: the head output is
permuted to NHWC before its reshape.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from facerecognizeonnx_tpu_torch.models.layers import Conv, ConvUnit, train_apply

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2

# Each entry: backbone plan of (out_ch, stride) blocks (the first is the
# stem), neck and head widths, stacked head convs; "dense" marks 3x3
# dense blocks, "s2d" a space-to-depth stem of that factor. A copy of the
# JAX package's table.
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
    "2.5g": {
        "plan": (
            (28, 2), (28, 1), (56, 2), (56, 1), (112, 2), (112, 1), (112, 1),
            (224, 2), (224, 1), (224, 1), (448, 2), (448, 1),
        ),
        "neck": 96,
        "head": 96,
        "stacked": 3,
    },
    "10g": {
        "plan": (
            (56, 2), (56, 1), (88, 2), (88, 1), (176, 2), (176, 1), (176, 1),
            (352, 2), (352, 1), (352, 1), (704, 2), (704, 1),
        ),
        "neck": 128,
        "head": 128,
        "stacked": 4,
    },
    "tpu": {
        "plan": (
            (32, 2), (32, 1), (64, 2), (64, 1), (96, 2), (96, 1),
            (128, 2), (128, 1), (160, 2), (160, 1),
        ),
        "neck": 64,
        "head": 64,
        "stacked": 2,
        "dense": True,
    },
    "500m_s2d": {
        "plan": (
            (40, 4), (40, 1), (72, 2), (72, 1),
            (152, 2), (152, 1), (288, 2), (288, 1),
        ),
        "neck": 64,
        "head": 64,
        "stacked": 2,
        "s2d": 4,
    },
}


def variant_taps(plan) -> Dict[int, str]:
    """{channel: tap_name} — the three largest widths are strides 8/16/32."""
    chans = sorted({c for c, _ in plan})[-3:]
    return dict(zip(chans, ("c3", "c4", "c5")))


def infer_variant(tree: Dict) -> str:
    """The variant of a param tree, from its block type, block count and
    output widths (500m and 500m_s2d share widths from 40 up and differ in
    their block count)."""
    backbone = tree["backbone"]
    is_dense = "conv" in backbone[0]
    key = "conv" if is_dense else "pw"
    for name, spec in SCRFD_VARIANTS.items():
        plan = spec["plan"][1:]
        if bool(spec.get("dense")) != is_dense or len(plan) != len(backbone):
            continue
        if all(np.shape(blk[key]["w"])[-1] == cout for (cout, _), blk in zip(plan, backbone)):
            return name
    raise ValueError("params do not match any known SCRFD variant")


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H/r, W/r, r*r*C), channel (dy*r + dx)*C + c: the
    JAX reshape/transpose order (F.pixel_unshuffle is channel-major)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // r, w // r, c * r * r)


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

    def fold(self) -> "DWSepBlock":
        return DWSepBlock(self.dw.fold(), self.pw.fold())


class SCRFD(nn.Module):
    def __init__(
        self,
        stem: ConvUnit,
        backbone: List[Union[DWSepBlock, ConvUnit]],
        neck: Dict[str, Conv],
        head_convs: List[ConvUnit],
        cls: Conv,
        bbox: Conv,
        kps: Conv,
        scales: Dict[int, float],
        variant: str = "500m",
    ):
        super().__init__()
        self.variant = variant
        self.plan = SCRFD_VARIANTS[variant]["plan"]
        self.s2d = int(SCRFD_VARIANTS[variant].get("s2d", 0))
        self.stem = stem
        self.backbone = nn.ModuleList(backbone)
        self.neck = nn.ModuleDict(neck)
        self.head_convs = nn.ModuleList(head_convs)
        self.cls, self.bbox, self.kps = cls, bbox, kps
        self.scales = dict(scales)

    def forward(
        self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
        train: bool = False,
    ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """With train=True, returns (outputs, batch stats by JAX path): the
        BNs normalize with batch statistics, a shared head BN with those of
        stride 8 (`layers.train_apply`)."""
        if train:
            return train_apply(self, lambda: self.forward(x, compute_dtype))
        dt = compute_dtype
        x = x.to(dt)
        if self.s2d:
            x = space_to_depth(x, self.s2d)
        y = self.stem(x.permute(0, 3, 1, 2), dt)
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

    @staticmethod
    def bn_path(name: str) -> str:
        """A BatchNorm's module name → its JAX param path
        ("backbone.2.dw.bn" → "backbone/2/dw_bn", "head_convs.1.bn" →
        "head/convs/1/bn")."""
        parts = name.split(".")
        if parts[0] == "backbone":  # a dense block's unit is the block itself
            return f"backbone/{parts[1]}/" + ("bn" if len(parts) == 3 else f"{parts[2]}_bn")
        if parts[0] == "head_convs":
            return f"head/convs/{parts[1]}/bn"
        return "/".join(parts)  # stem/bn

    def trainable_extras(self) -> None:
        """The per-stride output scales as parameters (`make_trainable`):
        the JAX tree's "scales" leaves are trained with the rest."""
        if not hasattr(self, "scale_params"):
            dev = self.cls.weight.device
            self.scale_params = nn.ParameterDict({
                f"s{s}": nn.Parameter(torch.tensor(float(v), dtype=torch.float32, device=dev))
                for s, v in self.scales.items()
            })
            self.scales = {s: self.scale_params[f"s{s}"] for s in self.scales}


def fold_inference_params(model: SCRFD) -> SCRFD:
    """A copy of `model` with EVERY BatchNorm folded into its conv — all
    SCRFD BNs are post-conv, so the whole net folds exactly."""
    out = copy.deepcopy(model)
    out.stem = out.stem.fold()
    out.backbone = nn.ModuleList(blk.fold() for blk in out.backbone)
    out.head_convs = nn.ModuleList(u.fold() for u in out.head_convs)
    return out


def num_params(model: SCRFD) -> int:
    """Leaves of the JAX tree the model holds: weights, biases, BN
    statistics, PReLU slopes and the three per-stride scales."""
    tensors = list(model.parameters()) + list(model.buffers())
    return sum(t.numel() for t in tensors) + len(model.scales)
