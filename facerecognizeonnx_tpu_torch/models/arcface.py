"""ArcFace IResNet embedding network (w600k_r50 architecture) as an
nn.Module.

Port of `facerecognizeonnx_tpu/models/arcface.py`:

  stem:   conv3x3(3→64, s1) → BN → PReLU
  stages: IBasicBlocks at widths [64, 128, 256, 512], the first block of
          each stage strides 2 (112→56→28→14→7)
  block:  BN → conv3x3 s1 → BN → PReLU → conv3x3 s_block → BN, plus a
          conv1x1+BN shortcut when the shape changes
  head:   BN → flatten(512*7*7) → FC(512) → BN1d

The FC consumes an NHWC flatten (the JAX layout, and the row order of
the JAX fc weight), so the head permutes NCHW → NHWC before `flatten`.
Output is not L2-normalized here.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch
from torch import nn

from facerecognizeonnx_tpu_torch.models.layers import (
    BatchNorm,
    ConvUnit,
    Linear,
)

IRESNET_SPECS = {
    "iresnet18": ((2, 2, 2, 2), (64, 128, 256, 512)),
    "iresnet34": ((3, 4, 6, 3), (64, 128, 256, 512)),
    "iresnet50": ((3, 4, 14, 3), (64, 128, 256, 512)),
    "iresnet100": ((3, 13, 30, 3), (64, 128, 256, 512)),
}


class IBasicBlock(nn.Module):
    """bn1 (pre-conv, never folded) → unit1 (conv1, bn2, prelu) →
    unit2 (conv2 at the block stride, bn3) + shortcut."""

    def __init__(self, bn1: BatchNorm, unit1: ConvUnit, unit2: ConvUnit,
                 down: Optional[ConvUnit] = None):
        super().__init__()
        self.bn1, self.unit1, self.unit2, self.down = bn1, unit1, unit2, down

    def forward(self, x, compute_dtype):
        out = self.unit1(self.bn1(x), compute_dtype)
        out = self.unit2(out, compute_dtype)
        identity = x if self.down is None else self.down(x, compute_dtype)
        return out + identity


class IResNet(nn.Module):
    def __init__(
        self,
        stem: ConvUnit,
        stages: List[List[IBasicBlock]],
        bn2: BatchNorm,
        fc: Linear,
        features_bn: Optional[BatchNorm] = None,
    ):
        super().__init__()
        self.stem = stem
        self.stages = nn.ModuleList(nn.ModuleList(s) for s in stages)
        self.bn2, self.fc, self.features_bn = bn2, fc, features_bn

    def forward(
        self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32
    ) -> torch.Tensor:
        """(B, S, S, 3) normalized RGB NHWC → (B, 512) float32."""
        out = self.stem(x.to(compute_dtype).permute(0, 3, 1, 2), compute_dtype)
        for stage in self.stages:
            for block in stage:
                out = block(out, compute_dtype)
        out = self.bn2(out)
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)  # NHWC flatten
        out = self.fc(out, compute_dtype)
        if self.features_bn is not None:
            out = self.features_bn(out)
        return out.to(torch.float32)

    @staticmethod
    def bn_path(name: str) -> str:
        """A BatchNorm's module name → its JAX param path
        ("stages.1.0.unit2.bn" → "layer2/0/bn3")."""
        if name == "stem.bn":
            return "bn1"
        parts = name.split(".")
        if parts[0] == "stages":
            leaf = {"bn1": "bn1", "unit1.bn": "bn2", "unit2.bn": "bn3",
                    "down.bn": "down_bn"}[".".join(parts[3:])]
            return f"layer{int(parts[1]) + 1}/{parts[2]}/{leaf}"
        return name  # bn2, features_bn


def fold_inference_params(model: IResNet) -> IResNet:
    """A copy of `model` with every POST-conv / post-FC BatchNorm folded
    into the preceding weights. PRE-conv BNs (block bn1, the pre-flatten
    bn2) stay: folding a BN that feeds a zero-padded conv would change
    border pixels."""
    out = copy.deepcopy(model)
    out.stem = out.stem.fold()
    for stage in out.stages:
        for block in stage:
            block.unit1, block.unit2 = block.unit1.fold(), block.unit2.fold()
            if block.down is not None:
                block.down = block.down.fold()
    if out.features_bn is not None:
        out.fc = out.fc.folded(out.features_bn)
        out.features_bn = None
    return out
