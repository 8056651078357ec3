"""MobileFaceNet embedding network (the w600k_mbf family) as an nn.Module.

Port of `facerecognizeonnx_tpu/models/mobilefacenet.py`:

  stem:     conv3x3(3→64s, s2) → BN → PReLU
  stem_dw:  conv3x3(64s→64s, groups=64, s1) → BN → PReLU
  body:     bottlenecks, each 1x1 expand (→G) → BN → PReLU → 3x3
            depthwise (groups=G, stride s) → BN → PReLU → 1x1 (→out) → BN,
            residual-added when s=1 (`body_plan`)
  conv_sep: conv1x1(128s→512) → BN → PReLU
  GDC head: conv S/16 x S/16 (512→512, groups=512, no padding) → BN →
            FC(512→512, no bias) → BN1d

Every BN is post-conv, so `fold_inference_params` folds them all. The
output is not L2-normalized here.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch
from torch import nn

from facerecognizeonnx_tpu_torch.models.layers import BatchNorm, ConvUnit, Linear

# (blocks, scale) per family member; "mbf" is the w600k_mbf config
MBF_SPECS = {
    "mbf": ((1, 4, 6, 2), 2),
    "mbf_large": ((2, 8, 12, 4), 4),
}


def body_plan(blocks: Tuple[int, ...], scale: int) -> List[Tuple[int, int, int, int]]:
    """[(cin, cout, expand_groups, stride)] for the bottleneck body: each
    stride-2 entry downsamples, each stride-1 entry is residual."""
    c64, c128 = 64 * scale, 128 * scale
    plan = [(c64, c64, 128, 2)]
    plan += [(c64, c64, 128, 1)] * blocks[1]
    plan += [(c64, c128, 256, 2)]
    plan += [(c128, c128, 256, 1)] * blocks[2]
    plan += [(c128, c128, 512, 2)]
    plan += [(c128, c128, 256, 1)] * blocks[3]
    return plan


def arch_of_depth(n_body: int) -> str:
    """The family member whose body has `n_body` bottlenecks."""
    for arch, spec in MBF_SPECS.items():
        if len(body_plan(*spec)) == n_body:
            return arch
    raise ValueError(f"unrecognized mbf body depth {n_body}")


class Bottleneck(nn.Module):
    """pw1 (expand) → dw (grouped, stride s) → pw2 (linear), + x at s=1."""

    def __init__(self, pw1: ConvUnit, dw: ConvUnit, pw2: ConvUnit, residual: bool):
        super().__init__()
        self.pw1, self.dw, self.pw2 = pw1, dw, pw2
        self.residual = residual

    def forward(self, x, compute_dtype):
        y = self.pw2(self.dw(self.pw1(x, compute_dtype), compute_dtype), compute_dtype)
        return x + y if self.residual else y

    def fold(self) -> "Bottleneck":
        return Bottleneck(self.pw1.fold(), self.dw.fold(), self.pw2.fold(), self.residual)


class MobileFaceNet(nn.Module):
    def __init__(
        self,
        stem: ConvUnit,
        stem_dw: ConvUnit,
        body: List[Bottleneck],
        conv_sep: ConvUnit,
        gdc: ConvUnit,
        fc: Linear,
        features_bn: Optional[BatchNorm] = None,
    ):
        super().__init__()
        self.stem, self.stem_dw = stem, stem_dw
        self.body = nn.ModuleList(body)
        self.conv_sep, self.gdc = conv_sep, gdc
        self.fc, self.features_bn = fc, features_bn

    def forward(
        self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32
    ) -> torch.Tensor:
        """(B, S, S, 3) normalized RGB NHWC → (B, 512) float32."""
        dt = compute_dtype
        out = self.stem(x.to(dt).permute(0, 3, 1, 2), dt)
        out = self.stem_dw(out, dt)
        for block in self.body:
            out = block(out, dt)
        out = self.gdc(self.conv_sep(out, dt), dt)
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)  # NHWC flatten
        out = self.fc(out, dt)
        if self.features_bn is not None:
            out = self.features_bn(out)
        return out.to(torch.float32)

    @staticmethod
    def bn_path(name: str) -> str:
        """A BatchNorm's module name → its JAX param path
        ("body.3.dw.bn" → "body/3/dw_bn", "gdc.bn" → "gdc_dw/bn")."""
        parts = name.split(".")
        if parts[0] == "body":
            return f"body/{parts[1]}/{parts[2]}_bn"
        if parts[0] == "gdc":
            return "gdc_dw/bn"
        return "/".join(parts)  # stem/bn, stem_dw/bn, conv_sep/bn, features_bn


def fold_inference_params(model: MobileFaceNet) -> MobileFaceNet:
    """A copy of `model` with every BatchNorm folded into its conv or the
    FC: all of mbf's BNs are post-conv, so no BN op is left."""
    out = copy.deepcopy(model)
    out.stem, out.stem_dw = out.stem.fold(), out.stem_dw.fold()
    out.body = nn.ModuleList(b.fold() for b in out.body)
    out.conv_sep, out.gdc = out.conv_sep.fold(), out.gdc.fold()
    if out.features_bn is not None:
        out.fc = out.fc.folded(out.features_bn)
        out.features_bn = None
    return out
