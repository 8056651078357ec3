"""NN layers of the port: functional ops plus the small modules the
SCRFD, IResNet and MobileFaceNet networks are built from (ViT adds its
LayerNorm in models/vit.py).

Port of `facerecognizeonnx_tpu/models/layers.py`. Activations inside a
network are NCHW (PyTorch's conv layout); the models convert from and
to the NHWC public layout themselves. The rounding points of the JAX
layers are kept:

  - conv: inputs rounded to the compute dtype, f32 products and sums,
    the bias added in f32, one rounding to the compute dtype;
  - batch_norm: f32 math, result cast back to the input dtype;
  - prelu: in the input (compute) dtype;
  - linear: compute-dtype operands, f32 products and sums, f32 output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


# ---------------------------------------------------------------- functional


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """NCHW x OIHW conv, symmetric padding; output in compute_dtype.

    The operands are rounded to compute_dtype, the conv runs in float32
    on them (products of bf16 values are exact in f32; on the card cuDNN
    may take TF32, which holds bf16 values exactly), the bias is added in
    float32, and the result is rounded once, as XLA's conv with
    preferred_element_type=f32 followed by the bias add. A bf16 conv
    would round its output before the bias: a second rounding."""
    xc = x.to(compute_dtype).to(torch.float32)
    wc = w.to(compute_dtype).to(torch.float32)
    y = F.conv2d(xc, wc, None, stride, padding, 1, groups)
    if b is not None:
        y = y + b.to(torch.float32)[:, None, None]
    return y.to(compute_dtype)


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = BN_EPS,
) -> torch.Tensor:
    """Inference BatchNorm over channel dim 1 (NCHW or (B, C)), f32 math."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    inv = (torch.rsqrt(var + eps) * scale).view(shape)
    y = (x.to(torch.float32) - mean.view(shape)) * inv + bias.view(shape)
    return y.to(x.dtype)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU over channel dim 1, in the input dtype."""
    a = alpha.to(x.dtype).view((-1,) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, x * a)


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, din) @ (dout, din)^T: compute-dtype operands, f32 result.

    Products of two bf16 values are exact in f32, so an f32 matmul of the
    rounded operands is the f32-accumulating bf16 product."""
    xc = x.to(compute_dtype).to(torch.float32)
    wc = w.to(compute_dtype).to(torch.float32)
    y = xc @ wc.t()
    if b is not None:
        y = y + b
    return y


def _bn_inv(bn: "BatchNorm", eps: float) -> torch.Tensor:
    return (bn.scale * torch.rsqrt(bn.var + eps)).to(torch.float32)


def fold_bn_into_conv(
    w: torch.Tensor, b: Optional[torch.Tensor], bn: "BatchNorm", eps: float = BN_EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly fold a POST-conv BatchNorm into OIHW weights + bias."""
    inv = _bn_inv(bn, eps)
    w = w.to(torch.float32) * inv[:, None, None, None]
    b0 = torch.zeros_like(bn.mean) if b is None else b.to(torch.float32)
    return w, (b0 - bn.mean) * inv + bn.bias


def fold_bn_into_linear(
    w: torch.Tensor, b: Optional[torch.Tensor], bn: "BatchNorm", eps: float = BN_EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly fold a POST-linear BatchNorm (1-D) into (dout, din) weights."""
    inv = _bn_inv(bn, eps)
    w = w.to(torch.float32) * inv[:, None]
    b0 = torch.zeros_like(bn.mean) if b is None else b.to(torch.float32)
    return w, (b0 - bn.mean) * inv + bn.bias


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """v / ||v||2, leaving the zero vector as it is."""
    norm = torch.linalg.vector_norm(x.to(torch.float32), dim=dim, keepdim=True)
    return torch.where(norm > eps, x / torch.clamp_min(norm, 1e-20), x)


# ---------------------------------------------------------------- modules


class Conv(nn.Module):
    """Conv2d with OIHW weight, optional bias, fixed stride/padding/groups."""

    def __init__(self, weight, bias=None, stride=1, padding=0, groups=1):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x, compute_dtype=torch.float32):
        return conv2d(
            x, self.weight, self.bias, self.stride, self.padding, self.groups,
            compute_dtype,
        )

    def folded(self, bn: "BatchNorm") -> "Conv":
        w, b = fold_bn_into_conv(self.weight, self.bias, bn)
        return Conv(w, b, self.stride, self.padding, self.groups)


class BatchNorm(nn.Module):
    """Inference BatchNorm (running stats) over channel dim 1."""

    def __init__(self, scale, bias, mean, var):
        super().__init__()
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)
        self.register_buffer("mean", mean)
        self.register_buffer("var", var)

    def forward(self, x):
        return batch_norm(x, self.scale, self.bias, self.mean, self.var)


class PReLU(nn.Module):
    def __init__(self, alpha):
        super().__init__()
        self.alpha = nn.Parameter(alpha, requires_grad=False)

    def forward(self, x):
        return prelu(x, self.alpha)


class Linear(nn.Module):
    """FC with (dout, din) weight (PyTorch layout) and optional bias."""

    def __init__(self, weight, bias=None):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x, compute_dtype=torch.float32):
        return linear(x, self.weight, self.bias, compute_dtype)

    def folded(self, bn: BatchNorm) -> "Linear":
        return Linear(*fold_bn_into_linear(self.weight, self.bias, bn))


class ConvUnit(nn.Module):
    """conv → optional post-conv BatchNorm → optional PReLU.

    `fold()` merges the BatchNorm into the conv (exact for a post-conv
    BN at any stride/padding)."""

    def __init__(self, conv: Conv, bn: Optional[BatchNorm] = None,
                 act: Optional[PReLU] = None):
        super().__init__()
        self.conv, self.bn, self.act = conv, bn, act

    def forward(self, x, compute_dtype=torch.float32):
        y = self.conv(x, compute_dtype)
        if self.bn is not None:
            y = self.bn(y)
        if self.act is not None:
            y = self.act(y)
        return y

    def fold(self) -> "ConvUnit":
        if self.bn is None:
            return self
        return ConvUnit(self.conv.folded(self.bn), None, self.act)
