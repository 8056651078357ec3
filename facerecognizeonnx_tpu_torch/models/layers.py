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

Train mode (`train_apply`): every BatchNorm of a forward normalizes with
the batch's own statistics, the biased variance over N, H, W in float32
(JAX's `batch_norm(train=True)`), optionally averaged over the ranks of
a process group, and the statistics come back keyed by the JAX param
paths ("layer2/0/bn3", "head/convs/1/bn") for `update_bn_stats`.
`make_trainable` turns a module's weights, BN affines (and SCRFD's
per-stride scales) into trainable parameters; the BN running statistics
stay buffers. A module built for inference is frozen and unchanged.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
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
    """BatchNorm over channel dim 1: running stats, or inside `train_apply`
    the batch's own (recorded at the module's first call of the forward)."""

    def __init__(self, scale, bias, mean, var):
        super().__init__()
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)
        self.register_buffer("mean", mean)
        self.register_buffer("var", var)

    def forward(self, x):
        if _TRAIN.stats is None:
            return batch_norm(x, self.scale, self.bias, self.mean, self.var)
        y, (mean, var) = batch_norm_train(x, self.scale, self.bias, group=_TRAIN.group)
        # a BN shared across calls (SCRFD's head, one call per stride)
        # keeps its first call's statistics, as the JAX model does
        _TRAIN.stats.setdefault(self, (mean.detach(), var.detach()))
        return y


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


# ---------------------------------------------------------------- train mode


class _TrainMode(threading.local):
    stats = None  # {BatchNorm: (mean, var)} while a train-mode forward runs
    group = None  # the process group whose batches the statistics span


_TRAIN = _TrainMode()


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ranks of `group`, with the gradient of that mean:
    the backward averages the ranks' gradients the same way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def batch_norm_train(x, scale, bias, eps: float = BN_EPS, group=None):
    """Train-mode BatchNorm over channel dim 1 in float32: the batch mean
    and the biased variance over every other dim (two passes, as
    `jnp.var`), averaged over the ranks of `group` when given (equal
    per-rank batches: the statistics of the global batch). Returns
    (y in x's dtype, (mean, var))."""
    xf = x.to(torch.float32)
    dims = [0] + list(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    mean = xf.mean(dims)
    if group is not None:
        mean = _AllReduceMean.apply(mean, group)
    c = xf - mean.view(shape)
    var = (c * c).mean(dims)
    if group is not None:
        var = _AllReduceMean.apply(var, group)
    inv = (torch.rsqrt(var + eps) * scale).view(shape)
    y = c * inv + bias.view(shape)
    return y.to(x.dtype), (mean, var)


def bn_paths(model: nn.Module) -> Dict[str, BatchNorm]:
    """{JAX param path: BatchNorm} of a model of the port; the model's
    class maps its module names to JAX paths (`bn_path`)."""
    return {
        type(model).bn_path(name): m
        for name, m in model.named_modules()
        if isinstance(m, BatchNorm)
    }


def check_unfolded(model: nn.Module) -> None:
    """Train mode needs every BatchNorm: a model whose post-conv / head BNs
    were folded into its weights is inference-only, as in the JAX package."""
    folded = getattr(model, "features_bn", 0) is None or any(
        isinstance(m, ConvUnit) and m.bn is None for m in model.modules()
    )
    if folded:
        raise ValueError(
            f"{type(model).__name__} has folded BatchNorms: train mode needs the "
            "unfolded model (its .npz tree, not fold_inference_params)"
        )


def train_apply(model: nn.Module, fn: Callable, group=None):
    """Run `fn()`, a forward of `model`, in train mode. Returns (fn's
    output, {JAX path: (mean, var)}) with the batch statistics detached;
    `group` averages them over its ranks (autograd flows through)."""
    check_unfolded(model)
    prev = (_TRAIN.stats, _TRAIN.group)
    _TRAIN.stats, _TRAIN.group = {}, group
    try:
        out = fn()
        seen = _TRAIN.stats
    finally:
        _TRAIN.stats, _TRAIN.group = prev
    return out, {path: seen[bn] for path, bn in bn_paths(model).items() if bn in seen}


@torch.no_grad()
def update_bn_stats(model: nn.Module, stats: Dict, momentum: float = 0.0) -> nn.Module:
    """Fold batch stats (from `train_apply`) into the BN running stats, in
    place. momentum=0 replaces outright (the detector's single-shot
    update); momentum m keeps m*old + (1-m)*new (the trainer's EMA)."""
    paths = bn_paths(model)
    for key, (mean, var) in stats.items():
        bn = paths[key]
        bn.mean.copy_(momentum * bn.mean + (1 - momentum) * mean)
        bn.var.copy_(momentum * bn.var + (1 - momentum) * var)
    return model


def make_trainable(model: nn.Module) -> nn.Module:
    """In place: every parameter requires grad, each BatchNorm's scale and
    bias become parameters (its running stats stay buffers), and a model
    with a `trainable_extras` hook (SCRFD's per-stride scales) adds its
    own. Raises on a folded model. Returns the model."""
    check_unfolded(model)
    for m in model.modules():
        if isinstance(m, BatchNorm) and not isinstance(m.scale, nn.Parameter):
            for k in ("scale", "bias"):
                t = m._buffers.pop(k)
                setattr(m, k, nn.Parameter(t))
    if hasattr(model, "trainable_extras"):
        model.trainable_extras()
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def trainable_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: parameter} of the tensors a train step updates."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}
