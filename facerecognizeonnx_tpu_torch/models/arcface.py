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

A folded model in bfloat16 on CUDA tensors, outside train mode and
autograd, runs `iresnet_forward_fused`: the same convolutions, with one
launch of the epilogue kernel (ops/conv_epilogue.py) after each in place
of the eager passes between them, bit for bit the eager result on the
same convolution outputs. Every other call runs the eager path.
"""

from __future__ import annotations

import copy
import weakref
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from facerecognizeonnx_tpu_torch.models.layers import (
    _TRAIN,
    BN_EPS,
    BatchNorm,
    Conv,
    ConvUnit,
    Linear,
    PReLU,
)
from facerecognizeonnx_tpu_torch.ops.conv_epilogue import conv_epilogue
from facerecognizeonnx_tpu_torch.utils.observability import count

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
        count("iresnet_blocks")
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
        if fusable(self, x, compute_dtype):
            return iresnet_forward_fused(self, x, compute_dtype)
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


# ---------------------------------------------------------------- fused path


def _blocks(model: IResNet) -> List[IBasicBlock]:
    return [block for stage in model.stages for block in stage]


def _folded_unit(unit, act_ok: bool = True) -> bool:
    """A conv unit whose BatchNorm is in its plain `Conv`'s weights and
    bias, with a PReLU or nothing after it (nothing where not `act_ok`)."""
    return (
        isinstance(unit, ConvUnit) and unit.bn is None and type(unit.conv) is Conv
        and unit.conv.bias is not None
        and (unit.act is None or (act_ok and isinstance(unit.act, PReLU)))
    )


def _f32_bn(bn) -> bool:
    return all(t.dtype == torch.float32 for t in (bn.scale, bn.bias, bn.mean, bn.var))


def fusable(model: IResNet, x: torch.Tensor, compute_dtype: torch.dtype) -> bool:
    """Whether `model(x, compute_dtype)` may take `iresnet_forward_fused`:
    CUDA input in bfloat16, outside train mode and autograd, every conv
    unit folded (its BatchNorm in the weights and bias) with a plain
    `Conv` (not a w8a8 `QConv`), no activation on a shortcut, float32
    BatchNorm tables and a plain `Linear` FC."""
    if not x.is_cuda or compute_dtype != torch.bfloat16 or _TRAIN.stats is not None:
        return False
    if any(p.requires_grad for p in model.parameters()) or (
        torch.is_grad_enabled() and x.requires_grad
    ):
        return False
    blocks = _blocks(model)
    return (
        bool(blocks) and _folded_unit(model.stem) and type(model.fc) is Linear
        and _f32_bn(model.bn2)
        and all(
            _folded_unit(b.unit1) and _folded_unit(b.unit2) and _f32_bn(b.bn1)
            and (b.down is None or _folded_unit(b.down, act_ok=False))
            for b in blocks
        )
    )


# module → (keys of its source tensors, the sources, the derived tensors)
_DERIVED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _derived(module: nn.Module, sources: Sequence[torch.Tensor], make: Callable):
    """`make()`, kept per module until one of `sources` is replaced or
    changed in place. Not kept while a program is traced or captured."""
    if (
        torch.compiler.is_compiling() or torch.compiler.is_exporting()
        or (sources[0].is_cuda and torch.cuda.is_current_stream_capturing())
    ):
        return make()
    key = tuple((t.data_ptr(), t._version, t.device) for t in sources)
    hit = _DERIVED.get(module)
    if hit is not None and hit[0] == key:
        return hit[2]
    out = make()
    # the sources are held so that no other tensor takes their address while
    # the key names it
    _DERIVED[module] = (key, tuple(t.detach() for t in sources), out)
    return out


def _conv(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """`layers.conv2d`'s convolution of an operand already rounded to
    bf16, on the conv's bf16-exact weight (kept channels-last), without
    the bias: the float32 output the epilogue takes."""
    w = _derived(conv, (conv.weight,), lambda: conv.weight.to(torch.bfloat16).to(
        torch.float32).contiguous(memory_format=torch.channels_last))
    return F.conv2d(x, w, None, conv.stride, conv.padding, 1, conv.groups)


def _bias(conv: Conv) -> torch.Tensor:
    return conv.bias.to(torch.float32)


def _alpha(unit: ConvUnit) -> Optional[torch.Tensor]:
    """The unit's PReLU slopes as a float32 table of bf16 values."""
    if unit.act is None:
        return None
    a = unit.act.alpha
    return _derived(unit.act, (a,), lambda: a.to(torch.bfloat16).to(torch.float32))


def bn_tables(bn: BatchNorm, eps: float = BN_EPS):
    """(mean, inv, beta) of an inference BatchNorm, `inv` computed with
    `layers.batch_norm`'s torch ops on the BatchNorm's device."""
    return _derived(
        bn, (bn.scale, bn.bias, bn.mean, bn.var),
        lambda: (bn.mean, torch.rsqrt(bn.var + eps) * bn.scale, bn.bias),
    )


def _next_operands(nxt: Optional[IBasicBlock]):
    """What the epilogue before block `nxt` writes besides its BatchNorm:
    (write_f32, write_bf16), f32 for a down-sampling conv's operand, bf16
    for a residual."""
    if nxt is None:
        return False, False
    return nxt.down is not None, nxt.down is None


def iresnet_forward_fused(
    model: IResNet, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """`model(x, compute_dtype)` of a folded IResNet in bfloat16 (the
    conditions of `fusable`) as convolutions with one epilogue between
    them: the stem's (bias, PReLU, then the first block's bn1 operand and
    its residual or shortcut operand), per block conv1's (bias, PReLU:
    conv2's operand) and conv2's (bias, the residual or the shortcut
    conv's output, then the next block's operands, or bn2's as the FC's
    operand). Every activation stays channels-last; each weight is rounded
    to bf16 once per module (`_derived`). On CPU tensors the epilogue is
    its plain version, so the result is the eager path's bit for bit."""
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the fused IResNet runs in bfloat16, not {compute_dtype}")
    blocks = _blocks(model)
    count("iresnet_blocks", len(blocks))
    count("iresnet_blocks_fused", len(blocks))
    xs = x.to(torch.bfloat16).permute(0, 3, 1, 2).to(torch.float32)
    stem = model.stem
    write_f32, write_bf16 = _next_operands(blocks[0])
    f32, res, op = conv_epilogue(
        _conv(stem.conv, xs), _bias(stem.conv), _alpha(stem), bn=bn_tables(blocks[0].bn1),
        write_f32=write_f32, write_bf16=write_bf16,
    )
    for i, block in enumerate(blocks):
        u, _, _ = conv_epilogue(
            _conv(block.unit1.conv, op), _bias(block.unit1.conv), _alpha(block.unit1),
            write_f32=True,
        )
        y = _conv(block.unit2.conv, u)
        down = None
        if block.down is not None:
            down = (_conv(block.down.conv, f32), _bias(block.down.conv))
            res = None
        nxt = blocks[i + 1] if i + 1 < len(blocks) else None
        write_f32, write_bf16 = _next_operands(nxt)
        f32, res, op = conv_epilogue(
            y, _bias(block.unit2.conv), _alpha(block.unit2), res=res, down=down,
            bn=bn_tables(model.bn2 if nxt is None else nxt.bn1),
            write_f32=write_f32, write_bf16=write_bf16,
        )
    fc = model.fc
    w = _derived(fc, (fc.weight,), lambda: fc.weight.to(torch.bfloat16).to(torch.float32))
    out = op.permute(0, 2, 3, 1).reshape(op.shape[0], -1) @ w.t()  # NHWC flatten
    if fc.bias is not None:
        out = out + fc.bias
    if model.features_bn is not None:
        out = model.features_bn(out)
    return out.to(torch.float32)
