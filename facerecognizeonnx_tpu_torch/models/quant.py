"""Post-training w8a8 quantization of the recognizers.

Port of `facerecognizeonnx_tpu/models/quant.py`. The scheme:

  - weights: per-output-channel int8, scale = max(absmax, 1e-12) / 127,
    w_q = clip(round(w / scale), -127, 127);
  - activations: per-tensor int8, x_q = clip(round(x * (1 / in_scale)),
    -127, 127), round half to even, in_scale = max(|x|) / 127 from ONE
    calibration forward in which every op already quantized runs int8,
    so each scale sees the error of the ops before it;
  - accumulation in int32, dequantized as acc * (w_scale * in_scale)
    (the product of the two scales formed first), then the bias, in
    float32; a conv's result is cast to the compute dtype, an FC's stays
    float32;
  - grouped and depthwise convs, and convs with fewer than
    `min_channels` outputs, stay in the compute dtype; every FC is
    quantized (ViT's linears included).

`quantize_recognizer(model, calib_x, ...)` returns a copy of any
recognizer (IResNet, MobileFaceNet, ViT) with `QConv` / `QLinear` in
place of the ops it quantizes: they hold int8 weights only, so the copy
keeps no float weight of a quantized op. It runs through the embed
pipelines like any recognizer.

The int8 product is `int_mm` on an im2col of the activations: on CUDA
tensors `torch._int_mm` (cuBLASLt, int8 x int8 → int32; counted in
`int_mm.launches`), the library product XLA's int8 conv stands for; on
CPU tensors its plain version `int_mm_reference`, an int64 matmul, which
is exact (|acc| <= 127² K < 2^31).
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from facerecognizeonnx_tpu_torch.models.layers import Conv, Linear

# torch._int_mm's shape rules on CUDA: more than 16 rows, K and N
# multiples of 8; zero padding keeps the product exact
_MIN_ROWS = 17
_ALIGN = 8


def quantize_weight(w: torch.Tensor, channel_dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: (w_q, scale)."""
    wf = w.to(torch.float32)
    dims = tuple(i for i in range(w.dim()) if i != channel_dim)
    scale = wf.abs().amax(dim=dims).clamp_min(1e-12) / 127.0
    shape = [1] * w.dim()
    shape[channel_dim] = -1
    w_q = torch.clamp(torch.round(wf / scale.view(shape)), -127, 127).to(torch.int8)
    return w_q, scale


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor activation scale: max(|x|) / 127, float32."""
    return x.to(torch.float32).abs().amax().clamp_min(1e-12) / 127.0


def quantize_act(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / in_scale
    return torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127).to(torch.int8)


def int_mm_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `int_mm`: (M, K) int8 × (N, K) int8 → (M, N) int32
    as an int64 matmul on the host's tensors."""
    return (a.to(torch.int64) @ w.to(torch.int64).t()).to(torch.int32)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _int_mm_padded(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm` on operands zero-padded to its shape rules."""
    m, k = a.shape
    n = w.shape[0]
    kp = -(-k // _ALIGN) * _ALIGN
    np_ = -(-n // _ALIGN) * _ALIGN
    acc = torch._int_mm(_pad_to(a, max(m, _MIN_ROWS), kp), _pad_to(w, np_, kp).t())
    return acc[:m, :n]


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 activations × (N, K) int8 weights → (M, N) int32.

    CUDA tensors: `torch._int_mm` (one launch, counted); CPU tensors:
    `int_mm_reference`."""
    if not a.is_cuda:
        return int_mm_reference(a, w)
    acc = _int_mm_padded(a, w)
    int_mm.launches += 1
    return acc


int_mm.launches = 0


def im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """(B, C, H, W) → ((B*Ho*Wo, kh*kw*C) rows in (dy, dx, c) order,
    (B, Ho, Wo)); zero padding, as the conv pads."""
    b, c, h, w = xq.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    x = xq.permute(0, 2, 3, 1)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    if kh == kw == 1:
        cols = x[:, : stride * (ho - 1) + 1 : stride, : stride * (wo - 1) + 1 : stride]
        return cols.reshape(b * ho * wo, c), (b, ho, wo)
    taps = [
        x[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride]
        for dy in range(kh)
        for dx in range(kw)
    ]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def conv_int32(
    xq: torch.Tensor, w_q: torch.Tensor, kh: int, kw: int, stride: int, padding: int,
    mm=None,
) -> torch.Tensor:
    """int8 NCHW activations × (O, kh*kw*C) int8 weights → the (B, O, Ho,
    Wo) int32 accumulator (an NCHW view of NHWC memory); the product is
    `mm`, by default `int_mm`."""
    cols, (b, ho, wo) = im2col(xq, kh, kw, stride, padding)
    return (mm or int_mm)(cols, w_q).reshape(b, ho, wo, -1).permute(0, 3, 1, 2)


class QConv(nn.Module):
    """w8a8 conv (groups=1). Weights as (O, kh*kw*I) int8, rows of the
    conv's (dy, dx, c) taps. An op built but not calibrated takes its
    activation scale from its first input (the calibration pass)."""

    def __init__(self, conv: Conv):
        super().__init__()
        o, i, kh, kw = conv.weight.shape
        w_q, w_scale = quantize_weight(conv.weight, 0)
        self.register_buffer("w_q", w_q.permute(0, 2, 3, 1).reshape(o, kh * kw * i).contiguous())
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("in_scale", None)
        self.register_buffer(
            "bias", None if conv.bias is None else conv.bias.detach().to(torch.float32)
        )
        self.kh, self.kw, self.stride, self.padding = kh, kw, conv.stride, conv.padding

    def accumulate(self, xq: torch.Tensor) -> torch.Tensor:
        """The int32 accumulator of int8 activations `xq`."""
        return conv_int32(xq, self.w_q, self.kh, self.kw, self.stride, self.padding)

    def forward(self, x, compute_dtype=torch.float32):
        if self.in_scale is None:
            self.in_scale = act_scale(x)
        acc = self.accumulate(quantize_act(x, self.in_scale))
        y = acc.to(torch.float32) * (self.w_scale * self.in_scale)[:, None, None]
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return y.to(compute_dtype)


class QLinear(nn.Module):
    """w8a8 FC; (dout, din) int8 weights; float32 output like `Linear`."""

    def __init__(self, lin: Linear):
        super().__init__()
        w_q, w_scale = quantize_weight(lin.weight, 0)
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("in_scale", None)
        self.register_buffer(
            "bias", None if lin.bias is None else lin.bias.detach().to(torch.float32)
        )

    def forward(self, x, compute_dtype=torch.float32):
        if self.in_scale is None:
            self.in_scale = act_scale(x)
        acc = int_mm(quantize_act(x, self.in_scale), self.w_q)
        y = acc.to(torch.float32) * (self.w_scale * self.in_scale)
        if self.bias is not None:
            y = y + self.bias
        return y


def quantize_recognizer(
    model: nn.Module,
    calib_x: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    min_channels: int = 0,
) -> nn.Module:
    """A w8a8 copy of `model`, calibrated by one forward over `calib_x`
    ((B, S, S, 3) normalized crops on the model's device)."""
    qmodel = copy.deepcopy(model)
    for parent in list(qmodel.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, Conv) and child.groups == 1 and \
                    child.weight.shape[0] >= min_channels:
                setattr(parent, name, QConv(child))
            elif isinstance(child, Linear):
                setattr(parent, name, QLinear(child))
    with torch.no_grad():
        qmodel(calib_x, compute_dtype)
    return qmodel


def is_quantized(model: Optional[nn.Module]) -> bool:
    return model is not None and any(
        isinstance(m, (QConv, QLinear)) for m in model.modules()
    )
