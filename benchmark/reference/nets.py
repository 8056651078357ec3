"""Plain forward passes of SCRFD, IResNet and MobileFaceNet over a
JAX-layout param tree (conv weights HWIO, FC weights (din, dout)).

IResNet and MobileFaceNet are written from the published architectures
(insightface's w600k_r50 and w600k_mbf). The detector is the one the
configuration's `detector` entry describes: the repo's own 500m-class
SCRFD redesign (a depthwise-separable backbone of the given plan, an FPN
neck and one head shared across strides), not the published det_500m
and its searched backbone. All in plain torch ops, with the rounding
points that a configuration with `compute: bfloat16` states:

  - conv and FC: both operands rounded by `prec.operand`, products and
    sums in float32 (a product of bfloat16 operands is exact with TF32
    on or off; the caller's TF32 setting picks the summation order), the
    bias added in float32, the result rounded once to bfloat16 (the FC
    result stays float32);
  - BatchNorm after a conv or an FC is folded into its weights in
    float32 before rounding; a BatchNorm in front of a conv (IResNet's
    block bn1 and the pre-flatten bn2) is applied in float32 and its
    result rounded to bfloat16;
  - PReLU, residual and FPN adds in bfloat16.

`prec` is a `Precision`: `BF16` for the reference, `FP8` for the
control (per-tensor scaled float8 e4m3 operands, one step below).
Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STRIDES = (8, 16, 32)
NUM_ANCHORS = 2


class Precision:
    """How conv / FC operands are rounded before the float32 product."""

    def __init__(self, name: str):
        if name not in ("bfloat16", "float8_e4m3"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        if self.name == "bfloat16":
            return t.to(torch.bfloat16).to(torch.float32)
        amax = t.abs().amax().clamp_min(1e-30)
        scale = amax / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


BF16 = Precision("bfloat16")
FP8 = Precision("float8_e4m3")


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _fold(w_oihw: torch.Tensor, b, bn: Dict, device):
    """A post-conv (or post-FC, w (dout, din)) BatchNorm folded in float32."""
    inv = _t(bn["scale"], device) * torch.rsqrt(_t(bn["var"], device) + BN_EPS)
    shape = (-1,) + (1,) * (w_oihw.dim() - 1)
    w = w_oihw * inv.view(shape)
    b0 = torch.zeros_like(inv) if b is None else b
    return w, (b0 - _t(bn["mean"], device)) * inv + _t(bn["bias"], device)


def _conv_params(p: Dict, bn, device):
    """HWIO weights (+ bias) of a tree conv, folded with `bn` if given,
    as (OIHW float32, bias float32 or None)."""
    w = _t(p["w"], device).permute(3, 2, 0, 1)
    b = _t(p["b"], device) if "b" in p else None
    if bn is not None:
        w, b = _fold(w, b, bn, device)
    return w.contiguous(), b


def conv(x, wb, prec: Precision, stride=1, padding=0, groups=1):
    w, b = wb
    y = F.conv2d(prec.operand(x), prec.operand(w), None, stride, padding, 1, groups)
    if b is not None:
        y = y + b[:, None, None]
    return y.to(torch.bfloat16)


def prelu(x, alpha, device):
    a = _t(alpha, device).to(x.dtype).view(1, -1, 1, 1)
    return torch.where(x >= 0, x, x * a)


def batch_norm(x, bn: Dict, device):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = (torch.rsqrt(_t(bn["var"], device) + BN_EPS) * _t(bn["scale"], device)).view(shape)
    y = (x.to(torch.float32) - _t(bn["mean"], device).view(shape)) * inv
    return (y + _t(bn["bias"], device).view(shape)).to(x.dtype)


def linear(x, wb, prec: Precision):
    w, b = wb  # w (dout, din)
    y = prec.operand(x) @ prec.operand(w).t()
    return y if b is None else y + b


# ---------------------------------------------------------------- SCRFD


def scrfd(tree: Dict, x_nhwc: torch.Tensor, prec: Precision, plan, device, logits=False):
    """Normalized RGB (B, S, S, 3) → {stride: (scores (B, N, 1), bbox
    (B, N, 4), kps (B, N, 10))}, rows location-major, anchors fastest
    (with logits=True the scores are the cls conv's outputs before the
    sigmoid). `plan`: the backbone's (out_ch, stride) blocks, the stem
    first."""
    cu = lambda p, key: _conv_params(p[key], p.get("bn"), device)  # noqa: E731
    y = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    st = tree["stem"]
    y = prelu(conv(y, cu(st, "conv"), prec, 2, 1), st["prelu"]["alpha"], device)
    chans = sorted({c for c, _ in plan})[-3:]
    tap_of = dict(zip(chans, ("c3", "c4", "c5")))
    taps, cin = {}, plan[0][0]
    for (cout, stride), blk in zip(plan[1:], tree["backbone"]):
        dw = _conv_params(blk["dw"], blk["dw_bn"], device)
        y = prelu(conv(y, dw, prec, stride, 1, groups=cin), blk["dw_prelu"]["alpha"], device)
        pw = _conv_params(blk["pw"], blk["pw_bn"], device)
        y = prelu(conv(y, pw, prec), blk["pw_prelu"]["alpha"], device)
        if cout in tap_of and stride == 1:
            taps[tap_of[cout]] = y
        cin = cout
    n = {k: _conv_params(v, None, device) for k, v in tree["neck"].items()}
    up = lambda t: t.repeat_interleave(2, 2).repeat_interleave(2, 3)  # noqa: E731
    p5 = conv(taps["c5"], n["lat_c5"], prec)
    p4 = conv(taps["c4"], n["lat_c4"], prec) + up(p5)
    p3 = conv(taps["c3"], n["lat_c3"], prec) + up(p4)
    p3, p4, p5 = (conv(p, n[f"smooth_p{i}"], prec, 1, 1) for i, p in ((3, p3), (4, p4), (5, p5)))
    head = tree["head"]
    units = [(_conv_params(c["conv"], c["bn"], device), c["prelu"]["alpha"]) for c in head["convs"]]
    outs = {}
    for stride, h in zip(STRIDES, (p3, p4, p5)):
        for wb, alpha in units:
            h = prelu(conv(h, wb, prec, 1, 1), alpha, device)
        scale = float(head_scale(tree, stride))
        b, _, hh, ww = h.shape
        rows = hh * ww * NUM_ANCHORS

        def rows_of(t, k):
            return t.to(torch.float32).permute(0, 2, 3, 1).reshape(b, rows, k)

        cls = conv(h, _conv_params(head["cls"], None, device), prec, 1, 1)
        bbox = conv(h, _conv_params(head["bbox"], None, device), prec, 1, 1)
        kps = conv(h, _conv_params(head["kps"], None, device), prec, 1, 1)
        c = rows_of(cls, 1)
        outs[stride] = (c if logits else torch.sigmoid(c), rows_of(bbox, 4) * scale,
                        rows_of(kps, 10) * scale)
    return outs


def head_scale(tree: Dict, stride: int) -> float:
    return float(torch.as_tensor(tree["scales"][f"s{stride}"]))


def scrfd_cls_logits(tree, x_nhwc, plan, device):
    """The reference's cls logits (B, N) before the sigmoid, for the
    detection-bias recipe (a sigmoid that rounds to 1 has no logit)."""
    outs = scrfd(tree, x_nhwc, BF16, plan, device, logits=True)
    return torch.cat([outs[s][0][..., 0] for s in STRIDES], -1)


# ---------------------------------------------------------------- recognizers


def _nhwc_flatten(t):
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)


def iresnet(tree: Dict, x_nhwc: torch.Tensor, prec: Precision, device) -> torch.Tensor:
    """Normalized RGB (B, 112, 112, 3) → (B, 512) float32, not normalized."""
    y = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    y = conv(y, _conv_params(tree["conv1"], tree["bn1"], device), prec, 1, 1)
    y = prelu(y, tree["prelu1"]["alpha"], device)
    s = 1
    while f"layer{s}" in tree:
        for i, p in enumerate(tree[f"layer{s}"]):
            stride = 2 if i == 0 else 1
            out = batch_norm(y, p["bn1"], device)
            out = conv(out, _conv_params(p["conv1"], p["bn2"], device), prec, 1, 1)
            out = prelu(out, p["prelu"]["alpha"], device)
            out = conv(out, _conv_params(p["conv2"], p["bn3"], device), prec, stride, 1)
            if "down_conv" in p:
                y = conv(y, _conv_params(p["down_conv"], p["down_bn"], device), prec, stride, 0)
            y = out + y
        s += 1
    y = _nhwc_flatten(batch_norm(y, tree["bn2"], device))
    fc = _fold(_t(tree["fc"]["w"], device).t(), _t(tree["fc"]["b"], device),
               tree["features_bn"], device)
    return linear(y, fc, prec).to(torch.float32)


def mobilefacenet(tree: Dict, x_nhwc: torch.Tensor, prec: Precision, plan, device) -> torch.Tensor:
    """Normalized RGB (B, 112, 112, 3) → (B, 512) float32, not normalized.
    `plan`: the body's (cin, cout, expand, stride) bottlenecks."""

    def unit(y, p, stride=1, padding=0, groups=1, act=True):
        y = conv(y, _conv_params(p["conv"], p["bn"], device), prec, stride, padding, groups)
        return prelu(y, p["prelu"]["alpha"], device) if act else y

    y = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    y = unit(y, tree["stem"], 2, 1)
    y = unit(y, tree["stem_dw"], 1, 1, groups=64)
    for (_, _, g, stride), p in zip(plan, tree["body"]):
        z = conv(y, _conv_params(p["pw1"], p["pw1_bn"], device), prec)
        z = prelu(z, p["pw1_prelu"]["alpha"], device)
        z = conv(z, _conv_params(p["dw"], p["dw_bn"], device), prec, stride, 1, groups=g)
        z = prelu(z, p["dw_prelu"]["alpha"], device)
        z = conv(z, _conv_params(p["pw2"], p["pw2_bn"], device), prec)
        y = y + z if stride == 1 else z
    y = unit(y, tree["conv_sep"])
    y = unit(y, tree["gdc_dw"], groups=512, act=False)
    fc = _fold(_t(tree["fc"]["w"], device).t(), None, tree["features_bn"], device)
    return linear(_nhwc_flatten(y), fc, prec).to(torch.float32)
