"""Weights bridge: JAX param trees (as numpy) → the port's nn.Modules.

`params_from_numpy(tree, device="cuda")` takes a param pytree of the JAX
package — after `jax.device_get`, or any tree of array-likes — and
returns the port's module on `device`: SCRFD (any variant, from
`scrfd.infer_variant`), IResNet, MobileFaceNet (a tree with "body") or
ViT (a tree with "pos_embed"). Both unfolded trees and
`fold_inference_params` trees (post-conv BN keys absent, conv biases
present) are accepted. Layout conversions:

  conv   HWIO → OIHW  (w.transpose(3, 2, 0, 1)); depthwise is HWIO, I=1;
         a conv dict may instead hold "w_oihw", taken as it is
  FC     (din, dout) → (dout, din)
  BN dicts, LayerNorms and PReLU alphas are copied as they are.

`tree_from_module(model)` is the inverse, module → numpy tree (the
ONNX exporter's input).

For training (`models.layers.make_trainable` modules): `tree_from_tensors`
/ `tensors_from_tree` carry per-parameter tensors (a gradient, a
momentum) between a module's parameter names and a JAX-layout tree,
`load_tree_into` overwrites a module's weights from a tree, and
`train_state_from_numpy` carries a JAX `TrainState` (after
`jax.device_get`) into the port's (train/trainer.py).

`init_params_numpy(arch, seed)` draws a tree of the same shapes as the
JAX initializers (He-normal convs and FC, identity BN and LayerNorm,
PReLU 0.25, the SCRFD focal-style cls bias, ViT positions N(0, 0.02²))
with numpy, for hosts without JAX. Its
values differ from `jax.random`'s.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.config import resolve_device
from facerecognizeonnx_tpu_torch.errors import ModelLoadError
from facerecognizeonnx_tpu_torch.models.arcface import (
    IRESNET_SPECS,
    IBasicBlock,
    IResNet,
)
from facerecognizeonnx_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvUnit,
    Linear,
    PReLU,
    make_trainable,
)
from facerecognizeonnx_tpu_torch.models.mobilefacenet import (
    MBF_SPECS,
    Bottleneck,
    MobileFaceNet,
    arch_of_depth,
    body_plan,
)
from facerecognizeonnx_tpu_torch.models.scrfd import (
    NUM_ANCHORS,
    SCRFD,
    SCRFD_VARIANTS,
    STRIDES,
    DWSepBlock,
    infer_variant,
)
from facerecognizeonnx_tpu_torch.models.vit import (
    PATCH,
    VIT_SPECS,
    Block,
    LayerNorm,
    ViT,
    arch_of_dim,
)

def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


# ---------------------------------------------------------------- tree → module


def _conv(p, stride=1, padding=0, groups=1) -> Conv:
    if "w_oihw" in p:  # as an ONNX file holds it (onnx_import/native_map.py)
        w = p["w_oihw"]
    else:
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)  # HWIO → OIHW
    b = _t(p["b"]) if "b" in p else None
    return Conv(_t(w), b, stride, padding, groups)


def _bn(p) -> Optional[BatchNorm]:
    if p is None:
        return None
    return BatchNorm(_t(p["scale"]), _t(p["bias"]), _t(p["mean"]), _t(p["var"]))


def _prelu(p) -> PReLU:
    return PReLU(_t(p["alpha"]))


def _linear(p) -> Linear:
    w = np.asarray(p["w"], np.float32).T  # (din, dout) → (dout, din)
    return Linear(_t(w), _t(p["b"]) if "b" in p else None)


def _cbp(p, stride=1, padding=0, groups=1) -> ConvUnit:
    """{"conv", "bn"?, "prelu"?} → ConvUnit (a folded tree has no "bn")."""
    act = _prelu(p["prelu"]) if "prelu" in p else None
    return ConvUnit(_conv(p["conv"], stride, padding, groups), _bn(p.get("bn")), act)


def _ln(p) -> LayerNorm:
    return LayerNorm(_t(p["scale"]), _t(p["bias"]))


def _scrfd_from_tree(tree) -> SCRFD:
    variant = infer_variant(tree)
    spec = SCRFD_VARIANTS[variant]
    plan = spec["plan"]
    stem = _cbp(tree["stem"], 1 if spec.get("s2d") else 2, 1)
    blocks = []
    cin = plan[0][0]
    for (cout, stride), blk in zip(plan[1:], tree["backbone"]):
        if spec.get("dense"):
            blocks.append(_cbp(blk, stride, 1))
        else:
            dw = ConvUnit(
                _conv(blk["dw"], stride, 1, groups=cin),
                _bn(blk.get("dw_bn")),
                _prelu(blk["dw_prelu"]),
            )
            pw = ConvUnit(_conv(blk["pw"]), _bn(blk.get("pw_bn")), _prelu(blk["pw_prelu"]))
            blocks.append(DWSepBlock(dw, pw))
        cin = cout
    n = tree["neck"]
    neck = {k: _conv(n[k], 1, 1 if k.startswith("smooth") else 0) for k in n}
    h = tree["head"]
    head_convs = [_cbp(cp, 1, 1) for cp in h["convs"]]
    scales = {s: float(np.asarray(tree["scales"][f"s{s}"])) for s in STRIDES}
    return SCRFD(
        stem, blocks, neck, head_convs,
        _conv(h["cls"], 1, 1), _conv(h["bbox"], 1, 1), _conv(h["kps"], 1, 1),
        scales, variant,
    )

def _iresnet_from_tree(tree) -> IResNet:
    stem = ConvUnit(_conv(tree["conv1"], 1, 1), _bn(tree.get("bn1")),
                    _prelu(tree["prelu1"]))
    stages = []
    for s in (1, 2, 3, 4):
        stage = []
        for b, p in enumerate(tree[f"layer{s}"]):
            stride = 2 if b == 0 else 1
            down = None
            if "down_conv" in p:
                down = ConvUnit(_conv(p["down_conv"], stride, 0), _bn(p.get("down_bn")))
            stage.append(
                IBasicBlock(
                    _bn(p["bn1"]),
                    ConvUnit(_conv(p["conv1"], 1, 1), _bn(p.get("bn2")),
                             _prelu(p["prelu"])),
                    ConvUnit(_conv(p["conv2"], stride, 1), _bn(p.get("bn3"))),
                    down,
                )
            )
        stages.append(stage)
    return IResNet(stem, stages, _bn(tree["bn2"]), _linear(tree["fc"]),
                   _bn(tree.get("features_bn")))


def _mbf_from_tree(tree) -> MobileFaceNet:
    plan = body_plan(*MBF_SPECS[arch_of_depth(len(tree["body"]))])
    body = [
        Bottleneck(
            ConvUnit(_conv(p["pw1"]), _bn(p.get("pw1_bn")), _prelu(p["pw1_prelu"])),
            ConvUnit(_conv(p["dw"], stride, 1, groups=g), _bn(p.get("dw_bn")),
                     _prelu(p["dw_prelu"])),
            ConvUnit(_conv(p["pw2"]), _bn(p.get("pw2_bn"))),
            residual=stride == 1,
        )
        for (_, _, g, stride), p in zip(plan, tree["body"])
    ]
    return MobileFaceNet(
        _cbp(tree["stem"], 2, 1), _cbp(tree["stem_dw"], 1, 1, groups=64), body,
        _cbp(tree["conv_sep"]), _cbp(tree["gdc_dw"], groups=512),
        _linear(tree["fc"]), _bn(tree.get("features_bn")),
    )


def _vit_from_tree(tree) -> ViT:
    _, _, heads = VIT_SPECS[arch_of_dim(np.shape(tree["pos_embed"])[1])]
    blocks = [
        Block(_ln(p["ln1"]), _linear(p["qkv"]), _linear(p["proj"]), _ln(p["ln2"]),
              _linear(p["mlp1"]), _linear(p["mlp2"]), heads)
        for p in tree["blocks"]
    ]
    return ViT(_linear(tree["patch"]), _t(tree["pos_embed"]), blocks, _ln(tree["ln_f"]),
               _linear(tree["fc"]), _bn(tree.get("features_bn")))


def params_from_numpy(tree: Dict, device="cuda") -> torch.nn.Module:
    """JAX SCRFD / IResNet / MobileFaceNet / ViT param tree → the port's
    module, float32, on `device` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    if "stem" in tree and "backbone" in tree:
        model = _scrfd_from_tree(tree)
    elif "layer1" in tree:
        model = _iresnet_from_tree(tree)
    elif "body" in tree:
        model = _mbf_from_tree(tree)
    elif "pos_embed" in tree:
        model = _vit_from_tree(tree)
    else:
        raise ModelLoadError(
            "param tree matches no known model (SCRFD, IResNet, MobileFaceNet or ViT)"
        )
    return model.to(dev)

# ---------------------------------------------------------------- module → tree


def _n(t: torch.Tensor) -> np.ndarray:
    # a copy: a trainable module's tensors change in place at every step
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _conv_tree(conv: Conv) -> Dict:
    tree = {"w": _n(conv.weight).transpose(2, 3, 1, 0)}  # OIHW → HWIO
    if conv.bias is not None:
        tree["b"] = _n(conv.bias)
    return tree


def _bn_tree(bn: BatchNorm) -> Dict:
    return {k: _n(getattr(bn, k)) for k in ("scale", "bias", "mean", "var")}


def _linear_tree(lin: Linear) -> Dict:
    tree = {"w": _n(lin.weight).T}  # (dout, din) → (din, dout)
    if lin.bias is not None:
        tree["b"] = _n(lin.bias)
    return tree


def _unit_tree(unit: ConvUnit, conv="conv", bn="bn", act="prelu") -> Dict:
    tree = {conv: _conv_tree(unit.conv)}
    if unit.bn is not None:
        tree[bn] = _bn_tree(unit.bn)
    if unit.act is not None:
        tree[act] = {"alpha": _n(unit.act.alpha)}
    return tree


def _ln_tree(ln: LayerNorm) -> Dict:
    return {"scale": _n(ln.scale), "bias": _n(ln.bias)}


def tree_from_module(model: torch.nn.Module) -> Dict:
    """The inverse of `params_from_numpy`: the JAX-layout numpy tree of a
    SCRFD / IResNet / MobileFaceNet / ViT module (unfolded or folded:
    absent BNs are absent keys)."""
    if isinstance(model, SCRFD):
        tree: Dict = {"stem": _unit_tree(model.stem)}
        tree["backbone"] = [
            {**_unit_tree(b.dw, "dw", "dw_bn", "dw_prelu"),
             **_unit_tree(b.pw, "pw", "pw_bn", "pw_prelu")}
            if isinstance(b, DWSepBlock) else _unit_tree(b)
            for b in model.backbone
        ]
        tree["neck"] = {k: _conv_tree(c) for k, c in model.neck.items()}
        tree["head"] = {
            "convs": [_unit_tree(u) for u in model.head_convs],
            "cls": _conv_tree(model.cls),
            "bbox": _conv_tree(model.bbox),
            "kps": _conv_tree(model.kps),
        }
        tree["scales"] = {  # floats, or parameters in a trainable model
            f"s{s}": np.float32(_n(v) if isinstance(v, torch.Tensor) else v)
            for s, v in model.scales.items()
        }
        return tree
    if isinstance(model, IResNet):
        stem = _unit_tree(model.stem, "conv1", "bn1", "prelu1")
        tree = {**stem}
        for s, stage in enumerate(model.stages, start=1):
            blocks = []
            for blk in stage:
                p = {"bn1": _bn_tree(blk.bn1),
                     **_unit_tree(blk.unit1, "conv1", "bn2", "prelu"),
                     **_unit_tree(blk.unit2, "conv2", "bn3")}
                if blk.down is not None:
                    p.update(_unit_tree(blk.down, "down_conv", "down_bn"))
                blocks.append(p)
            tree[f"layer{s}"] = blocks
        tree["bn2"] = _bn_tree(model.bn2)
        tree["fc"] = _linear_tree(model.fc)
    elif isinstance(model, MobileFaceNet):
        tree = {"stem": _unit_tree(model.stem), "stem_dw": _unit_tree(model.stem_dw)}
        tree["body"] = [
            {**_unit_tree(b.pw1, "pw1", "pw1_bn", "pw1_prelu"),
             **_unit_tree(b.dw, "dw", "dw_bn", "dw_prelu"),
             **_unit_tree(b.pw2, "pw2", "pw2_bn")}
            for b in model.body
        ]
        tree["conv_sep"] = _unit_tree(model.conv_sep)
        tree["gdc_dw"] = _unit_tree(model.gdc)
        tree["fc"] = _linear_tree(model.fc)
    elif isinstance(model, ViT):
        tree = {
            "patch": _linear_tree(model.patch),
            "pos_embed": _n(model.pos_embed),
            "blocks": [
                {"ln1": _ln_tree(b.ln1), "qkv": _linear_tree(b.qkv),
                 "proj": _linear_tree(b.proj), "ln2": _ln_tree(b.ln2),
                 "mlp1": _linear_tree(b.mlp1), "mlp2": _linear_tree(b.mlp2)}
                for b in model.blocks
            ],
            "ln_f": _ln_tree(model.ln_f),
            "fc": _linear_tree(model.fc),
        }
    else:
        raise ModelLoadError(f"not a model of the port: {type(model).__name__}")
    if model.features_bn is not None:
        tree["features_bn"] = _bn_tree(model.features_bn)
    return tree


# ---------------------------------------------------------------- training


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def tree_from_tensors(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict:
    """The JAX-layout tree of per-parameter tensors of a trainable `model`
    ({parameter name: tensor of its shape}, e.g. a momentum): the
    model's tree with each parameter replaced by its tensor and each BN
    running statistic by zeros (a JAX optimizer state holds zeros there:
    those leaves get no gradient in train mode)."""
    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in shadow.named_parameters():
            p.copy_(tensors[name])
        for b in shadow.buffers():
            b.zero_()
    return tree_from_module(shadow)


def tensors_from_tree(model: torch.nn.Module, tree: Dict) -> Dict[str, torch.Tensor]:
    """The inverse of `tree_from_tensors`: {parameter name of `model`:
    tensor} from a JAX-layout tree of the model's structure, on the
    model's device (its BN statistic leaves are ignored)."""
    shadow = make_trainable(params_from_numpy(tree, device=_model_device(model)))
    return {n: p.detach() for n, p in shadow.named_parameters()}


def load_tree_into(model: torch.nn.Module, tree: Dict) -> torch.nn.Module:
    """Overwrite a trainable model's weights and BN statistics, in place,
    from a JAX-layout tree of the same structure."""
    src = make_trainable(params_from_numpy(tree, device=_model_device(model)))
    with torch.no_grad():
        model.load_state_dict(src.state_dict())
    return model


def train_state_from_numpy(params: Dict, classifier, opt_state, step, device="cuda",
                           mesh=None):
    """A JAX `TrainState`'s fields (after `jax.device_get`: the params
    tree, the (D, C) classifier, the optax SGD state, the step) → the
    port's `TrainState` on `device` (or this rank's device and classifier
    columns on `mesh`), so both packages step from the same state. The
    optax state is (TraceState(trace=(params, classifier)), EmptyState()
    or ScaleByScheduleState(count)); without a count the count is the
    step."""
    from facerecognizeonnx_tpu_torch.train.trainer import (
        TrainState,
        _state_device,
        column_block,
    )

    dev = _state_device(mesh, device)
    model = make_trainable(params_from_numpy(params, device=dev))
    trace_params, trace_cls = opt_state[0].trace
    has_count = "count" in getattr(opt_state[1], "_fields", ())
    count = opt_state[1].count if has_count else step
    trace = tensors_from_tree(model, trace_params)
    trace["classifier"] = column_block(_t(trace_cls), mesh).to(dev)
    cls = column_block(_t(classifier), mesh).to(dev).requires_grad_(True)
    return TrainState(
        model, cls,
        {"trace": trace, "count": torch.tensor(int(np.asarray(count)), dtype=torch.int64)},
        torch.tensor(int(np.asarray(step)), dtype=torch.int64),
    )


# ---------------------------------------------------------------- numpy init


class _Init:
    """He-normal initializers mirroring models/layers.py of the JAX package."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def conv(self, kh, kw, cin, cout, groups=1):
        std = (2.0 / (kh * kw * cin // groups)) ** 0.5
        w = self.rng.standard_normal((kh, kw, cin // groups, cout), np.float32)
        return {"w": w * np.float32(std)}

    def linear(self, din, dout):
        std = (2.0 / din) ** 0.5
        w = self.rng.standard_normal((din, dout), np.float32) * np.float32(std)
        return {"w": w, "b": np.zeros((dout,), np.float32)}

    @staticmethod
    def bn(c):
        return {
            "scale": np.ones((c,), np.float32),
            "bias": np.zeros((c,), np.float32),
            "mean": np.zeros((c,), np.float32),
            "var": np.ones((c,), np.float32),
        }

    @staticmethod
    def prelu(c):
        return {"alpha": np.full((c,), 0.25, np.float32)}


def _cbp_tree(init: _Init, k, cin, cout, groups=1, prelu=True) -> Dict:
    tree = {"conv": init.conv(k, k, cin, cout, groups), "bn": init.bn(cout)}
    if prelu:
        tree["prelu"] = init.prelu(cout)
    return tree


def _scrfd_tree(init: _Init, variant: str) -> Dict:
    spec = SCRFD_VARIANTS[variant]
    plan, neck_ch, head_ch = spec["plan"], spec["neck"], spec["head"]
    stem_ch = plan[0][0]
    s2d = int(spec.get("s2d", 0))
    tree: Dict = {"stem": _cbp_tree(init, 3, 3 * s2d * s2d if s2d else 3, stem_ch)}
    blocks, cin = [], stem_ch
    for cout, _ in plan[1:]:
        if spec.get("dense"):
            blocks.append(_cbp_tree(init, 3, cin, cout))
        else:
            blocks.append({
                "dw": init.conv(3, 3, cin, cin, groups=cin),
                "dw_bn": init.bn(cin),
                "dw_prelu": init.prelu(cin),
                "pw": init.conv(1, 1, cin, cout),
                "pw_bn": init.bn(cout),
                "pw_prelu": init.prelu(cout),
            })
        cin = cout
    tree["backbone"] = blocks
    c3, c4, c5 = sorted({c for c, _ in plan})[-3:]
    tree["neck"] = {
        "lat_c3": init.conv(1, 1, c3, neck_ch),
        "lat_c4": init.conv(1, 1, c4, neck_ch),
        "lat_c5": init.conv(1, 1, c5, neck_ch),
        "smooth_p3": init.conv(3, 3, neck_ch, neck_ch),
        "smooth_p4": init.conv(3, 3, neck_ch, neck_ch),
        "smooth_p5": init.conv(3, 3, neck_ch, neck_ch),
    }
    convs, cin = [], neck_ch
    for _ in range(spec["stacked"]):
        convs.append(_cbp_tree(init, 3, cin, head_ch))
        cin = head_ch
    head = {"convs": convs}
    for name, k, bias in (("cls", 1, -4.59), ("bbox", 4, 0.0), ("kps", 10, 0.0)):
        head[name] = init.conv(3, 3, head_ch, NUM_ANCHORS * k)
        head[name]["b"] = np.full((NUM_ANCHORS * k,), bias, np.float32)
    tree["head"] = head
    tree["scales"] = {f"s{s}": np.ones((), np.float32) for s in STRIDES}
    return tree

def _iresnet_tree(init: _Init, arch: str, input_size: int, feature_dim: int) -> Dict:
    blocks, widths = IRESNET_SPECS[arch]
    tree: Dict = {
        "conv1": init.conv(3, 3, 3, 64),
        "bn1": init.bn(64),
        "prelu1": init.prelu(64),
    }
    inplanes = 64
    for s, (n, planes) in enumerate(zip(blocks, widths), start=1):
        stage = []
        for b in range(n):
            block = {
                "bn1": init.bn(inplanes),
                "conv1": init.conv(3, 3, inplanes, planes),
                "bn2": init.bn(planes),
                "prelu": init.prelu(planes),
                "conv2": init.conv(3, 3, planes, planes),
                "bn3": init.bn(planes),
            }
            if b == 0 or inplanes != planes:
                block["down_conv"] = init.conv(1, 1, inplanes, planes)
                block["down_bn"] = init.bn(planes)
            stage.append(block)
            inplanes = planes
        tree[f"layer{s}"] = stage
    spatial = input_size // 16
    tree["bn2"] = init.bn(widths[-1])
    tree["fc"] = init.linear(widths[-1] * spatial * spatial, feature_dim)
    tree["features_bn"] = init.bn(feature_dim)
    return tree


def _mbf_tree(init: _Init, arch: str, input_size: int, feature_dim: int) -> Dict:
    blocks, scale = MBF_SPECS[arch]
    c64, c128 = 64 * scale, 128 * scale
    tree: Dict = {
        "stem": _cbp_tree(init, 3, 3, c64),
        "stem_dw": _cbp_tree(init, 3, c64, c64, groups=64),
    }
    body = []
    for cin, cout, g, _ in body_plan(blocks, scale):
        body.append({
            "pw1": init.conv(1, 1, cin, g),
            "pw1_bn": init.bn(g),
            "pw1_prelu": init.prelu(g),
            "dw": init.conv(3, 3, g, g, groups=g),
            "dw_bn": init.bn(g),
            "dw_prelu": init.prelu(g),
            "pw2": init.conv(1, 1, g, cout),
            "pw2_bn": init.bn(cout),
        })
    tree["body"] = body
    tree["conv_sep"] = _cbp_tree(init, 1, c128, 512)
    tree["gdc_dw"] = _cbp_tree(init, input_size // 16, 512, 512, groups=512, prelu=False)
    tree["fc"] = {"w": init.linear(512, feature_dim)["w"]}  # no bias
    tree["features_bn"] = init.bn(feature_dim)
    return tree


def _vit_tree(init: _Init, arch: str, input_size: int, feature_dim: int) -> Dict:
    dim, depth, _ = VIT_SPECS[arch]
    if input_size % PATCH:
        raise ValueError(f"input_size {input_size} not divisible by {PATCH}")

    def ln():
        return {"scale": np.ones((dim,), np.float32), "bias": np.zeros((dim,), np.float32)}

    n_tok = (input_size // PATCH) ** 2
    tree: Dict = {
        "patch": init.linear(PATCH * PATCH * 3, dim),
        "pos_embed": init.rng.standard_normal((n_tok, dim), np.float32) * np.float32(0.02),
    }
    tree["blocks"] = [
        {
            "ln1": ln(),
            "qkv": init.linear(dim, 3 * dim),
            "proj": init.linear(dim, dim),
            "ln2": ln(),
            "mlp1": init.linear(dim, 4 * dim),
            "mlp2": init.linear(4 * dim, dim),
        }
        for _ in range(depth)
    ]
    tree["ln_f"] = ln()
    tree["fc"] = init.linear(dim, feature_dim)
    tree["features_bn"] = init.bn(feature_dim)
    return tree


def init_params_numpy(
    arch: str, seed: int = 0, input_size: int = 112, feature_dim: int = 512
) -> Dict:
    """Random param tree for an SCRFD variant ("500m", "2.5g", "10g",
    "tpu", "500m_s2d") or a recognizer ("iresnet18/34/50/100", "mbf",
    "mbf_large", "vit_t/s/b"), JAX layouts, drawn from `seed` with numpy."""
    init = _Init(seed)
    if arch in SCRFD_VARIANTS:
        return _scrfd_tree(init, arch)
    if arch in IRESNET_SPECS:
        return _iresnet_tree(init, arch, input_size, feature_dim)
    if arch in MBF_SPECS:
        return _mbf_tree(init, arch, input_size, feature_dim)
    if arch in VIT_SPECS:
        return _vit_tree(init, arch, input_size, feature_dim)
    raise ValueError(f"unknown arch {arch!r}")
