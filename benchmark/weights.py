"""Seeded parameter trees in the JAX layout the program's loader reads
(conv weights HWIO, FC weights (din, dout), BatchNorm dicts), drawn on
the device in two large calls (one normal, one uniform buffer) and cut
into leaves.

He-normal convs and FCs; BatchNorms with drawn statistics (scale and
var in [0.8, 1.2], bias and mean N(0, 0.05²)) so that folding them is
real work; PReLU slopes in [0.15, 0.35]. The architectures are read
from the configuration file (`plan`, `blocks`, `widths`, ...), so a
configuration of another depth needs no code here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


class _Draw:
    """Collects leaf shapes first, then fills them from two buffers."""

    def __init__(self):
        self.leaves: List[Tuple[dict, str, tuple, str, float, float]] = []

    def _add(self, d, key, shape, kind, a=0.0, b=1.0):
        self.leaves.append((d, key, tuple(shape), kind, a, b))

    def conv(self, k, cin, cout, groups=1, bias=False) -> Dict:
        d: Dict = {}
        self._add(d, "w", (k, k, cin // groups, cout), "normal", 0.0,
                  (2.0 / (k * k * cin // groups)) ** 0.5)
        if bias:
            self._add(d, "b", (cout,), "normal", 0.0, 0.01)
        return d

    def linear(self, din, dout, bias=True) -> Dict:
        d: Dict = {}
        self._add(d, "w", (din, dout), "normal", 0.0, (2.0 / din) ** 0.5)
        if bias:
            self._add(d, "b", (dout,), "normal", 0.0, 0.01)
        return d

    def bn(self, c) -> Dict:
        d: Dict = {}
        self._add(d, "scale", (c,), "uniform", 0.8, 1.2)
        self._add(d, "bias", (c,), "normal", 0.0, 0.05)
        self._add(d, "mean", (c,), "normal", 0.0, 0.05)
        self._add(d, "var", (c,), "uniform", 0.8, 1.2)
        return d

    def prelu(self, c) -> Dict:
        d: Dict = {}
        self._add(d, "alpha", (c,), "uniform", 0.15, 0.35)
        return d

    def cbp(self, k, cin, cout, groups=1, prelu=True) -> Dict:
        t = {"conv": self.conv(k, cin, cout, groups), "bn": self.bn(cout)}
        if prelu:
            t["prelu"] = self.prelu(cout)
        return t

    def fill(self, seed: int, device) -> None:
        """Draw every leaf from `seed` on `device`: float32 tensors."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        sizes = {"normal": 0, "uniform": 0}
        for _, _, shape, kind, _, _ in self.leaves:
            sizes[kind] += int(np.prod(shape))
        bufs = {
            "normal": torch.randn(sizes["normal"], generator=gen, device=device),
            "uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
        }
        offs = {"normal": 0, "uniform": 0}
        for d, key, shape, kind, a, b in self.leaves:
            n = int(np.prod(shape))
            raw = bufs[kind][offs[kind]: offs[kind] + n].reshape(shape)
            offs[kind] += n
            d[key] = raw * b + a if kind == "normal" else a + raw * (b - a)


def scrfd_tree(det: Dict, seed: int, device) -> Dict:
    """SCRFD (depthwise-separable variant) tree; head scales 1."""
    dr = _Draw()
    plan = [tuple(p) for p in det["plan"]]
    tree: Dict = {"stem": dr.cbp(3, 3, plan[0][0])}
    blocks, cin = [], plan[0][0]
    for cout, _ in plan[1:]:
        blocks.append({
            "dw": dr.conv(3, cin, cin, groups=cin), "dw_bn": dr.bn(cin),
            "dw_prelu": dr.prelu(cin),
            "pw": dr.conv(1, cin, cout), "pw_bn": dr.bn(cout), "pw_prelu": dr.prelu(cout),
        })
        cin = cout
    tree["backbone"] = blocks
    c3, c4, c5 = sorted({c for c, _ in plan})[-3:]
    nk = det["neck"]
    tree["neck"] = {
        "lat_c3": dr.conv(1, c3, nk), "lat_c4": dr.conv(1, c4, nk), "lat_c5": dr.conv(1, c5, nk),
        "smooth_p3": dr.conv(3, nk, nk), "smooth_p4": dr.conv(3, nk, nk),
        "smooth_p5": dr.conv(3, nk, nk),
    }
    convs, cin = [], nk
    for _ in range(det["stacked"]):
        convs.append(dr.cbp(3, cin, det["head"]))
        cin = det["head"]
    a = det["num_anchors"]
    tree["head"] = {
        "convs": convs,
        "cls": dr.conv(3, det["head"], a * 1, bias=True),
        "bbox": dr.conv(3, det["head"], a * 4, bias=True),
        "kps": dr.conv(3, det["head"], a * 10, bias=True),
    }
    dr.fill(seed, device)
    tree["scales"] = {f"s{s}": torch.ones((), device=device) for s in det["strides"]}
    return tree


def iresnet_tree(rec: Dict, seed: int, device) -> Dict:
    dr = _Draw()
    tree: Dict = {"conv1": dr.conv(3, 3, 64), "bn1": dr.bn(64), "prelu1": dr.prelu(64)}
    inplanes = 64
    for s, (n, planes) in enumerate(zip(rec["blocks"], rec["widths"]), start=1):
        stage = []
        for b in range(n):
            blk = {
                "bn1": dr.bn(inplanes), "conv1": dr.conv(3, inplanes, planes),
                "bn2": dr.bn(planes), "prelu": dr.prelu(planes),
                "conv2": dr.conv(3, planes, planes), "bn3": dr.bn(planes),
            }
            if b == 0 or inplanes != planes:
                blk["down_conv"] = dr.conv(1, inplanes, planes)
                blk["down_bn"] = dr.bn(planes)
            stage.append(blk)
            inplanes = planes
        tree[f"layer{s}"] = stage
    sp = rec["input_size"] // 16
    tree["bn2"] = dr.bn(rec["widths"][-1])
    tree["fc"] = dr.linear(rec["widths"][-1] * sp * sp, rec["feature_dim"])
    tree["features_bn"] = dr.bn(rec["feature_dim"])
    dr.fill(seed, device)
    return tree


def mbf_plan(rec: Dict) -> List[Tuple[int, int, int, int]]:
    """[(cin, cout, expand, stride)] of MobileFaceNet's bottlenecks."""
    b, s = rec["blocks"], rec["scale"]
    c64, c128 = 64 * s, 128 * s
    plan = [(c64, c64, 128, 2)] + [(c64, c64, 128, 1)] * b[1]
    plan += [(c64, c128, 256, 2)] + [(c128, c128, 256, 1)] * b[2]
    plan += [(c128, c128, 512, 2)] + [(c128, c128, 256, 1)] * b[3]
    return plan


def mbf_tree(rec: Dict, seed: int, device) -> Dict:
    dr = _Draw()
    c64 = 64 * rec["scale"]
    c128 = 128 * rec["scale"]
    tree: Dict = {"stem": dr.cbp(3, 3, c64), "stem_dw": dr.cbp(3, c64, c64, groups=64)}
    body = []
    for cin, cout, g, _ in mbf_plan(rec):
        body.append({
            "pw1": dr.conv(1, cin, g), "pw1_bn": dr.bn(g), "pw1_prelu": dr.prelu(g),
            "dw": dr.conv(3, g, g, groups=g), "dw_bn": dr.bn(g), "dw_prelu": dr.prelu(g),
            "pw2": dr.conv(1, g, cout), "pw2_bn": dr.bn(cout),
        })
    tree["body"] = body
    tree["conv_sep"] = dr.cbp(1, c128, 512)
    tree["gdc_dw"] = dr.cbp(rec["input_size"] // 16, 512, 512, groups=512, prelu=False)
    tree["fc"] = dr.linear(512, rec["feature_dim"], bias=False)
    tree["features_bn"] = dr.bn(rec["feature_dim"])
    dr.fill(seed, device)
    return tree


def recognizer_tree(rec: Dict, seed: int, device) -> Dict:
    if rec["kind"] == "iresnet":
        return iresnet_tree(rec, seed, device)
    if rec["kind"] == "mobilefacenet":
        return mbf_tree(rec, seed, device)
    raise ValueError(f"unknown recognizer kind {rec['kind']!r}")


def to_numpy(tree):
    """The same tree with host numpy leaves (the program's loader reads numpy)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
