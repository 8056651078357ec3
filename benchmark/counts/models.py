"""Model FLOPs of one forward pass, from the configuration's shapes.

Counted as torch.utils.flop_counter counts: 2 per multiply-accumulate
of every convolution and matrix product, nothing for elementwise ops
(BatchNorm, PReLU, adds, upsampling, sigmoid).
"""

from __future__ import annotations

from typing import Dict

from benchmark.weights import mbf_plan


def conv_flops(h_out: int, w_out: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    return 2 * h_out * w_out * cout * (cin // groups) * k * k


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def scrfd_flops(det: Dict, size: int) -> int:
    plan = [tuple(p) for p in det["plan"]]
    s = _out(size, 3, 2, 1)
    total = conv_flops(s, s, 3, plan[0][0], 3)
    cin = plan[0][0]
    sizes = {}
    for cout, stride in plan[1:]:
        s = _out(s, 3, stride, 1)
        total += conv_flops(s, s, cin, cin, 3, groups=cin)  # depthwise
        total += conv_flops(s, s, cin, cout, 1)  # pointwise
        sizes[cout] = s
        cin = cout
    nk, hd, a = det["neck"], det["head"], det["num_anchors"]
    for c in sorted({c for c, _ in plan})[-3:]:
        s = sizes[c]
        total += conv_flops(s, s, c, nk, 1) + conv_flops(s, s, nk, nk, 3)
        c_in = nk
        for _ in range(det["stacked"]):
            total += conv_flops(s, s, c_in, hd, 3)
            c_in = hd
        total += conv_flops(s, s, hd, a * (1 + 4 + 10), 3)
    return total


def iresnet_flops(rec: Dict) -> int:
    s = rec["input_size"]
    total = conv_flops(s, s, 3, 64, 3)
    inplanes = 64
    for n, planes in zip(rec["blocks"], rec["widths"]):
        for b in range(n):
            total += conv_flops(s, s, inplanes, planes, 3)
            s_out = _out(s, 3, 2 if b == 0 else 1, 1)
            total += conv_flops(s_out, s_out, planes, planes, 3)
            if b == 0 or inplanes != planes:
                total += conv_flops(s_out, s_out, inplanes, planes, 1)
            s, inplanes = s_out, planes
    return total + 2 * rec["widths"][-1] * s * s * rec["feature_dim"]


def mbf_flops(rec: Dict) -> int:
    s = _out(rec["input_size"], 3, 2, 1)
    c64, c128 = 64 * rec["scale"], 128 * rec["scale"]
    total = conv_flops(s, s, 3, c64, 3) + conv_flops(s, s, c64, c64, 3, groups=64)
    for cin, cout, g, stride in mbf_plan(rec):
        total += conv_flops(s, s, cin, g, 1)
        s = _out(s, 3, stride, 1)
        total += conv_flops(s, s, g, g, 3, groups=g) + conv_flops(s, s, g, cout, 1)
    total += conv_flops(s, s, c128, 512, 1)
    total += conv_flops(1, 1, 512, 512, s, groups=512)
    return total + 2 * 512 * rec["feature_dim"]


def recognizer_flops(rec: Dict) -> int:
    return iresnet_flops(rec) if rec["kind"] == "iresnet" else mbf_flops(rec)


def match_flops(n_queries: int, n_rows: int, dim: int) -> int:
    return 2 * n_queries * n_rows * dim
