"""The work counts of benchmark/counts against hand counts and against
torch.utils.flop_counter on the plain reference nets, at small shapes."""

from __future__ import annotations

import copy
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec, weights
from benchmark.counts import kernels, models, peaks
from benchmark.reference import nets


def _cfg(name):
    return json.loads((spec.ROOT / "configs" / f"{name}.json").read_text())


def test_conv_flops_by_hand():
    # 3x3 conv, 4 -> 8 channels, 5x5 output: 2 * 25 * 8 * 4 * 9
    assert models.conv_flops(5, 5, 4, 8, 3) == 2 * 25 * 8 * 4 * 9
    # depthwise: one input channel per output channel
    assert models.conv_flops(5, 5, 8, 8, 3, groups=8) == 2 * 25 * 8 * 9


def test_published_sizes():
    sc, s = _cfg("buffalo_sc"), _cfg("buffalo_s")
    assert round(models.scrfd_flops(sc["detector"], 640) / 1e9, 2) == 2.90
    assert round(models.recognizer_flops(sc["recognizer"]) / 1e9, 2) == 12.62
    assert round(models.recognizer_flops(s["recognizer"]) / 1e9, 3) == 0.875


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_counts_match_the_flop_counter_on_the_reference_nets():
    det = _cfg("buffalo_sc")["detector"]
    tree = weights.scrfd_tree(det, 1, "cpu")
    x = torch.zeros(1, 64, 64, 3)
    assert _counted(lambda: nets.scrfd(tree, x, nets.BF16, det["plan"], "cpu")) == \
        models.scrfd_flops(det, 64)
    for name in ("buffalo_sc", "buffalo_s"):
        rec = copy.deepcopy(_cfg(name)["recognizer"])
        if rec["kind"] == "iresnet":
            rec["blocks"] = [1, 2, 1, 1]
        tree = weights.recognizer_tree(rec, 2, "cpu")
        x = torch.zeros(1, 112, 112, 3)
        if rec["kind"] == "iresnet":
            run = lambda: nets.iresnet(tree, x, nets.BF16, "cpu")  # noqa: E731
        else:
            plan = weights.mbf_plan(rec)
            run = lambda: nets.mobilefacenet(tree, x, nets.BF16, plan, "cpu")  # noqa: E731
        assert _counted(run) == models.recognizer_flops(rec), name


def test_kernel_bytes_by_hand():
    # levels 1-3 of a 64x32 frame: 3 * (32*16 + 16*8 + 8*4) bytes, frame read once
    assert kernels.pyramid_bytes(2, 64, 32) == 2 * (64 * 32 * 3 + 3 * (512 + 128 + 32))
    assert kernels.nms_bytes(4, 512) == 4 * 512 * 18
    # dst = src / 0.9: read at level 0, the crop covers (112 * 0.9)^2 source pixels
    Ms = torch.tensor([[[[1 / 0.9, 0.0, -10.0], [0.0, 1 / 0.9, -20.0]]]])
    valid = torch.tensor([[True]])
    n_out = 112 * 112 * 3 * 2 + 9 * 4 + 6 * 4 + 1
    got = kernels.warp_xm_bytes(Ms, valid, 640, 640)
    assert abs(got - (3 * (112 * 0.9) ** 2 + n_out)) < 1e-3 * got
    # an invalid slot reads nothing but is still written
    assert kernels.warp_xm_bytes(Ms, ~valid, 640, 640) == n_out
    # dst = src / 4: level 3 (8x down), so (112 * 4 / 8)^2 pixels of that level
    big = torch.tensor([[[[0.25, 0.0, 0.0], [0.0, 0.25, 0.0]]]])
    assert kernels.warp_xm_bytes(big, valid, 640, 640) == 3 * 56 * 56 + n_out


def test_roofline_takes_the_larger_bound():
    assert peaks.roofline_s(0, 3.35e12) == 1.0
    assert peaks.roofline_s(989e12, 1.0) == 1.0
