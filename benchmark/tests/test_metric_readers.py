"""The per-layer readers on a hand-made traced summary: what each reads,
and None where a cell has nothing for it."""

from __future__ import annotations

import pytest

from benchmark import spec
from benchmark.counts import peaks


def _summary(**over):
    s = {
        "kind": "identify", "family": "dense", "precision": "bfloat16", "window_s": 0.5, "busy_s": 0.4,
        "batches": 4,
        "layers_s": {"detect": 0.06, "detect_post": 0.01, "embed": 0.2, "match": 0.03},
        "ops": {
            "warp_xm_kernel(unsigned char const*)": {"s": 0.002, "calls": 4, "layer": "detect_post"},
            "pyramid_kernel(unsigned char const*)": {"s": 0.001, "calls": 4, "layer": "detect_post"},
            "nms_greedy_kernel(float const*)": {"s": 0.0004, "calls": 4, "layer": "detect_post"},
        },
        "work": {"model_flops": 2e13, "kernels": {
            "warp_xm": {"bytes": 3.35e9, "flops": 0.0},
            "warp_xm_pyramid": {"bytes": 1.675e9, "flops": 0.0},
            "nms_greedy": {"bytes": 3.35e6, "flops": 0.0}}},
        "host": {"dispatch_s": [0.01, 0.03]},
        "counters": {"steps": 200, "corrections": 1},
    }
    s.update(over)
    return s


def read(name, s):
    return spec.metric(name).read(s)


def test_layer_times_per_batch():
    s = _summary()
    assert read("detect_ms", s) == pytest.approx((0.07 - 0.003) / 4 * 1e3)
    assert read("embed_ms", s) == pytest.approx(50.0)
    assert read("dispatch_ms", s) == pytest.approx(20.0)


def test_shares():
    s = _summary()
    assert read("warp_xm_roofline", s) == pytest.approx(50.0)  # 1 ms of bytes in 2 ms
    assert read("warp_xm_pyramid_roofline", s) == pytest.approx(50.0)
    assert read("nms_greedy_roofline", s) == pytest.approx(0.25)
    assert read("device_idle.identify", s) == pytest.approx(20.0)
    assert read("mfu.identify", s) == pytest.approx(100.0 * 2e13 / (0.5 * peaks.FLOPS["bfloat16"]))
    assert read("bucket_corrections", s) == pytest.approx(5.0)


def test_a_family_reads_only_its_own_cells():
    dense, bucketed = _summary(), _summary(family="bucketed")
    for name in ("detect_ms", "embed_ms", "dispatch_ms", "device_idle", "mfu"):
        plain = {"device_idle": "device_idle.identify", "mfu": "mfu.identify"}.get(name, name)
        assert read(f"{name}.bucketed", bucketed) == pytest.approx(read(plain, dense)), name
        assert read(f"{name}.bucketed", dense) is None, name
        assert read(plain, bucketed) is None, name
    for name in ("warp_xm_roofline", "warp_xm_pyramid_roofline", "nms_greedy_roofline"):
        assert read(name, bucketed) is None, name


def test_nothing_to_read_gives_none():
    s = _summary(ops={}, counters={}, layers_s={}, host={})
    for name in ("detect_ms", "embed_ms", "warp_xm_roofline", "nms_greedy_roofline",
                 "bucket_corrections", "dispatch_ms"):
        assert read(name, s) is None, name
    other = _summary(kind="train")
    for name in ("detect_ms", "device_idle.identify", "mfu.identify"):
        assert read(name, other) is None, name
