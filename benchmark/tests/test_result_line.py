"""A run's result: exactly the keys the contract reads, `checks` last,
the end-to-end metrics with --trace 0 and per-layer ones with --trace 1,
and `correct` true where the program agrees with the reference (tiny
cells on the CPU, where the program takes its kernels' plain versions)."""

from __future__ import annotations

import json
import math

import pytest

from benchmark import run as bench

BASE = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["sc_dense8", "s_dense8", "sc_adaptive2"])
def test_untraced_line(name, tiny):
    res = bench.run(name, 2**31 + 17, 0.5, False, device="cpu", cell=tiny(name))
    assert list(res) == BASE + ["checks"]
    assert set(res["metrics"]) == set(bench.end_to_end_names(tiny(name))) | {"setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    json.loads(bench.result_line(res))


def test_traced_line(tiny):
    res = bench.run("sc_adaptive2", 3, 3.0, True, device="cpu", cell=tiny("sc_adaptive2"))
    assert list(res) == BASE + ["breakdown", "checks"]
    assert not any(m.startswith("frames_per_s") for m in res["metrics"])
    assert res["metrics"]["bucket_corrections"]["value"] == 0.0
    # the CPU has no device trace: only the readers of the window and the host
    assert {"mfu.bucketed", "dispatch_ms.bucketed"} <= set(res["metrics"])
    assert "mfu.identify" not in res["metrics"] and "dispatch_ms" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_number_that_is_not_finite_prints_as_null_and_is_not_correct():
    res = {"correct": False, "checks": {"feature_gap": {"value": math.inf, "limit": 1e-3}}}
    line = json.loads(bench.result_line(res))
    assert line["checks"]["feature_gap"]["value"] is None
