"""The control of `correct`: the reference in the program's place with
its detector's, or its recognizer's, operands one precision step below
the configuration's bfloat16 (float8 e4m3). Each must come out not
correct under the cell's limits. On the chip the controls run at the
cells' own sizes through `python -m benchmark.calibrate`; here at a size
a test run holds."""

from __future__ import annotations

import pytest

from benchmark import run as bench


@pytest.mark.parametrize("name", ["sc_dense8", "s_dense8", "sc_adaptive2"])
@pytest.mark.parametrize("stage, fails", [("det", "unpaired_slots"), ("rec", "feature_gap")])
def test_control_is_not_correct(name, stage, fails, tiny):
    res = bench.run(name, 11, 0.5, False, device="cpu", cell=tiny(name), control=stage)
    assert res["correct"] is False
    c = res["checks"][fails]
    assert c["value"] > c["limit"], res["checks"]
