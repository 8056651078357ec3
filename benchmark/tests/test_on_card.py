"""Every cell of BENCHMARK.json, run on the card as the driver runs it:
a short window, then `correct` true and the contract's keys. Marked
`card`; run on the chip machine with `python -m pytest benchmark -m card`."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in json.loads((spec.ROOT.parent / "BENCHMARK.json").read_text())[
    "workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name, "--seed", str(2**31 + 5),
         "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
