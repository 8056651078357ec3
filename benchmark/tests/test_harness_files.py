"""The harness is driven by files: BENCHMARK.json agrees with them, a new
configuration, traffic mix, cell, drive or metric is found by its name,
and nothing the harness runs loads JAX or the JAX package."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run as bench
from benchmark import spec

REPO = spec.ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_has_its_files_and_limits():
    for w in BENCH["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["name"] == w["traffic"]
        assert (c["chips"], c["why"]) == (w["chips"], w["why"])
        drive = spec.drive(c["drive"]).Drive
        lim = bench.limits(w["name"])
        assert set(drive.COMPARED) <= set(lim["limits"]), w["name"]
        assert all(lim["limits"][k] is not None for k in drive.COMPARED), w["name"]
        assert set(lim["pairing"]) == {"coord_px", "score"}, w["name"]


def test_every_config_file_is_named_in_the_benchmark():
    for cfg in BENCH["configs"]:
        assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
        assert json.loads((REPO / cfg["file"]).read_text())["source"] == cfg["source"]


def test_every_per_layer_metric_has_a_reader_with_its_unit():
    names = set(spec.metric_names())
    for m in BENCH["per_layer"]:
        assert m["name"] in names
        assert spec.metric(m["name"]).UNIT == m["unit"]
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_each_cell_reports_the_metrics_its_entries_move():
    """A cell's family names its end-to-end metrics; every per-layer metric
    listing the cell moves one of them, and the end-to-end entries list the
    cells that report them."""
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))
           for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        reported = set(bench.end_to_end_names(spec.cell(w["name"]))) | {"setup_s"}
        assert reported == {m for m, cells in e2e.items() if w["name"] in cells}, w["name"]
        for m in BENCH["per_layer"]:
            if w["name"] in m["workloads"]:
                assert m["moves"] in reported, (w["name"], m["name"])


def test_names_and_units_use_the_allowed_characters():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    for d in ("configs", "traffic", "workloads", "drives", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "cfg_x.json").write_text(json.dumps({"name": "cfg_x"}))
    (tmp_path / "traffic" / "mix_y.json").write_text(json.dumps({"name": "mix_y", "batch": 3}))
    (tmp_path / "workloads" / "cell_z.json").write_text(json.dumps(
        {"config": "cfg_x", "traffic": "mix_y", "drive": "drive_w", "chips": 1, "why": "w"}))
    (tmp_path / "drives" / "drive_w.py").write_text("class Drive:\n    kind = 'w'\n")
    (tmp_path / "metrics" / "m.v.py").write_text("UNIT = 'ms'\n\ndef read(s):\n    return 1.5\n")
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    c = spec.cell("cell_z")
    assert c["config"]["name"] == "cfg_x" and c["traffic"]["batch"] == 3
    assert spec.drive(c["drive"]).Drive.kind == "w"
    assert spec.metric_names() == ["m.v"]
    assert spec.metric("m.v").read({}) == 1.5
    with pytest.raises(FileNotFoundError):
        spec.cell("cell_missing")
    with pytest.raises(ValueError):
        spec.cell("../configs/cfg_x")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "facerecognizeonnx_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.sub", object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "facerecognizeonnx_tpu.ops", object())
    assert bench.forbidden_modules() == ["facerecognizeonnx_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import importlib.util, json, torch\n"
        "s = importlib.util.spec_from_file_location('bench_conftest', %r)\n"
        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
        "from benchmark import run\n"
        "torch.set_num_threads(2)\n"
        "run.run('sc_adaptive2', 5, 0.5, True, device='cpu', cell=m.tiny_cell('sc_adaptive2'))\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    ) % str(Path(__file__).parent.parent / "conftest.py")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_read_no_tpu_bench_output():
    for p in spec.ROOT.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "bench_detail" not in text and "BENCH_r" not in text, p
        assert "import facerecognizeonnx_tpu\n" not in text and "from facerecognizeonnx_tpu " not in text
        assert "facerecognizeonnx_tpu_torch.bench" not in text, p


def test_reference_imports_nothing_of_the_program():
    for p in (spec.ROOT / "reference").glob("*.py"):
        assert "facerecognizeonnx_tpu" not in p.read_text(), p


def test_main_without_a_card_exits_nonzero_and_prints_nothing(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("pycache_prefix", "dont_write_bytecode"):  # main sets the run's own
        monkeypatch.setattr(sys, name, getattr(sys, name))
    rc = bench.main(["--workload", "sc_dense8", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
