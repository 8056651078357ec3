"""The port's bench mode (facerecognizeonnx_tpu_torch/bench.py) on the CPU.

Held against the root bench.py (the JAX bench) where its side is cheap:
`_emit_final` byte for byte (the JAX function writes its detail file
next to its module, so the test points the module's `__file__` under
tmp_path), `_percentiles`, the config names and the `all` order, and the
keys of the headline runner (JAX's runner with a stub in place of the
fused pipeline, so no JAX program of the pipeline is compiled). The
gallery methods are held against the JAX gallery reference. The run
guards (watchdog re-exec, SIGTERM, the whole-run deadline) run with
stand-in configs. The headline runner runs the port's real step at
128x128 with MobileFaceNet, two synchronized latency steps and no
warm-up steps (the module's MIN_LATENCY_SAMPLES / WARMUP_STEPS).
"""

import ast
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import facerecognizeonnx_tpu.pipeline.fused as jax_fused
from facerecognizeonnx_tpu.ops.pallas_gallery import gallery_topk_reference as jax_topk
from facerecognizeonnx_tpu_torch import bench
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.pipeline import fused

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- output


def _results(case):
    order = list(bench.ORDER)
    detail = {"frames_per_sec": 962.3, "batch": 128, "faces_per_frame": 8,
              "valid_faces_per_frame": 8,
              "batch_step_latency": {"samples": 20, "p50_ms": 132.97, "p90_ms": 134.1,
                                     "p99_ms": 140.2},
              "launches": {"warp_xm": 5, "warp_xm_pyramid": 5, "nms_greedy": 5,
                           "gallery_topk": 0}}
    unit = "faces/sec" if case != "truncated" else "faces per second, " * 8
    results = {
        name: {"metric": f"a metric string for {name}", "value": 1000.5 + i, "unit": unit,
               "vs_baseline": None, "detail": dict(detail)}
        for i, name in enumerate(order)
    }
    results["video"] = {"error": "x" * 500}  # errors truncate to 60 characters
    results["_hbm_gbps"] = 2911.4
    if case == "missing_headline":
        results["headline"] = {"error": "RuntimeError: no card"}
    return results, order


@pytest.mark.parametrize("case", ["normal", "truncated", "missing_headline"])
def test_emit_final_matches_the_jax_bench(case, tmp_path, monkeypatch, capsys):
    results, order = _results(case)
    (tmp_path / "jax").mkdir()
    monkeypatch.setattr(jax_bench, "__file__", str(tmp_path / "jax" / "bench.py"))
    jax_bench._emit_final(json.loads(json.dumps(results)), order)
    want = capsys.readouterr().out
    detail = tmp_path / "bench_detail.json"
    bench._emit_final(results, order, str(detail))
    got = capsys.readouterr().out
    assert got == want
    full, compact = got.strip().splitlines()
    assert len(compact) <= 1900
    assert json.loads(detail.read_text()) == json.loads(full)
    assert detail.read_text() == (tmp_path / "jax" / "bench_detail.json").read_text()
    doc = json.loads(compact)
    if case == "truncated":
        assert doc["detail"]["configs"] == "truncated, see bench_detail.json"
    else:
        assert len(doc["detail"]["configs"]["video"]["error"]) == 60
    if case == "missing_headline":
        assert doc["value"] == 0.0 and json.loads(full)["detail"]["error"].startswith("Runtime")


def test_emit_final_carries_the_probes_and_the_card(tmp_path, capsys):
    results, order = _results("normal")
    results["_h2d_mbps"] = 9876.5
    results["_card"] = {"name": "a card", "nvidia_smi": "a card, 700.00 W"}
    bench._emit_final(results, order, str(tmp_path / "d.json"))
    full, compact = (json.loads(line) for line in capsys.readouterr().out.splitlines())
    for doc in (full, compact):
        assert doc["detail"]["hbm_read_gbps"] == 2911.4
        assert doc["detail"]["h2d_mbytes_per_sec"] == 9876.5
        assert doc["detail"]["card"]["nvidia_smi"] == "a card, 700.00 W"
    assert compact["detail"]["detail_file"] == "d.json"


@pytest.mark.parametrize("n", [1, 20, 333])
def test_percentiles_match_the_jax_bench(n):
    samples = np.random.default_rng(n).gamma(2.0, 0.01, n).tolist()
    assert bench._percentiles(samples) == jax_bench._percentiles(samples)


def _jax_bench_lists():
    """The `--config` choices and the `all` order of the root bench.py."""
    tree = ast.parse((REPO / "bench.py").read_text())
    choices = order = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument" \
                and node.args and getattr(node.args[0], "value", None) == "--config":
            choices = next(ast.literal_eval(k.value) for k in node.keywords if k.arg == "choices")
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "order":
            order = ast.literal_eval(node.value)
    return choices, order


def test_configs_and_order_match_the_jax_bench():
    choices, order = _jax_bench_lists()
    assert sorted(bench.CONFIGS + ("all", "selftest")) == sorted(choices)
    assert list(bench.ORDER) == order
    assert bench._parser().get_default("config") == "all"


# ---------------------------------------------------------------- run guards


def _bench_proc(tmp_path, extra_env, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO), **extra_env)
    return subprocess.run(
        [sys.executable, "-m", "facerecognizeonnx_tpu_torch.bench", "--config", "selftest",
         *args], capture_output=True, text=True, timeout=60, env=env, cwd=tmp_path,
    )


@pytest.mark.parametrize("hang", [False, True])
def test_selftest_passes_and_reexecs_past_a_hung_config(hang, tmp_path):
    env = {"FRT_BENCH_TEST_HANG": "1", "FRT_BENCH_CONFIG_DEADLINE_S": "1"} if hang else {}
    p = _bench_proc(tmp_path, env)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1  # only the line of record reaches stdout
    doc = json.loads(lines[0])
    assert doc["metric"] == "bench watchdog selftest"
    assert doc["detail"] == ({"attempt": 1, "reexecs": 1} if hang
                             else {"attempt": 0, "reexecs": 0})
    assert ("WATCHDOG" in p.stderr) is hang


def test_watchdog_emits_partial_results_when_its_budget_is_spent(tmp_path):
    p = _bench_proc(tmp_path, {"FRT_BENCH_TEST_HANG": "1", "FRT_BENCH_CONFIG_DEADLINE_S": "1",
                               "FRT_BENCH_MAX_REEXECS": "0"}, "--detail", "out.json")
    assert p.returncode == 0, p.stderr
    full, compact = (json.loads(line) for line in p.stdout.strip().splitlines())
    assert compact["value"] == 0.0
    assert "timed out" in compact["detail"]["configs"]["selftest"]["error"]
    assert json.loads((tmp_path / "out.json").read_text()) == full


def _stand_in(value):
    return {"metric": "m", "value": value, "unit": "faces/sec", "vs_baseline": None,
            "detail": {}}


def test_sigterm_emits_the_configs_already_done(tmp_path):
    code = f"""
import sys, time
from facerecognizeonnx_tpu_torch import bench

def hang():
    print("HANGING", file=sys.stderr, flush=True)
    time.sleep(600)

runners = {{"headline": lambda: {_stand_in(5.0)!r}, "headline_mbf": hang,
            "gallery": lambda: {_stand_in(7.0)!r}}}
state = {{"results": {{}}, "attempts": {{}}, "reexecs": 0}}
with bench._stdout_to_stderr():
    print("a stray line", flush=True)
    bench.run_configs(["headline", "headline_mbf", "gallery"], runners, state,
                      {str(tmp_path / 's.json')!r}, [], {str(tmp_path / 'd.json')!r},
                      lambda *a: print(*a, file=sys.stderr, flush=True))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
    killer = threading.Timer(60, proc.kill)
    killer.start()
    try:
        while "HANGING" not in proc.stderr.readline():
            assert proc.poll() is None, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        killer.cancel()
    assert proc.returncode == 0, err
    lines = out.strip().splitlines()
    assert len(lines) == 2, lines  # the stray print went to stderr
    doc = json.loads(lines[-1])
    assert doc["value"] == 5.0
    assert doc["detail"]["configs"] == {
        "headline_mbf": {"error": "terminated by SIGTERM before it finished"}}
    assert json.loads((tmp_path / "d.json").read_text()) == json.loads(lines[0])


def _guard_run(tmp_path, runners, order, **kw):
    state = {"results": {}, "attempts": {}, "reexecs": 0}
    return bench.run_configs(order, runners, state, str(tmp_path / "s.json"), [],
                             str(tmp_path / "d.json"), lambda *a: None, **kw)


def test_whole_run_deadline_stops_before_the_next_config(tmp_path, capsys):
    calls = []

    def slow():
        calls.append("headline")
        time.sleep(0.5)
        return _stand_in(3.0)

    def never():
        calls.append("after the deadline")
        return _stand_in(1.0)

    results = _guard_run(tmp_path, {"headline": slow, "gallery": never, "video": never},
                         ["headline", "gallery", "video"], total_deadline_s=0.25)
    assert calls == ["headline"]
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["value"] == 3.0
    for name in ("gallery", "video"):
        assert "whole-run deadline" in results[name]["error"]
        assert "whole-run deadline" in doc["detail"]["configs"][name]["error"]


def test_a_config_that_raises_fails_alone(tmp_path, capsys):
    def boom():
        raise RuntimeError("gallery_topk launch failed")

    _guard_run(tmp_path, {"headline": lambda: _stand_in(3.0), "gallery": boom,
                          "video": lambda: _stand_in(2.0)}, ["headline", "gallery", "video"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["detail"]["configs"]["gallery"] == {
        "error": "RuntimeError: gallery_topk launch failed"}
    assert doc["detail"]["configs"]["video"]["value"] == 2.0


def test_without_cuda_and_without_cpu_the_bench_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main(["--config", "gallery"])


def test_probes_on_the_cpu():
    rate = bench._probe_hbm_gbps(lambda *a: None, CPU)
    assert np.isfinite(rate) and rate > 0
    assert bench._probe_h2d_rate_mbps(lambda *a: None, CPU) is None


# ---------------------------------------------------------------- runners


@pytest.fixture(scope="module")
def small():
    """The bench's seeded SCRFD-500m and MobileFaceNet (folded) at 128x128."""
    cfg = PipelineConfig(det_input_size=128, compute_dtype="bfloat16", warp_impl="cuda",
                         skip_invalid_faces=False)
    return cfg, bench._detector(CPU), bench._mbf(CPU)


def _jax_headline(monkeypatch, valid_cap):
    """The JAX runner's result at batch 1, iters 1, the fused pipeline
    replaced by a stub that gives zero features."""
    def stub(det, arc, frames, cfg, max_faces_embed=8, valid_cap=None):
        return None, jnp.zeros((frames.shape[0], max_faces_embed, 4), jnp.float32)

    monkeypatch.setattr(jax_fused, "frames_to_features", stub)
    return jax_bench.bench_headline(SimpleNamespace(batch=1, iters=1), None, None, None,
                                    lambda *a: None, valid_cap=valid_cap)


@pytest.mark.parametrize("name, faces", [("headline", 8), ("headline_occ", 2)])
def test_headline_runner(name, faces, small, monkeypatch):
    """The runner's keys are the JAX runner's (plus `launches`); its
    step is frames_to_features on the seeded frames, K=8, all slots
    embedded for the headline and exactly 2 for headline_occ."""
    cfg, det, rec = small
    monkeypatch.setattr(bench, "MIN_LATENCY_SAMPLES", 2)
    monkeypatch.setattr(bench, "WARMUP_STEPS", 0)
    seen = []
    real = fused.frames_to_features

    def recording(*a, **kw):
        out = real(*a, **kw)
        seen.append((a[3], kw, out[1]))
        return out

    monkeypatch.setattr(fused, "frames_to_features", recording)
    args = SimpleNamespace(device=CPU, batch=1, iters=1)
    out = bench._runners(args, cfg, det, rec, lambda *a: None)[name]()
    want = _jax_headline(monkeypatch, None if name == "headline" else 2)
    assert set(out) == set(want) and set(out["detail"]) == set(want["detail"]) | {"launches"}
    assert set(out["detail"]["batch_step_latency"]) == set(want["detail"]["batch_step_latency"])
    assert out["vs_baseline"] is None
    assert out["detail"]["valid_faces_per_frame"] == faces
    assert abs(out["value"] - out["detail"]["frames_per_sec"] * faces) <= 0.05 * faces + 0.05
    assert out["detail"]["launches"] == {k: 0 for k in bench._kernels()}  # plain versions
    assert len(seen) == 1 + 1 + 2  # first run, iters, latency samples

    step_cfg, kw, feats = seen[-1]
    assert step_cfg.skip_invalid_faces is (name == "headline_occ")
    assert kw == {"max_faces_embed": 8, "valid_cap": None if name == "headline" else 2}
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 128, 128, 3), dtype=np.uint8))
    with torch.no_grad():
        _, direct = real(det, rec, frames, step_cfg, 8, valid_cap=kw["valid_cap"])
    assert torch.equal(feats, direct)
    assert ((feats.abs().sum(-1) > 0).sum(-1) == faces).all()


@pytest.mark.parametrize("method", ["dense", "bf16_at_rest", "tiled512", "gallery_topk_cuda"])
def test_gallery_methods_match_the_jax_reference(method):
    g = np.random.default_rng(0).normal(size=(2048, 512)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[:128]
    methods = bench.gallery_methods(torch.from_numpy(g), 5)
    assert list(methods) == ["dense", "bf16_at_rest", "tiled512", "gallery_topk_cuda"]
    s, i = methods[method](torch.from_numpy(q))
    storage = jnp.bfloat16 if method == "bf16_at_rest" else None
    js, ji = jax_topk(jnp.asarray(q), jnp.asarray(g), 5, storage_dtype=storage)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
