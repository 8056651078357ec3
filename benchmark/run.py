"""Runs one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (weights and inputs from the seed, the program's
models, warm-up of the cell's own shapes), a measured window of
`--seconds`, then the comparison with the plain reference that decides
`correct`. The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device (and with --trace 1 the
breakdown), then `checks`, each compared number beside its limit, also
printed as the last lines of standard error. With --trace 0 the metrics
are the cell's end-to-end ones, with --trace 1 its per-layer ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "facerecognizeonnx_tpu")
LIMITS_DIR = Path(__file__).resolve().parent / "limits"
# Bytecode of every module a run imports, cached at a fixed path inside the
# checkout and written there even where the environment asks Python to write
# none: the chip machine's site-packages hold none for the modules torch
# imports lazily on its first operations, and compiling them again in every
# process (about 5 s of the first batch) made set-up long and uneven.
PYCACHE_DIR = Path(__file__).resolve().parent.parent / ".bench_pycache"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def limits(cell_name: str) -> dict:
    """The cell's limits file: {"limits": {number: limit}, "pairing": {...}}."""
    return json.loads((LIMITS_DIR / f"{cell_name}.json").read_text())


def end_to_end_names(cell: dict) -> tuple:
    """The cell's throughput and tail metrics: a family other than "dense"
    reports them under its own suffix, so that it is held to bounds of its
    own."""
    family = cell["family"]
    sfx = "" if family == "dense" else f".{family}"
    return f"frames_per_s{sfx}", f"batch_ms_p95{sfx}"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(result: dict) -> str:
    """The result as one line of strict JSON: a number that is not finite
    (no served slot to compare) prints as null."""
    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, list):
            return [clean(x) for x in v]
        return v

    return json.dumps(clean(result), allow_nan=False)


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Window:
    """The measured loop: keeps `in_flight` batches dispatched, resolves
    the oldest, and times each batch from its dispatch to its identities
    on the host."""

    def __init__(self, drive, in_flight: int):
        self.drive, self.in_flight = drive, in_flight
        self.pending = collections.deque()
        self.latency_s, self.dispatch_s, self.resolved, self.i = [], [], 0, 0
        self.seg = None  # the tracer's layer ranges while tracing

    def _span(self, name):
        import torch

        if self.seg is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def dispatch(self) -> None:
        t0 = time.perf_counter()
        with self._span("dispatch"):
            h = self.drive.dispatch(self.i)
            if self.seg is not None:
                self.seg.close()
        t1 = time.perf_counter()
        self.pending.append((self.i, t0, h))
        self.dispatch_s.append((self.i, t1 - t0))
        self.i += 1

    def resolve_one(self):
        i, t0, h = self.pending.popleft()
        with self._span("resolve"):
            self.resolved += self.drive.resolve(h)
            if self.seg is not None:
                self.seg.close()
        self.latency_s.append(time.perf_counter() - t0)
        return i, h

    def fill(self) -> None:
        while len(self.pending) < self.in_flight:
            self.dispatch()

    def drain(self) -> None:
        while self.pending:
            self.resolve_one()


def run(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
        cell=None, control=None, readings=None) -> dict:
    """One run; returns the result dict (its `checks` last). `cell` and
    `device` let the CPU tests drive a small cell; `control` puts the
    reference in the program's place, its detector's operands ("det") or
    its recognizer's ("rec") one precision step lower (float8 e4m3):
    no window, only the comparison. `readings`, where given, receives
    every number the judge read, the compared ones and those beside them."""
    import torch

    from benchmark import spec
    from benchmark import trace as tracing
    from benchmark.reference import nets

    cell = spec.cell(cell_name) if cell is None else cell
    drive = spec.drive(cell["drive"]).Drive(cell, seed, device, log)
    traffic = cell["traffic"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
    log(f"set-up: torch and the device ready at {time.perf_counter() - T_START:.2f} s")
    drive.setup()

    win = Window(drive, traffic["in_flight"])
    if control is None:
        for _ in range(traffic["warmup_batches"]):  # the cell's own shapes, nothing else
            win.fill()
            win.resolve_one()
            log(f"set-up: warm-up batch at {time.perf_counter() - T_START:.2f} s")
        win.drain()
    if on_card:
        torch.cuda.synchronize()
    log(f"set-up: warm-up done at {time.perf_counter() - T_START:.2f} s from the start")
    drive.reset_counters()
    drive.kept.clear()
    win = Window(drive, traffic["in_flight"])

    setup_s = time.perf_counter() - T_START
    prof = summary = None
    traced = {}
    last_kept = max(drive.keep_at)
    t0 = time.perf_counter()
    end = t0 + seconds
    while control is None and (time.perf_counter() < end or win.i <= last_kept):
        if trace and prof is None and win.i >= traffic["trace_after"]:
            win.drain()
            prof, seg, t_prof = tracing.start(drive.modules())
            win.seg, n0 = seg, win.i
        win.fill()
        if win.seg is not None:
            traced.update({i: h for i, _, h in win.pending if i not in traced})
        win.resolve_one()
        if win.seg is not None and win.i >= n0 + traffic["trace_batches"]:
            win.drain()
            window_s = tracing.stop(prof, seg, t_prof)
            win.seg = None
    if win.seg is not None:  # the window ended inside the traced part
        win.drain()
        window_s = tracing.stop(prof, seg, t_prof)
        win.seg = None
    win.drain()
    t_end = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        raise SystemExit(3)

    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
    result = {"correct": False, "attempted": win.i, "failed": 0, "metrics": {}}
    if not trace and control is None:
        fps, p95 = end_to_end_names(cell)
        result["metrics"] = {
            fps: {"value": win.resolved / (t_end - t0), "unit": "frames/s"},
            p95: {"value": percentile(win.latency_s, 95) * 1e3, "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    if prof is not None:
        summary = tracing.summarise(prof)
        log(f"trace: {summary['n_device_ops']} device ops, layers {summary['layers_s']}")
        flops, kern = 0.0, {}
        for h in traced.values():
            w = drive.work(drive.detections(h))
            flops += w["model_flops"]
            for k, v in w["kernels"].items():
                acc = kern.setdefault(k, {"bytes": 0.0, "flops": 0.0})
                acc["bytes"] += v["bytes"]
                acc["flops"] += v["flops"]
        summary.update({
            "kind": drive.kind, "family": cell["family"],
            "precision": cell["config"]["compute"], "window_s": window_s,
            "batches": len(traced), "work": {"model_flops": flops, "kernels": kern},
            "host": {"dispatch_s": [d for i, d in win.dispatch_s if i not in traced]},
            "counters": dict(drive.counters(), window_batches=win.i),
        })
        for name in spec.metric_names():
            reader = spec.metric(name)
            v = reader.read(summary)
            if v is not None:
                result["metrics"][name] = {"value": v, "unit": reader.UNIT}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(mem_peak),
        "power": power_limit() if on_card else "none",
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}

    # ---- correct: the kept outputs against the plain reference
    if control is None:
        drive.keep_last()
    kept = dict(drive.kept)
    drive.free_program()
    if on_card:
        torch.cuda.empty_cache()
    if control is not None:
        precs = {"det": (nets.FP8, nets.BF16), "rec": (nets.BF16, nets.FP8)}[control]
        kept = drive.control(*precs, sorted(drive.keep_at))
    lim = limits(cell["name"])
    numbers = drive.judge(kept, lim["pairing"])
    if readings is not None:
        readings.update(numbers)
    checks = {k: {"value": numbers[k], "limit": lim["limits"].get(k)} for k in drive.COMPARED}
    result["correct"] = bool(kept) and all(
        checks[k]["limit"] is not None and checks[k]["value"] <= checks[k]["limit"]
        for k in drive.COMPARED)  # a NaN compares False: not correct
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.pycache_prefix, sys.dont_write_bytecode = str(PYCACHE_DIR), False

    import torch

    from benchmark import spec

    torch.set_num_threads(1)  # one process, few threads: the host work is launches
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"cell {args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    checks = result["checks"]
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
