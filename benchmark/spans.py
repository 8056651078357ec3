"""The program's own spans in a traced run: where the device's time and
its idle gaps fall among the port's `frt.` ranges
(`facerecognizeonnx_tpu_torch/utils/observability.py`).

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s> [--out FILE]

makes one `--trace 1` run of the cell as `benchmark.run` does, with the
`program` key added to the traced summary (`benchmark.run` leaves it
out). The result line is `benchmark.run`'s; the `program` breakdown per
traced batch follows on standard error and, with --out, as one JSON line
in FILE.

`program`, from the profiler's raw events by the rules of `trace.py`:

- `device_s`: each device operation's time, credited to the innermost
  `frt.` range open when its launching op started, or to "none";
- `gaps_s`: each idle gap of the device, credited to the innermost
  `frt.` range open on the host when the device went idle, or "none";
- `spans`: `host_s` and `calls` of each span, from the profiler's ranges;
- `counters`: the program's counters (its tracer's `snapshot()`) at the
  end of the traced window.

The program's ranges are function-scope records that the profiler keeps
on the host's timeline only; a range mirrored onto the device's timeline
would still be left out of the device operations here.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, Iterable, Optional

PREFIX = "frt."


def program_snapshot() -> Optional[Dict]:
    """The program's tracer tallies (`{"spans": ..., "counters": ...}`),
    or None where the program has no tracer to read."""
    try:
        from facerecognizeonnx_tpu_torch.utils import observability
    except ImportError:
        return None
    snap = getattr(observability, "snapshot", None)
    return None if snap is None else snap()


def program_summary(events: Iterable, counters: Optional[Dict[str, int]] = None) -> Dict:
    """The `program` key from the profiler's raw events (objects with the
    kineto event methods: name, device_type, start_ns, end_ns,
    correlation_id, linked_correlation_id)."""
    import torch

    from benchmark import trace as tracing

    cpu = torch.autograd.DeviceType.CPU
    spans, ops, device = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            if name.startswith(PREFIX):
                spans.append((e.start_ns(), e.end_ns(), name[len(PREFIX):]))
            elif not tracing._is_runtime(name) and not name.startswith(("layer.", "bench.")):
                ops[e.correlation_id()] = e.start_ns()
        elif tracing._is_device_op(name) and not name.startswith(PREFIX):
            device.append((e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    spans.sort()
    device_s = collections.Counter()
    for a, b, corr in device:
        launched = ops.get(corr)
        owner = tracing._containing(spans, launched) if launched is not None else None
        device_s[owner or "none"] += (b - a) * 1e-9
    busy = tracing._union([(a, b) for a, b, _ in device])
    gaps_s = collections.Counter()
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        gaps_s[tracing._containing(spans, b0) or "none"] += (a1 - b0) * 1e-9
    host: Dict[str, Dict] = {}
    for a, b, name in spans:
        h = host.setdefault(name, {"host_s": 0.0, "calls": 0})
        h["host_s"] += (b - a) * 1e-9
        h["calls"] += 1
    return {"device_s": dict(device_s), "gaps_s": dict(gaps_s), "spans": host,
            "counters": counters or {}}


def per_batch_ms(program: Dict, batches: int) -> Dict:
    """The breakdown in ms per traced batch (calls per batch for spans)."""
    n = max(1, batches)
    return {
        "device_ms": {k: 1e3 * v / n for k, v in sorted(program["device_s"].items())},
        "gap_ms": {k: 1e3 * v / n for k, v in sorted(program["gaps_s"].items())},
        "host_ms": {k: 1e3 * v["host_s"] / n for k, v in sorted(program["spans"].items())},
        "calls": {k: v["calls"] / n for k, v in sorted(program["spans"].items())},
        "counters": {k: v / n for k, v in sorted(program["counters"].items())},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="append the breakdown as one JSON line here")
    args = p.parse_args(argv)

    from benchmark import run as bench
    from benchmark import trace as tracing

    plain, traced = tracing.summarise, []

    def summarise(prof):
        s = plain(prof)
        snap = program_snapshot()
        s["program"] = program_summary(prof.profiler.kineto_results.events(),
                                       None if snap is None else snap["counters"])
        traced.append(s)
        return s

    tracing.summarise = summarise
    try:
        rc = bench.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        tracing.summarise = plain
    if rc or not traced:
        return rc or 1
    s = traced[0]
    line = dict(per_batch_ms(s["program"], s["batches"]), workload=args.workload,
                seed=args.seed, batches=s["batches"], busy_s=s["busy_s"],
                window_s=s["window_s"], layers_s=s["layers_s"], idle_gaps=s["idle_gaps"])
    text = json.dumps(line)
    bench.log(f"program: {text}")
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
