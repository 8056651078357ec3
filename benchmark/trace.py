"""The traced part of a `--trace 1` run: a bounded run of steady batches
under `torch.profiler`, summarised in memory (no trace file).

Layer ranges come from the benchmark's own hooks: a forward pre-hook on
the program's detector opens "detect", its post-hook opens
"detect_post" (decode, top-k, NMS, align, warp, compaction), the
recognizer's pre-hook opens "embed" and its post-hook "match"; the
harness closes the open range when a dispatch or a resolve returns.
Each range is a `record_function` span, so the profiler records it on
the host clock. A device operation belongs to the range that was open
when the host op that launched it started (the profiler links each
device event to its launching op by correlation id). Device time is
also summed per device symbol (`ops`), where a metric finds a
hand-written kernel by its own name.

Busy time is the union of device intervals (kernels, copies, sets),
never their sum.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Tuple

import torch

class Segments:
    """The layer range open on the host, switched by the hooks."""

    def __init__(self):
        self.cur = None
        self.handles = []

    def open(self, name: str) -> None:
        self.close()
        self.cur = torch.profiler.record_function(f"layer.{name}")
        self.cur.__enter__()

    def close(self) -> None:
        if self.cur is not None:
            self.cur.__exit__(None, None, None)
            self.cur = None

    def hook(self, modules: Dict[str, torch.nn.Module]) -> None:
        det, rec = modules["detect"], modules["embed"]
        self.handles = [
            det.register_forward_pre_hook(lambda *_: self.open("detect")),
            det.register_forward_hook(lambda *_: self.open("detect_post")),
            rec.register_forward_pre_hook(lambda *_: self.open("embed")),
            rec.register_forward_hook(lambda *_: self.open("match")),
        ]

    def unhook(self) -> None:
        self.close()
        for h in self.handles:
            h.remove()
        self.handles = []


def start(modules):
    seg = Segments()
    seg.hook(modules)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof, seg, time.perf_counter()


def stop(prof, seg, t0: float) -> float:
    """Waits for the device, stops the profiler; returns the window's
    host seconds."""
    seg.unhook()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    return window


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _containing(ranges, t):
    """The innermost (latest-starting) range holding time t, or None."""
    best = None
    for a, b, name in ranges:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, b, name)
    return None if best is None else best[2]


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call recorded on the host (cudaLaunchKernel,
    cuLaunchKernel, ...): not an op that launches on its own."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _is_device_op(name: str) -> bool:
    """A kernel, copy or set on the device; not a range mirrored onto the
    device's timeline (the benchmark's own `layer.` and `bench.` ranges)
    nor a synchronization record."""
    if name.startswith(("layer.", "bench.")):
        return False
    return "Sync" not in name and not name.startswith("Stream Wait")


def summarise(prof) -> Dict:
    """Device time per layer range and per device symbol (with the range
    it was launched in), busy and idle, and the breakdown lists, from the
    profiler's raw events."""
    evs = prof.profiler.kineto_results.events()
    ops: Dict[int, int] = {}
    layer_ranges, host_ranges = [], []
    device = []
    for e in evs:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith("layer."):
                layer_ranges.append((e.start_ns(), e.end_ns(), name[6:]))
            elif name.startswith("bench."):
                host_ranges.append((e.start_ns(), e.end_ns(), name[6:]))
            elif not _is_runtime(name):
                ops[e.correlation_id()] = e.start_ns()
        elif _is_device_op(name):
            device.append((name, e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    layer_ranges.sort()
    layers = collections.Counter()
    by_name: Dict[str, Dict] = {}
    for name, a, b, corr in device:
        dur = (b - a) * 1e-9
        launched = ops.get(corr)
        layer = _containing(layer_ranges, launched) if launched is not None else None
        layers[layer or "other"] += dur
        k = by_name.setdefault(name, {"s": 0.0, "calls": 0, "layer": layer or "other"})
        k["s"] += dur
        k["calls"] += 1
    busy = _union([(a, b) for _, a, b, _ in device])
    gaps = collections.Counter()
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        host = _containing(host_ranges, b0) or "between"
        layer = _containing(layer_ranges, b0)
        gaps[host if layer is None else f"{host}/{layer}"] += (a1 - b0) * 1e-9
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "layers_s": dict(layers),
        "ops": by_name,
        "device_ops": [[n[:96], k["s"]] for n, k in
                       sorted(by_name.items(), key=lambda kv: -kv[1]["s"])[:10]],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
        "n_device_ops": len(device),
    }
