"""The port's tracer, a throughput counter and device traces.

The tracer marks the stage boundaries of the hot path: `span(name)` and
`count(name, n)`. It is active while `enable()` is in force or while a
`torch.profiler` session records, and never while a program is being
compiled or exported (so an exported program, and a CUDA graph captured
from one, holds no profiler op). Inactive, `span` returns one shared
no-op context and `count` returns at once: one flag test each. Active, a
span opens the profiler range `frt.<name>`, on the profiler's clock, so
the profiler credits the device operations launched inside it to it,
and adds its host seconds and calls to an in-memory tally; `count` adds
to a named counter. `snapshot()` returns both and `reset()` clears them;
both are safe from any thread. Nothing is written to disk.

`host_waits` counts each call of the hot path that makes the host wait
for the device's stream (`host_wait`).

`Counter` keeps a rate and p50/p99 latencies of a repeated event (the
video pipeline, the bench mode), and `trace` writes a `torch.profiler`
trace (the bench mode's `--profile`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.autograd.profiler as _profiler

_lock = threading.Lock()
_enabled = False
_spans: Dict[str, List[float]] = {}  # name → [calls, host seconds]
_counters: Dict[str, int] = {}


def enable(on: bool = True) -> None:
    """Keeps the tracer active without a profiler (or not)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    """Whether `enable()` is in force."""
    return _enabled


def _tracing() -> bool:
    return not (torch.compiler.is_compiling() or torch.compiler.is_exporting())


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """A profiler range `frt.<name>` (a plain function-scope record, which
    the profiler keeps on the host's timeline only) and its host time."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch._C._profiler._RecordFunctionFast(f"frt.{self.name}")
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        with _lock:
            tally = _spans.setdefault(self.name, [0, 0.0])
            tally[0] += 1
            tally[1] += dt
        return False


def span(name: str):
    """A context that marks one stage of the hot path as `frt.<name>`."""
    if not (_enabled or _profiler._is_profiler_enabled) or not _tracing():
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` while the tracer is active."""
    if not (_enabled or _profiler._is_profiler_enabled) or not _tracing():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def host_wait(device: torch.device) -> None:
    """Counts one call that makes the host wait for `device`'s stream (a
    blocking copy from pageable memory, an event's synchronize) in
    `host_waits`; a device without a stream has nothing to wait for."""
    if device.type == "cuda":
        count("host_waits")


def snapshot() -> Dict:
    """{"spans": {name: {"calls", "host_s"}}, "counters": {name: n}}."""
    with _lock:
        return {
            "spans": {k: {"calls": int(c), "host_s": s} for k, (c, s) in _spans.items()},
            "counters": dict(_counters),
        }


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


class Counter:
    """Throughput and latency percentiles of a repeated event."""

    def __init__(self, name: str = "frames"):
        self.name = name
        self._durations: List[float] = []
        self._items = 0
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def event(self, items: int = 1):
        t0 = time.perf_counter()
        yield
        self._durations.append(time.perf_counter() - t0)
        self._items += items

    def summary(self) -> Dict[str, float]:
        elapsed = time.perf_counter() - self._t0
        d = np.asarray(self._durations) * 1e3
        return {
            f"{self.name}_per_sec": self._items / max(elapsed, 1e-9),
            "p50_ms": float(np.percentile(d, 50)) if len(d) else 0.0,
            "p99_ms": float(np.percentile(d, 99)) if len(d) else 0.0,
            "count": len(d),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block (host and CUDA activity),
    written to `log_dir/trace.json` (open it in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
