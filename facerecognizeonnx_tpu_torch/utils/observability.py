"""Per-stage timing, throughput counters and device traces.

Port of `facerecognizeonnx_tpu/utils/observability.py`: the hot path
prints nothing; `StageTimer` times host stages behind a flag (near zero
cost when off), `Counter` keeps a rate and p50/p99 latencies of a
repeated event, and `trace` records a `torch.profiler` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


class StageTimer:
    """Wall-clock time per named stage; enabled=False costs ~nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {total * 1e3:.1f}ms total, {total / n * 1e3:.2f}ms avg x{n}")
        return "\n".join(lines)


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
