"""What the readers of the program's own counters share
(`facerecognizeonnx_tpu_torch/utils/observability.py`). The program's
tracer counts only while a profiler records, so in a traced run over the
traced window; its tallies are the process's, so a reader trusts them
only where the program's root span of the family (`identify`, `start`)
ran once for each traced batch and no more. Each returns None in a cell
of another family, where the program has no tracer, and where the
tallies hold calls from outside the traced window."""

from benchmark.metrics._identify import serves
from benchmark.spans import program_snapshot

# the program's span around each dispatch of a family
ROOT = {"dense": "identify", "bucketed": "start"}


def counter_per_batch(s, family: str, name: str):
    """The program's counter `name` over the traced batches (0 where the
    tracer counted none)."""
    if not serves(s, family) or not s.get("batches"):
        return None
    snap = program_snapshot()
    if snap is None:
        return None
    root = snap["spans"].get(ROOT[family], {}).get("calls", 0)
    if root != s["batches"]:
        return None
    return snap["counters"].get(name, 0) / s["batches"]
