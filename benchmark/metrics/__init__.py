"""Per-layer metrics: one module per metric, named as in BENCHMARK.json.
Each has `UNIT` and `read(summary) -> float | None`; `summary` is the
traced run's summary (benchmark/trace.py and benchmark/run.py). A reader
that finds nothing to read returns None and the metric is left out."""
