"""The program's spans in a traced summary (`benchmark/spans.py`), on
hand-made profiler events, and the readers of its counters."""

from __future__ import annotations

import pytest
import torch

from benchmark import spans, spec
from benchmark import trace as tracing
from facerecognizeonnx_tpu_torch.utils import observability as obs

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, a, b, corr=0, linked=0):
        self._v = (name, dev, a, b, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _self: events})()


def _batch():
    """One dispatch: the harness's ranges and hooks, the program's spans
    (identify ⊃ detect, decode, match), three launching ops and their
    kernels, and idle gaps while the host is in decode and in detect."""
    host = [
        Ev("bench.dispatch", CPU, 0, 1000),
        Ev("layer.detect", CPU, 100, 400),
        Ev("layer.detect_post", CPU, 400, 900),
        Ev("aten::conv2d", CPU, 150, 160, corr=1),
        Ev("aten::add", CPU, 450, 455, corr=2),
        Ev("aten::mm", CPU, 800, 805, corr=3),
        Ev("cudaLaunchKernel", CPU, 151, 152, corr=11, linked=1),
    ]
    device = [
        Ev("conv_kernel", CUDA, 200, 300, linked=1),
        Ev("add_kernel", CUDA, 500, 520, linked=2),
        Ev("gemm_kernel", CUDA, 850, 900, linked=3),
        Ev("layer.detect", CUDA, 200, 300),  # the harness's own mirrored range
    ]
    program = [
        Ev("frt.identify", CPU, 50, 950, corr=21),
        Ev("frt.detect", CPU, 120, 420, corr=22),
        Ev("frt.decode", CPU, 420, 700, corr=23),
        Ev("frt.match", CPU, 790, 940, corr=24),
    ]
    return host, device, program


def test_program_ranges_leave_every_existing_key_unchanged():
    host, device, program = _batch()
    plain = tracing.summarise(Prof(host + device))
    assert tracing.summarise(Prof(host + device + program)) == plain
    assert plain["busy_s"] == pytest.approx(170e-9)
    assert not any(n.startswith("frt.") for n, _ in plain["device_ops"])


def test_device_time_and_gaps_go_to_the_innermost_span():
    host, device, program = _batch()
    p = spans.program_summary(host + device + program, {"host_waits": 4})
    assert p["device_s"] == pytest.approx({"detect": 100e-9, "decode": 20e-9, "match": 50e-9})
    # idle from 300 (host in detect) to 500, and from 520 (host in decode) to 850
    assert p["gaps_s"] == pytest.approx({"detect": 200e-9, "decode": 330e-9})
    assert p["spans"]["identify"] == {"host_s": pytest.approx(900e-9), "calls": 1}
    assert p["counters"] == {"host_waits": 4}


def test_program_mirrors_never_count_as_device_operations():
    host, device, program = _batch()
    mirrors = [Ev("frt.identify", CUDA, 200, 900, corr=21), Ev("frt.detect", CUDA, 200, 300)]
    p = spans.program_summary(host + device + program + mirrors)
    assert sum(p["device_s"].values()) == pytest.approx(170e-9)
    assert sum(p["gaps_s"].values()) == pytest.approx(530e-9)


def test_no_program_span_credits_everything_to_none():
    host, device, _ = _batch()
    p = spans.program_summary(host + device)
    assert p["device_s"] == pytest.approx({"none": 170e-9})
    assert p["spans"] == {}


def _summary(family="dense"):
    return {"kind": "identify", "family": family, "batches": 4}


def read(name, s):
    return spec.metric(name).read(s)


def test_per_batch_breakdown():
    host, device, program = _batch()
    p = spans.program_summary(host + device + program, {"host_waits": 8})
    b = spans.per_batch_ms(p, 2)
    assert b["device_ms"]["match"] == pytest.approx(25e-6)
    assert b["gap_ms"]["decode"] == pytest.approx(165e-6)
    assert b["calls"]["identify"] == 0.5 and b["counters"] == {"host_waits": 4}


def _traced(family, batches, waits):
    obs.enable()
    for _ in range(batches):
        with obs.span("identify" if family == "dense" else "start"):
            obs.count("host_waits", waits)
    obs.enable(False)


@pytest.mark.parametrize("family", ["dense", "bucketed"])
def test_host_waits_reads_the_program_counter(family):
    sfx = "" if family == "dense" else ".bucketed"
    s = _summary(family)
    obs.reset()
    try:
        _traced(family, 4, 0)
        assert read(f"host_waits{sfx}", s) == 0.0
        obs.reset()
        _traced(family, 4, 5)
        assert read(f"host_waits{sfx}", s) == pytest.approx(5.0)
        assert read(f"host_waits{'.bucketed' if not sfx else ''}", s) is None
    finally:
        obs.enable(False)
        obs.reset()


@pytest.mark.parametrize("batches", [0, 3, 5])
def test_host_waits_is_silent_where_the_tally_is_not_the_windows(batches):
    """Calls traced outside the window (or none at all) leave the root
    span's calls apart from the traced batches: no reading."""
    obs.reset()
    try:
        _traced("dense", batches, 5)
        assert read("host_waits", _summary()) is None
    finally:
        obs.enable(False)
        obs.reset()


def test_host_waits_is_silent_where_the_program_has_no_tracer(monkeypatch):
    monkeypatch.delattr(obs, "snapshot")
    assert read("host_waits", _summary()) is None
    assert spans.program_snapshot() is None
