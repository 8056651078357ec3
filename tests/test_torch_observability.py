"""The port's tracer (`utils/observability.py`) and the spans and counters
it marks on the identify path.

The tracer is active while `enable()` is in force or while a
`torch.profiler` session records, and never while a program is being
exported; inactive, `span` is one shared no-op and `count` does nothing.
On the hot path each stage opens its span once, in the function every
entry point shares, under the root of its entry (`identify`, `start`,
`finish`), and `host_waits` counts each call that makes the host wait
for a card's stream (the CPU has no stream, so the tests let the CPU
count as a waiting device). Tiny seeded models at 128², iresnet18,
float32, K=4 slots, on the CPU.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.pipeline import aot
from facerecognizeonnx_tpu_torch.pipeline.bucketed import BucketedEmbedPipeline
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_matches
from facerecognizeonnx_tpu_torch.utils import observability as obs

SIZE, K, TOP_K = 128, 4, 3
CFG = PipelineConfig(det_input_size=SIZE, compute_dtype="float32", pre_nms_topk=64,
                     max_faces=16, rec_arch="iresnet18", warp_impl="cuda")
IDENTIFY = ["identify", "detect", "decode", "nms", "nms", "align", "embed", "match"]


@pytest.fixture(autouse=True)
def _fresh_tracer():
    obs.enable(False)
    obs.reset()
    yield
    obs.enable(False)
    obs.reset()


@pytest.fixture(scope="module")
def world():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    det_tree = detection_bias(bridge.init_params_numpy("500m", seed=0), frames)
    det = bridge.params_from_numpy(det_tree, "cpu")
    rec = bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=1), "cpu")
    bank = rng.normal(size=(16, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank = torch.from_numpy(np.concatenate([bank, np.zeros((16, 512), np.float32)]))
    yield frames, det, rec, bank
    torch.set_num_threads(n)


def _frt_ranges(prof):
    """(start, end, name) of the frt. ranges on the host, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name()[4:])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("frt."))


def _inside(outer, ranges):
    a, b, _ = outer
    return [n for s, e, n in ranges if a <= s and e <= b and (s, e) != (a, b)]


# ---------------------------------------------------------------- the tracer


def test_inactive_span_is_the_shared_no_op_and_leaves_no_range():
    s = obs.span("a")
    assert s is obs.span("b") is obs._NO_SPAN
    obs.count("n")
    with torch.profiler.profile() as prof:
        with s:
            torch.ones(4).sum()
    assert _frt_ranges(prof) == []
    assert obs.snapshot() == {"spans": {}, "counters": {}}


def test_profiler_session_sets_the_flag_the_tracer_reads():
    assert not torch.autograd.profiler._is_profiler_enabled
    with torch.profiler.profile():
        assert torch.autograd.profiler._is_profiler_enabled
        assert obs.span("a") is not obs._NO_SPAN
    assert not torch.autograd.profiler._is_profiler_enabled


def test_enabled_spans_nest_and_tally():
    obs.enable()
    assert obs.enabled()
    for _ in range(2):
        with obs.span("outer"):
            with obs.span("inner"):
                torch.ones(4).sum()
    snap = obs.snapshot()["spans"]
    assert {k: v["calls"] for k, v in snap.items()} == {"outer": 2, "inner": 2}
    assert 0 < snap["inner"]["host_s"] <= snap["outer"]["host_s"]


def test_profiled_spans_name_themselves_and_nest():
    with torch.profiler.profile() as prof:
        with obs.span("outer"):
            with obs.span("inner"):
                torch.ones(4).sum()
            torch.ones(4).sum()
    ranges = _frt_ranges(prof)
    assert [n for _, _, n in ranges] == ["outer", "inner"]
    assert _inside(ranges[0], ranges) == ["inner"]
    assert set(obs.snapshot()["spans"]) == {"outer", "inner"}


def test_count_snapshot_and_reset_across_threads():
    obs.enable()

    def work():
        for _ in range(500):
            obs.count("hits")
            obs.count("twos", 2)
            with obs.span("t"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    snap = obs.snapshot()
    assert snap["counters"] == {"hits": 2000, "twos": 4000}
    assert snap["spans"]["t"]["calls"] == 2000
    obs.reset()
    assert obs.snapshot() == {"spans": {}, "counters": {}}


def test_host_wait_counts_waiting_devices_only():
    obs.enable()
    obs.host_wait(torch.device("cpu"))
    assert obs.snapshot()["counters"] == {}
    obs.host_wait(torch.device("cuda"))
    assert obs.snapshot()["counters"] == {"host_waits": 1}


def test_exported_fused_step_holds_no_profiler_op(world):
    frames, det, rec, _ = world
    obs.enable()
    ep = aot._export(aot._Fused(det, rec, CFG, K), (frames,))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not any("profiler" in t or "record_function" in t for t in targets)
    assert obs.snapshot()["spans"] == {}


# ---------------------------------------------------------------- the hot path


def _blocks(rec) -> int:
    """The IBasicBlocks of one forward of the IResNet `rec`."""
    return sum(len(stage) for stage in rec.stages)


def _cpu_waits(monkeypatch):
    """Counts the hot path's waits on the CPU too, which has no stream."""
    monkeypatch.setattr(obs, "host_wait", lambda device: obs.count("host_waits"))


def test_frames_to_matches_opens_its_stages_in_order(world, monkeypatch):
    frames, det, rec, bank = world
    _cpu_waits(monkeypatch)
    with torch.profiler.profile() as prof, torch.no_grad():
        frames_to_matches(det, rec, frames, bank, 16, CFG, K, TOP_K)
    ranges = _frt_ranges(prof)
    assert [n for _, _, n in ranges] == IDENTIFY
    assert _inside(ranges[0], ranges) == IDENTIFY[1:]
    # three anchor-centre uploads (one a stride) and the ArcFace template;
    # the CPU runs the recognizer's blocks on the eager path
    assert obs.snapshot()["counters"] == {"host_waits": 4, "iresnet_blocks": _blocks(rec)}


class _Ready:
    """Stands in for the CUDA event `start` records on a card."""

    def synchronize(self):
        pass


def _bucketed(world, **kw):
    _, det, rec, _ = world
    return BucketedEmbedPipeline(det, rec, CFG, max_faces_embed=K, buckets=[2, 4, 8],
                                 search_top_k=TOP_K, device="cpu", **kw)


@pytest.mark.parametrize("short_guess", [False, True])
def test_bucketed_start_and_finish_open_their_stages(world, monkeypatch, short_guess):
    frames, _, _, bank = world
    _cpu_waits(monkeypatch)
    pipe = _bucketed(world, valid_cap=3)
    if short_guess:
        pipe._last_rate = 0.5  # guesses a bucket of 2 for 6 occupied slots
    with torch.profiler.profile() as prof, torch.no_grad():
        pend = dataclasses.replace(pipe.start(frames, bank_padded=bank, n_rows=16),
                                   ready=_Ready())
        out = pipe.finish(pend)
    ranges = _frt_ranges(prof)
    roots = [r for r in ranges if r[2] in ("start", "finish")]
    assert [r[2] for r in roots] == ["start", "finish"]
    assert _inside(roots[0], ranges) == IDENTIFY[1:6] + ["compact", "embed", "match"]
    rerun = ["rerun", "embed", "match"] if short_guess else []
    assert _inside(roots[1], ranges) == ["counts_wait"] + rerun
    assert pipe.corrections == int(short_guess) and out[-1] == 6
    # decode's three uploads, the template, and the wait for the counts
    blocks = (1 + short_guess) * _blocks(world[2])
    assert obs.snapshot()["counters"] == {"host_waits": 5, "iresnet_blocks": blocks}


def test_service_worker_opens_its_stages_and_stats_reports_them(world):
    from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
    from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService

    frames, det, rec, bank = world
    gallery = GalleryBank(device="cpu")
    gallery.add_batch([f"r{i}" for i in range(16)], bank[:16].numpy())
    svc = IdentifyService(det, rec, gallery, CFG, max_batch=2, batch_window_ms=1,
                          max_faces=K, fuse_search=True, search_top_k=TOP_K, device="cpu")
    try:
        assert "spans" not in svc.stats()
        obs.enable()
        for f in frames.numpy():
            svc.identify(f, top_k=TOP_K, timeout=600)
        spans = svc.stats()["spans"]
    finally:
        svc.close()
    for name in ("letterbox", "stack", "upload", "resolve", "identify", "match"):
        assert spans[name]["calls"] >= 1 and spans[name]["host_ms"] >= 0, name
    assert spans["letterbox"]["calls"] == spans["resolve"]["calls"] == svc.stats()["batches"]
