"""End-to-end benchmark of the port: one JSON line per config.

Port of the repository's root `bench.py` (the JAX bench), with the same
configs, names and output contract, run on the CUDA card (`--cpu` for
the host CPU; without a card and without `--cpu` it raises, as every
entry point does):

    python -m facerecognizeonnx_tpu_torch.bench [--config NAME|all]
        [--batch B] [--iters N] [--cpu] [--json-only] [--detail PATH]
        [--profile DIR]
    frt-torch bench          # the headline config, in process

The headline program is `pipeline.fused.frames_to_features`: a batch of
letterboxed 640x640 frames → SCRFD-500m → decode → top-k → the NMS
kernel → align → the x-major warp kernel → IResNet-50, K=8 faces
embedded per frame whether or not a detection occupies the slot. The
other configs: the model families (MobileFaceNet, w8a8), the models
loaded from `.onnx` files, 2 of 8 slots occupied (dense and through the
occupancy-adaptive bucketed embed), the identify service, one-frame
latency, batched enrollment, the 100,000-row gallery through the
gallery top-k kernel, and a 1080p video stream.

Output: a single config prints one JSON line. `all` runs the configs
of `ORDER` and prints the full document on one line (also written to
`--detail`, default `bench_detail.json` in the working directory), then
a compact final line of at most 1,900 bytes with every config's value.
Every progress line goes to stderr (file descriptor 1 points there
while the configs run). Each result's detail names the device (its name
and nvidia-smi's name and power limit) and the kernel launches counted
around its timed region. `vs_baseline` is null in every result: the
port has no baseline on the card yet.

Inputs are seeded numpy draws and the weights come from
`bridge.init_params_numpy` (seed 0 the detector, 1 IResNet-50, 2
MobileFaceNet), BN-folded. Steps are timed between synchronizations
(`torch.cuda.synchronize`) or CUDA events; nothing is chained from one
step into the next.

Run guards: a per-config deadline re-execs a fresh process that resumes
from the saved results (`FRT_BENCH_CONFIG_DEADLINE_S`, at most
`FRT_BENCH_MAX_REEXECS` re-execs, 2 attempts per config); past the
whole-run deadline (`FRT_BENCH_TOTAL_DEADLINE_S`) no config starts and
the results so far are emitted; SIGTERM emits the results so far and
exits 0.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import platform
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.embed.pipeline import embed_crops
from facerecognizeonnx_tpu_torch.io.imageio import VideoSource
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.match.similarity import similarity_matrix
from facerecognizeonnx_tpu_torch.models import arcface, mobilefacenet, quant, scrfd
from facerecognizeonnx_tpu_torch.onnx_export import export_detector, export_recognizer
from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner
from facerecognizeonnx_tpu_torch.onnx_import.native_map import map_recognizer
from facerecognizeonnx_tpu_torch.ops import gallery_cuda, nms, warp_cuda
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.pipeline import fused
from facerecognizeonnx_tpu_torch.pipeline.bucketed import (
    BucketedEmbedPipeline,
    detect_and_compact,
)
from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService
from facerecognizeonnx_tpu_torch.pipeline.video import VideoPipeline
from facerecognizeonnx_tpu_torch.utils.observability import Counter, trace

FACES_PER_FRAME = 8
# latency percentiles take at least this many synchronized steps, and
# every runner warms up with this many steps after its first
MIN_LATENCY_SAMPLES = 20
WARMUP_STEPS = 2

CONFIG_DEADLINE_S = float(os.environ.get("FRT_BENCH_CONFIG_DEADLINE_S", "1500"))
MAX_REEXECS = int(os.environ.get("FRT_BENCH_MAX_REEXECS", "6"))
TOTAL_DEADLINE_S = float(os.environ.get("FRT_BENCH_TOTAL_DEADLINE_S", "3600"))
MAX_ATTEMPTS_PER_CONFIG = 2

CONFIGS = (
    "headline", "headline_mbf", "headline_q8", "headline_mbf_q8",
    "headline_onnx", "headline_occ", "headline_occ_adaptive",
    "headline_occ_adaptive_mbf", "headline_occ_adaptive_q8",
    "serve", "latency", "enroll", "gallery", "video",
)
# what `all` runs, in this order; headline_mbf_q8 and
# headline_occ_adaptive_q8 run by name only
ORDER = (
    "headline", "headline_mbf", "headline_q8", "headline_onnx",
    "headline_occ", "headline_occ_adaptive",
    "headline_occ_adaptive_mbf", "serve", "latency", "enroll",
    "gallery", "video",
)
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the stream the JSON lines go to while fd 1 points at stderr (main)
_OUT = None


def _out():
    return _OUT if _OUT is not None else sys.stdout


def _load_state(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"results": {}, "attempts": {}, "reexecs": 0}


def _save_state(path, state):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def _emit_final(results, order, detail_path="bench_detail.json"):
    """Print the full document on one line, then the compact line of
    record (at most 1,900 bytes, every config's value), and write the
    full document to `detail_path`. Works when the headline config
    failed or never ran."""
    head = results.get("headline")
    if not (isinstance(head, dict) and "value" in head):
        head = {
            "metric": "faces/sec/chip end-to-end (detect+align+embed)",
            "value": 0.0, "unit": "faces/sec", "vs_baseline": 0.0,
            "detail": {"error": (head or {}).get("error", "headline missing")},
        }
    full = dict(head)
    full["detail"] = dict(head.get("detail", {}))
    full["detail"]["configs"] = {
        k: v for k, v in results.items() if k != "headline" and k in order
    }
    probes = {}
    if results.get("_hbm_gbps") is not None:
        probes["hbm_read_gbps"] = results["_hbm_gbps"]
    if results.get("_h2d_mbps") is not None:
        probes["h2d_mbytes_per_sec"] = results["_h2d_mbps"]
    if results.get("_card") is not None:
        probes["card"] = results["_card"]
    full["detail"].update(probes)
    detail_file = None
    try:
        with open(detail_path, "w") as f:
            json.dump(full, f, indent=1)
        detail_file = os.path.basename(detail_path)
    except OSError:
        pass
    out = _out()
    print(json.dumps(full), file=out)  # the full document, before the line of record

    compact = {
        "metric": head["metric"],
        "value": head["value"],
        "unit": head["unit"],
        "vs_baseline": head["vs_baseline"],
        "detail": {"configs": {}},
    }
    for k in order:
        v = results.get(k)
        if k == "headline" or v is None:
            continue
        if isinstance(v, dict) and "value" in v:
            compact["detail"]["configs"][k] = {
                "value": v["value"], "unit": v["unit"],
                "vs_baseline": v["vs_baseline"],
            }
        else:
            compact["detail"]["configs"][k] = {
                "error": str((v or {}).get("error", "?"))[:60]
            }
    compact["detail"].update(probes)
    if detail_file:
        compact["detail"]["detail_file"] = detail_file
    line = json.dumps(compact)
    if len(line) > 1900:
        compact["detail"] = {
            "configs": (
                "truncated, see " + detail_file
                if detail_file
                else "truncated (detail file unwritable)"
            )
        }
        compact["detail"].update(probes)
        line = json.dumps(compact)
    print(line, file=out)
    out.flush()


def _reexec_env():
    """The environment of a re-exec'd bench: this package importable."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (PACKAGE_ROOT, path) if p))


class _Watchdog:
    """Per-config deadline. `arm()` around each runner; on expiry the
    watchdog thread either re-execs a fresh bench process that resumes
    from the state file (the hung config dies with the old process and
    its CUDA context), or, with the re-exec budget spent, emits the
    results so far itself and exits 0."""
    def __init__(self, state_path, state, order, argv, detail_path,
                 deadline_s=CONFIG_DEADLINE_S):
        self.state_path = state_path
        self.state = state
        self.order = order
        self.argv = [a for a in argv if not a.startswith("--_state")]
        self.detail_path = detail_path
        self.deadline_s = deadline_s
        self._cancel = None
        self._timer = None

    def arm(self, name):
        self.disarm()
        ev = threading.Event()
        self._cancel = ev
        t = threading.Timer(self.deadline_s, self._expire, (name, ev))
        t.daemon = True
        t.start()
        self._timer = t

    def disarm(self):
        if self._cancel is not None:
            self._cancel.set()
            self._timer.cancel()
            self._cancel = None

    def _expire(self, name, ev):
        if ev.is_set():
            return
        print(
            f"WATCHDOG: config '{name}' exceeded {self.deadline_s:.0f}s "
            f"(attempt {self.state['attempts'].get(name, '?')}); ",
            file=sys.stderr, end="",
        )
        if self.state.get("reexecs", 0) >= MAX_REEXECS:
            print("re-exec budget exhausted — emitting partial results", file=sys.stderr)
            self.state["results"].setdefault(
                name, {"error": f"timed out after {self.deadline_s:.0f}s"}
            )
            _emit_final(self.state["results"], self.order, self.detail_path)
            os._exit(0)
        print("re-exec with saved results", file=sys.stderr)
        sys.stderr.flush()
        _restore_stdout()  # the new process writes its lines to the real stdout
        os.execve(
            sys.executable,
            [sys.executable, "-m", "facerecognizeonnx_tpu_torch.bench"] + self.argv
            + [f"--_state={self.state_path}"],
            _reexec_env(),
        )


def _percentiles(samples_s):

    ms = np.asarray(samples_s) * 1000.0
    return {
        "samples": len(ms),
        "p50_ms": round(float(np.percentile(ms, 50)), 2),
        "p90_ms": round(float(np.percentile(ms, 90)), 2),
        "p99_ms": round(float(np.percentile(ms, 99)), 2),
    }


@contextlib.contextmanager
def _stdout_to_stderr():
    """fd 1 → stderr for the block (so a print anywhere below, or a
    library's, cannot land among the JSON lines); the JSON lines go to
    `_OUT`, which holds the original stdout."""
    global _OUT
    sys.stdout.flush()
    _OUT = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    try:
        yield
    finally:
        _restore_stdout()


def _restore_stdout():
    """Point fd 1 at the original stdout again (before a re-exec too)."""
    global _OUT
    if _OUT is None:
        return
    sys.stdout.flush()
    _OUT.flush()
    os.dup2(_OUT.fileno(), 1)
    _OUT.close()
    _OUT = None


@contextlib.contextmanager
def _sigterm_emits(state, order, detail_path, current):
    """SIGTERM while the block runs: mark the config in progress
    (`current["name"]`) as terminated, emit the results so far and exit
    0. Only the main thread can take a signal handler; elsewhere the
    block runs without one."""
    def handler(signum, frame):
        results = state["results"]
        name = current.get("name")
        if name is not None and name not in results:
            results[name] = {"error": "terminated by SIGTERM before it finished"}
        print(f"SIGTERM: emitting {len(results)} result(s)", file=sys.stderr, flush=True)
        _emit_final(results, order, detail_path)
        os._exit(0)

    try:
        previous = signal.signal(signal.SIGTERM, handler)
    except ValueError:  # not the main thread
        yield
        return
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, previous)


def run_configs(order, runners, state, state_path, argv, detail_path, log,
                probes=None, total_deadline_s=None):
    """Run the configs of `order` not yet in `state["results"]`, each
    under the watchdog, then `probes()` (a dict of `_`-keys merged into
    the results), and emit. Past the whole-run deadline (counted from
    `state["t_start"]`, which a re-exec keeps) no config starts; each one
    left gets an error. A config that raises gets its error and the next
    one runs."""
    total = TOTAL_DEADLINE_S if total_deadline_s is None else total_deadline_s
    state.setdefault("t_start", time.time())
    results = state["results"]
    if results:
        log(f"resuming: {sorted(results)} already done "
            f"(re-exec {state['reexecs']}/{MAX_REEXECS})")
    wd = _Watchdog(state_path, state, order, argv, detail_path)
    current = {}
    with _sigterm_emits(state, order, detail_path, current):
        for name in order:
            if name in results:
                continue
            if time.time() >= state["t_start"] + total:
                results[name] = {"error": f"not run: whole-run deadline of {total:.0f}s passed"}
                log(f"{name} SKIPPED: the whole-run deadline ({total:.0f}s) has passed")
                continue
            attempt = state["attempts"].get(name, 0)
            if attempt >= MAX_ATTEMPTS_PER_CONFIG:
                results[name] = {"error": f"timed out (watchdog, {attempt} attempts)"}
                _save_state(state_path, state)
                log(f"{name} SKIPPED after {attempt} timed-out attempts")
                continue
            state["attempts"][name] = attempt + 1
            _save_state(state_path, state)
            t0 = time.time()
            current["name"] = name
            wd.arm(name)
            try:
                results[name] = runners[name]()
            except Exception as e:  # one config must not sink the others
                log(f"{name} FAILED:\n{traceback.format_exc()}")
                results[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
            wd.disarm()
            current.pop("name")
            _save_state(state_path, state)
            log(f"{name} done in {time.time() - t0:.1f}s")
        if probes is not None:
            results.update(probes())
        _save_state(state_path, state)
        _emit_final(results, order, detail_path)
    return results


# ---------------------------------------------------------------- device


def _sync(device):

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _elapsed_ms(device, fn, n):
    """ms per call over n back-to-back calls of fn: between two CUDA
    events on the card (no host synchronization between the calls), on
    the host clock around a final synchronization elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1000.0 / n


_SMI = {}


def _nvidia_smi():
    """nvidia-smi's "name, power.limit" of the first card, or None."""
    if "line" not in _SMI:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True,
            )
            _SMI["line"] = out.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            _SMI["line"] = None
    return _SMI["line"]


def _device_info(device):

    if device.type == "cuda":
        return {"name": torch.cuda.get_device_name(device), "nvidia_smi": _nvidia_smi()}
    return {"name": f"cpu ({platform.machine()}, {torch.get_num_threads()} threads)",
            "nvidia_smi": None}


def _kernels():
    """The hand-written kernels' wrappers, each counting its launches."""
    return {
        "warp_xm": warp_cuda.warp_affine_xm,
        "warp_xm_pyramid": warp_cuda.build_pyramid,
        "nms_greedy": nms.nms_greedy,
        "gallery_topk": gallery_cuda.gallery_topk_cuda,
    }


@contextlib.contextmanager
def _counted(into):
    """Set every kernel's launch count to 0, run the block, and fill
    `into` with the counts (CPU tensors take the plain versions and
    launch nothing)."""
    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    yield into
    into.update({k: fn.launches for k, fn in kernels.items()})


def _seeded_frames(batch, size, device, seed=0):

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)).to(device)


# ---------------------------------------------------------------- models


def _detector(device, folded=True):

    model = bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=0), device)
    return scrfd.fold_inference_params(model) if folded else model


def _r50(device, folded=True):

    model = bridge.params_from_numpy(bridge.init_params_numpy("iresnet50", seed=1), device)
    return arcface.fold_inference_params(model) if folded else model


def _mbf(device):

    return mobilefacenet.fold_inference_params(
        bridge.params_from_numpy(bridge.init_params_numpy("mbf", seed=2), device))


def _q8(model, seed, device):
    """w8a8 copy of `model`, the wide convs only (min_channels=128),
    calibrated on 64 seeded noise crops."""
    rng = np.random.default_rng(seed)
    calib = (rng.integers(0, 256, (64, 112, 112, 3)).astype(np.float32) - 127.5) / 128.0
    return quant.quantize_recognizer(
        model, torch.from_numpy(calib).to(device), torch.bfloat16, min_channels=128)


# ---------------------------------------------------------------- runners


def bench_headline(args, cfg, det_params, arc_params, log, valid_cap=None):
    """frames_to_features on seeded (batch, S, S, 3) frames (S =
    cfg.det_input_size): throughput over `iters` steps between two
    synchronizations, latency over synchronized steps."""
    dev = args.device
    frames = _seeded_frames(args.batch, cfg.det_input_size, dev)

    def step():
        with torch.no_grad():
            return fused.frames_to_features(det_params, arc_params, frames, cfg,
                                            max_faces_embed=FACES_PER_FRAME,
                                            valid_cap=valid_cap)

    t0 = time.perf_counter()
    step()
    _sync(dev)
    log(f"first run {time.perf_counter() - t0:.1f}s")
    for _ in range(WARMUP_STEPS):
        step()
    _sync(dev)

    launches = {}
    with _counted(launches):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        _sync(dev)
        dt = time.perf_counter() - t0

    samples = []
    for _ in range(max(MIN_LATENCY_SAMPLES, args.iters)):
        t1 = time.perf_counter()
        step()
        _sync(dev)
        samples.append(time.perf_counter() - t1)

    frames_per_sec = args.batch * args.iters / dt
    faces = FACES_PER_FRAME if valid_cap is None else valid_cap
    faces_per_sec = frames_per_sec * faces
    return {
        "metric": "faces/sec/chip end-to-end (detect+align+embed)",
        "value": round(faces_per_sec, 1),
        "unit": "faces/sec",
        "vs_baseline": None,
        "detail": {
            "frames_per_sec": round(frames_per_sec, 1),
            "batch": args.batch,
            "faces_per_frame": FACES_PER_FRAME,
            "valid_faces_per_frame": faces,
            "batch_step_latency": _percentiles(samples),
            "device": _device_info(dev),
            "launches": launches,
        },
    }


def bench_occ_adaptive(args, cfg, det_params, arc_params, log, label="", stage_split=False):
    """The occupancy-adaptive bucketed embed (pipeline/bucketed.py) at 2
    of 8 slots: program A (detect, align, compact) sizes program B's
    bucket. Throughput is the pipelined start/finish loop (start(N+1)
    before finish(N) reads the counts), latency synchronous steps;
    stage_split times program A and program B (at the steady bucket)
    alone."""
    VALID = 2
    dev = args.device
    cfg_occ = dataclasses.replace(cfg, skip_invalid_faces=True)
    pipe = BucketedEmbedPipeline(det_params, arc_params, cfg_occ,
                                 max_faces_embed=FACES_PER_FRAME, valid_cap=VALID, device=dev)
    frames = _seeded_frames(args.batch, cfg.det_input_size, dev)

    t0 = time.perf_counter()
    pipe(frames)
    _sync(dev)
    log(f"first run {time.perf_counter() - t0:.1f}s")
    for _ in range(WARMUP_STEPS):
        pipe(frames)
    _sync(dev)
    pipe.corrections = 0  # the warm-up's full-bucket first step is not steady state

    launches = {}
    with _counted(launches):
        t0 = time.perf_counter()
        pend = pipe.start(frames)
        for _ in range(args.iters - 1):
            nxt = pipe.start(frames)
            pipe.finish(pend)
            pend = nxt
        pipe.finish(pend)
        _sync(dev)
        dt = time.perf_counter() - t0

    samples = []
    for _ in range(max(MIN_LATENCY_SAMPLES, args.iters)):
        t1 = time.perf_counter()
        pipe(frames)
        _sync(dev)
        samples.append(time.perf_counter() - t1)

    frames_per_sec = args.batch * args.iters / dt
    faces_per_sec = frames_per_sec * VALID
    out = {
        "metric": ("faces/sec/chip end-to-end, 2/8 occupancy "
                   f"(adaptive bucketed embed{label})"),
        "value": round(faces_per_sec, 1),
        "unit": "faces/sec",
        "vs_baseline": None,
        "detail": {
            "frames_per_sec": round(frames_per_sec, 1),
            "batch": args.batch,
            "faces_per_frame": FACES_PER_FRAME,
            "valid_faces_per_frame": VALID,
            "steady_bucket": pipe.last_bucket,
            "corrections": pipe.corrections,
            "sync_step_latency": _percentiles(samples),
            "note": "throughput = pipelined two-phase loop (the count read of step N "
                    "follows the launch of step N+1, as the video pipeline and the "
                    "service worker run it); sync_step_latency = one synchronized "
                    "step at a time",
            "device": _device_info(dev),
            "launches": launches,
        },
    }
    if stage_split:
        bucket = max(pipe.last_bucket, 1)

        def program_a():
            with torch.no_grad():
                return detect_and_compact(det_params, frames, cfg_occ, FACES_PER_FRAME,
                                          None, VALID)

        ops = program_a()[1:4]
        a_ms = _elapsed_ms(dev, program_a, args.iters)
        b_ms = _elapsed_ms(dev, lambda: pipe._embed(bucket, ops, None), args.iters)
        out["detail"]["stage_split_ms"] = {
            "program_a_detect_compact": round(a_ms, 2),
            "program_b_embed_bucket": round(b_ms, 2),
            "bucket": bucket,
            "note": "each program alone, `iters` back-to-back calls between two "
                    "CUDA events; the composed step overlaps B with A's count read",
        }
    return out


def _probe_h2d_rate_mbps(log, device):
    """Host → device copy rate of 16 pageable 640x640x3 uint8 frames
    (MB/s), the second of two copies; None on the CPU (no link)."""
    if device.type != "cuda":
        return None
    buf = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (16, 640, 640, 3), dtype=np.uint8))
    buf.to(device)
    _sync(device)
    t0 = time.perf_counter()
    buf.to(device)
    _sync(device)
    dt = time.perf_counter() - t0
    rate = round(buf.numel() / dt / 1e6, 1)
    log(f"h2d probe: {rate} MB/s")
    return rate


def bench_serve(args, cfg, det_params, arc_params, log):
    """`IdentifyService` under closed-loop load at 2 of 8 slots against a
    10,240-row bank (fused search, top 5), dense and adaptive_embed:
    frames/s, the service's enqueue→result percentiles and the mean
    micro-batch. Then each service's own device step on `batch` frames
    already on the device, without the host letterbox and queue."""

    VALID = 2
    G = 10240
    dev = args.device
    cfg_occ = dataclasses.replace(cfg, skip_invalid_faces=True)
    bank = GalleryBank(device=dev)
    rngb = np.random.default_rng(1)
    bank.add_batch([f"p{i}" for i in range(G)], rngb.normal(size=(G, 512)).astype(np.float32))

    rng = np.random.default_rng(0)
    size = cfg.det_input_size
    pool = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(32)]
    h2d_mbps = _probe_h2d_rate_mbps(log, dev)

    results = {}
    for name, adaptive in (("dense", False), ("adaptive", True)):
        svc = IdentifyService(
            det_params, arc_params, bank, cfg_occ,
            max_batch=args.batch, batch_window_ms=20.0,
            fuse_search=True, search_top_k=5,
            adaptive_embed=adaptive, valid_cap=VALID, device=dev,
        )
        try:
            t0 = time.perf_counter()
            svc.identify(pool[0], top_k=1, timeout=1800.0)
            log(f"serve[{name}] first request {time.perf_counter() - t0:.1f}s")

            # closed loop, at most 2 batches in flight
            nreq = args.batch * 6
            sem = threading.BoundedSemaphore(2 * args.batch)
            futs = []
            launches = {}
            with _counted(launches):
                t0 = time.perf_counter()
                for i in range(nreq):
                    sem.acquire()
                    fut = svc.identify_async(pool[i % len(pool)], top_k=1)
                    fut.add_done_callback(lambda f: sem.release())
                    futs.append(fut)
                for f in futs:
                    f.result(timeout=900.0)
                wall = time.perf_counter() - t0
            st = svc.stats()
            entry = {
                "qps_frames": round(nreq / wall, 1),
                "qps_valid_faces": round(nreq * VALID / wall, 1),
                "latency_ms": st.get("latency_ms"),
                "avg_batch": round(st["avg_batch"], 1),
                "launches": launches,
            }

            # the service's own device step, frames already on the device
            frames = torch.from_numpy(
                np.stack([pool[i % len(pool)] for i in range(args.batch)])).to(dev)
            bank_dev, n_rows, _ = svc.bank.device_bank_padded()
            iters = max(10, args.iters // 2)
            if adaptive:
                bk = svc._bucketed
                bk(frames, bank_padded=bank_dev, n_rows=n_rows)
                _sync(dev)
                t0 = time.perf_counter()
                pend = bk.start(frames, bank_padded=bank_dev, n_rows=n_rows)
                for _ in range(iters - 1):
                    nxt = bk.start(frames, bank_padded=bank_dev, n_rows=n_rows)
                    bk.finish(pend)
                    pend = nxt
                bk.finish(pend)
                _sync(dev)
                dt = time.perf_counter() - t0
            else:
                def step():
                    with torch.no_grad():
                        return fused.frames_to_matches(
                            svc.det, svc.arc, frames, bank_dev, n_rows, svc.cfg,
                            svc.max_faces, svc.search_top_k, valid_cap=svc.valid_cap)

                step()
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(iters):
                    step()
                _sync(dev)
                dt = time.perf_counter() - t0
            entry["device_valid_faces_per_sec"] = round(args.batch * VALID * iters / dt, 1)
            entry["device_step_ms"] = round(dt * 1000.0 / iters, 2)
            results[name] = entry
        finally:
            svc.close()

    dense_dev = results["dense"]["device_valid_faces_per_sec"]
    adapt_dev = results["adaptive"]["device_valid_faces_per_sec"]
    return {
        "metric": ("serving identify qps, 2/8 occupancy, 10k gallery "
                   "(IdentifyService, fused search, adaptive embed)"),
        "value": results["adaptive"]["qps_frames"],
        "unit": "frames/sec",
        "vs_baseline": None,
        "detail": {
            "dense": results["dense"],
            "adaptive": results["adaptive"],
            "adaptive_over_dense_device": round(adapt_dev / max(dense_dev, 1e-9), 3),
            "requests": args.batch * 6,
            "max_batch": args.batch,
            "batch_window_ms": 20.0,
            "h2d_link_mbytes_per_sec": h2d_mbps,
            "note": "qps: closed loop, requests of host frames through the service "
                    "(host letterbox, queue, micro-batch, device step); device_* rows "
                    "time each service's own step on frames already on the device",
            "device": _device_info(dev),
            "launches": results["adaptive"]["launches"],
        },
    }


def bench_latency(args, cfg, det_params, arc_params, log):
    """One 640x640 frame through frames_to_features: ms per frame between
    CUDA events around CHAIN back-to-back steps (no host synchronization
    between them), wall p50/p99 per synchronized call, and identify
    against a 10,240-row bank as two dispatches (features, a host read,
    then the dense search) against one (frames_to_matches)."""
    CHAIN = 20
    dev = args.device
    rng = np.random.default_rng(0)
    size = cfg.det_input_size
    frames = torch.from_numpy(rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)).to(dev)

    def step():
        with torch.no_grad():
            return fused.frames_to_features(det_params, arc_params, frames, cfg,
                                            max_faces_embed=FACES_PER_FRAME)

    t0 = time.perf_counter()
    step()
    _sync(dev)
    log(f"latency first run {time.perf_counter() - t0:.1f}s")
    for _ in range(WARMUP_STEPS):
        step()
    _sync(dev)

    outer = max(3, args.iters // 4)
    launches = {}
    with _counted(launches):
        rounds = [_elapsed_ms(dev, step, CHAIN) for _ in range(outer)]
    device_ms = float(np.mean(rounds))

    samples = []
    for _ in range(30):
        t1 = time.perf_counter()
        step()
        _sync(dev)
        samples.append(time.perf_counter() - t1)

    G = 10240
    bank = rng.normal(size=(G, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank_dev = torch.from_numpy(bank).to(dev)

    def two_dispatch():
        with torch.no_grad():
            _d, feats = step()
            q = feats.reshape(-1, 512).cpu()  # host read between the stages
            v, _i = topk_stable(similarity_matrix(q.to(dev), bank_dev), 5)
            return v.cpu()

    def one_dispatch():
        with torch.no_grad():
            _d, _f, v, _i = fused.frames_to_matches(
                det_params, arc_params, frames, bank_dev, G, cfg,
                max_faces_embed=FACES_PER_FRAME, top_k=5)
            return v.cpu()

    t0 = time.perf_counter()
    two_dispatch()
    one_dispatch()
    log(f"identify A/B first runs {time.perf_counter() - t0:.1f}s")
    two, one = [], []
    for samples_of, fn in ((two, two_dispatch), (one, one_dispatch)):
        for _ in range(20):
            t1 = time.perf_counter()
            fn()
            samples_of.append(time.perf_counter() - t1)

    return {
        "metric": "single-frame e2e latency, detect+align+embed K=8 (device)",
        "value": round(device_ms, 2),
        "unit": "ms/frame",
        "vs_baseline": None,
        "detail": {
            "chain": CHAIN,
            "outer": outer,
            "chain_ms_per_frame": [round(r, 3) for r in rounds],
            "wall_per_call": _percentiles(samples),
            "note": "value: mean over `outer` rounds of CHAIN back-to-back steps between "
                    "two CUDA events (host launch gaps that the device waits for "
                    "included); wall_per_call: one synchronized call",
            "serving_identify": {
                "gallery_rows": G,
                "two_dispatch_wall": _percentiles(two),
                "fused_one_dispatch_wall": _percentiles(one),
                "note": "identify = frame -> features -> gallery top-5 (the dense "
                        "search); fused = frames_to_matches, one host read",
            },
            "device": _device_info(dev),
            "launches": launches,
        },
    }


def bench_enroll(args, cfg, arc_params, log):
    """Batched enrollment embed: 256 seeded uint8 crops through
    `embed_crops`, 30 calls between two synchronizations."""
    dev = args.device
    rng = np.random.default_rng(0)
    batch = 256
    crops = torch.from_numpy(rng.integers(0, 256, (batch, 112, 112, 3), dtype=np.uint8)).to(dev)
    INNER, outer = 10, 3

    def call():
        with torch.no_grad():
            return embed_crops(arc_params, crops, cfg)

    call()
    _sync(dev)
    launches = {}
    with _counted(launches):
        t0 = time.perf_counter()
        for _ in range(outer * INNER):
            call()
        _sync(dev)
        rate = batch * outer * INNER / (time.perf_counter() - t0)
    return {
        "metric": "batched enrollment embed throughput",
        "value": round(rate, 1), "unit": "faces/sec",
        "vs_baseline": None,
        "detail": {"batch": batch, "calls": outer * INNER,
                   "gallery_256_seconds": round(256 / rate, 3),
                   "device": _device_info(dev), "launches": launches},
    }


def gallery_methods(gallery, k):
    """The gallery config's search methods over `gallery` ((G, D) rows on
    their device), each a function of (Q, D) queries → ((Q, k) sims,
    (Q, k) int32 indices): the dense reference, the bf16 bank at rest
    (cast once here, as `GalleryBank` caches it), the exact tiled top-k
    with 512-row tiles, and the streaming kernel as
    `GalleryBank.search(method="cuda")` calls it."""
    g16 = gallery.to(torch.bfloat16)
    return {
        "dense": lambda q: gallery_cuda.gallery_topk_reference(q, gallery, k),
        "bf16_at_rest": lambda q: gallery_cuda.gallery_topk_reference(q, g16, k, torch.bfloat16),
        "tiled512": lambda q: gallery_cuda.gallery_topk_tiled(q, gallery, k, tile=512),
        "gallery_topk_cuda": lambda q: gallery_cuda.gallery_topk_cuda(q, gallery, k),
    }


def bench_gallery(args, log):
    """1:N search of 128 queries (the first 128 rows) against 100,000
    seeded L2-normalized 512-d rows, top 5: each method's queries/s
    between CUDA events over 60 back-to-back searches. A method that
    raises fails the config. The value is the kernel's rate."""
    dev = args.device
    rng = np.random.default_rng(0)
    g = rng.normal(size=(100_000, 512)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    gd = torch.from_numpy(g).to(dev)
    q = gd[:128].contiguous()
    INNER, outer = 20, 3

    rates = {}
    launches = {}
    for name, fn in gallery_methods(gd, 5).items():
        with torch.no_grad():
            fn(q)
            _sync(dev)
            with _counted(launches) if name == "gallery_topk_cuda" else contextlib.nullcontext():
                ms = _elapsed_ms(dev, lambda: fn(q), outer * INNER)
        rates[name] = 128 * 1000.0 / ms
        log(f"gallery {name}: {rates[name]:.1f} queries/s")
    kernel = rates["gallery_topk_cuda"]
    fastest = max(rates, key=rates.get)
    detail = {k: round(v, 1) for k, v in rates.items()}
    detail.update({
        "rows": 100_000, "queries": 128, "k": 5, "searches_timed": outer * INNER,
        "fastest": fastest,
        "device": _device_info(dev), "launches": launches,
    })
    if fastest != "gallery_topk_cuda":
        detail["note"] = (f"{fastest} beats the kernel here "
                          f"({rates[fastest]:.1f} against {kernel:.1f} queries/s)")
    return {
        "metric": "1:N identification, 100k gallery top-5 (gallery_topk kernel)",
        "value": round(kernel, 1), "unit": "queries/sec",
        "vs_baseline": None,
        "detail": detail,
    }


def _probe_hbm_gbps(log, device):
    """Device memory read rate (GB/s): a 256 MB float32 tensor summed
    20 times back to back between two CUDA events (the host clock on
    the CPU), after one warm-up sum."""
    x = torch.randn(64 * 2**20, device=device)
    reps = 20
    x.sum()
    _sync(device)
    ms = _elapsed_ms(device, x.sum, reps)
    rate = round(x.numel() * 4 / (ms / 1000.0) / 1e9, 1)
    log(f"device memory read probe: {rate} GB/s")
    return rate


def bench_video(args, cfg, det_params, arc_params, log):
    """1080p frame loop: `VideoPipeline` (host letterbox in the prefetch
    thread, micro-batches of `batch` frames through the fused step,
    each face matched against a reference feature) over
    batch × iters synthetic 1920x1080 frames."""
    dev = args.device
    h2d_mbps = _probe_h2d_rate_mbps(log, dev)
    pipe = VideoPipeline(det_params, arc_params, cfg, batch=args.batch, device=dev)
    ref = np.zeros(512, np.float32)
    warm = VideoSource("synthetic:1920x1080x%d" % (2 * args.batch))
    for _ in pipe.run(warm.frames(), ref_feature=ref):
        pass
    pipe.counter = Counter("frames")

    src = VideoSource("synthetic:1920x1080x%d" % (args.batch * args.iters))
    n = 0
    launches = {}
    with _counted(launches):
        for _ in pipe.run(src.frames(), ref_feature=ref):
            n += 1
    stats = pipe.stats()
    fps = stats["frames_per_sec"]
    return {
        "metric": "1080p video stream detect+verify",
        "value": round(fps, 1), "unit": "frames/sec",
        "vs_baseline": None,
        "detail": {
            "frames": n, "batch": args.batch,
            "p50_ms": round(stats["p50_ms"], 2),
            "p99_ms": round(stats["p99_ms"], 2),
            "h2d_link_mbytes_per_sec": h2d_mbps,
            "note": "p50/p99: per micro-batch, the host side of a dispatch "
                    "(upload and launch); frames/sec over the whole stream",
            "device": _device_info(dev),
            "launches": launches,
        },
    }


# ---------------------------------------------------------------- main


def _parser():
    ap = argparse.ArgumentParser(prog="python -m facerecognizeonnx_tpu_torch.bench")
    ap.add_argument("--batch", type=int, default=None,
                    help="frames per step (default: 128 on the card, 2 with --cpu)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    ap.add_argument("--json-only", action="store_true", help="no progress lines on stderr")
    ap.add_argument(
        "--config", default="all", choices=CONFIGS + ("all", "selftest"),
        help="the config to run; 'all' (default) runs " + ", ".join(ORDER)
        + " and reports headline as the top-level metric",
    )
    ap.add_argument("--detail", default="bench_detail.json", metavar="PATH",
                    help="where 'all' writes the full document")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the selected config to "
                    "DIR/trace.json; single-config runs only")
    ap.add_argument("--_state", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args._state is None:
        fd, args._state = tempfile.mkstemp(prefix="frt_bench_", suffix=".json")
        os.close(fd)
    state = _load_state(args._state)
    state["reexecs"] = state.get("reexecs", 0) + (
        1 if state["results"] or state["attempts"] else 0)
    state.setdefault("t_start", time.time())
    try:
        with _stdout_to_stderr():
            _main(args, argv, state)
    finally:
        with contextlib.suppress(OSError):
            os.unlink(args._state)
    return 0


def _main(args, argv, state):
    def log(*a):
        if not args.json_only:
            print(*a, file=sys.stderr, flush=True)

    if args.config == "selftest":
        # the watchdog's plumbing, no torch: hangs on the first attempt
        # when FRT_BENCH_TEST_HANG is set, passes on the retry
        name = "selftest"
        wd = _Watchdog(args._state, state, [name], argv, args.detail)
        attempt = state["attempts"].get(name, 0)
        state["attempts"][name] = attempt + 1
        _save_state(args._state, state)
        wd.arm(name)
        if os.environ.get("FRT_BENCH_TEST_HANG") and attempt == 0:
            while True:
                time.sleep(3600)
        wd.disarm()
        print(json.dumps({
            "metric": "bench watchdog selftest", "value": 1.0, "unit": "ok",
            "vs_baseline": None, "detail": {"attempt": attempt,
                                            "reexecs": state["reexecs"]},
        }), file=_out(), flush=True)
        return

    args.device = resolve_device("cpu" if args.cpu else "cuda")
    if args.batch is None:
        args.batch = 128 if args.device.type == "cuda" else 2
    # all K slots are embedded whether or not a detection occupies them
    cfg = PipelineConfig(compute_dtype="bfloat16", warp_impl="cuda", skip_invalid_faces=False)
    log(f"device: {_device_info(args.device)} warp={cfg.warp_impl} batch={args.batch}")

    t0 = time.perf_counter()
    dev = args.device
    det, r50 = _detector(dev), _r50(dev)
    log(f"init {time.perf_counter() - t0:.1f}s")
    runners = _runners(args, cfg, det, r50, log)

    if args.config != "all":
        name = args.config
        wd = _Watchdog(args._state, state, [name], argv, args.detail)
        state["attempts"][name] = state["attempts"].get(name, 0) + 1
        _save_state(args._state, state)
        current = {"name": name}
        with _sigterm_emits(state, [name], args.detail, current):
            wd.arm(name)
            if args.profile:
                with trace(args.profile):
                    out = runners[name]()
                log(f"profiler trace written to {os.path.join(args.profile, 'trace.json')}")
            else:
                out = runners[name]()
            wd.disarm()
        print(json.dumps(out), file=_out(), flush=True)
        return
    if args.profile:
        log("--profile needs a single --config; ignoring it for 'all'")

    def probes():
        return {
            "_hbm_gbps": _probe_hbm_gbps(log, dev),
            "_h2d_mbps": _probe_h2d_rate_mbps(log, dev),
            "_card": _device_info(dev),
        }

    run_configs(ORDER, runners, state, args._state, argv, args.detail, log, probes)


def _runners(args, cfg, det, r50, log):
    """Config name → a function of no arguments returning its result."""
    dev = args.device

    def headline_family(rec, metric, run_cfg=cfg, valid_cap=None):
        def run():
            out = bench_headline(args, run_cfg, det, rec(), log, valid_cap=valid_cap)
            out["metric"] = metric
            return out
        return run

    def headline_onnx():
        """Both models from .onnx files: the seeded unfolded models
        exported with the port's writer; the detector runs through
        `OnnxRunner`'s graph executor, the recognizer is mapped onto the
        native IResNet-50 (and folded), as `FaceRecognizer.load_model`
        maps a real w600k_r50.onnx."""
        with tempfile.TemporaryDirectory() as d:
            dpath = os.path.join(d, "det_500m_rt.onnx")
            rpath = os.path.join(d, "w600k_r50_rt.onnx")
            export_detector(_detector(dev, folded=False), path=dpath,
                            input_size=cfg.det_input_size)
            export_recognizer(_r50(dev, folded=False), path=rpath)
            runner = OnnxRunner(dpath, device=dev)
            mapped = map_recognizer(rpath, "iresnet50", device=dev)
            if mapped is None:
                raise RuntimeError(
                    "native_map rejected the exported w600k_r50-shaped .onnx; the "
                    "deployment fast path regressed"
                )
            rec = arcface.fold_inference_params(mapped)
        out = bench_headline(args, cfg, runner, rec, log)
        out["metric"] = ("faces/sec/chip end-to-end (both models from .onnx: "
                         "executor detect + native-mapped embed)")
        return out

    cfg_occ = dataclasses.replace(cfg, skip_invalid_faces=True)
    return {
        "headline": lambda: bench_headline(args, cfg, det, r50, log),
        "headline_mbf": headline_family(
            lambda: _mbf(dev), "faces/sec/chip end-to-end (detect+align+mbf embed)"),
        "headline_q8": headline_family(
            lambda: _q8(r50, 3, dev), "faces/sec/chip end-to-end (detect+align+int8 embed)"),
        "headline_mbf_q8": headline_family(
            lambda: _q8(_mbf(dev), 4, dev),
            "faces/sec/chip end-to-end (detect+align+int8 mbf embed)"),
        "headline_onnx": headline_onnx,
        "headline_occ": headline_family(
            lambda: r50, "faces/sec/chip end-to-end, 2/8 occupancy "
            "(production-default valid-skip)", run_cfg=cfg_occ, valid_cap=2),
        "headline_occ_adaptive": lambda: bench_occ_adaptive(
            args, cfg, det, r50, log, stage_split=True),
        "headline_occ_adaptive_mbf": lambda: bench_occ_adaptive(
            args, cfg, det, _mbf(dev), log, label=" x mbf"),
        "headline_occ_adaptive_q8": lambda: bench_occ_adaptive(
            args, cfg, det, _q8(r50, 3, dev), log, label=" x int8 r50"),
        "serve": lambda: bench_serve(args, cfg, det, r50, log),
        "latency": lambda: bench_latency(args, cfg, det, r50, log),
        "enroll": lambda: bench_enroll(args, cfg, r50, log),
        "gallery": lambda: bench_gallery(args, log),
        "video": lambda: bench_video(args, cfg, det, r50, log),
    }


if __name__ == "__main__":
    sys.exit(main())
