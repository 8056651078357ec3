"""Micro-batching identification service.

Port of `facerecognizeonnx_tpu/pipeline/service.py`.
Concurrent callers submit frames; a worker thread coalesces them into
micro-batches (letterbox on the host, with the native runtime's
`letterbox_native` where it builds, as the reference does → detect +
align + embed on the device → gallery search) and resolves their
futures. The worker is pipelined one batch deep: batch N resolves right
after batch N+1 is dispatched, or at once when the queue is empty.

  default            two dispatches: `frames_to_features`, then
                     `GalleryBank.search` on the host side
  fuse_search=True   one dispatch: `frames_to_matches` against the bank's
                     power-of-two padded device copy
  adaptive_embed     either mode through the occupancy-adaptive
                     `BucketedEmbedPipeline` (pipeline/bucketed.py): the
                     embed packs the detected faces of the micro-batch
                     into a bucket sized by recent occupancy; pad frames
                     of a partial batch are left out of the occupancy
  aot                a `.frtz` bundle (path or `AotPipeline`,
                     pipeline/aot.py) gives the features: on the card
                     one CUDA-graph replay per micro-batch; the search
                     stays `GalleryBank.search`. The bundle fixes the
                     config, max_batch and max_faces; it excludes
                     fuse_search, mesh, adaptive_embed and valid_cap

Each micro-batch is answered against the bank version taken once at its
dispatch (names, rows and length from one snapshot), so a bank that
grows or shrinks before the batch resolves cannot misalign names with
rows. (The reference package reads the bank length again at resolve.)

Knobs: max_batch (device batch), batch_window_ms (how long to wait for
co-riders before dispatching a partial batch), max_faces (embed slots
per frame), search_top_k (the fused program's width), valid_cap (a
benchmark control, see `pipeline.fused.detect_topk`).

Parallel serving (`parallel/`): `mesh` (a mesh, or an int n for the
first min(n, world) ranks) runs each micro-batch data-parallel over the
mesh's `mesh_axis` (`make_dp_program`, or the bucketed pipeline's mesh
form with adaptive_embed); `sharded` spreads the gallery rows of the
host-side search over the default "model" mesh. Every rank runs a
service and submits the same requests in the same order. Then the
service's collectives all run on its worker thread, and the workers
agree on each micro-batch: one all-reduce over the ranks settles how
many of the held requests it takes (the fewest any rank holds) and when
every rank has closed, and each batch is resolved right after its
dispatch. So every rank issues the same collectives in the same order,
whatever the timing of its callers. Bank updates through `update_bank`
join the same queue there: a micro-batch never spans one, and each rank
applies it after the same batches, so every rank answers each batch
against the same bank.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.ops.image import letterbox_host
from facerecognizeonnx_tpu_torch.pipeline.aot import load_bundle
from facerecognizeonnx_tpu_torch.pipeline.bucketed import BucketedEmbedPipeline
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features, frames_to_matches
from facerecognizeonnx_tpu_torch.types import Detections
from facerecognizeonnx_tpu_torch.utils import observability
from facerecognizeonnx_tpu_torch.utils.observability import span

@dataclass
class IdentifyResult:
    boxes: np.ndarray  # (K, 4) original-image pixels
    scores: np.ndarray  # (K,)
    valid: np.ndarray  # (K,) bool
    names: List[List[str]]  # per valid face slot
    sims: np.ndarray  # (K, top_k)


@dataclass
class _Request:
    image: np.ndarray
    top_k: int
    future: Future = field(default_factory=Future)
    t_enqueue: float = 0.0


@dataclass
class _BankUpdate:
    method: str  # "add" or "remove", a GalleryBank mutator
    args: tuple
    future: Future = field(default_factory=Future)

    def apply(self, bank: GalleryBank) -> None:
        try:
            self.future.set_result(getattr(bank, self.method)(*self.args))
        except Exception as e:  # the caller's future carries the error
            self.future.set_exception(e)


class IdentifyService:
    def __init__(
        self,
        det_params,
        arc_params,
        bank: GalleryBank,
        cfg: PipelineConfig = PipelineConfig(),
        max_batch: int = 8,
        batch_window_ms: float = 5.0,
        max_faces: int = 8,
        sharded: bool = False,
        aot=None,
        mesh=None,
        fuse_search: bool = False,
        search_top_k: int = 5,
        adaptive_embed: bool = False,
        valid_cap: Optional[int] = None,
        device="cuda",
        mesh_axis: str = "data",
    ):
        """det_params / arc_params: the SCRFD and recognizer modules (e.g.
        `FaceDetector.params`, `FaceRecognizer.params`) on `device`; unused
        (may be None) with aot, whose bundle is loaded onto `device` when
        given as a path. With `mesh` the models are placed on the rank's
        device of the mesh, and max_batch is rounded up to a multiple of
        the axis size."""
        if fuse_search and sharded:
            raise ValueError(
                "fuse_search composes with mesh dp, but not with sharded gallery rows "
                "(those keep the two-dispatch path)"
            )
        if fuse_search and aot is not None:
            raise ValueError(
                "fuse_search does not compose with aot bundles (a bundle gives the "
                "features; the search stays GalleryBank.search)"
            )
        if aot is not None and mesh is not None:
            raise ValueError(
                "aot and mesh are mutually exclusive: .frtz bundles are single-device "
                "programs (export one per card and balance above the service instead)"
            )
        if aot is not None and (adaptive_embed or valid_cap is not None):
            raise ValueError(
                "adaptive_embed/valid_cap need the live programs; .frtz bundles bake "
                "the dense step (serve without aot)"
            )
        if mesh is not None and valid_cap is not None and not adaptive_embed:
            raise ValueError(
                "valid_cap (bench control) supports the single-device paths and "
                "adaptive_embed only"
            )
        if isinstance(aot, str):
            aot = load_bundle(aot, device=device)
        self.device = aot.device if aot is not None else resolve_device(device)
        if aot is not None:
            cfg, max_batch, max_faces = aot.config, aot.batch, aot.max_faces_embed
        self.sharded = sharded
        self.mesh = None
        self._program = None
        if mesh is not None or sharded:
            from facerecognizeonnx_tpu_torch.parallel import mesh as pm
            from facerecognizeonnx_tpu_torch.parallel.sharded_ops import make_dp_program

            # every group is built here, in every rank's program order
            pm.ensure_process_group(self.device)
            if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
                n = min(int(mesh), dist.get_world_size())
                mesh = pm.make_mesh((mesh_axis,), ranks=range(n), device=self.device)
            if sharded:
                pm.make_mesh(("model",), device=bank.device)
            self._agree_group = pm.world_group(self.device.type)
            if mesh is not None:
                self.mesh = mesh
                self.device = pm.mesh_device(mesh)
                n = pm.axis_size(mesh, mesh_axis)
                max_batch = -(-max_batch // n) * n
                if not adaptive_embed:
                    self._program, _ = make_dp_program(
                        det_params, arc_params, cfg, mesh=mesh, axis=mesh_axis,
                        max_faces_embed=max_faces,
                        search_top_k=search_top_k if fuse_search else None,
                    )
        self.aot = aot
        self.det, self.arc = det_params, arc_params
        self.cfg = cfg
        self.bank = bank
        self.max_batch = max_batch
        self.window_s = batch_window_ms / 1e3
        self.max_faces = max_faces
        self.fuse_search = fuse_search
        self.search_top_k = search_top_k
        self.valid_cap = valid_cap
        self.adaptive = adaptive_embed
        if adaptive_embed:
            self._bucketed = BucketedEmbedPipeline(
                det_params, arc_params, cfg, max_faces_embed=max_faces, valid_cap=valid_cap,
                search_top_k=search_top_k if fuse_search else None, mesh=self.mesh,
                mesh_axis=mesh_axis, device=self.device,
            )
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._batches_run = 0
        self._requests_served = 0
        # rolling enqueue→result wall latency window (ms), for stats()
        self._lat: "deque[float]" = deque(maxlen=1024)
        self._collective = self.mesh is not None or sharded
        self._worker = threading.Thread(
            target=self._run_agreed if self._collective else self._run, daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- client

    def identify_async(self, image_bgr: np.ndarray, top_k: int = 1) -> Future:
        req = _Request(image=image_bgr, top_k=top_k, t_enqueue=time.perf_counter())
        self._q.put(req)
        return req.future

    def identify(
        self, image_bgr: np.ndarray, top_k: int = 1, timeout: float = 120.0
    ) -> IdentifyResult:
        return self.identify_async(image_bgr, top_k).result(timeout)

    def update_bank(self, method: str, *args) -> Future:
        """`bank.add(name, feature)` or `bank.remove(name)`, resolved in the
        returned future. A mesh or sharded service applies it on its
        worker between micro-batches, in the order of the queue (module
        docstring); any other applies it now."""
        if method not in ("add", "remove"):
            raise ValueError(f"update_bank: {method!r} is not a bank update (add, remove)")
        update = _BankUpdate(method, args)
        if self._collective:
            self._q.put(update)
        else:
            update.apply(self.bank)
        return update.future

    def stats(self):
        out = {
            "batches": self._batches_run,
            "requests": self._requests_served,
            "avg_batch": self._requests_served / max(1, self._batches_run),
        }
        if self._lat:
            # snapshot: the worker thread appends concurrently
            lat = np.fromiter(list(self._lat), np.float64)
            out["latency_ms"] = {
                "p50": round(float(np.percentile(lat, 50)), 3),
                "p90": round(float(np.percentile(lat, 90)), 3),
                "p99": round(float(np.percentile(lat, 99)), 3),
                "window": int(lat.size),
            }
        if observability.enabled():
            # the tracer's tallies are the process's: every pipeline's
            # spans since its last reset, in calls and host ms
            spans = observability.snapshot()["spans"]
            out["spans"] = {k: {"calls": v["calls"], "host_ms": round(v["host_s"] * 1e3, 3)}
                            for k, v in spans.items()}
        return out

    def close(self):
        """Stop the worker after it has served every queued request."""
        self._q.put(None)
        self._worker.join(timeout=30)

    # ------------------------------------------------------------- worker

    def _letterbox(self, image: np.ndarray) -> Tuple[np.ndarray, float]:
        return letterbox_host(image, self.cfg.det_input_size)

    def _run(self):
        closed = False
        pending = None  # dispatched-but-unresolved previous batch
        while not closed:
            try:
                first = self._q.get(timeout=0.25)
            except queue.Empty:
                if pending is not None:
                    self._safe_resolve(pending)
                    pending = None
                continue
            if first is None:
                break
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    closed = True
                    break
                batch.append(nxt)
            try:
                ctx = self._dispatch(batch)
            except Exception as e:  # a failed batch fails its requests only
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
                ctx = None
            if pending is not None:
                self._safe_resolve(pending)
                pending = None
            if ctx is not None:
                if closed or self._q.empty():
                    self._safe_resolve(ctx)
                else:
                    pending = ctx
        if pending is not None:
            self._safe_resolve(pending)

    def _agree(self, held: int, open_: bool) -> Tuple[int, bool]:
        """One all-reduce over the ranks: (the fewest requests any rank
        holds, whether every rank has closed with nothing held)."""
        v = torch.tensor([held, -held, int(open_), -int(open_)], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=self._agree_group)
        n_min, n_max, open_max = int(v[0]), -int(v[1]), -int(v[3])
        return n_min, n_max == 0 and open_max == 0

    def _run_agreed(self):
        """The worker of a mesh or sharded service: the ranks agree on
        every batch (module docstring), and each batch resolves right
        after its dispatch."""
        if self.device.type == "cuda":  # the rank's device, on this thread too
            torch.cuda.set_device(self.device)
        # requests, and at most one bank update behind them: a batch takes
        # only requests that came before it, and the update is applied
        # once they are all dispatched, with nothing held
        held: "deque[_Request]" = deque()
        update: Optional[_BankUpdate] = None
        closed = False
        while True:
            if update is not None and not held:
                update.apply(self.bank)
                update = None
            if not closed and update is None:
                deadline = time.perf_counter() + self.window_s if held else None
                while len(held) < self.max_batch:
                    timeout = 0.25 if deadline is None else deadline - time.perf_counter()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if nxt is None:
                        closed = True
                        break
                    if isinstance(nxt, _BankUpdate):
                        if held:
                            update = nxt
                            break
                        nxt.apply(self.bank)
                        continue
                    held.append(nxt)
                    if deadline is None:
                        deadline = time.perf_counter() + self.window_s
            n, done = self._agree(len(held), not closed)
            if done:
                break
            n = min(n, self.max_batch)
            if n == 0:
                continue
            batch = [held.popleft() for _ in range(n)]
            try:
                ctx = self._dispatch(batch)
            except Exception as e:  # a failed batch fails its requests only
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
                continue
            self._safe_resolve(ctx)

    def _safe_resolve(self, ctx):
        try:
            self._resolve(ctx)
        except Exception as e:  # the batch's requests carry the error
            for req in ctx["batch"]:
                if not req.future.done():
                    req.future.set_exception(e)

    def _dispatch(self, batch: List[_Request]) -> dict:
        """Host letterbox + device program launch (waiting for the device
        only where the program's post-processing uploads constants from
        host memory: the tracer's `host_waits`)."""
        frames, scales = [], []
        with span("letterbox"):
            for req in batch:
                padded, scale = self._letterbox(req.image)
                frames.append(padded)
                scales.append(scale)
        with span("stack"):
            stacked = np.stack(frames + [frames[-1]] * (self.max_batch - len(frames)))
            x = torch.from_numpy(stacked)
        if self.mesh is None:  # a mesh program moves each rank's block itself
            with span("upload"):
                x = x.to(self.device, non_blocking=True)
        # ONE bank snapshot answers this whole batch
        store = self.bank._store
        ctx = {"batch": batch, "scales": scales, "store": store}
        with torch.no_grad():
            if self.aot is not None:
                boxes, scores, kps, valid, feats = self.aot(x)
                ctx["out"] = (Detections(boxes, scores, kps, valid), feats)
            elif self.fuse_search:
                # an empty bank still runs the fused program: n_rows=0
                # masks every sim and the names stay empty
                bank_dev, n_rows, _ = self.bank.device_bank_padded(store=store)
                if self.adaptive:
                    ctx["handle"] = self._bucketed.start(
                        x, n_frames=len(batch), bank_padded=bank_dev, n_rows=n_rows
                    )
                elif self._program is not None:
                    ctx["out"] = self._program(x, bank_dev, n_rows)
                else:
                    ctx["out"] = frames_to_matches(
                        self.det, self.arc, x, bank_dev, n_rows, self.cfg,
                        self.max_faces, self.search_top_k, valid_cap=self.valid_cap,
                    )
            elif self.adaptive:
                ctx["handle"] = self._bucketed.start(x, n_frames=len(batch))
            elif self._program is not None:
                ctx["out"] = self._program(x)
            else:
                ctx["out"] = frames_to_features(
                    self.det, self.arc, x, self.cfg, self.max_faces,
                    valid_cap=self.valid_cap,
                )
        return ctx

    def _resolve(self, ctx: dict):
        """Host fetch + per-request postprocess, then the futures: set after
        the `resolve` span closes, so that a caller holding its result reads
        stats that count its batch."""
        with span("resolve"):
            results = self._resolve_batch(ctx)
        for req, result in results:
            req.future.set_result(result)

    def _resolve_batch(self, ctx: dict) -> List[Tuple[_Request, IdentifyResult]]:
        batch, scales, store = ctx["batch"], ctx["scales"], ctx["store"]
        n_rows = len(store.names)
        wide = any(r.top_k > self.search_top_k for r in batch)
        # the bucketed pipeline's results, less its n_valid, have the dense
        # programs' layout
        out = self._bucketed.finish(ctx["handle"])[:-1] if self.adaptive else ctx["out"]
        if self.fuse_search:
            dets, feats, f_sims, f_idx = out
            f_sims, f_idx = f_sims.cpu().numpy(), f_idx.cpu().numpy()
        else:
            dets, feats = out
        # the fused path needs the features on the host only for a
        # request wider than its baked top-k
        if not self.fuse_search or (n_rows and wide):
            feats = feats.cpu().numpy()
        boxes, scores, valid_all = (t.cpu().numpy() for t in (dets.boxes, dets.scores, dets.valid))
        self._batches_run += 1
        results = []
        for i, req in enumerate(batch):
            valid = valid_all[i][: self.max_faces]
            k = int(valid.sum())
            names: List[List[str]] = [[] for _ in range(self.max_faces)]
            sims = np.zeros((self.max_faces, req.top_k), np.float32)
            if k and n_rows and (not self.fuse_search or req.top_k > self.search_top_k):
                # the host-side search, on the dispatch's snapshot; a
                # request wider than the fused width takes it too, so it
                # never gets fewer matches than default serving
                n, s = self.bank._search(store, feats[i][:k], req.top_k, self.sharded)
                for j in range(k):
                    names[j] = n[j]
                    sims[j, : len(s[j])] = s[j]
            elif self.fuse_search and k:
                # the first min(t, n_rows) entries are real rows (pad rows
                # were masked to sim −1 and sort last)
                t = min(req.top_k, self.search_top_k, n_rows)
                for j in range(k):
                    names[j] = [store.names[ii] for ii in f_idx[i, j, :t]]
                    sims[j, :t] = f_sims[i, j, :t]
            inv = 1.0 / scales[i]
            results.append((req, IdentifyResult(
                boxes=boxes[i][: self.max_faces] * inv,
                scores=scores[i][: self.max_faces],
                valid=valid,
                names=names,
                sims=sims,
            )))
            self._requests_served += 1
            self._lat.append((time.perf_counter() - req.t_enqueue) * 1e3)
        return results
