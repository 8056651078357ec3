"""Micro-batching identification service.

Port of `facerecognizeonnx_tpu/pipeline/service.py` (single device).
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

Not ported yet, and raising NotImplementedError: sharded and mesh
(ROADMAP.md Queue A item 16).
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

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.ops.image import letterbox_host
from facerecognizeonnx_tpu_torch.pipeline.aot import load_bundle
from facerecognizeonnx_tpu_torch.pipeline.bucketed import BucketedEmbedPipeline
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features, frames_to_matches
from facerecognizeonnx_tpu_torch.types import Detections

UNPORTED = {
    "sharded": "sharded gallery rows (ROADMAP.md Queue A item 16)",
    "mesh": "data-parallel serving over a mesh (ROADMAP.md Queue A item 16)",
}


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
    ):
        """det_params / arc_params: the SCRFD and recognizer modules (e.g.
        `FaceDetector.params`, `FaceRecognizer.params`) on `device`; unused
        (may be None) with aot, whose bundle is loaded onto `device` when
        given as a path."""
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
        for name, value in (("sharded", sharded), ("mesh", mesh)):
            if value:
                raise NotImplementedError(f"{UNPORTED[name]} is not ported yet")
        if isinstance(aot, str):
            aot = load_bundle(aot, device=device)
        self.device = aot.device if aot is not None else resolve_device(device)
        if aot is not None:
            cfg, max_batch, max_faces = aot.config, aot.batch, aot.max_faces_embed
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
                search_top_k=search_top_k if fuse_search else None, device=self.device,
            )
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._batches_run = 0
        self._requests_served = 0
        # rolling enqueue→result wall latency window (ms), for stats()
        self._lat: "deque[float]" = deque(maxlen=1024)
        self._worker = threading.Thread(target=self._run, daemon=True)
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

    def _safe_resolve(self, ctx):
        try:
            self._resolve(ctx)
        except Exception as e:  # the batch's requests carry the error
            for req in ctx["batch"]:
                if not req.future.done():
                    req.future.set_exception(e)

    def _dispatch(self, batch: List[_Request]) -> dict:
        """Host letterbox + device program launch (nothing waits for the
        device here)."""
        frames, scales = [], []
        for req in batch:
            padded, scale = self._letterbox(req.image)
            frames.append(padded)
            scales.append(scale)
        stacked = np.stack(frames + [frames[-1]] * (self.max_batch - len(frames)))
        x = torch.from_numpy(stacked).to(self.device, non_blocking=True)
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
                else:
                    ctx["out"] = frames_to_matches(
                        self.det, self.arc, x, bank_dev, n_rows, self.cfg,
                        self.max_faces, self.search_top_k, valid_cap=self.valid_cap,
                    )
            elif self.adaptive:
                ctx["handle"] = self._bucketed.start(x, n_frames=len(batch))
            else:
                ctx["out"] = frames_to_features(
                    self.det, self.arc, x, self.cfg, self.max_faces,
                    valid_cap=self.valid_cap,
                )
        return ctx

    def _resolve(self, ctx: dict):
        """Host fetch + per-request postprocess and future resolution."""
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
        for i, req in enumerate(batch):
            valid = valid_all[i][: self.max_faces]
            k = int(valid.sum())
            names: List[List[str]] = [[] for _ in range(self.max_faces)]
            sims = np.zeros((self.max_faces, req.top_k), np.float32)
            if k and n_rows and (not self.fuse_search or req.top_k > self.search_top_k):
                # the host-side search, on the dispatch's snapshot; a
                # request wider than the fused width takes it too, so it
                # never gets fewer matches than default serving
                n, s = self.bank._search(store, feats[i][:k], req.top_k)
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
            req.future.set_result(
                IdentifyResult(
                    boxes=boxes[i][: self.max_faces] * inv,
                    scores=scores[i][: self.max_faces],
                    valid=valid,
                    names=names,
                    sims=sims,
                )
            )
            self._requests_served += 1
            self._lat.append((time.perf_counter() - req.t_enqueue) * 1e3)
