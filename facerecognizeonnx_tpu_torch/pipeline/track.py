"""Face tracking + embedding cache for video streams.

Port of `facerecognizeonnx_tpu/pipeline/track.py`. The reference
re-embeds every face of every frame; here an IOU tracker associates
detections across frames, each track carries a cached (momentum-
smoothed) feature, and only frames holding a NEW track or a track due
for refresh run the full detect + align + embed path — every other frame
runs detection only. Labels (Match / Unknown against a reference feature
at 0.6 on the (cos+1)/2 scale, or the 1:N top-1 of a gallery) come from
the track's cached feature.

The tracker is numpy on the host; detection
(`detect.pipeline.detect_batch_program`) and the refresh
(`pipeline.fused.frames_to_features`, or the occupancy-adaptive
`BucketedEmbedPipeline` with adaptive_embed=True) run on `device` at a
fixed micro-batch (pad-by-repeat). Frames are letterboxed on the host
(`ops.image.letterbox_host`: the native runtime, else torch), as the
video pipeline does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.detect.pipeline import detect_batch_program
from facerecognizeonnx_tpu_torch.ops.image import letterbox_host
from facerecognizeonnx_tpu_torch.pipeline.bucketed import BucketedEmbedPipeline
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features
from facerecognizeonnx_tpu_torch.types import Detections

# a refresh slot whose box moved farther than this (px) from the detect-only
# run's box holds another face (see TrackingVideoPipeline.slot_mismatches)
SLOT_BOX_TOL = 0.5


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) [x1,y1,x2,y2] → (N, M) IoU with the reference's
    +1 width convention: w = x2-x1+1. Degenerate boxes (x2 == x1) keep
    area 1, so an identical degenerate box re-detected next frame still
    matches its track at IoU 1.0 rather than 0/0."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)

    def canon(x):
        # inverted corners (x2 < x1) would zero their own area and never
        # self-match; association treats a box as its corner hull
        return np.concatenate(
            [np.minimum(x[:, :2], x[:, 2:]), np.maximum(x[:, :2], x[:, 2:])], axis=1
        )

    a, b = canon(np.asarray(a, np.float32)), canon(np.asarray(b, np.float32))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1.0, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return np.clip(x[:, 2] - x[:, 0] + 1.0, 0, None) * np.clip(
            x[:, 3] - x[:, 1] + 1.0, 0, None
        )

    union = area(a)[:, None] + area(b)[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


@dataclass
class Track:
    track_id: int
    box: np.ndarray  # (4,) letterboxed px
    score: float
    feature: Optional[np.ndarray] = None  # (512,) L2-normalized, cached
    hits: int = 1
    misses: int = 0
    frames_since_embed: int = 0  # counts from the last feature update
    label: str = ""
    label_dirty: bool = False  # feature changed since the last 1:N label

    def needs_embed(self, refresh_every: int) -> bool:
        return self.feature is None or self.frames_since_embed >= refresh_every


@dataclass
class IOUTracker:
    """Greedy IOU association (highest-IoU pairs first): unmatched
    detections open tracks, tracks missing for > max_misses frames
    close."""

    iou_threshold: float = 0.3
    max_misses: int = 5
    _next_id: int = 0
    tracks: List[Track] = field(default_factory=list)

    def update(self, boxes: np.ndarray, scores: np.ndarray) -> List[Track]:
        """boxes (N, 4) / scores (N,) for ONE frame's valid detections →
        the Track of each detection row (same order)."""
        n = len(boxes)
        ious = iou_matrix(
            np.stack([t.box for t in self.tracks]) if self.tracks
            else np.zeros((0, 4), np.float32),
            boxes,
        )
        matched_det = [None] * n
        used_t, used_d = set(), set()
        order = np.dstack(np.unravel_index(np.argsort(-ious, axis=None), ious.shape))
        for ti, di in order.reshape(-1, 2):
            if ious[ti, di] < self.iou_threshold:
                break
            if ti in used_t or di in used_d:
                continue
            used_t.add(int(ti))
            used_d.add(int(di))
            t = self.tracks[ti]
            t.box = boxes[di].copy()
            t.score = float(scores[di])
            t.hits += 1
            t.misses = 0
            t.frames_since_embed += 1
            matched_det[di] = t
        for di in range(n):
            if matched_det[di] is None:
                t = Track(self._next_id, boxes[di].copy(), float(scores[di]))
                self._next_id += 1
                self.tracks.append(t)
                matched_det[di] = t
        for ti, t in enumerate(self.tracks):
            if ti not in used_t and matched_det.count(t) == 0:
                t.misses += 1
        self.tracks = [t for t in self.tracks if t.misses <= self.max_misses]
        return matched_det


class TrackingVideoPipeline:
    """Video stream with per-track embedding cache.

    Per micro-batch of letterboxed frames:
      1. detection only (detect_batch_program) on the device
      2. the host IOU tracker assigns detections to tracks
      3. frames holding a track that needs_embed() run again through the
         refresh path, on a batch of those frames only; its slots are
         taken to hold the detect-only run's faces (same weights, same
         batch shape), and each track's feature updates with momentum
      4. labels from cached track features

    stats(): embed_frames / total_frames (plus the bucket and its
    corrections with adaptive_embed). `slot_mismatches` counts the
    refresh slots whose valid mask differs from the detect-only run's, or
    whose box moved more than SLOT_BOX_TOL px: a count above 0 means a
    track took another face's feature."""

    def __init__(
        self,
        det_params,
        arc_params,
        cfg: Optional[PipelineConfig] = None,
        batch: int = 4,
        max_faces_embed: int = 8,
        refresh_every: int = 32,
        iou_threshold: float = 0.3,
        max_misses: int = 5,
        feat_momentum: float = 0.9,
        adaptive_embed: bool = False,
        device="cuda",
    ):
        """det_params / arc_params: the SCRFD and recognizer modules on
        `device`. adaptive_embed=True refreshes through the bucketed
        pipeline (pipeline/bucketed.py): a refresh batch typically holds
        1-2 stale tracks of K slots, the low-occupancy case that path
        exists for."""
        self.device = resolve_device(device)
        self.cfg = cfg or PipelineConfig()
        self.det = det_params
        self.batch = batch
        self.k = max_faces_embed
        self.refresh_every = refresh_every
        self.momentum = feat_momentum
        self.tracker = IOUTracker(iou_threshold=iou_threshold, max_misses=max_misses)
        if adaptive_embed:
            self.bucketed = BucketedEmbedPipeline(
                det_params, arc_params, self.cfg, max_faces_embed, device=self.device
            )

            def embed(frames, n_real):
                return self.bucketed.finish(self.bucketed.start(frames, n_frames=n_real))[:2]
        else:
            self.bucketed = None

            def embed(frames, n_real):
                return frames_to_features(det_params, arc_params, frames, self.cfg,
                                          max_faces_embed)
        self._embed = embed
        self.total_frames = 0
        self.embed_frames = 0
        self.slot_mismatches = 0

    # ------------------------------------------------------------- internals

    def _letterboxed(self, frame_iter) -> Iterator:
        size = self.cfg.det_input_size
        for frame in frame_iter:
            yield letterbox_host(frame, size)

    def _update_feature(self, track: Track, feat: np.ndarray):
        feat = np.asarray(feat, np.float32)
        norm = np.linalg.norm(feat)
        if norm <= 0:
            return
        feat = feat / norm
        if track.feature is None:
            track.feature = feat
        else:
            mixed = self.momentum * track.feature + (1.0 - self.momentum) * feat
            track.feature = mixed / max(np.linalg.norm(mixed), 1e-9)
        track.frames_since_embed = 0
        track.label_dirty = True

    def _count_mismatches(self, dets: Detections, edets: Detections, rows: List[int]):
        k = self.k
        for row, i in enumerate(rows):
            v_d, v_e = dets.valid[i, :k], edets.valid[row, :k]
            moved = np.abs(dets.boxes[i, :k] - edets.boxes[row, :k]).max(-1) > SLOT_BOX_TOL
            self.slot_mismatches += int(((v_d != v_e) | (v_d & moved)).sum())

    # ------------------------------------------------------------------ run

    def run(
        self,
        frame_iter,
        ref_feature: Optional[np.ndarray] = None,
        match_threshold: Optional[float] = None,
        bank=None,
    ):
        """Yields (frame_idx, dets_dict, tracks) per frame: dets_dict has
        numpy boxes / scores / kps / valid (top-K slots, original-frame
        px), tracks the per-slot list of Track (None on invalid slots).

        Labeling: `bank` (a match.gallery.GalleryBank) labels each track
        with its 1:N top-1 identity at the match threshold — one batched
        search per micro-batch, only for tracks whose cached feature
        changed (label_dirty). Without a bank, `ref_feature` gives the
        reference's webcam Match / Unknown. bank wins if both are
        passed."""
        thr = self.cfg.match_threshold if match_threshold is None else match_threshold
        buf, scales = [], []
        n_out = 0

        def flush():
            nonlocal n_out
            if not buf:
                return
            n = len(buf)
            frames = np.stack(buf + [buf[-1]] * (self.batch - n))
            dev = torch.from_numpy(frames).to(self.device)
            with torch.no_grad():
                dets = detect_batch_program(self.det, dev, self.cfg)
            dets = Detections(*(t.cpu().numpy() for t in dets))
            k = self.k
            # host tracking pass over the real frames of this batch
            per_frame_tracks: List[List[Optional[Track]]] = []
            need_embed = []
            for i in range(n):
                idx = np.nonzero(dets.valid[i, :k])[0]
                assigned = self.tracker.update(dets.boxes[i, :k][idx], dets.scores[i, :k][idx])
                slots: List[Optional[Track]] = [None] * k
                for j, det_slot in enumerate(idx):
                    slots[int(det_slot)] = assigned[j]
                per_frame_tracks.append(slots)
                if any(t is not None and t.needs_embed(self.refresh_every) for t in slots):
                    need_embed.append(i)
            # the refresh runs ONLY for frames with stale / new tracks (the
            # adaptive path leaves the pad-by-repeat rows out of its occupancy)
            if need_embed:
                sel = need_embed + [need_embed[-1]] * (self.batch - len(need_embed))
                with torch.no_grad():
                    edets, feats = self._embed(dev[sel], len(need_embed))
                feats = feats.cpu().numpy()
                self._count_mismatches(
                    dets, Detections(*(t.cpu().numpy() for t in edets)), need_embed
                )
                for row, i in enumerate(need_embed):
                    for slot, t in enumerate(per_frame_tracks[i]):
                        if t is not None and t.needs_embed(self.refresh_every):
                            self._update_feature(t, feats[row, slot])
                self.embed_frames += len(need_embed)
            self.total_frames += n
            # labels: ONE batched 1:N search for every refreshed track
            if bank is not None and len(bank):
                fresh, seen = [], set()
                for slots in per_frame_tracks:
                    for t in slots:
                        if (t is not None and t.label_dirty and t.feature is not None
                                and id(t) not in seen):
                            seen.add(id(t))
                            fresh.append(t)
                if fresh:
                    top_names, top_sims = bank.search(
                        np.stack([t.feature for t in fresh]), top_k=1
                    )
                    for t, nm, sm in zip(fresh, top_names, top_sims):
                        t.label = nm[0] if float(sm[0]) > thr else "Unknown"
                        t.label_dirty = False
            for i in range(n):
                scale = scales[i]
                for t in per_frame_tracks[i]:
                    if t is None:
                        continue
                    if bank is not None:
                        if t.feature is None:
                            t.label = "Unknown"
                        continue
                    if ref_feature is None:
                        continue
                    if t.feature is None:
                        t.label = "Unknown"
                        continue
                    sim = float((t.feature @ ref_feature + 1.0) / 2.0)
                    t.label = "Match" if sim > thr else "Unknown"
                out = {
                    "boxes": dets.boxes[i, :k] / scale,
                    "scores": dets.scores[i, :k],
                    "kps": dets.kps[i, :k] / scale,
                    "valid": dets.valid[i, :k],
                }
                yield n_out, out, per_frame_tracks[i]
                n_out += 1
            buf.clear()
            scales.clear()

        for frame, scale in self._letterboxed(frame_iter):
            buf.append(frame)
            scales.append(scale)
            if len(buf) == self.batch:
                yield from flush()
        yield from flush()

    def stats(self):
        out = {
            "total_frames": self.total_frames,
            "embed_frames": self.embed_frames,
            "embed_fraction": (
                self.embed_frames / self.total_frames if self.total_frames else 0.0
            ),
            "active_tracks": len(self.tracker.tracks),
        }
        if self.bucketed is not None:
            out["embed_bucket"] = self.bucketed.last_bucket
            out["embed_corrections"] = self.bucketed.corrections
        return out
