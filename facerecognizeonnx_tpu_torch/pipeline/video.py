"""Streaming video: prefetch → micro-batch → the fused device path.

Port of `facerecognizeonnx_tpu/pipeline/video.py`. Three stages overlap:

  host:   a PrefetchLoader thread (native letterbox) fills a frame ring
          (the torch host letterbox where the native runtime cannot be
          built)
  device: detect + align + embed for a micro-batch of frames
          (`frames_to_features`, or the bucketed pipeline with
          adaptive_embed=True)
  host:   each face matched against a reference feature, (cos+1)/2
          against the 0.6 threshold → "Match" / "Unknown"

The device work of micro-batch N+1 is enqueued before batch N's results
are brought to the host.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.ops.image import letterbox_host
from facerecognizeonnx_tpu_torch.pipeline.bucketed import BucketedEmbedPipeline
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features
from facerecognizeonnx_tpu_torch.runtime.native import PrefetchLoader, native_available
from facerecognizeonnx_tpu_torch.types import Detections
from facerecognizeonnx_tpu_torch.utils.observability import Counter


class VideoPipeline:
    def __init__(
        self,
        det_params,
        arc_params,
        cfg: PipelineConfig = PipelineConfig(),
        batch: int = 4,
        max_faces_embed: int = 8,
        adaptive_embed: bool = False,
        device="cuda",
    ):
        """det_params / arc_params: the SCRFD and recognizer modules on
        `device`. adaptive_embed=True runs the occupancy-adaptive
        bucketed pipeline (pipeline/bucketed.py) instead of the dense
        path: the embed follows the detected faces, not all K slots. Its
        count fetch happens when a batch is brought to the host, after
        the next batch was enqueued; pad frames of a partial last batch
        are left out of its occupancy."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_faces_embed = max_faces_embed
        if adaptive_embed:
            bucketed = BucketedEmbedPipeline(det_params, arc_params, cfg, max_faces_embed,
                                             device=self.device)
            self._start = lambda frames, n_real: bucketed.start(frames, n_frames=n_real)
            self._finish = lambda pend: bucketed.finish(pend)[:2]
        else:
            def dense(frames, n_real):
                with torch.no_grad():
                    return frames_to_features(det_params, arc_params, frames, cfg, max_faces_embed)

            self._start = dense
            self._finish = lambda out: out
        self.counter = Counter("frames")

    def _letterboxed_frames(self, frame_iter) -> Iterator:
        size = self.cfg.det_input_size
        if native_available():
            loader = PrefetchLoader(frame_iter, size, 2 * self.batch)
            try:
                yield from loader.frames()
            finally:
                loader.close()
            return
        for frame in frame_iter:
            yield letterbox_host(frame, size)

    def run(
        self,
        frame_iter,
        ref_feature: Optional[np.ndarray] = None,
        max_frames: Optional[int] = None,
        match_threshold: Optional[float] = None,
    ):
        """Yields (frame_idx, Detections (host arrays, original pixels),
        features (K, 512), labels) per frame."""
        thr = self.cfg.match_threshold if match_threshold is None else match_threshold
        buf: List[np.ndarray] = []
        scales: List[float] = []
        n_out = 0
        pending = None  # (start() handle, batch length, scales)

        def dispatch():
            nonlocal pending
            if not buf:
                return None
            frames = np.stack(buf + [buf[-1]] * (self.batch - len(buf)))
            with self.counter.event(items=len(buf)):
                x = torch.from_numpy(frames).to(self.device, non_blocking=True)
                out = self._start(x, len(buf))
            prev, pending = pending, (out, len(buf), list(scales))
            buf.clear()
            scales.clear()
            return prev

        def materialize(entry):
            nonlocal n_out
            if entry is None:
                return
            handle, n, batch_scales = entry
            dets, feats = self._finish(handle)
            feats = feats.cpu().numpy()
            dets = Detections(*(t.cpu().numpy() for t in dets))
            for i in range(n):
                det_i = Detections(
                    boxes=dets.boxes[i] / batch_scales[i],
                    scores=dets.scores[i],
                    kps=dets.kps[i] / batch_scales[i],
                    valid=dets.valid[i],
                )
                labels = []
                if ref_feature is not None:
                    for k in range(self.max_faces_embed):
                        if not det_i.valid[k]:
                            labels.append("")
                            continue
                        sim = float((feats[i, k] @ ref_feature + 1.0) / 2.0)
                        labels.append("Match" if sim > thr else "Unknown")
                yield (n_out, det_i, feats[i], labels)
                n_out += 1

        frames_in = self._letterboxed_frames(frame_iter)
        stop = False
        try:
            for frame, scale in frames_in:
                buf.append(frame)
                scales.append(scale)
                if len(buf) == self.batch:
                    yield from materialize(dispatch())
                if max_frames is not None and n_out + len(buf) + (
                    pending[1] if pending else 0
                ) >= max_frames:
                    stop = True
                    break
        finally:
            frames_in.close()  # stops the prefetch thread
        if not stop or buf:
            yield from materialize(dispatch())
        yield from materialize(pending)

    def stats(self):
        return self.counter.summary()
