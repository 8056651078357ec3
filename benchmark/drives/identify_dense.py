"""Dense identify: `pipeline.fused.frames_to_matches` on a batch of
letterboxed frames, every one of the K slots embedded. A dispatch
enqueues the step and the copy of its identities (slot mask, top-k
sims and rows) into pinned host memory behind it, and records an event;
a resolve waits on that event only, so the next batch's step is already
queued while the host reads this one's."""

from __future__ import annotations

import torch

from benchmark.identify import Identify


class Drive(Identify):
    def build(self) -> None:
        from facerecognizeonnx_tpu_torch.pipeline import fused

        self._step = fused.frames_to_matches

    def dispatch(self, i: int):
        with torch.no_grad():
            dets, feats, sims, idx = self._step(
                self.det, self.rec, self.frames(i), self.bank_padded, self.n_rows, self.pcfg,
                max_faces_embed=self.K, top_k=self.top_k, valid_cap=self.valid_cap,
            )
        self.keep(i, dets, feats, sims, idx)
        host = [t.to("cpu", non_blocking=True)
                for t in (dets.valid[:, : self.K], sims, idx)]
        ready = torch.cuda.Event() if self.device.type == "cuda" else None
        if ready is not None:
            ready.record()
        return host, ready, dets

    def resolve(self, handle) -> int:
        host, ready, _ = handle
        if ready is not None:
            ready.synchronize()
        valid, sims, idx = host
        names = self.names
        # identities on the host: the best row's name for each occupied slot
        best = idx[..., 0][valid]
        _ = [names[j] for j in best.tolist()]
        return valid.shape[0]

    def detections(self, handle):
        return handle[2]
