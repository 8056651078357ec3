"""Occupancy-adaptive identify: `pipeline.bucketed.BucketedEmbedPipeline`
with the gallery search (`search_top_k`, `bank_padded`). A dispatch is
`start()` (program A, then program B at the bucket guessed from the
previous batch); a resolve is `finish()` (the counts read, a rerun when
the guess fell short) and the copy of the identities to the host. With
two batches in flight, batch N+1 is started before batch N is finished,
as the program's own video and service loops run it."""

from __future__ import annotations

from benchmark.identify import Identify


class Drive(Identify):
    def build(self) -> None:
        from facerecognizeonnx_tpu_torch.pipeline.bucketed import BucketedEmbedPipeline

        self.pipe = BucketedEmbedPipeline(
            self.det, self.rec, self.pcfg, max_faces_embed=self.K, valid_cap=self.valid_cap,
            search_top_k=self.top_k, device=self.device,
        )

    def dispatch(self, i: int):
        pend = self.pipe.start(self.frames(i), bank_padded=self.bank_padded, n_rows=self.n_rows)
        return i, pend

    def resolve(self, handle) -> int:
        i, pend = handle
        dets, feats, sims, idx, _ = self.pipe.finish(pend)
        self.keep(i, dets, feats, sims, idx)
        valid = self.embed_valid(dets.valid[:, : self.K]).cpu()
        best = idx[..., 0].cpu()[valid]
        names = self.names
        _ = [names[j] for j in best.tolist()]
        return valid.shape[0]

    def detections(self, handle):
        return handle[1].dets

    def counters(self):
        return {"steps": self.pipe.steps, "corrections": self.pipe.corrections,
                "last_bucket": self.pipe.last_bucket}

    def reset_counters(self):
        self.pipe.steps = 0
        self.pipe.corrections = 0
