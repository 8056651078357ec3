"""Occupancy-adaptive bucketed embedding (the low-occupancy production path).

Port of `facerecognizeonnx_tpu/pipeline/bucketed.py`. The
fused path (`pipeline/fused.py`) embeds all K face slots of every frame
whether or not a face holds them; this path splits it at its seam:

  program A: detect → decode → NMS → align → warp, then compact the
    (B*K) crop slots valid-first with a stable argsort and one gather,
    and count the occupied slots per frame (`detect_and_compact`);
  program B: embed the first `bucket` compacted crops (a Python int) and
    scatter the features back to their (B, K) slots, invalid slots zero
    (`embed_compacted`); with `search_top_k` set it also runs the gallery
    top-k (`embed_compacted_matches`, the adaptive `frames_to_matches`).

`BucketedEmbedPipeline` guesses the bucket from the previous step's
occupancy of real frames, so program B is enqueued before the counts
reach the host: `start()` copies the counts into pinned host memory
behind program A and records an event, and only `finish()` waits on it.
A guess that falls short is corrected exactly by running program B again
at the right bucket. Buckets are powers of two from MIN_BUCKET up.

On the card the NMS is a kernel (csrc/nms_greedy.cu), so `start()` waits
for the device's stream only where the detector's post-processing
uploads constants from host memory (the anchor centres, the ArcFace
template; counted in the tracer's `host_waits`).

With `mesh` both programs run on each rank's block of the batch over
the mesh's `mesh_axis` (every rank makes the same calls with the global
frames): each rank compacts and embeds its own frames' crops, the
per-frame counts are all-gathered in `start()` so every rank sizes the
bucket by the most occupied rank, and `finish()` all-gathers the
results into the global batch. The models are placed on the rank's
device once; the gallery bank of the fused search is replicated.

Buckets are static batch sizes, and cuDNN and cuBLAS pick their kernels
per shape, so in bfloat16 the bucketed features differ from the dense
path's in the last bits (cosine 0.999854 at 16 faces of 64 slots on an
NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py, exactly what the same
crops give in batches of 32 and 64); in float32 they agree to 1e-5
(tests/test_torch_bucketed.py; 1.05e-06 on that card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.embed.pipeline import align_faces_batch, embed_crops
from facerecognizeonnx_tpu_torch.match.similarity import similarity_matrix
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable
from facerecognizeonnx_tpu_torch.pipeline.fused import detect_topk
from facerecognizeonnx_tpu_torch.types import Detections
from facerecognizeonnx_tpu_torch.utils import observability
from facerecognizeonnx_tpu_torch.utils.observability import span

MIN_BUCKET = 32  # the smallest embed batch worth its own shape


def detect_and_compact(
    det_model,
    frames_u8: torch.Tensor,
    cfg: PipelineConfig,
    max_faces_embed: int = 8,
    compute_dtype: Optional[torch.dtype] = None,
    valid_cap: Optional[int] = None,
) -> Tuple[Detections, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Program A: frames → (dets, compacted crops, perm, valid, counts).

    crops_c is (B*K, S, S, 3) embed-ready crops reordered valid-first,
    stable (slot order kept within each class); perm the (B*K,)
    permutation that made it; valid the (B*K,) slot mask; counts the (B,)
    int32 occupied slots per frame. Pad frames stacked last stay behind
    every real frame's crops, so the first sum(counts[:n_real]) compacted
    crops hold every real face."""
    dets, top = detect_topk(det_model, frames_u8, cfg, max_faces_embed, compute_dtype, valid_cap)
    crops = align_faces_batch(
        frames_u8, top.kps, top.boxes, cfg,
        valid=top.valid if cfg.skip_invalid_faces else None,
        normalized=True,
    )
    with span("compact"):
        b, k = crops.shape[0], crops.shape[1]
        valid_flat = top.valid.reshape(b * k)
        # a stable sort on 0 (valid) / 1 (invalid) keys: frame-major order kept
        perm = torch.argsort((~valid_flat).to(torch.uint8), stable=True)
        crops_c = crops.reshape((b * k,) + crops.shape[2:])[perm]
        counts = top.valid.sum(dim=1, dtype=torch.int32)
    return dets, crops_c, perm, valid_flat, counts


def embed_compacted(
    arc_model,
    crops_c: torch.Tensor,
    perm: torch.Tensor,
    valid_flat: torch.Tensor,
    cfg: PipelineConfig,
    max_faces_embed: int,
    bucket: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Program B: embed crops_c[:bucket] and scatter back → (B, K, D).

    Slots beyond the bucket and invalid slots get zero features, as in
    `frames_to_features`. `bucket` must cover every valid crop the caller
    needs: a valid crop beyond it gets zero features
    (`BucketedEmbedPipeline` corrects a short guess)."""
    total = valid_flat.shape[0]
    feats_b = embed_crops(arc_model, crops_c[:bucket], cfg, compute_dtype, normalized=True)
    out = feats_b.new_zeros((total, feats_b.shape[-1]))
    out[perm[:bucket]] = feats_b
    out = out * valid_flat[:, None].to(out.dtype)
    return out.reshape(total // max_faces_embed, max_faces_embed, -1)


def embed_compacted_matches(
    arc_model,
    crops_c: torch.Tensor,
    perm: torch.Tensor,
    valid_flat: torch.Tensor,
    bank_padded: torch.Tensor,
    n_rows,
    cfg: PipelineConfig,
    max_faces_embed: int,
    bucket: int,
    top_k: int,
    compute_dtype: Optional[torch.dtype] = None,
):
    """Program B with the gallery top-k: embed the bucket, scatter back,
    similarities on the (cos+1)/2 scale against the padded bank, rows ≥
    n_rows masked to −1, stable top-k. Returns (feats (B, K, D), sims
    (B, K, top_k), int32 indices (B, K, top_k)); only valid slots mean
    anything, as with `frames_to_matches`."""
    feats = embed_compacted(
        arc_model, crops_c, perm, valid_flat, cfg, max_faces_embed, bucket, compute_dtype,
    )
    b, k, d = feats.shape
    with span("match"):
        sims = similarity_matrix(feats.reshape(b * k, d), bank_padded)
        mask = torch.arange(bank_padded.shape[0], device=sims.device)[None, :] < n_rows
        sims = torch.where(mask, sims, torch.full_like(sims, -1.0))
        v, i = topk_stable(sims, top_k)
    return feats, v.reshape(b, k, top_k), i.to(torch.int32).reshape(b, k, top_k)


def default_buckets(total: int) -> Tuple[int, ...]:
    """Powers of two from MIN_BUCKET up, capped (and ended) at total."""
    out = []
    b = MIN_BUCKET
    while b < total:
        out.append(b)
        b *= 2
    out.append(total)
    return tuple(out)


@dataclass
class _Pending:
    """A batch in flight: what start() enqueued, resolved by finish()."""

    dets: Detections
    counts: torch.Tensor  # (B,) int32 per-frame counts on the host (pinned on a card)
    ready: Optional[Any]  # CUDA event recorded after the counts' copy, or None on the CPU
    feats: Optional[torch.Tensor]  # the guessed bucket's (B, K, D) features, or None
    matches: Optional[Tuple[torch.Tensor, torch.Tensor]]  # (sims, idx) with the search
    guess: int  # the guessed bucket (0: no embed enqueued)
    n_frames: int  # real leading frames of the batch
    bank: Optional[Tuple[torch.Tensor, Any]]  # (bank_padded, n_rows) with the search
    ops: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (crops_c, perm, valid) for a rerun


class BucketedEmbedPipeline:
    """frames → (Detections, (B, K, D) features[, sims, idx], n_valid)
    with an embed sized by the detected faces, rounded up to a bucket.

    Features of valid slots equal `frames_to_features`' within float
    tolerance; invalid slots are zeros in both. With search_top_k,
    `__call__` / `start` also take (bank_padded, n_rows), the padded
    bank of `GalleryBank.device_bank_padded`. `start()` enqueues both
    programs; `finish()` fetches the counts, corrects a short guess and
    returns the results, so a caller can resolve batch N while batch N+1
    runs. `__call__` is `finish(start(...))`.

    Counters: `steps`, `corrections` (guessed embeds thrown away) and
    `last_bucket` (the bucket of the latest step). The models live on
    `device`, and frames are moved there."""

    def __init__(
        self,
        det_model,
        arc_model,
        cfg: PipelineConfig,
        max_faces_embed: int = 8,
        buckets: Optional[Sequence[int]] = None,
        valid_cap: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        search_top_k: Optional[int] = None,
        mesh=None,
        mesh_axis: str = "data",
        device="cuda",
    ):
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self._n_shards = 1
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from facerecognizeonnx_tpu_torch.parallel.mesh import (
                axis_size,
                in_mesh,
                mesh_device,
            )
            from facerecognizeonnx_tpu_torch.parallel.sharded_ops import module_on

            if not in_mesh(mesh):
                raise ValueError("the mesh form of the bucketed embed runs on the mesh's ranks")
            self._n_shards = axis_size(mesh, mesh_axis)
            self.device = mesh_device(mesh)
            det_model, arc_model = module_on(det_model, self.device), module_on(
                arc_model, self.device)
        self.det, self.arc = det_model, arc_model
        self.cfg = cfg
        self.k = max_faces_embed
        self._buckets = tuple(sorted(buckets)) if buckets else None
        self.valid_cap = valid_cap
        self.compute_dtype = compute_dtype
        self.search_top_k = search_top_k
        self.corrections = 0
        self.steps = 0
        self.last_bucket = 0
        self._last_rate: Optional[float] = None  # valid faces per real frame

    def _pick(self, n: int, total: int) -> int:
        if n <= 0:
            return 0
        for b in self._buckets or default_buckets(total):
            if b >= n:
                return min(b, total)
        return total

    def _embed(self, bucket: int, ops, bank):
        """Program B at this bucket → (feats, (sims, idx) or None)."""
        with torch.no_grad():
            if bank is None:
                return embed_compacted(
                    self.arc, *ops, self.cfg, self.k, bucket, self.compute_dtype
                ), None
            feats, sims, idx = embed_compacted_matches(
                self.arc, *ops, *bank, self.cfg, self.k, bucket, self.search_top_k,
                self.compute_dtype,
            )
            return feats, (sims, idx)

    def start(
        self,
        frames_u8: torch.Tensor,
        n_frames: Optional[int] = None,
        bank_padded: Optional[torch.Tensor] = None,
        n_rows=None,
    ) -> _Pending:
        """Enqueue program A and the guessed program B; the counts go to
        the host behind program A without a wait here. n_frames: how many
        leading frames are real (the rest are pad copies, left out of the
        occupancy). bank_padded and n_rows are required exactly when the
        pipeline has search_top_k."""
        if (bank_padded is None) != (self.search_top_k is None) or (
            self.search_top_k is not None and n_rows is None
        ):
            raise ValueError(
                "bank_padded AND n_rows must be passed exactly when the "
                "pipeline was built with search_top_k"
            )
        with span("start"):
            if self.mesh is not None:
                from facerecognizeonnx_tpu_torch.parallel.mesh import block, gather_rows

                frames_u8 = block(torch.as_tensor(frames_u8), self.mesh, self.mesh_axis)
            with torch.no_grad():
                dets, crops_c, perm, valid_flat, counts = detect_and_compact(
                    self.det, frames_u8.to(self.device), self.cfg, self.k, self.compute_dtype,
                    self.valid_cap,
                )
            if self.mesh is not None:  # every rank sizes the bucket from all counts
                counts = gather_rows(counts, self.mesh, self.mesh_axis)
            if counts.is_cuda:
                host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
                host.copy_(counts, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host, ready = counts, None
            b = counts.shape[0]
            local_b = b // self._n_shards
            total = local_b * self.k
            n_frames = b if n_frames is None else n_frames
            # guess from the previous step's occupancy of real frames (the
            # first step guesses full occupancy)
            if self._last_rate is None:
                guess = self._pick(total, total)
            else:
                guess = self._pick(int(math.ceil(self._last_rate * local_b)), total)
            bank = None if self.search_top_k is None else (bank_padded.to(self.device), n_rows)
            ops = (crops_c, perm, valid_flat)
            feats, matches = self._embed(guess, ops, bank) if guess > 0 else (None, None)
            return _Pending(dets, host, ready, feats, matches, guess, n_frames, bank, ops)

    def finish(self, pend: _Pending):
        """Wait for the counts, correct a short guess, return (dets,
        feats, n_valid), or (dets, feats, sims, idx, n_valid) with the
        search. n_valid counts the occupied slots of real frames only."""
        with span("finish"):
            with span("counts_wait"):
                if pend.ready is not None:
                    observability.host_wait(pend.ops[0].device)
                    pend.ready.synchronize()
            real = pend.counts.numpy().astype(np.int64)
            b = real.shape[0]
            local_b = b // self._n_shards
            total = local_b * self.k
            real[pend.n_frames:] = 0  # pad frames do not count
            n = int(real.sum())
            self.steps += 1
            self._last_rate = n / max(1, pend.n_frames)
            # each rank embeds its own first `bucket` compacted crops, so the
            # bucket covers the most occupied rank's real crops
            need = self._pick(int(real.reshape(self._n_shards, local_b).sum(axis=1).max()), total)
            feats, matches = pend.feats, pend.matches
            if need > pend.guess:  # the guess fell short: run program B again
                if pend.guess > 0:
                    self.corrections += 1  # a guessed embed is thrown away
                with span("rerun"):
                    feats, matches = self._embed(need, pend.ops, pend.bank)
                self.last_bucket = need
            else:
                self.last_bucket = max(need, pend.guess) if pend.guess else need
            if feats is None:  # no faces anywhere: nothing was embedded
                dev = pend.ops[0].device
                feats = torch.zeros((local_b, self.k, self.cfg.feature_dim), device=dev)
                if pend.bank is not None:
                    shape = (local_b, self.k, self.search_top_k)
                    matches = (torch.zeros(shape, device=dev),
                               torch.zeros(shape, dtype=torch.int32, device=dev))
            dets = pend.dets
            if self.mesh is not None:  # the global batch on every rank
                from facerecognizeonnx_tpu_torch.parallel.mesh import gather_rows

                def join(t):
                    return gather_rows(t, self.mesh, self.mesh_axis)

                dets, feats = Detections(*(join(t) for t in dets)), join(feats)
                matches = None if matches is None else tuple(join(t) for t in matches)
            if pend.bank is not None:
                return dets, feats, matches[0], matches[1], n
            return dets, feats, n

    def __call__(self, frames_u8, bank_padded=None, n_rows=None):
        return self.finish(self.start(frames_u8, bank_padded=bank_padded, n_rows=n_rows))
