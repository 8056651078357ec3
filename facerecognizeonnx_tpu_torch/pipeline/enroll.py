"""Batched gallery enrollment.

Port of `facerecognizeonnx_tpu/pipeline/enroll.py` (single device): each
image's best face is detected and aligned per shape bucket (one batched
letterbox → detect and one batched align per distinct image shape, on
the ORIGINAL-resolution frames), and every kept crop is embedded in ONE
`embed_crops` call on the device. The crops are truncated to uint8
before the embed, as the reference package does; that truncation is
part of the enrolled features.

Not ported yet, and raising NotImplementedError: `mesh` (data-parallel
embed) and `experts` (expert-parallel specialist routing), ROADMAP.md
Queue A item 16.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.detect.pipeline import detect_batch_program
from facerecognizeonnx_tpu_torch.embed.pipeline import align_faces_batch, embed_crops
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.ops.image import letterbox

UNPORTED_PARALLEL = (
    "mesh / expert-parallel enrollment is not ported yet (ROADMAP.md Queue A item 16)"
)


def _bucket_detect_align(detector, names, images, cfg, device):
    """Shape-bucketed batched detect + batched align of each image's best
    face (slot 0: postprocess compacts by score). Returns (kept_names,
    crops: list of (S, S, 3) uint8 arrays, kept_kps: list of (5, 2)
    source-resolution landmarks)."""
    buckets = {}
    for i, img in enumerate(images):
        buckets.setdefault(img.shape, []).append(i)

    size = cfg.det_input_size
    kept_names: List[str] = []
    crops: List[np.ndarray] = []
    kept_kps: List[np.ndarray] = []
    for idxs in buckets.values():
        frames = torch.from_numpy(np.stack([images[i] for i in idxs])).to(device)
        with torch.no_grad():
            padded = []
            for f in frames:
                p, scale = letterbox(f, size)
                padded.append(p)
            dets = detect_batch_program(detector.params, torch.stack(padded), cfg)
        valid = dets.valid[:, 0].cpu().numpy()
        # letterboxed → source pixels (/scale), in float32 as the reference
        inv_scale = (1.0 / np.full(len(idxs), scale, np.float32))[:, None]
        boxes = dets.boxes[:, 0].cpu().numpy() * inv_scale
        kps = dets.kps[:, 0].cpu().numpy() * inv_scale[..., None]
        with torch.no_grad():
            batch_crops = align_faces_batch(
                frames,
                torch.from_numpy(kps[:, None]).to(device),
                torch.from_numpy(boxes[:, None]).to(device),
                cfg,
            )[:, 0].cpu().numpy()
        for j, i in enumerate(idxs):
            if valid[j]:
                kept_names.append(names[i])
                crops.append(batch_crops[j].astype(np.uint8))
                kept_kps.append(kps[j])
    return kept_names, crops, kept_kps


def enroll_batch(
    detector,
    recognizer,
    names: Sequence[str],
    images: Sequence[np.ndarray],
    bank: Optional[GalleryBank] = None,
    cfg: Optional[PipelineConfig] = None,
    mesh=None,
    experts: Optional[Sequence] = None,
    expert_router=None,
    device="cuda",
) -> Tuple[GalleryBank, List[str]]:
    """Detect the best face per image, align all, embed as one batch on
    `device` (where the detector's and recognizer's modules lie), and
    add the features to `bank` (a new bank on `device` when None).
    Returns (bank, enrolled_names): images with no detected face are
    skipped, reported by omission."""
    if mesh is not None or experts is not None or expert_router is not None:
        raise NotImplementedError(UNPORTED_PARALLEL)
    dev = resolve_device(device)
    cfg = cfg or detector.cfg
    bank = bank if bank is not None else GalleryBank(cfg.feature_dim, device=dev)
    kept_names, crops, _ = _bucket_detect_align(detector, names, images, cfg, dev)
    if not crops:
        return bank, []
    with torch.no_grad():
        feats = embed_crops(recognizer.params, torch.from_numpy(np.stack(crops)).to(dev), cfg)
    bank.add_batch(kept_names, feats.cpu().numpy())
    return bank, kept_names


def detect_align_crops(
    detector,
    images: Sequence[np.ndarray],
    cfg: Optional[PipelineConfig] = None,
    max_crops: int = 64,
    device="cuda",
) -> np.ndarray:
    """Detect + align the best face of each image → (N, S, S, 3) uint8
    crops (N ≤ max_crops; images with no face are dropped)."""
    dev = resolve_device(device)
    cfg = cfg or detector.cfg
    names = [str(i) for i in range(len(images))]
    _, crops, _ = _bucket_detect_align(detector, names, list(images), cfg, dev)
    if not crops:
        return np.zeros((0, cfg.rec_input_size, cfg.rec_input_size, 3), np.uint8)
    return np.stack(crops[:max_crops])
