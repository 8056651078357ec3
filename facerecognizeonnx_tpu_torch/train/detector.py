"""SCRFD detector fine-tuning on labeled boxes.

Port of `facerecognizeonnx_tpu/train/detector.py`. Dataset format: the
same ground-truth JSON the CLI `eval --det-gt` mode scores against —
`{"relative/img.jpg": [[x1,y1,x2,y2], ...], ...}` in original-image
pixels, relative to a root directory.

Method, as in the JAX package:

- images letterboxed to `cfg.det_input_size` with the detector's own
  scale rule (scale = min(S/w, S/h), truncated resize, top-left pad);
  GT boxes carried into letterbox pixels by the same scale;
- anchor assignment by center-sampling: an anchor is positive when its
  center lies inside a GT box (smallest containing box wins ties);
  bbox targets are the SCRFD head's stride-unit l,t,r,b distances;
- loss = positive-weighted BCE on the post-sigmoid scores + masked L1
  on the distances, through the SCRFD forward with train=True, Adam
  (`optax.adam`'s formula), and the BN running stats replaced by each
  step's batch statistics (momentum 0).

The returned model is train-form (unfolded BN); `bridge.
tree_from_module` + `utils.checkpoint.save_params` give an .npz that
`FaceDetector.load_model` of either package accepts (it folds BN on
load).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.detect.decode import anchor_centers


def load_detection_dataset(
    root: str,
    gt_json: str,
    det_size: int,
    imread_fn: Optional[Callable] = None,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """→ (images (N, S, S, 3) uint8 letterboxed BGR, boxes per image
    (M_i, 4) float32 x1y1x2y2 in letterbox pixels). Unreadable images
    are skipped."""
    import cv2

    if imread_fn is None:
        from facerecognizeonnx_tpu_torch.io.imageio import imread as imread_fn

    with open(gt_json) as f:
        gt = json.load(f)
    images, boxes_out = [], []
    for fname, boxes in sorted(gt.items()):
        path = fname if os.path.isabs(fname) else os.path.join(root, fname)
        img = imread_fn(path)
        if img is None:
            continue
        h, w = img.shape[:2]
        scale = min(det_size / w, det_size / h)
        nw, nh = int(w * scale), int(h * scale)
        resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        canvas = np.zeros((det_size, det_size, 3), np.uint8)
        canvas[:nh, :nw] = resized
        images.append(canvas)
        boxes_out.append(np.asarray(boxes, np.float32).reshape(-1, 4) * scale)
    if not images:
        raise ValueError(f"no readable images listed in {gt_json}")
    return np.stack(images), boxes_out


def make_targets(
    boxes: np.ndarray,
    det_size: int,
    strides: Sequence[int] = (8, 16, 32),
    num_anchors: int = 2,
) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One image's GT boxes → per-stride (score_t (N, 1), bbox_t (N, 4)
    stride units, pos (N,)) matching the SCRFD forward's anchor order."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    out = {}
    for stride in strides:
        pts = anchor_centers(det_size, stride, num_anchors)  # (N, 2) px
        n = pts.shape[0]
        pos = np.zeros(n, np.float32)
        dist = np.zeros((n, 4), np.float32)
        if len(boxes):
            # (N, M): anchor center strictly inside box
            inside = (
                (pts[:, 0:1] > boxes[None, :, 0])
                & (pts[:, 0:1] < boxes[None, :, 2])
                & (pts[:, 1:2] > boxes[None, :, 1])
                & (pts[:, 1:2] < boxes[None, :, 3])
            )
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            # smallest containing box wins (standard center-sampling tie)
            cost = np.where(inside, areas[None, :], np.inf)
            owner = cost.argmin(axis=1)
            pos = inside.any(axis=1).astype(np.float32)
            b = boxes[owner]  # (N, 4)
            dist = (
                np.stack(
                    [
                        pts[:, 0] - b[:, 0],
                        pts[:, 1] - b[:, 1],
                        b[:, 2] - pts[:, 0],
                        b[:, 3] - pts[:, 1],
                    ],
                    axis=-1,
                )
                / stride
            ).astype(np.float32)
            dist *= pos[:, None]  # targets only matter where positive
        out[stride] = (pos[:, None], dist, pos)
    return out


def mirror_detection_data(
    images: np.ndarray, boxes: List[np.ndarray]
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Horizontal-flip copies of (letterboxed images, boxes): the whole
    canvas flips and box x-coords mirror across the canvas width
    (x1' = S - x2, x2' = S - x1). Convs are translation-equivariant, so
    training on right-anchored flipped content is valid even though
    serving letterboxes anchor top-left."""
    s = images.shape[2]
    img_f = images[:, :, ::-1].copy()
    boxes_f = [
        np.stack([s - b[:, 2], b[:, 1], s - b[:, 0], b[:, 3]], axis=-1)
        if len(b) else b
        for b in boxes
    ]
    return img_f, boxes_f


class Adam:
    """`optax.adam(lr)` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): mu and
    nu moving averages, bias-corrected at the incremented count, update
    −lr·mu_hat/(sqrt(nu_hat) + eps)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, tensors: Dict[str, torch.Tensor]) -> dict:
        return {
            "mu": {k: torch.zeros_like(t, requires_grad=False) for k, t in tensors.items()},
            "nu": {k: torch.zeros_like(t, requires_grad=False) for k, t in tensors.items()},
            "count": torch.zeros((), dtype=torch.int64),
        }

    @torch.no_grad()
    def update(self, tensors: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: dict) -> dict:
        """Steps `tensors`, mu and nu in place; returns the new state."""
        count = state["count"] + 1
        f32 = torch.float32
        c1 = 1 - torch.tensor(self.b1, dtype=f32) ** count.to(f32)
        c2 = 1 - torch.tensor(self.b2, dtype=f32) ** count.to(f32)
        for k, t in tensors.items():
            g, mu, nu = grads[k], state["mu"][k], state["nu"][k]
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            update = (mu / c1.to(mu.device)) / (torch.sqrt(nu / c2.to(nu.device)) + self.eps)
            t.add_(update * (-self.lr))
        return {"mu": state["mu"], "nu": state["nu"], "count": count}


def train_detector(
    images: np.ndarray,
    boxes: List[np.ndarray],
    cfg: PipelineConfig = PipelineConfig(),
    steps: int = 200,
    batch: int = 8,
    lr: float = 2e-3,
    pos_weight: float = 25.0,
    seed: int = 0,
    init_params=None,
    log: Callable[[str], None] = print,
    log_every: int = 20,
    augment: bool = False,
    device="cuda",
):
    """Fine-tune (or train from scratch when init_params is None) the
    `cfg.scrfd_variant` SCRFD on (N, S, S, 3) uint8 letterboxed images.

    init_params: a JAX-layout param tree (an .npz of a train run), else
    weights drawn from `seed` (`bridge.init_params_numpy`). Returns
    (train-form SCRFD module on `device`, losses list). Batches are
    sampled with replacement per step. augment=True doubles the dataset
    with horizontal-flip mirrors (mirror_detection_data) before target
    assignment."""
    from facerecognizeonnx_tpu_torch import bridge
    from facerecognizeonnx_tpu_torch.models.layers import (
        make_trainable,
        trainable_tensors,
        update_bn_stats,
    )

    dev = resolve_device(device)
    if augment:
        img_f, boxes_f = mirror_detection_data(images, boxes)
        images = np.concatenate([images, img_f])
        boxes = list(boxes) + boxes_f

    det_size = images.shape[1]
    strides = tuple(cfg.strides)
    tree = (
        init_params
        if init_params is not None
        else bridge.init_params_numpy(cfg.scrfd_variant, seed=seed)
    )
    model = make_trainable(bridge.params_from_numpy(tree, device=dev))

    tgt = [make_targets(b, det_size, strides, cfg.num_anchors) for b in boxes]

    def stacked(i):
        return {s: torch.from_numpy(np.stack([t[s][i] for t in tgt])).to(dev) for s in strides}

    score_t, bbox_t, pos_t = stacked(0), stacked(1), stacked(2)
    x_all = torch.from_numpy(np.ascontiguousarray(
        (images.astype(np.float32)[..., ::-1] - cfg.pixel_mean) / cfg.pixel_scale
    )).to(dev)  # BGR→RGB + reference normalization (src/face_detector.cpp:124-136)

    tensors = trainable_tensors(model)
    opt = Adam(lr)
    opt_state = opt.init(tensors)

    def loss_fn(x, st, bt, pt):
        outs, stats = model(x, torch.float32, train=True)
        loss = 0.0
        for s in strides:
            scores, bbox, _kps = outs[s]
            eps = 1e-6
            sc = torch.clamp(scores.to(torch.float32), eps, 1 - eps)
            t = st[s]
            bce = -(pos_weight * t * torch.log(sc) + (1 - t) * torch.log(1 - sc))
            loss = loss + bce.mean()
            l1 = torch.abs(bbox.to(torch.float32) - bt[s])
            w = pt[s][..., None]
            loss = loss + (l1 * w).sum() / (w.sum() * 4 + 1)
        return loss, stats

    rng = np.random.default_rng(seed)
    n = images.shape[0]
    losses = []
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, min(batch, n))).to(dev)
        loss, stats = loss_fn(
            x_all[idx],
            {s: score_t[s][idx] for s in strides},
            {s: bbox_t[s][idx] for s in strides},
            {s: pos_t[s][idx] for s in strides},
        )
        # the kps head is not in the loss: its gradient is zero, as in JAX
        grads = torch.autograd.grad(loss, list(tensors.values()), materialize_grads=True)
        opt_state = opt.update(tensors, dict(zip(tensors, grads)), opt_state)
        update_bn_stats(model, stats)
        losses.append(float(loss.detach()))
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"step {i + 1}/{steps} loss {losses[-1]:.4f}")
    return model, losses
