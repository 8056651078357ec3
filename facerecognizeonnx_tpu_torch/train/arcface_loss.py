"""ArcFace additive-angular-margin loss with a column-split classifier.

Port of `facerecognizeonnx_tpu/train/arcface_loss.py`. The (D, C)
class-centre matrix is normalized column by column inside the loss at
every step (the gradient flows through the norm); the product stays a
float32 `torch.matmul`, as the JAX package computes it outside any
Pallas kernel.

`partial_fc_xent` is the cross entropy the trainer uses: its logits may
be this rank's block of columns of a classifier split over the ranks of
a process group (the partial-FC layout), so the log-normalizer is an
all-reduce of the row maxima and of the sums of exponentials, and the
target logit comes from the rank that owns the label.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from facerecognizeonnx_tpu_torch.config import resolve_device


def init_classifier(
    generator: torch.Generator, feature_dim: int, num_classes: int, device="cuda"
) -> torch.Tensor:
    """(D, C) class-centre matrix with unit-norm columns, drawn from a CPU
    `torch.Generator` (the same values on every device), on `device`."""
    w = torch.randn((feature_dim, num_classes), generator=generator, dtype=torch.float32)
    w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True)
    return w.to(resolve_device(device))


def arcface_margin_logits(
    features: torch.Tensor,
    classifier: torch.Tensor,
    labels: torch.Tensor,
    margin: float = 0.5,
    scale: float = 64.0,
    col_offset: int = 0,
) -> torch.Tensor:
    """(B, D) L2-normalized features → (B, C) margin-adjusted logits:
    s·cos(θ_y + m) on the target class, s·cos elsewhere, θ from the
    cosine clipped to ±(1 − 1e-7). `classifier` may be a block of columns
    starting at global class `col_offset`."""
    w = classifier / torch.clamp_min(
        torch.linalg.vector_norm(classifier, dim=0, keepdim=True), 1e-12
    )
    cos = torch.matmul(features, w)
    cos = torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    cols = torch.arange(col_offset, col_offset + cos.shape[-1], device=cos.device)
    onehot = (labels[:, None] == cols[None, :]).to(cos.dtype)
    target = torch.cos(theta + margin)
    return scale * (onehot * target + (1.0 - onehot) * cos)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy; stable log-softmax."""
    logz = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    return torch.mean(logz - target)


def partial_fc_xent(
    logits: torch.Tensor, labels: torch.Tensor, col_offset: int = 0, group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row cross entropy of logits split by columns over `group` (None:
    all columns here). Returns (loss rows, objective rows): the loss is
    logsumexp − target over the global row, detached; the objective's
    gradient with respect to this rank's logits is softmax − one-hot on
    its columns, the loss's own gradient, so a backward of the objective
    needs no collective."""
    with torch.no_grad():
        mx = logits.max(dim=1).values
        if group is not None:
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        sumexp = torch.exp(logits - mx[:, None]).sum(dim=1)
        if group is not None:
            dist.all_reduce(sumexp, group=group)
        logz = torch.log(sumexp) + mx
        probs = torch.exp(logits - logz[:, None])
    local = labels.long() - col_offset
    own = (local >= 0) & (local < logits.shape[1])
    picked = torch.gather(logits, 1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    target = torch.where(own, picked, torch.zeros_like(picked))
    with torch.no_grad():
        target_all = target.detach().clone()
        if group is not None:
            dist.all_reduce(target_all, group=group)
    return logz - target_all, (probs * logits).sum(dim=1) - target
