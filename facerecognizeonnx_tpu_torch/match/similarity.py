"""Cosine-similarity face matching on the (dot+1)/2 scale.

Port of `facerecognizeonnx_tpu/match/similarity.py`.
"""

from __future__ import annotations

import torch


def compare_faces(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(…, D) × (…, D) → (…,) similarity on the [0, 1] scale."""
    return ((f1 * f2).sum(dim=-1) + 1.0) * 0.5


def similarity_matrix(queries: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (G, D) → (Q, G) mapped similarities, f32 (one matmul)."""
    dots = queries.to(torch.float32) @ gallery.to(torch.float32).t()
    return (dots + 1.0) * 0.5
