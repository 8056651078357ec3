"""PyTorch model definitions of the port (NHWC at the public boundary,
NCHW inside): `scrfd` (det_500m) and `arcface` (IResNet 18/34/50/100).
"""

from __future__ import annotations

import torch

# MobileFaceNet (w600k_mbf) and ViT recognizers are not ported yet.
UNPORTED_RECOGNIZER = (
    "only IResNet recognizers are ported; MobileFaceNet and ViT are queued "
    "in ROADMAP.md Queue A item 12"
)


def recognizer_apply(model, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Dispatch a recognizer forward pass on the model's structure."""
    from facerecognizeonnx_tpu_torch.models.arcface import IResNet

    if isinstance(model, IResNet):
        return model(x, compute_dtype)
    raise NotImplementedError(UNPORTED_RECOGNIZER)
