"""PyTorch model definitions of the port (NHWC at the public boundary,
NCHW inside): `scrfd` (the det_500m / 2.5g / 10g / tpu / 500m_s2d
family), and the recognizers `arcface` (IResNet 18/34/50/100),
`mobilefacenet` (mbf, mbf_large) and `vit` (vit_t/s/b); `quant` (w8a8)
and `packs` (the buffalo bundles). `recognizer_apply` also runs an ONNX
recognizer graph (`onnx_import.OnnxRunner`).
"""

from __future__ import annotations

import importlib

import torch

_FAMILIES = (
    ("arcface", "IResNet", "IRESNET_SPECS"),
    ("mobilefacenet", "MobileFaceNet", "MBF_SPECS"),
    ("vit", "ViT", "VIT_SPECS"),
)


def _family(name: str):
    return importlib.import_module(f"facerecognizeonnx_tpu_torch.models.{name}")


def recognizer_module_for(model: torch.nn.Module):
    """The model module of a recognizer, from its type (a quantized copy
    keeps its family's type)."""
    for name, cls, _ in _FAMILIES:
        mod = _family(name)
        if isinstance(model, getattr(mod, cls)):
            return mod
    raise TypeError(f"not a recognizer of the port: {type(model).__name__}")


def recognizer_apply(model, x: torch.Tensor, compute_dtype: torch.dtype,
                     train: bool = False, stats_group=None):
    """A recognizer's forward pass: (B, S, S, 3) → (B, 512) float32. The
    model is a native recognizer or an `onnx_import.OnnxRunner` of kind
    "arcface" (a recognizer .onnx that no native mapper fits).

    train=True (native, unfolded recognizers) returns (features, batch
    stats by JAX path) for `layers.update_bn_stats`; `stats_group`
    averages the statistics over its ranks (`layers.train_apply`)."""
    # imported here: config imports this package while it is being built
    from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner

    if isinstance(model, OnnxRunner):
        if model.kind != "arcface":
            raise TypeError(f"an ONNX runner of kind {model.kind!r} is not a recognizer")
        if train:
            raise TypeError("train mode needs a native recognizer, not an ONNX runner")
    else:
        recognizer_module_for(model)
    if train:
        from facerecognizeonnx_tpu_torch.models.layers import train_apply

        return train_apply(model, lambda: model(x, compute_dtype), stats_group)
    return model(x, compute_dtype)


def recognizer_archs():
    """Every recognizer arch name of the port."""
    return tuple(a for name, _, specs in _FAMILIES for a in getattr(_family(name), specs))
