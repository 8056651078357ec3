"""ONNX export: the port's models → .onnx files.

Port of `facerecognizeonnx_tpu/onnx_export/`. A module's weights go to
the JAX-layout numpy tree (`bridge.tree_from_module`) and through the
same emitters, so the file holds the same bytes as the JAX package's
export of the same weights:

    from facerecognizeonnx_tpu_torch import onnx_export
    onnx_export.export_recognizer(model, "my_w600k.onnx")

Export UNFOLDED modules (with their BatchNorms); a folded module has no
BN tensors to serialize and is rejected, as are ONNX runners and w8a8
copies.
"""

from __future__ import annotations

from typing import Optional

import torch

from facerecognizeonnx_tpu_torch.bridge import tree_from_module
from facerecognizeonnx_tpu_torch.models import quant
from facerecognizeonnx_tpu_torch.models.arcface import IRESNET_SPECS, IResNet
from facerecognizeonnx_tpu_torch.models.mobilefacenet import MobileFaceNet
from facerecognizeonnx_tpu_torch.models.scrfd import SCRFD
from facerecognizeonnx_tpu_torch.models.vit import ViT
from facerecognizeonnx_tpu_torch.onnx_export.emit import (
    emit_iresnet_onnx,
    emit_mobilefacenet_onnx,
    emit_scrfd_onnx,
    emit_vit_onnx,
)

__all__ = ["export_recognizer", "export_detector"]


def _iresnet_arch_of(model: IResNet) -> str:
    depth = tuple(len(stage) for stage in model.stages)
    for arch, (blocks, _w) in IRESNET_SPECS.items():
        if blocks == depth:
            return arch
    raise ValueError(f"unrecognized iresnet stage depths {depth}")


def _write(data: bytes, path: Optional[str]) -> bytes:
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def export_recognizer(
    model: torch.nn.Module,
    path: Optional[str] = None,
    input_size: int = 112,
) -> bytes:
    """Serialize an IResNet, MobileFaceNet or ViT module to ONNX bytes
    (ViT: the decomposed-LN opset-9 graph of `emit_vit_onnx`); also
    writes `path` when given. ValueError on a folded module, an ONNX
    runner or a w8a8 copy: export the original unfolded module."""
    if not isinstance(model, (IResNet, MobileFaceNet, ViT)) or quant.is_quantized(model):
        raise ValueError(
            "params is an executor/quantized wrapper — export needs the "
            "native unfolded pytree"
        )
    if model.features_bn is None:
        raise ValueError(
            "params look BN-folded (no features_bn): export needs UNFOLDED "
            "params — the .onnx carries explicit BatchNormalization nodes"
        )
    tree = tree_from_module(model)
    if isinstance(model, MobileFaceNet):
        data = emit_mobilefacenet_onnx(tree, input_size=input_size)
    elif isinstance(model, IResNet):
        data = emit_iresnet_onnx(tree, _iresnet_arch_of(model), input_size)
    else:
        data = emit_vit_onnx(tree, input_size=input_size)
    return _write(data, path)


def export_detector(
    model: torch.nn.Module,
    path: Optional[str] = None,
    input_size: int = 640,
) -> bytes:
    """Serialize an SCRFD module (any variant; s2d through an ONNX
    SpaceToDepth stem) to a canonical 9-output det_* graph that accepts
    any batch; also writes `path` when given. Unfolded modules only."""
    if not isinstance(model, SCRFD):
        raise ValueError(
            "params is an executor wrapper — export needs the native "
            "unfolded pytree"
        )
    return _write(emit_scrfd_onnx(tree_from_module(model), input_size=input_size), path)
