"""Letterbox / color / normalization ops on NHWC tensors.

Port of `facerecognizeonnx_tpu/ops/image.py`: the same cv2 conventions
(float min-scale, truncated resized size, top-left zero pad, BGR→RGB,
(px - 127.5) / 128), on torch tensors of any device; and
`letterbox_host`, the host letterbox of the service and the video path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from facerecognizeonnx_tpu_torch.runtime import native


def letterbox_params(height: int, width: int, target: int) -> Tuple[float, int, int]:
    """Letterbox geometry: scale and resized h, w (integer truncation)."""
    scale = min(float(target) / width, float(target) / height)
    return scale, int(height * scale), int(width * scale)


@functools.lru_cache(maxsize=64)
def _linear_resize_weights(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, half-pixel centers,
    clamped edges — cv2.INTER_LINEAR sampling (no antialias)."""
    j = np.arange(out_size)
    src = (j + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(src).astype(np.int64)
    frac = (src - x0).astype(np.float32)
    x0c = np.clip(x0, 0, in_size - 1)
    x1c = np.clip(x0 + 1, 0, in_size - 1)
    W = np.zeros((out_size, in_size), np.float32)
    np.add.at(W, (j, x0c), 1.0 - frac)
    np.add.at(W, (j, x1c), frac)
    return W


def resize_bilinear(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) → (..., out_h, out_w, C) float32, cv2.INTER_LINEAR
    convention, as two matmuls with the separable weight matrices."""
    x = image.to(torch.float32)
    h, w = x.shape[-3], x.shape[-2]
    wy = torch.from_numpy(_linear_resize_weights(out_h, h)).to(x.device)
    wx = torch.from_numpy(_linear_resize_weights(out_w, w)).to(x.device)
    x = torch.einsum("ph,...hwc->...pwc", wy, x)
    return torch.einsum("qw,...pwc->...pqc", wx, x)


def letterbox(image: torch.Tensor, target: int) -> Tuple[torch.Tensor, float]:
    """Aspect-preserving resize + top-left zero pad to (target, target).

    image: (H, W, 3) uint8/float BGR. Returns (float32 (target, target, 3)
    BGR on the [0, 255] scale, scale)."""
    h, w = int(image.shape[0]), int(image.shape[1])
    scale, new_h, new_w = letterbox_params(h, w, target)
    padded = torch.zeros((target, target, 3), dtype=torch.float32, device=image.device)
    padded[:new_h, :new_w] = resize_bilinear(image, new_h, new_w)
    return padded, scale


def letterbox_host(image_bgr: np.ndarray, target: int) -> Tuple[np.ndarray, float]:
    """Letterbox on the host → ((target, target, 3) uint8, scale): the
    native runtime's letterbox (rounds) where it builds, as the reference
    serves, else `letterbox` on the CPU, truncated to uint8."""
    if native.native_available():
        return native.letterbox_native(image_bgr, target)
    padded, scale = letterbox(torch.from_numpy(np.ascontiguousarray(image_bgr)), target)
    return padded.numpy().astype(np.uint8), scale


def normalize_to_rgb(
    image_bgr: torch.Tensor,
    mean: float = 127.5,
    scale: float = 128.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """BGR→RGB channel flip + (px - mean) * (1/scale), any leading dims."""
    rgb = image_bgr.flip(-1)
    return ((rgb.to(torch.float32) - mean) * (1.0 / scale)).to(dtype)
