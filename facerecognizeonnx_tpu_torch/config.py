"""Central configuration for the PyTorch face pipeline.

Same fields and defaults as `facerecognizeonnx_tpu.config.PipelineConfig`
so a config can be read by either package. `warp_impl` takes the
reference's names:

  "gather" — exact cv2-bilinear parity (4 gather indices/pixel), any device
  "banded" — per-row band gather + hat-weight matmuls (ops/warp_banded.py)
  "cuda"   — the hand-written Hopper kernel (ops/warp_cuda.py, x-major
             window); a CPU tensor takes its plain-torch version
  "pallas" — the reference's name for its x-major TPU kernel: the same
             semantics, so it runs "cuda"

`scrfd_variant` names a detector of `models/scrfd.py` ("500m", "2.5g",
"10g", "tpu", "500m_s2d"), `rec_arch` a recognizer ("iresnet18/34/50/
100", "mbf", "mbf_large", "vit_t/s/b"), `recognizer_quant` "none" or
"w8a8" (quantize the recognizer at load).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

WARP_IMPLS = ("gather", "banded", "cuda", "pallas")
RECOGNIZER_QUANTS = ("none", "w8a8")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # --- detector
    det_input_size: int = 640
    score_threshold: float = 0.5
    nms_threshold: float = 0.4
    strides: Tuple[int, ...] = (8, 16, 32)
    num_anchors: int = 2
    pre_nms_topk: int = 512
    max_faces: int = 128
    # IoU on integer-truncated rects (C int-cast semantics)
    nms_int_rects: bool = True

    # --- recognizer
    rec_input_size: int = 112
    feature_dim: int = 512
    rec_arch: str = "iresnet50"
    recognizer_quant: str = "none"

    # --- matching, on the (cos+1)/2 scale
    match_threshold: float = 0.6

    # --- normalization
    pixel_mean: float = 127.5
    pixel_scale: float = 128.0

    # --- execution
    compute_dtype: str = "bfloat16"
    host_letterbox: bool = False
    scrfd_variant: str = "500m"
    warp_impl: str = "gather"
    # kept for field parity with the JAX config; the port has no
    # interpret mode (a CPU tensor takes the kernel's plain version)
    warp_interpret: bool = False
    # skip the warp for unoccupied face slots (zeros in their crops)
    skip_invalid_faces: bool = True
    param_dtype: str = "float32"
    data_axis: str = "data"
    model_axis: str = "model"

    # --- model weights
    detector_weights: Optional[str] = None
    recognizer_weights: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        from facerecognizeonnx_tpu_torch.models import recognizer_archs
        from facerecognizeonnx_tpu_torch.models.scrfd import SCRFD_VARIANTS

        for field, value, allowed in (
            ("warp_impl", self.warp_impl, WARP_IMPLS),
            ("scrfd_variant", self.scrfd_variant, tuple(SCRFD_VARIANTS)),
            ("rec_arch", self.rec_arch, recognizer_archs()),
            ("recognizer_quant", self.recognizer_quant, RECOGNIZER_QUANTS),
        ):
            if value not in allowed:
                raise ValueError(f"{field} must be one of {allowed}, got {value!r}")

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


DEFAULT_CONFIG = PipelineConfig()


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. The port's entry points
    default to "cuda"; asking for CUDA where there is none raises rather
    than running on the CPU unasked (pass device="cpu" for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def auto_config(**overrides) -> PipelineConfig:
    """PipelineConfig for the current host: the CUDA warp kernel when a
    GPU is present, the portable gather warp elsewhere."""
    base = dict(warp_impl="cuda" if torch.cuda.is_available() else "gather")
    base.update(overrides)
    return PipelineConfig(**base)
