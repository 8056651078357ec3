"""facerecognizeonnx_tpu_torch — the PyTorch/CUDA port of facerecognizeonnx_tpu.

The JAX package `facerecognizeonnx_tpu` is the reference; this package
mirrors its module paths (config, types, ops/, models/, detect/, embed/,
match/, pipeline/) on torch tensors. The main path is
`pipeline.fused.frames_to_features` / `frames_to_matches`; its alignment
warp is a hand-written CUDA kernel for Hopper (csrc/warp_xm.cu, built
with nvcc at first use). Weights come from JAX param trees through
`bridge.params_from_numpy`, or from `bridge.init_params_numpy`.

Importing this package never imports jax.
"""

from facerecognizeonnx_tpu_torch.config import PipelineConfig, auto_config
from facerecognizeonnx_tpu_torch.types import Detections, FaceBox

__all__ = ["PipelineConfig", "auto_config", "Detections", "FaceBox"]
