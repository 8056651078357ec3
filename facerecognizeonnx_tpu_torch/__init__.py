"""facerecognizeonnx_tpu_torch — the PyTorch/CUDA port of facerecognizeonnx_tpu.

The JAX package `facerecognizeonnx_tpu` is the reference; this package
mirrors its module paths (config, types, ops/, models/, detect/, embed/,
match/, pipeline/) on torch tensors. Entry points:

  pipeline.fused.frames_to_features / frames_to_matches   the fused path
  FaceDetector, FaceRecognizer (pipeline/api.py)           the components
  match.gallery.GalleryBank, pipeline.enroll.enroll_batch,
  pipeline.service.IdentifyService                         1:N identify
  models.packs.load_pack                                   a buffalo pack

Each runs on the card unless the caller passes device="cpu". The TPU
kernels of the JAX package are hand-written CUDA kernels for Hopper
(csrc/*.cu, built with nvcc at first use). Weights come from `.npz`
checkpoints of either package, from JAX param trees through
`bridge.params_from_numpy`, or from `bridge.init_params_numpy`.

Importing this package never imports jax.
"""

from facerecognizeonnx_tpu_torch.config import PipelineConfig, auto_config
from facerecognizeonnx_tpu_torch.types import Detections, FaceBox

__all__ = [
    "PipelineConfig", "auto_config", "Detections", "FaceBox",
    "FaceDetector", "FaceRecognizer",
]


def __getattr__(name):
    # lazy: importing the package builds no model
    if name in ("FaceDetector", "FaceRecognizer"):
        from facerecognizeonnx_tpu_torch.pipeline import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
