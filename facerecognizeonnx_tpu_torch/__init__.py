"""facerecognizeonnx_tpu_torch — the PyTorch/CUDA port of facerecognizeonnx_tpu.

The JAX package `facerecognizeonnx_tpu` is the reference; this package
mirrors its module paths (config, types, ops/, models/, detect/, embed/,
match/, pipeline/) on torch tensors. Entry points:

  pipeline.fused.frames_to_features / frames_to_matches   the fused path
  FaceDetector, FaceRecognizer (pipeline/api.py)           the components
  match.gallery.GalleryBank, pipeline.enroll.enroll_batch,
  pipeline.service.IdentifyService                         1:N identify
  models.packs.load_pack                                   a buffalo pack
  FaceApp (pipeline/app.py)                                one-object front end
  TrackingVideoPipeline (pipeline/track.py)                video with a track cache
  make_server (pipeline/server.py), IdentifyClient         HTTP serving
  python -m facerecognizeonnx_tpu_torch <mode>             the CLI (cli/main.py)

Each runs on the card unless the caller passes device="cpu". The TPU
kernels of the JAX package are hand-written CUDA kernels for Hopper
(csrc/*.cu, built with nvcc at first use). Weights come from `.npz`
checkpoints of either package, from `.onnx` files (`onnx_import`), from
JAX param trees through `bridge.params_from_numpy`, or from
`bridge.init_params_numpy`; `onnx_export` writes a model as `.onnx`.

Importing this package never imports jax.
"""

from facerecognizeonnx_tpu_torch.config import PipelineConfig, auto_config
from facerecognizeonnx_tpu_torch.types import Detections, FaceBox

__all__ = [
    "PipelineConfig", "auto_config", "Detections", "FaceBox",
    "FaceDetector", "FaceRecognizer", "FaceApp", "IdentifyClient", "make_server",
    "TrackingVideoPipeline",
]

_LAZY = {
    "FaceDetector": "pipeline.api",
    "FaceRecognizer": "pipeline.api",
    "FaceApp": "pipeline.app",
    "IdentifyClient": "pipeline.client",
    "make_server": "pipeline.server",
    "TrackingVideoPipeline": "pipeline.track",
}


def __getattr__(name):
    # lazy: importing the package builds no model
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
