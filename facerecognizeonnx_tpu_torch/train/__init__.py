"""Training: the ArcFace recognizer (partial-FC train step, fit loop,
identity-folder data), SCRFD detector fine-tuning, and evaluation
(verification accuracy, TAR@FAR, detection AP). Port of
`facerecognizeonnx_tpu/train/`."""

from facerecognizeonnx_tpu_torch.train.arcface_loss import (
    arcface_margin_logits,
    init_classifier,
    softmax_xent,
)
from facerecognizeonnx_tpu_torch.train.fit import fit, warmup_cosine
from facerecognizeonnx_tpu_torch.train.trainer import TrainState, make_train_step

__all__ = [
    "arcface_margin_logits",
    "init_classifier",
    "softmax_xent",
    "TrainState",
    "make_train_step",
    "fit",
    "warmup_cosine",
]
