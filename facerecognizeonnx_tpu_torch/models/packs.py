"""Named model packs: the InsightFace buffalo_* bundle layout.

Port of `facerecognizeonnx_tpu/models/packs.py`. Each pack pairs a
detector variant with a recognizer arch and names the `.onnx` files the
published bundle ships, so

    detector, recognizer = load_pack("buffalo_l", model_dir="models/")

returns a matched (FaceDetector, FaceRecognizer) on the card. Where the
pack's files are in `model_dir` they are loaded (`load_model` of the
`.onnx` files: the detector through the graph executor, the recognizer
mapped onto its native module); where they are absent the models take
seeded random weights, as `load_model(None)` does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Pack:
    """One buffalo bundle: detector variant + recognizer arch + the .onnx
    filenames of the published pack directory."""

    det_variant: str
    rec_arch: str
    det_file: str
    rec_file: str
    note: str = ""


# buffalo_sc is the reference's own pack (det_500m + w600k_r50); the
# others are the published InsightFace model-zoo compositions
PACKS: Dict[str, Pack] = {
    "buffalo_sc": Pack(
        "500m", "iresnet50", "det_500m.onnx", "w600k_r50.onnx",
        note="the reference's pack (models/README.md:28-30)",
    ),
    "buffalo_s": Pack(
        "500m", "mbf", "det_500m.onnx", "w600k_mbf.onnx",
        note="small: 500m detector + MobileFaceNet embedder",
    ),
    "buffalo_m": Pack(
        "2.5g", "iresnet50", "det_2.5g.onnx", "w600k_r50.onnx",
        note="medium: 2.5g detector + r50 embedder",
    ),
    "buffalo_l": Pack(
        "10g", "iresnet50", "det_10g.onnx", "w600k_r50.onnx",
        note="large: 10g detector + r50 embedder",
    ),
}

# quant option → FaceRecognizer.quantize(min_channels=...)
QUANT_MIN_CHANNELS = {"w8a8": 0, "w8a8-fast": 128}


def pack_names() -> Tuple[str, ...]:
    return tuple(sorted(PACKS))


def resolve_pack(
    name: str, model_dir: Optional[str] = None
) -> Tuple[Pack, Optional[str], Optional[str]]:
    """(Pack, det_path-or-None, rec_path-or-None): a path only where the
    pack's file exists under model_dir."""
    if name not in PACKS:
        raise KeyError(f"unknown pack {name!r}; available: {', '.join(pack_names())}")
    pack = PACKS[name]
    det_path = rec_path = None
    if model_dir:
        det = os.path.join(model_dir, pack.det_file)
        rec = os.path.join(model_dir, pack.rec_file)
        det_path = det if os.path.exists(det) else None
        rec_path = rec if os.path.exists(rec) else None
    return pack, det_path, rec_path


def load_pack(
    name: str,
    model_dir: Optional[str] = None,
    quant: Optional[str] = None,
    device="cuda",
):
    """(FaceDetector, FaceRecognizer) of a named pack on `device`.

    quant: None | "none" | "w8a8" | "w8a8-fast" — int8-quantize the
    recognizer after load ("w8a8-fast" quantizes only the convs with at
    least 128 outputs)."""
    from facerecognizeonnx_tpu_torch.config import auto_config
    from facerecognizeonnx_tpu_torch.errors import ModelLoadError
    from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector, FaceRecognizer

    if quant not in (None, "none", *QUANT_MIN_CHANNELS):
        raise ValueError(f"quant must be None, 'none' or one of {tuple(QUANT_MIN_CHANNELS)}")
    pack, det_path, rec_path = resolve_pack(name, model_dir)
    cfg = auto_config(
        detector_weights=det_path,
        recognizer_weights=rec_path,
        rec_arch=pack.rec_arch,
        scrfd_variant=pack.det_variant,
    )
    detector = FaceDetector(cfg, device=device)
    if not detector.load_model(det_path):
        raise ModelLoadError(f"pack {name}: failed to load {det_path}")
    recognizer = FaceRecognizer(cfg, device=device)
    if not recognizer.load_model(rec_path):
        raise ModelLoadError(f"pack {name}: failed to load {rec_path}")
    if quant in QUANT_MIN_CHANNELS:
        recognizer.quantize(min_channels=QUANT_MIN_CHANNELS[quant])
    return detector, recognizer
