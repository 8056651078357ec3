"""The reference-compatible component API on torch.

Port of `facerecognizeonnx_tpu/pipeline/api.py`:

  FaceDetector:   load_model/loadModel, detect, detect_raw, detect_batch
  FaceRecognizer: load_model/loadModel, extract_feature(s)/extractFeature,
                  extract_feature_simple/extractFeatureSimple,
                  compare_faces/compareFaces

The same defaults (score 0.5, NMS 0.4, match threshold 0.6 on the
(cos+1)/2 scale, 640/112 inputs, 512-d features) and the same guard
semantics (empty results on a missing model or image; load_model
returns False on a missing or corrupt file). Inputs and outputs are
numpy on the host; each method runs its program on `device` (the card
unless the caller asks for the CPU). PyTorch runs eagerly, so there is
no per-shape compile cache.

`host_letterbox=True` letterboxes `detect_raw`'s image on the host with
the native runtime (`runtime/native.py`), and `detect_files` reads,
decodes and letterboxes files with its threaded loader, as the
reference does.

The detector is any SCRFD variant (`cfg.scrfd_variant`), the recognizer
any arch of `cfg.rec_arch` (IResNet, MobileFaceNet, ViT);
`FaceRecognizer.quantize` makes it w8a8 (`models/quant.py`), as does
`cfg.recognizer_quant="w8a8"` at load.

`.onnx` weights load as in the JAX package: a detector file always runs
through the graph executor (`onnx_import.OnnxRunner`); a recognizer file
is first mapped onto the native module (`onnx_import.native_map`,
self-verified), and runs through the executor where no mapping fits.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np
import torch

from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.detect.decode import decode_outputs
from facerecognizeonnx_tpu_torch.detect.pipeline import detect_program, postprocess
from facerecognizeonnx_tpu_torch.embed.pipeline import embed_program, embed_simple_program
from facerecognizeonnx_tpu_torch.errors import ModelLoadError
from facerecognizeonnx_tpu_torch.io.imageio import imread
from facerecognizeonnx_tpu_torch.models import quant, recognizer_module_for, scrfd
from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner
from facerecognizeonnx_tpu_torch.ops.image import letterbox, normalize_to_rgb
from facerecognizeonnx_tpu_torch.runtime import native
from facerecognizeonnx_tpu_torch.types import Detections, FaceBox, face_boxes_to_arrays
from facerecognizeonnx_tpu_torch.utils import checkpoint

def _load_tree(path: Optional[str], init_fn):
    """Param tree from `.npz`, or init_fn() when path is None. Raises
    ModelLoadError on a missing or corrupt file."""
    if path is None:
        return init_fn()
    try:
        return checkpoint.load_params(path)
    except (OSError, ValueError) as e:
        raise ModelLoadError(f"cannot load weights {path!r}: {e}") from e


def _load_onnx(path: str, device, native_mapper=None) -> torch.nn.Module:
    """An .onnx file → the native module `native_mapper(path)` maps it
    onto, else an OnnxRunner. Raises ModelLoadError on a missing,
    corrupt or unsupported file."""
    from facerecognizeonnx_tpu_torch.onnx_import import importer, proto

    try:
        graph = proto.load_model(path)
        if native_mapper is not None:
            mapped = native_mapper(graph)
            if mapped is not None:
                print("ONNX weights mapped onto the native model")
                return mapped
        return importer.load_onnx_params(graph, device=device)
    except (OSError, ValueError, IndexError, struct.error, NotImplementedError) as e:
        # a truncated protobuf runs its reader off the end (IndexError,
        # struct.error), where the JAX package lets them through
        raise ModelLoadError(f"cannot load ONNX model {path!r}: {e}") from e


def _to_module(tree, device) -> torch.nn.Module:
    try:
        return bridge.params_from_numpy(tree, device)
    except (KeyError, TypeError, ValueError) as e:
        raise ModelLoadError(f"weights do not fit the model: {e!r}") from e


def _int_rects(faces: List[FaceBox]) -> List[FaceBox]:
    """The reference truncates rect coords to int."""
    for f in faces:
        x1, y1 = int(f.box[0]), int(f.box[1])
        x2, y2 = int(f.box[0] + f.box[2]), int(f.box[1] + f.box[3])
        f.box = (x1, y1, x2 - x1, y2 - y1)
    return faces


class FaceDetector:
    """SCRFD face detector."""

    def __init__(self, config: PipelineConfig = DEFAULT_CONFIG, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.params = None  # the SCRFD module, once loaded

    def load_model(self, model_path: Optional[str] = None) -> bool:
        """Weights from `.npz` (either package's checkpoint format) or
        `.onnx` (run by the graph executor), or with model_path=None a
        random init from `cfg.seed` (`bridge.init_params_numpy`, whose
        values differ from the JAX package's `jax.random` init). A native
        model's BatchNorms are folded. False on a missing or corrupt file."""
        try:
            if model_path is not None and model_path.endswith(".onnx"):
                model = _load_onnx(model_path, self.device)
            else:
                tree = _load_tree(
                    model_path,
                    lambda: bridge.init_params_numpy(self.cfg.scrfd_variant, seed=self.cfg.seed),
                )
                model = _to_module(tree, self.device)
        except ModelLoadError as e:
            print(f"Error loading model: {e}")
            return False
        if isinstance(model, scrfd.SCRFD) and model.stem.bn is not None:
            model = scrfd.fold_inference_params(model)
        self.params = model
        print("Face detector model loaded successfully!")
        print(f"Using input size: {self.cfg.det_input_size}x{self.cfg.det_input_size}")
        return True

    loadModel = load_model

    def detect(
        self,
        image: np.ndarray,
        score_threshold: Optional[float] = None,
        nms_threshold: Optional[float] = None,
    ) -> List[FaceBox]:
        """BGR uint8 (H, W, 3) → FaceBox list in original pixel coords,
        rects truncated to int. Empty on a missing model or image."""
        if self.params is None:
            print("Model not loaded!")
            return []
        if image is None or image.size == 0 or image.ndim != 3:
            print("Input image is empty!")
            return []
        dets = self.detect_raw(image, score_threshold, nms_threshold)
        return _int_rects(dets.to_face_boxes())

    def detect_raw(
        self,
        image: np.ndarray,
        score_threshold: Optional[float] = None,
        nms_threshold: Optional[float] = None,
    ) -> Detections:
        """Full-precision fixed-K Detections (tensors on the device).

        With cfg.host_letterbox and an image not already at the detector's
        size, the native runtime letterboxes it on the host (rounding) and
        the coordinates are scaled back after NMS, as in the reference;
        where the runtime cannot be built, the device letterbox runs."""
        size = self.cfg.det_input_size
        scale = 1.0
        if self.cfg.host_letterbox and image.shape[:2] != (size, size) and \
                native.native_available():
            image, scale = native.letterbox_native(image, size)
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        with torch.no_grad():
            dets = detect_program(self.params, img, self.cfg, score_threshold, nms_threshold)
        if scale == 1.0:
            return dets
        inv = 1.0 / scale
        return dets._replace(boxes=dets.boxes * inv, kps=dets.kps * inv)

    def detect_batch(self, images: Sequence[np.ndarray]) -> List[List[FaceBox]]:
        """Batched detect: same-shaped BGR frames run as one batch
        (letterbox + detect on the device); mixed shapes bucket by shape.
        A FaceBox list per image, `detect(img)` semantics (the per-image
        scale divides before NMS)."""
        if self.params is None:
            print("Model not loaded!")
            return [[] for _ in images]
        results: List[List[FaceBox]] = [[] for _ in images]
        buckets: dict = {}
        for i, img in enumerate(images):
            if img is None or img.size == 0 or img.ndim != 3:
                continue
            buckets.setdefault(img.shape, []).append(i)
        size = self.cfg.det_input_size
        for idxs in buckets.values():
            frames = torch.from_numpy(np.stack([images[i] for i in idxs])).to(self.device)
            with torch.no_grad():
                letterboxed = [letterbox(f, size) for f in frames]
            scale = letterboxed[0][1]
            dets = self._detect_letterboxed(
                torch.stack([p for p, _ in letterboxed]),
                torch.full((len(idxs),), scale, dtype=torch.float32, device=self.device),
            )
            for row, i in enumerate(idxs):
                results[i] = _int_rects(Detections(*(t[row] for t in dets)).to_face_boxes())
        return results

    def _detect_letterboxed(self, frames: torch.Tensor, scales: torch.Tensor) -> Detections:
        """(B, S, S, 3) letterboxed BGR frames (uint8 or float) and their
        (B,) scales → Detections in original pixels (/scale before NMS)."""
        cfg = self.cfg
        dtype = cfg.torch_compute_dtype
        with torch.no_grad():
            x = normalize_to_rgb(frames, cfg.pixel_mean, cfg.pixel_scale, dtype=dtype)
            scores, boxes, kps = decode_outputs(
                self.params(x, dtype), cfg.det_input_size, cfg.num_anchors
            )
            return postprocess(scores, boxes, kps, scales, cfg)

    def detect_files(
        self, paths: Sequence[str], batch_size: int = 32, threads: int = 1
    ) -> List[List[FaceBox]]:
        """Detection over image files. The native loader reads, decodes
        and letterboxes the files on `threads` host threads while the
        device runs fixed-size batches of `batch_size` (a partial last
        batch is zero-padded, its pad rows dropped). A FaceBox list per
        file, `detect()` semantics (/scale before NMS); [] for a file
        that cannot be read or decoded. Without the native codecs it
        runs `imread` + `detect_batch`."""
        if self.params is None:
            print("Model not loaded!")
            return [[] for _ in paths]
        if not native.codecs_available():
            return self.detect_batch([imread(p) for p in paths])
        size = self.cfg.det_input_size
        results: List[List[FaceBox]] = [[] for _ in paths]
        frames = np.zeros((batch_size, size, size, 3), np.uint8)
        scales = np.ones(batch_size, np.float32)
        idxs: List[int] = []

        def flush():
            if not idxs:
                return
            dets = self._detect_letterboxed(
                torch.from_numpy(frames).to(self.device), torch.from_numpy(scales).to(self.device)
            )
            for row, i in enumerate(idxs):
                results[i] = _int_rects(Detections(*(t[row] for t in dets)).to_face_boxes())
            frames[:] = 0
            scales[:] = 1.0
            idxs.clear()

        with native.NativeImageLoader(
            paths, size, threads=threads, capacity=max(8, 2 * batch_size)
        ) as loader:
            for idx, frame, scale in loader:
                if frame is None:
                    continue
                frames[len(idxs)] = frame
                scales[len(idxs)] = scale
                idxs.append(idx)
                if len(idxs) == batch_size:
                    flush()
        flush()
        return results


class FaceRecognizer:
    """Face embedder + comparator (IResNet, MobileFaceNet or ViT)."""

    def __init__(self, config: PipelineConfig = DEFAULT_CONFIG, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.params = None  # the recognizer module, once loaded

    def load_model(self, model_path: Optional[str] = None) -> bool:
        """Weights from `.npz` (either package's checkpoint format) or
        `.onnx` (mapped onto the native module when a mapper of
        `onnx_import.native_map` fits it, else run by the graph
        executor), or with model_path=None a random init from
        `cfg.seed + 1` (`bridge.init_params_numpy`, whose values differ
        from the JAX package's `jax.random` init). A native model's
        post-conv BNs are folded (each family's `fold_inference_params`).
        False on a missing or corrupt file."""
        from facerecognizeonnx_tpu_torch.onnx_import.native_map import map_recognizer

        cfg = self.cfg
        try:
            if model_path is not None and model_path.endswith(".onnx"):
                model = _load_onnx(model_path, self.device, lambda graph: map_recognizer(
                    graph, cfg.rec_arch, input_size=cfg.rec_input_size, device=self.device,
                ))
            else:
                tree = _load_tree(
                    model_path,
                    lambda: bridge.init_params_numpy(
                        cfg.rec_arch, seed=cfg.seed + 1, input_size=cfg.rec_input_size,
                        feature_dim=cfg.feature_dim,
                    ),
                )
                model = _to_module(tree, self.device)
        except ModelLoadError as e:
            print(f"Error loading model: {e}")
            return False
        if not isinstance(model, OnnxRunner) and model.features_bn is not None:
            model = recognizer_module_for(model).fold_inference_params(model)
        self.params = model
        print("Face recognizer model loaded successfully!")
        print(f"Using input size: {self.cfg.rec_input_size}x{self.cfg.rec_input_size}")
        if self.cfg.recognizer_quant == "w8a8":
            self.quantize()
        return True

    loadModel = load_model

    def quantize(self, calib_crops: Optional[np.ndarray] = None, min_channels: int = 0) -> bool:
        """Switch the loaded recognizer to w8a8 int8 (`models/quant.py`).

        calib_crops: (N, S, S, 3) uint8 BGR aligned crops for the
        activation calibration; by default 64 crops of noise drawn from
        `cfg.seed` (the JAX package's batch). min_channels quantizes only
        the convs at least that wide. False when no model is loaded or it
        is already quantized, or an ONNX graph runs it."""
        if self.params is None:
            print("Model not loaded!")
            return False
        if isinstance(self.params, OnnxRunner):
            print("Quantization needs native model params (not an ONNX graph)")
            return False
        if quant.is_quantized(self.params):
            print("Recognizer is already quantized")
            return False
        s = self.cfg.rec_input_size
        if calib_crops is None:
            rng = np.random.default_rng(self.cfg.seed)
            calib_crops = rng.integers(0, 256, (64, s, s, 3)).astype(np.uint8)
        x = normalize_to_rgb(
            torch.from_numpy(np.ascontiguousarray(calib_crops)).to(self.device),
            self.cfg.pixel_mean, self.cfg.pixel_scale, dtype=self.cfg.torch_compute_dtype,
        )
        self.params = quant.quantize_recognizer(self.params, x, min_channels=min_channels)
        print("Recognizer quantized to w8a8 int8")
        return True

    def extract_feature(self, image: np.ndarray, face: FaceBox) -> np.ndarray:
        """Aligned 512-d L2-normalized feature for one face; an empty
        array on failure."""
        feats = self.extract_features(image, [face])
        return feats[0] if len(feats) else np.zeros(0, np.float32)

    extractFeature = extract_feature

    def extract_features(self, image: np.ndarray, faces: Sequence[FaceBox]) -> np.ndarray:
        """All faces of a frame aligned and embedded in one batch →
        (len(faces), 512); the faces fill a power-of-two bucket of ≥ 8
        slots, as in the reference package."""
        if self.params is None:
            print("Model not loaded!")
            return np.zeros((0, 512), np.float32)
        if image is None or image.size == 0 or not faces:
            print("Input image is empty!")
            return np.zeros((0, 512), np.float32)
        k_bucket = max(8, 1 << (len(faces) - 1).bit_length())
        dets = face_boxes_to_arrays(list(faces), k_bucket)
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        with torch.no_grad():
            feats = embed_program(
                self.params, img, dets.kps.to(self.device), dets.boxes.to(self.device),
                dets.valid.to(self.device), self.cfg,
            )
        return feats.cpu().numpy()[: len(faces)]

    def extract_feature_simple(self, image: np.ndarray) -> np.ndarray:
        """Whole-image resize → embed, no detection or alignment."""
        if self.params is None:
            print("Model not loaded!")
            return np.zeros(0, np.float32)
        if image is None or image.size == 0:
            print("Input image is empty!")
            return np.zeros(0, np.float32)
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        with torch.no_grad():
            return embed_simple_program(self.params, img, self.cfg).cpu().numpy()

    extractFeatureSimple = extract_feature_simple

    @staticmethod
    def compare_faces(feature1, feature2) -> float:
        """(dot+1)/2 similarity; 0.0 on a size mismatch or an empty
        feature, as the reference guards."""
        f1 = np.asarray(feature1, np.float32).ravel()
        f2 = np.asarray(feature2, np.float32).ravel()
        if f1.size != f2.size or f1.size == 0:
            return 0.0
        return float((np.dot(f1, f2) + 1.0) / 2.0)

    compareFaces = compare_faces
