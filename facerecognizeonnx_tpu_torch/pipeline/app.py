"""FaceApp — one object in front of the whole pipeline.

Port of `facerecognizeonnx_tpu/pipeline/app.py`. The reference wires the
detector and the recognizer together by hand in every mode; FaceApp
packages that wiring once, InsightFace-FaceAnalysis-style:

    app = FaceApp.from_pack("buffalo_sc", model_dir="models/")
    faces = app.get(image)           # detected + embedded
    same, sim = app.verify(img1, img2)

Detection and embedding stay the components' batched programs
(FaceDetector.detect, FaceRecognizer.extract_features) on the models'
device: the card unless they were built for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from facerecognizeonnx_tpu_torch.types import FaceBox


@dataclass
class Face:
    """One detected face with its 512-d L2-normalized embedding."""

    box: FaceBox
    embedding: np.ndarray  # (D,) float32

    @property
    def score(self) -> float:
        return self.box.score

    @property
    def landmarks(self) -> np.ndarray:
        return self.box.landmarks


class FaceApp:
    def __init__(self, detector, recognizer, gallery=None):
        """detector / recognizer: a loaded FaceDetector / FaceRecognizer;
        the app runs on the detector's device."""
        self.detector = detector
        self.recognizer = recognizer
        self.device = detector.device
        self._bank = gallery  # lazy GalleryBank; built on first use

    @classmethod
    def from_pack(
        cls,
        name: str = "buffalo_sc",
        model_dir: Optional[str] = None,
        quant: Optional[str] = None,
        device="cuda",
    ) -> "FaceApp":
        """Build from a named buffalo pack (models/packs.py) on `device`:
        the pack's `.onnx` files where they are in model_dir, seeded
        weights where they are absent."""
        from facerecognizeonnx_tpu_torch.models.packs import load_pack

        detector, recognizer = load_pack(name, model_dir=model_dir, quant=quant, device=device)
        return cls(detector, recognizer)

    def get(self, image: np.ndarray, max_faces: Optional[int] = None) -> List[Face]:
        """Detect and embed every face of a BGR uint8 image, all faces of
        the frame in one embed batch."""
        faces = self.detector.detect(image)
        if max_faces is not None:
            faces = faces[:max_faces]
        if not faces:
            return []
        feats = self.recognizer.extract_features(image, faces)
        return [Face(box=f, embedding=e) for f, e in zip(faces, feats)]

    def compare(self, image1: np.ndarray, image2: np.ndarray) -> float:
        """Reference compare-mode semantics: best face of each image,
        (cos+1)/2 similarity; 0.0 when either image has no detectable
        face (the reference's empty-feature guard)."""
        a = self.get(image1, max_faces=1)
        b = self.get(image2, max_faces=1)
        if not a or not b:
            return 0.0
        return self.recognizer.compare_faces(a[0].embedding, b[0].embedding)

    def verify(
        self, image1: np.ndarray, image2: np.ndarray, threshold: float = 0.6
    ) -> Tuple[bool, float]:
        """(same-person verdict, similarity) at the reference's 0.6."""
        sim = self.compare(image1, image2)
        return bool(sim > threshold), sim

    # ------------------------------------------------- gallery (1:N)

    @property
    def gallery(self):
        """The app's GalleryBank on the app's device (created on first
        use). Assignable — e.g. `app.gallery = GalleryBank.load("g.npz")`."""
        if self._bank is None:
            from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank

            self._bank = GalleryBank(device=self.device)
        return self._bank

    @gallery.setter
    def gallery(self, bank):
        self._bank = bank

    def enroll(self, name: str, image: np.ndarray) -> bool:
        """Detect + embed the best face and add it under `name`. False
        when no face is found (nothing is added)."""
        faces = self.get(image, max_faces=1)
        if not faces:
            return False
        self.gallery.add(name, faces[0].embedding)
        return True

    def identify(
        self, image: np.ndarray, top_k: int = 1, threshold: float = 0.6
    ) -> List[dict]:
        """1:N search for every face of the image against the app's
        gallery: [{"face": Face, "label": name-or-"Unknown",
        "matches": [(name, sim), ...]}, ...]. Empty gallery or no faces
        → []. Labels use the reference threshold on (cos+1)/2."""
        if self._bank is None or not len(self._bank):
            return []
        faces = self.get(image)
        if not faces:
            return []
        feats = np.stack([f.embedding for f in faces])
        names, sims = self.gallery.search(feats, top_k=min(top_k, len(self._bank)))
        out = []
        for face, nrow, srow in zip(faces, names, sims):
            best = nrow[0] if float(srow[0]) > threshold else "Unknown"
            out.append({
                "face": face,
                "label": best,
                "matches": [(str(n), float(s)) for n, s in zip(nrow, srow)],
            })
        return out
