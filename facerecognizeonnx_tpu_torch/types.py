"""Result types.

`FaceBox` is the host-facing record of one face. `Detections` is its
fixed-shape, batched structure-of-arrays form as torch tensors: a frame
always yields `max_faces` slots plus a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass
class FaceBox:
    """One detected face in original-image pixel coordinates.

    box = (x, y, w, h); landmarks = (5, 2) array ordered L-eye, R-eye,
    nose, L-mouth, R-mouth.
    """

    box: tuple
    score: float
    landmarks: np.ndarray

    @property
    def x1(self) -> float:
        return self.box[0]

    @property
    def y1(self) -> float:
        return self.box[1]

    @property
    def x2(self) -> float:
        return self.box[0] + self.box[2]

    @property
    def y2(self) -> float:
        return self.box[1] + self.box[3]


class Detections(NamedTuple):
    """Fixed-shape detections for one image (or a batch).

    boxes:  (..., K, 4) x1,y1,x2,y2 in original-image pixels
    scores: (..., K)
    kps:    (..., K, 5, 2)
    valid:  (..., K) bool — True for real detections, False for padding.

    Slots are sorted by descending score; padding slots carry score 0.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    kps: torch.Tensor
    valid: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def to_face_boxes(self) -> list:
        """Convert a single image's detections to a host FaceBox list."""
        boxes, scores, kps = (t.detach().float().cpu().numpy() for t in self[:3])
        valid = self.valid.detach().cpu().numpy()
        if boxes.ndim != 2:
            raise ValueError("to_face_boxes expects unbatched detections")
        out = []
        for i in range(boxes.shape[0]):
            if not valid[i]:
                continue
            x1, y1, x2, y2 = (float(v) for v in boxes[i])
            out.append(
                FaceBox(
                    box=(x1, y1, x2 - x1, y2 - y1),
                    score=float(scores[i]),
                    landmarks=np.asarray(kps[i], dtype=np.float32),
                )
            )
        return out


def face_boxes_to_arrays(faces, max_faces: int) -> Detections:
    """Pack a FaceBox list into fixed-shape host tensors (the inverse of
    `Detections.to_face_boxes`): (max_faces, ...) slots, the first
    len(faces) valid."""
    boxes = np.zeros((max_faces, 4), np.float32)
    scores = np.zeros((max_faces,), np.float32)
    kps = np.zeros((max_faces, 5, 2), np.float32)
    valid = np.zeros((max_faces,), bool)
    for i, f in enumerate(faces[:max_faces]):
        boxes[i] = (f.x1, f.y1, f.x2, f.y2)
        scores[i] = f.score
        kps[i] = f.landmarks
        valid[i] = True
    return Detections(
        boxes=torch.from_numpy(boxes),
        scores=torch.from_numpy(scores),
        kps=torch.from_numpy(kps),
        valid=torch.from_numpy(valid),
    )
