"""Host-side result overlay (the reference's drawFaceInfo): a green box,
red landmark dots and score / similarity / label text on a filled
background.

Port of `facerecognizeonnx_tpu/utils/draw.py`. Drawing stays on the host
and never touches the device path. cv2 is imported when a call draws;
where it does not import, drawing is a no-op, as in the reference
package.
"""

from __future__ import annotations

import numpy as np

from facerecognizeonnx_tpu_torch.types import FaceBox


def draw_face_info(
    image: np.ndarray,
    face: FaceBox,
    label: str = "",
    similarity: float = -1.0,
) -> None:
    try:
        import cv2
    except ImportError:
        return
    x, y, w, h = (int(v) for v in face.box)
    cv2.rectangle(image, (x, y), (x + w, y + h), (0, 255, 0), 2)
    for lx, ly in np.asarray(face.landmarks):
        cv2.circle(image, (int(lx), int(ly)), 2, (0, 0, 255), -1)
    text = f"Score: {face.score:.3f}"
    if similarity >= 0:
        text += f" | Sim: {similarity:.3f}"
    if label:
        text = f"{label} | {text}"
    (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
    cv2.rectangle(image, (x, y - th - 10), (x + tw, y), (0, 255, 0), -1)
    cv2.putText(image, text, (x, y - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
