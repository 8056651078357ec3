"""Host image and video I/O.

Port of `facerecognizeonnx_tpu/io/imageio.py`: decode and encode stay on
the host, every pixel operation after this boundary runs on the device.
`imread` decodes JPEG / PNG with the native runtime, and otherwise with
cv2, then PIL. cv2 and PIL are imported only when a call needs them, so
nothing else in the port depends on either.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

import numpy as np


def _cv2():
    """The cv2 module, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def imread(path: str) -> Optional[np.ndarray]:
    """Read an image as BGR uint8 (cv::imread semantics); None on failure.

    JPEG / PNG go through the native decoder (GIL-free); other formats
    and codec-less builds take cv2, then PIL."""
    if path.lower().endswith((".jpg", ".jpeg", ".png")):
        from facerecognizeonnx_tpu_torch.runtime import native

        try:
            with open(path, "rb") as f:
                img = native.decode_native(f.read())
        except OSError:
            return None
        if img is not None:
            return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.imread(path)
    from PIL import Image  # PIL gives RGB: flip to BGR

    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))[..., ::-1].copy()
    except OSError:
        return None


def imwrite(path: str, image_bgr: np.ndarray) -> bool:
    cv2 = _cv2()
    if cv2 is not None:
        return bool(cv2.imwrite(path, image_bgr))
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(image_bgr[..., ::-1])).save(path)
    return True


class VideoSource:
    """Frame iterator over a camera index or a video file (cv2), or
    "synthetic:WxHxN": N frames of seeded noise, shifted 7 px each, for
    runs without a camera."""

    def __init__(self, source: Union[int, str] = 0):
        self._synthetic = None
        self._cap = None
        if isinstance(source, str) and source.startswith("synthetic:"):
            w, h, n = (int(v) for v in source.split(":", 1)[1].split("x"))
            self._synthetic = (w, h, n)
        else:
            cv2 = _cv2()
            if cv2 is None:
                raise RuntimeError("OpenCV unavailable; only synthetic sources work")
            self._cap = cv2.VideoCapture(source)

    def is_open(self) -> bool:
        if self._synthetic is not None:
            return True
        return bool(self._cap and self._cap.isOpened())

    def frames(self) -> Iterator[np.ndarray]:
        if self._synthetic is not None:
            w, h, n = self._synthetic
            base = np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)
            for i in range(n):
                yield np.roll(base, i * 7, axis=1)
            return
        while True:
            ok, frame = self._cap.read()
            if not ok or frame is None:
                return
            yield frame

    def release(self) -> None:
        if self._cap is not None:
            self._cap.release()
