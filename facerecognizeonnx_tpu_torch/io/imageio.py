"""Host image and video I/O.

Port of `facerecognizeonnx_tpu/io/imageio.py`: decode and encode stay on
the host, every pixel operation after this boundary runs on the device.
`decode_image` (and `imread`, which reads a file into it) decodes with
the native runtime, and otherwise with cv2, then PIL, then `decode_png`,
a PNG reader of the standard library and numpy: a host without libjpeg /
libpng (for the native codecs), cv2 and PIL reads PNG only. cv2 and PIL
are imported only when a call needs them, so nothing else in the port
depends on either.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Iterator, Optional, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples per pixel: grey, RGB, grey + alpha, RGBA
# (palette images, type 3, are not read)
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _cv2():
    """The cv2 module, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    """PIL's Image module, or None where it does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _unfilter(raw: np.ndarray, bpp: int) -> Optional[np.ndarray]:
    """(h, 1 + stride) filtered scanlines → (h, stride) uint8 samples,
    the five PNG filter types undone; None on a type out of range."""
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        return None
    if types.max(initial=0) >= 3:
        return _unfilter_wavefront(raw, bpp)
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = out[0]  # the row above the first is zeros
    for y in range(h):
        ftype, line = int(types[y]), raw[y, 1:]
        if ftype == 0:  # None
            out[y] = line
        elif ftype == 1:  # Sub: a running sum down each sample's column
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            out[y] = line + prior
        prior = out[y]
    return out


def _unfilter_wavefront(raw: np.ndarray, bpp: int) -> np.ndarray:
    """`_unfilter` for images with Average or Paeth rows, whose every
    pixel needs the one left of it. A pixel needs only its left, upper and
    upper-left neighbours, so the pixels of one anti-diagonal x + y = d
    are undone together, d = 0 .. h + w - 2. The image is stored skewed,
    pixel (y, x) at row y + 1 and column x + y + 2 of `out` (the zero row
    and columns before it stand for the pixels outside the image), so a
    diagonal is one column and its neighbours are slices."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    w = stride // bpp
    ys, xs = np.mgrid[0:h, 0:w]
    line = np.zeros((h, h + w - 1, bpp), np.int16)
    line[ys, xs + ys] = raw[:, 1:].reshape(h, w, bpp)
    out = np.zeros((h + 1, h + w + 1, bpp), np.int16)
    types = raw[:, 0, None]
    sub, up, avg, paeth = (types == 1), (types == 2), (types == 3), (types == 4)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = out[y0 + 1:y1 + 1, d + 1]
        b = out[y0:y1, d + 1]
        c = out[y0:y1, d]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where(
            paeth[y0:y1],
            np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)),
            np.where(avg[y0:y1], (a + b) >> 1,
                     np.where(up[y0:y1], b, np.where(sub[y0:y1], a, 0))),
        )
        out[y0 + 1:y1 + 1, d + 2] = (line[y0:y1, d] + pred) & 0xFF
    return out[1:, 2:][ys, xs + ys].reshape(h, stride).astype(np.uint8)


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes → (H, W, 3) BGR uint8, as cv2.imdecode(IMREAD_COLOR)
    gives them: grey replicated to three channels, alpha dropped.
    Reads 8-bit, non-interlaced grey, grey + alpha, RGB and RGBA images
    with any of the five filter types; None for anything else (16-bit,
    palette, interlaced, damaged)."""
    if not data.startswith(PNG_SIGNATURE):
        return None
    pos, header, idat = len(PNG_SIGNATURE), None, []
    try:
        while pos + 8 <= len(data):
            length, tag = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + length]
            if len(body) < length:
                return None
            if tag == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif tag == b"IDAT":
                idat.append(body)
            elif tag == b"IEND":
                break
            pos += 12 + length
        if header is None:
            return None
        w, h, depth, ctype, _, _, interlace = header
        if depth != 8 or interlace != 0 or ctype not in PNG_CHANNELS or not w or not h:
            return None
        ch = PNG_CHANNELS[ctype]
        raw = zlib.decompress(b"".join(idat))
    except (struct.error, zlib.error):
        return None
    n = h * (w * ch + 1)
    if len(raw) < n:
        return None
    px = _unfilter(np.frombuffer(raw, np.uint8, n).reshape(h, -1), ch)
    if px is None:
        return None
    px = px.reshape(h, w, ch)
    if ch <= 2:  # grey (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) → BGR


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes → BGR uint8 (cv2.imdecode semantics); None
    when no decoder here reads them. Tries the native decoder (JPEG /
    PNG, GIL-free), cv2, PIL and `decode_png`, in that order, and
    returns the first image read."""
    from facerecognizeonnx_tpu_torch.runtime import native

    img = native.decode_native(data)
    if img is not None:
        return img
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is not None:
            return img
    image = _pil_image()
    if image is not None:
        try:
            with image.open(io.BytesIO(data)) as im:  # RGB: flip to BGR
                return np.asarray(im.convert("RGB"))[..., ::-1].copy()
        except (OSError, ValueError):
            pass
    return decode_png(data)


def imread(path: str) -> Optional[np.ndarray]:
    """Read an image file as BGR uint8 (cv::imread semantics); None when
    it cannot be read or decoded (`decode_image`)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_image(data)


def imwrite(path: str, image_bgr: np.ndarray) -> bool:
    """Encode with cv2, else PIL; raises RuntimeError where neither
    imports (the port carries no encoder of its own)."""
    cv2 = _cv2()
    if cv2 is not None:
        return bool(cv2.imwrite(path, image_bgr))
    image = _pil_image()
    if image is None:
        raise RuntimeError(
            f"cannot write {path}: no image encoder here (neither cv2 nor PIL imports)"
        )
    image.fromarray(np.ascontiguousarray(image_bgr[..., ::-1])).save(path)
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
