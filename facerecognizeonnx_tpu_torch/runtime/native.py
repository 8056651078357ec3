"""ctypes bindings of the port's native host runtime (runtime/cc/frt_runtime.cc).

Port of `facerecognizeonnx_tpu/runtime/native.py`. The library is built
with g++ at first use into the package's gitignored `_build/` directory,
named by a hash of the source and the flags (never next to the source),
first with the JPEG/PNG codecs and, if that build fails, without them,
as the reference Makefile does. It degrades as the reference does:
`native_available()` is False where no compiler builds it, and callers
take their torch host paths instead; `codecs_available()` is False in a
codec-less build, and callers decode with cv2 / PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from facerecognizeonnx_tpu_torch.errors import NativeRuntimeUnavailable

SOURCE = Path(__file__).resolve().parent / "cc" / "frt_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The reference Makefile's flags, plus -ffp-contract=off: the letterbox
# rounds (uint8)(v + 0.5f), and a host whose g++ contracts to FMA by
# default (aarch64) would round differently. No -march=native, no
# -ffast-math.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-ffp-contract=off", "-shared")
CODEC_BUILD = (("-DFRT_WITH_CODECS",), ("-ljpeg", "-lpng", "-lpthread"))
PLAIN_BUILD = ((), ("-lpthread",))

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _compile(defines, libs) -> Path:
    """g++ the source with these defines and libraries into `_build/`
    (once per source and flags); raises OSError or
    subprocess.CalledProcessError when it cannot."""
    flags = CXX_FLAGS + tuple(defines)
    tag = hashlib.sha1(
        SOURCE.read_bytes() + " ".join(flags + tuple(libs)).encode()
    ).hexdigest()[:12]
    so_path = BUILD_DIR / f"frt_runtime_{tag}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *flags, "-o", tmp, str(SOURCE), *libs],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so_path


def _bind(lib: ctypes.CDLL) -> None:
    lib.frt_letterbox.restype = ctypes.c_float
    lib.frt_letterbox.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.frt_nms.restype = ctypes.c_int
    lib.frt_nms.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.frt_ring_create.restype = ctypes.c_void_p
    lib.frt_ring_create.argtypes = [ctypes.c_int, ctypes.c_size_t]
    lib.frt_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.frt_ring_close.argtypes = [ctypes.c_void_p]
    lib.frt_ring_push.restype = ctypes.c_int
    lib.frt_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
    lib.frt_ring_pop.restype = ctypes.c_int
    lib.frt_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.frt_ring_size.restype = ctypes.c_int
    lib.frt_ring_size.argtypes = [ctypes.c_void_p]
    lib.frt_codecs_available.restype = ctypes.c_int
    lib.frt_codecs_available.argtypes = []
    lib.frt_image_info.restype = ctypes.c_int
    lib.frt_image_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.frt_decode.restype = ctypes.c_int
    lib.frt_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.frt_decode_letterbox.restype = ctypes.c_float
    lib.frt_decode_letterbox.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.frt_loader_create.restype = ctypes.c_void_p
    lib.frt_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.frt_loader_next.restype = ctypes.c_int
    lib.frt_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.frt_loader_destroy.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None where it cannot be built."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        for defines, libs in (CODEC_BUILD, PLAIN_BUILD):
            try:
                lib = ctypes.CDLL(str(_compile(defines, libs)))
                break
            except (OSError, subprocess.SubprocessError):
                continue
        else:
            _build_failed = True
            return None
        _bind(lib)
        lib.has_codecs = bool(lib.frt_codecs_available())
        _lib = lib
        return _lib


def _require():
    lib = _load()
    if lib is None:
        raise NativeRuntimeUnavailable("the native runtime could not be built (no g++?)")
    return lib


def native_available() -> bool:
    return _load() is not None


def codecs_available() -> bool:
    """True when the library was built with libjpeg / libpng."""
    lib = _load()
    return bool(lib is not None and lib.has_codecs)


def letterbox_native(image_bgr: np.ndarray, target: int):
    """uint8 letterbox on the host (reference geometry,
    src/face_detector.cpp:92-137). Returns ((target, target, 3) uint8,
    scale)."""
    lib = _require()
    img = np.ascontiguousarray(image_bgr, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    out = np.empty((target, target, 3), np.uint8)
    scale = lib.frt_letterbox(img.ctypes.data, h, w, out.ctypes.data, target)
    return out, float(scale)


def nms_native(
    boxes: np.ndarray, scores: np.ndarray, iou_threshold: float, int_rects: bool = True,
) -> np.ndarray:
    """Greedy NMS keep mask in the original order. int_rects=True
    computes IoU on integer-truncated rects, as the reference does
    (src/face_detector.cpp:340-354)."""
    lib = _require()
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    n = len(s)
    if b.shape != (n, 4):
        raise ValueError(f"boxes must be ({n}, 4), got {b.shape}")
    keep = np.zeros(n, np.int32)
    lib.frt_nms(b.ctypes.data, s.ctypes.data, n, iou_threshold, int(int_rects),
                keep.ctypes.data)
    return keep.astype(bool)


def decode_native(data: bytes):
    """JPEG / PNG bytes → BGR uint8 array (cv2.imdecode's channel order),
    decoded with the GIL released. None on failure or without codecs."""
    lib = _load()
    if lib is None or not lib.has_codecs:
        return None
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.frt_image_info(data, len(data), ctypes.byref(h), ctypes.byref(w)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.frt_decode(data, len(data), out.ctypes.data, h.value, w.value):
        return None
    return out


def decode_letterbox_native(data: bytes, target: int):
    """Decode + letterbox in one native call: encoded bytes →
    ((target, target, 3) BGR uint8, scale). None on failure."""
    lib = _load()
    if lib is None or not lib.has_codecs:
        return None
    out = np.empty((target, target, 3), np.uint8)
    scale = lib.frt_decode_letterbox(data, len(data), out.ctypes.data, target)
    if scale <= 0:
        return None
    return out, float(scale)


class NativeImageLoader:
    """Multi-threaded native file loader: C++ workers read, decode and
    letterbox a path list into a bounded queue; iterating yields
    (index, frame, scale) in completion order, and (index, None, 0.0) for
    a file that could not be read or decoded, so every input is
    accounted for."""

    def __init__(self, paths, target: int, threads: int = 1, capacity: int = 8):
        lib = _load()
        if lib is None or not lib.has_codecs:
            raise NativeRuntimeUnavailable("the native runtime is missing or has no codecs")
        self._lib = lib
        self.target = int(target)
        self.n = len(paths)
        arr = (ctypes.c_char_p * self.n)(*[os.fsencode(p) for p in paths])
        self._h = lib.frt_loader_create(arr, self.n, self.target, int(threads), int(capacity))
        if not self._h:
            raise NativeRuntimeUnavailable("frt_loader_create failed")

    def __iter__(self):
        while self._h:
            out = np.empty((self.target, self.target, 3), np.uint8)
            scale, index = ctypes.c_float(0.0), ctypes.c_int(-1)
            rc = self._lib.frt_loader_next(
                self._h, out.ctypes.data, ctypes.byref(scale), ctypes.byref(index), 30_000,
            )
            if rc == -2:
                return
            if rc == -1:
                raise TimeoutError("native loader stalled (30 s)")
            if rc == -3:
                yield index.value, None, 0.0
            else:
                yield index.value, out, float(scale.value)

    def close(self) -> None:
        """Stop the workers (even mid-list) and free the loader."""
        if self._h:
            self._lib.frt_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class FrameRing:
    """Bounded ring of fixed-size uint8 frames in native memory."""

    def __init__(self, capacity: int, frame_shape):
        self._lib = _require()
        self.frame_shape = tuple(frame_shape)
        self._h = self._lib.frt_ring_create(capacity, int(np.prod(frame_shape)))
        self.closed = False

    def push(self, frame: np.ndarray, scale: float = 1.0, timeout_ms: int = 1000) -> bool:
        """False when the ring stayed full for timeout_ms or is closed."""
        f = np.ascontiguousarray(frame, np.uint8)
        if f.shape != self.frame_shape:
            raise ValueError(f"frame shape {f.shape} != ring's {self.frame_shape}")
        return self._lib.frt_ring_push(self._h, f.ctypes.data, scale, timeout_ms) == 0

    def pop(self, timeout_ms: int = 1000):
        """(frame, scale); None once the ring is closed and drained."""
        out = np.empty(self.frame_shape, np.uint8)
        scale = ctypes.c_float(0.0)
        rc = self._lib.frt_ring_pop(self._h, out.ctypes.data, ctypes.byref(scale), timeout_ms)
        if rc == -2:
            return None
        if rc == -1:
            raise TimeoutError("frame ring pop timed out")
        return out, float(scale.value)

    def close(self) -> None:
        """No more pushes; pops drain what is left."""
        self.closed = True
        self._lib.frt_ring_close(self._h)

    def __len__(self) -> int:
        return self._lib.frt_ring_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.frt_ring_destroy(self._h)
            self._h = None


class PrefetchLoader:
    """A producer thread reads frames from an iterator, letterboxes them
    natively and pushes them into a FrameRing; the consumer pops them
    with `frames()`. Host letterbox overlaps device compute. `close()`
    stops the producer early (the source may be endless, a camera)."""

    def __init__(self, frame_iter, target: int, capacity: int = 8):
        self.ring = FrameRing(capacity, (target, target, 3))
        self.target = target
        self._thread = threading.Thread(target=self._produce, args=(frame_iter,), daemon=True)
        self._thread.start()

    def _produce(self, frame_iter):
        try:
            for frame in frame_iter:
                padded, scale = letterbox_native(frame, self.target)
                while not self.ring.push(padded, scale, timeout_ms=200):
                    if self.ring.closed:
                        return
                if self.ring.closed:
                    return
        finally:
            self.ring.close()

    def frames(self) -> Iterator:
        while True:
            item = self.ring.pop(timeout_ms=10_000)
            if item is None:
                return
            yield item

    def close(self) -> None:
        """Stop the producer and wait for it."""
        self.ring.close()
        self._thread.join(timeout=10)

    def join(self, timeout=None):
        self._thread.join(timeout)
