"""The port's native host runtime (C++ letterbox, NMS oracle, frame ring,
JPEG/PNG decode, threaded file loader), built with g++ at first use."""

from facerecognizeonnx_tpu_torch.runtime.native import (
    FrameRing,
    NativeImageLoader,
    PrefetchLoader,
    codecs_available,
    letterbox_native,
    native_available,
    nms_native,
)

__all__ = [
    "FrameRing",
    "NativeImageLoader",
    "PrefetchLoader",
    "codecs_available",
    "letterbox_native",
    "native_available",
    "nms_native",
]
