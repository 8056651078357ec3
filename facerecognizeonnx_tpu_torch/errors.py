"""Typed errors raised by the port (the subset of the JAX package's
hierarchy this package raises, plus the kernel error)."""


class FrtError(Exception):
    """Base class for facerecognizeonnx_tpu_torch errors."""


class ModelLoadError(FrtError):
    """Weights missing/corrupt, or a param tree of no known model."""


class InvalidInputError(FrtError, ValueError):
    """Image/tensor input fails shape, dtype or device validation."""


class KernelError(FrtError, RuntimeError):
    """A hand-written CUDA kernel failed to build, load or launch."""


class GalleryError(FrtError, ValueError):
    """Gallery bank misuse (dim mismatch, missing file)."""


class NativeRuntimeUnavailable(FrtError, RuntimeError):
    """The native host runtime (runtime/cc/frt_runtime.cc) could not be
    built or loaded."""


class UnsupportedOnnxOp(FrtError, NotImplementedError):
    """The graph executor hit an op outside its registry."""
