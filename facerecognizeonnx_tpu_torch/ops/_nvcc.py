"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled with nvcc for sm_90a into a plain-C shared
library (no PyTorch headers, so a build takes seconds), named by a hash
of the source, every header of `csrc/` (`*.cuh`, which the sources
include) and the flags, in the package's gitignored `_build/`
directory, and loaded with ctypes. A library is built at most once per
process; a later process reuses the file. Builds of different sources
may run at once (one lock per source).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Tuple

from facerecognizeonnx_tpu_torch.errors import KernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# No --use_fast_math: it changes log2f / exp2f and divisions, which the
# warp kernel's face table must compute as torch does. -ldl: the gallery
# kernel takes cuTensorMapEncodeTiled from libcuda with dlopen/dlsym.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-ldl",
)

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def build_library(
    source: str, bind: Callable[[ctypes.CDLL], None]
) -> Tuple[ctypes.CDLL, str]:
    """Compile `csrc/<source>` (once per source and flags) and load it;
    `bind` declares the library's argtypes and restypes.

    Returns (library, nvcc's output): the output holds -Xptxas -v's
    register and spill report, and is empty when the library was already
    loaded or built."""
    from torch.utils.cpp_extension import CUDA_HOME

    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _libs:
            return _libs[source], ""
        path = CSRC / source
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        tag = hashlib.sha1(
            path.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
        so_path = BUILD_DIR / f"{path.stem}_{tag}.so"
        log = ""
        if not so_path.exists():
            if CUDA_HOME is None:
                raise KernelError(f"no CUDA toolkit found to build csrc/{source}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", tmp, str(path)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise KernelError(f"nvcc failed on csrc/{source} ({proc.returncode}):\n{log}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        bind(lib)
        _libs[source] = lib
        return lib, log
