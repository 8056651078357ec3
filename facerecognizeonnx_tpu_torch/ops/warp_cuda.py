"""The alignment warp on the GPU: a hand-written CUDA kernel (csrc/warp_xm.cu)
and its plain-torch version.

Port of `facerecognizeonnx_tpu/ops/warp_pallas.py` x-major path
(`_warp_affine_pallas_xm` + `_kernel_xm`). What it computes, per face:

  1. a 4-level mip pyramid of each frame: level l = 2x2 average of the
     UNROUNDED level l-1 (odd edges dropped), each level stored rounded
     (half-to-even) — every value is an integer 0..255, so the pyramid
     is uint8, exact;
  2. the inverse affine, a level chosen from its source extent against
     COVER=110 px, and a window origin x_lo = floor(x_min/16)·16,
     y_lo = floor(y_min/128)·128 (clipped to the canvas); taps outside
     the 128(x)×256(y) window read zero, so the origin rounding is part
     of the result for faces larger than level-3 coverage;
  3. the six float parameters in the kernel's fixed point (2^20 for the
     coefficients, 2^16 for the translations, after nan_to_num and
     clips to ±2000 / ±30000);
  4. per output pixel a bilinear resample: y hat weights rounded to
     bf16, x hat weights in f32, f32 sums y first;
  5. optionally the epilogue (channel 2-c, (s-mean)/scale, bf16) and the
     valid-slot skip (zeros, no reads).

`warp_affine_xm` launches the kernel for CUDA tensors and counts its
launches in `warp_affine_xm.launches`; for CPU tensors it runs
`warp_affine_xm_reference`, the plain version. A CUDA tensor never takes
the plain version: the kernel launches or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from facerecognizeonnx_tpu_torch.errors import InvalidInputError, KernelError
from facerecognizeonnx_tpu_torch.ops.warp import invert_affine

NUM_LEVELS = 4
OUT = 112
COVER = 110.0
WIN_X, WIN_Y = 128, 256  # window: x extent, y extent
ALIGN_X, ALIGN_Y = 16, 128  # window origin rounding
PAD_W, PAD_H = 656, 768  # the reference's zero canvas (x, y)
MAX_X_LO = float(((PAD_W - WIN_X) // ALIGN_X) * ALIGN_X)  # 528
MAX_Y_LO = float(((PAD_H - WIN_Y) // ALIGN_Y) * ALIGN_Y)  # 512
MAX_W, MAX_H = PAD_W - ALIGN_X, PAD_H - ALIGN_Y  # 640, 640
FP_COEF = float(1 << 20)
FP_TX = float(1 << 16)
N_PARAMS = 9  # level, x_lo, y_lo, a, b, c, d, tx_loc, ty_loc

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "warp_xm.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


# ---------------------------------------------------------------- shared parts


def level_sizes(H: int, W: int):
    """[(H_l, W_l)] of the pyramid levels (VALID 2x2 pooling floors)."""
    return [(H >> lvl, W >> lvl) for lvl in range(NUM_LEVELS)]


def build_pyramid_xm(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, P) uint8: the 4 levels, each (H_l, W_l, 3)
    row-major, concatenated per frame (P = Σ 3·H_l·W_l).

    Level l pools the unrounded float level l-1; every partial sum is a
    dyadic fraction with few bits, so it is exact in f32 in any order."""
    B = frames_u8.shape[0]
    level = frames_u8.permute(0, 3, 1, 2).to(torch.float32)
    parts = []
    for lvl in range(NUM_LEVELS):
        if lvl:
            level = F.avg_pool2d(level, 2)
        parts.append(
            torch.round(level).to(torch.uint8).permute(0, 2, 3, 1).reshape(B, -1)
        )
    return torch.cat(parts, dim=1)


def face_params_xm(Ms: torch.Tensor) -> torch.Tensor:
    """(B, K, 2, 3) forward affines → (B·K, 9) float32 per-face table:
    level, x_lo, y_lo, then a, b, c, d, tx_loc, ty_loc — the inverse
    affine at the chosen level in window-local coordinates, in the same
    f32 ops and fixed-point rounding as `_warp_affine_pallas_xm`."""
    Minv = invert_affine(Ms.to(torch.float32)).reshape(-1, 2, 3)
    a, b, tx = Minv[:, 0, 0], Minv[:, 0, 1], Minv[:, 0, 2]
    c, d, ty = Minv[:, 1, 0], Minv[:, 1, 1], Minv[:, 1, 2]

    span_x = (OUT - 1) * (a.abs() + b.abs()) + 2.0
    span_y = (OUT - 1) * (c.abs() + d.abs()) + 2.0
    extent = torch.maximum(span_x, span_y)
    level = torch.clamp(
        torch.ceil(torch.log2(torch.clamp_min(extent / COVER, 1e-6))),
        0, NUM_LEVELS - 1,
    )
    factor = torch.exp2(level)
    af, bf, cf, df = (v / factor for v in (a, b, c, d))
    txf = (tx + 0.5) / factor - 0.5
    tyf = (ty + 0.5) / factor - 0.5

    zero = torch.zeros_like(af)
    big = 1e7
    x_min = torch.clamp(
        torch.minimum(af * (OUT - 1), zero) + torch.minimum(bf * (OUT - 1), zero) + txf,
        -big, big,
    )
    y_min = torch.clamp(
        torch.minimum(cf * (OUT - 1), zero) + torch.minimum(df * (OUT - 1), zero) + tyf,
        -big, big,
    )
    x_lo = torch.clamp(torch.floor(x_min / ALIGN_X) * ALIGN_X, 0.0, MAX_X_LO)
    y_lo = torch.clamp(torch.floor(y_min / ALIGN_Y) * ALIGN_Y, 0.0, MAX_Y_LO)

    def fixed(v, scale, lim):
        # float32(int32(round(v·scale)))·scale⁻¹: every step is exact in f32
        v = torch.clamp(torch.nan_to_num(v), -lim, lim)
        return torch.round(v * scale) * (1.0 / scale)

    return torch.stack(
        [
            level, x_lo, y_lo,
            fixed(af, FP_COEF, 2000.0), fixed(bf, FP_COEF, 2000.0),
            fixed(cf, FP_COEF, 2000.0), fixed(df, FP_COEF, 2000.0),
            fixed(txf - x_lo, FP_TX, 30000.0), fixed(tyf - y_lo, FP_TX, 30000.0),
        ],
        dim=-1,
    ).contiguous()


def _check_inputs(frames_u8, Ms, valid):
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise InvalidInputError(
            f"frames must be (B, H, W, 3) uint8, got {tuple(frames_u8.shape)} "
            f"{frames_u8.dtype}"
        )
    B, H, W, _ = frames_u8.shape
    if H > MAX_H or W > MAX_W:
        raise InvalidInputError(f"frames up to {MAX_H}x{MAX_W}, got {H}x{W}")
    if Ms.dim() != 4 or Ms.shape[0] != B or Ms.shape[2:] != (2, 3):
        raise InvalidInputError(f"Ms must be ({B}, K, 2, 3), got {tuple(Ms.shape)}")
    if Ms.device != frames_u8.device:
        raise InvalidInputError("frames and Ms must lie on one device")
    if valid is not None and (
        tuple(valid.shape) != tuple(Ms.shape[:2]) or valid.device != frames_u8.device
    ):
        raise InvalidInputError(
            f"valid must be {tuple(Ms.shape[:2])} on the frames' device"
        )


def _finish(s: torch.Tensor, B: int, K: int, epilogue, valid) -> torch.Tensor:
    """(N, 112, 112, 3) f32 sums → the public (B, K, 112, 112, 3) output."""
    if epilogue is not None:
        mean, scale = epilogue
        s = ((s - mean) * (1.0 / scale)).flip(-1).to(torch.bfloat16)
    s = s.reshape(B, K, OUT, OUT, 3)
    if valid is not None:
        s = torch.where(valid.to(torch.bool)[..., None, None, None], s, torch.zeros_like(s))
    return s


# ---------------------------------------------------------------- plain version


def resample_xm_reference(
    pyr: torch.Tensor,
    prm: torch.Tensor,
    H: int,
    W: int,
    K: int,
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain-torch version of the kernel, on any device: vectorized gather
    and arithmetic over a pyramid (`build_pyramid_xm`) and a per-face
    table (`face_params_xm`) of B frames of H x W and K faces each.

    Returns (B, K, 112, 112, 3): raw f32 BGR, or with epilogue=(mean,
    scale) bf16 normalized RGB. valid (B, K): invalid slots are zeros."""
    B = pyr.shape[0]
    N = B * K
    dev = pyr.device
    pyr = pyr.reshape(-1)

    sizes = level_sizes(H, W)
    offs = [0]
    for h, w in sizes[:-1]:
        offs.append(offs[-1] + 3 * h * w)
    level = prm[:, 0].long()
    hl = torch.tensor([h for h, _ in sizes], device=dev)[level][:, None, None]
    wl = torch.tensor([w for _, w in sizes], device=dev)[level][:, None, None]
    base = (
        torch.arange(N, device=dev) // K * (3 * sum(h * w for h, w in sizes))
        + torch.tensor(offs, device=dev)[level]
    )[:, None, None]
    x_lo = prm[:, 1].long()[:, None, None]
    y_lo = prm[:, 2].long()[:, None, None]
    a, b, c, d, tx, ty = (prm[:, k, None, None] for k in range(3, 9))

    ii = torch.arange(OUT, dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(OUT, dtype=torch.float32, device=dev)[None, :]
    lx = (a * jj + b * ii + tx).clamp(-2.0, WIN_X + 1.0)  # (N, 112, 112)
    ly = (c * jj + d * ii + ty).clamp(-2.0, WIN_Y + 1.0)
    x0 = torch.floor(lx)
    y0 = torch.floor(ly)
    chan = torch.arange(3, device=dev)

    s = torch.zeros((N, OUT, OUT, 3), dtype=torch.float32, device=dev)
    for dx in (0, 1):
        xw = x0 + dx
        wx = torch.clamp_min(1.0 - (lx - xw).abs(), 0.0)
        t = torch.zeros_like(s)
        for dy in (0, 1):
            yw = y0 + dy
            wy = torch.clamp_min(1.0 - (ly - yw).abs(), 0.0)
            wy = wy.to(torch.bfloat16).to(torch.float32)
            gx = x_lo + xw.long()
            gy = y_lo + yw.long()
            ok = (
                (xw >= 0) & (xw < WIN_X) & (yw >= 0) & (yw < WIN_Y)
                & (gx < wl) & (gy < hl)
            )
            idx = base + (gy.clamp_min(0) * wl + gx.clamp_min(0)) * 3
            idx = torch.where(ok, idx, torch.zeros_like(idx))
            px = pyr[idx[..., None] + chan].to(torch.float32)
            px = torch.where(ok[..., None], px, torch.zeros_like(px))
            t = t + wy[..., None] * px
        s = s + t * wx[..., None]
    return _finish(s, B, K, epilogue, valid)


def warp_affine_xm_reference(
    frames_u8: torch.Tensor,
    Ms: torch.Tensor,
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The whole warp in plain torch: pyramid, per-face table, resample.

    frames_u8 (B, H, W, 3) uint8, Ms (B, K, 2, 3) → (B, K, 112, 112, 3)."""
    _check_inputs(frames_u8, Ms, valid)
    _, H, W, _ = frames_u8.shape
    return resample_xm_reference(
        build_pyramid_xm(frames_u8), face_params_xm(Ms), H, W, Ms.shape[1],
        epilogue, valid,
    )


# ---------------------------------------------------------------- the kernel

_lib = None
_lib_lock = threading.Lock()


def build_library() -> Tuple[ctypes.CDLL, str]:
    """Compile csrc/warp_xm.cu with nvcc for sm_90a (once per source and
    flags, into the package's _build directory) and load it.

    Returns (library, nvcc's output) — the output holds -Xptxas -v's
    register and spill report, empty when the library was already built.
    """
    global _lib
    from torch.utils.cpp_extension import CUDA_HOME

    with _lib_lock:
        if _lib is not None:
            return _lib, ""
        src = SOURCE.read_bytes()
        tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        so_path = BUILD_DIR / f"warp_xm_{tag}.so"
        log = ""
        if not so_path.exists():
            if CUDA_HOME is None:
                raise KernelError("no CUDA toolkit found to build csrc/warp_xm.cu")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
                   "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise KernelError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        lib.warp_xm_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.warp_xm_launch.restype = ctypes.c_int
        lib.warp_xm_error_string.argtypes = [ctypes.c_int]
        lib.warp_xm_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib, log


def resample_xm(
    pyr: torch.Tensor,
    prm: torch.Tensor,
    H: int,
    W: int,
    K: int,
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch csrc/warp_xm.cu on CUDA tensors: the kernel counterpart of
    `resample_xm_reference`, same arguments and output. Counts the
    launch in `warp_affine_xm.launches`."""
    B = pyr.shape[0]
    N = B * K
    dev = pyr.device
    if dev.type != "cuda":
        raise InvalidInputError(f"the warp kernel takes CUDA tensors, got {dev}")
    frame_bytes = sum(3 * h * w for h, w in level_sizes(H, W))
    if (
        pyr.dtype != torch.uint8 or tuple(pyr.shape) != (B, frame_bytes)
        or not pyr.is_contiguous()
    ):
        raise InvalidInputError(f"pyramid must be contiguous uint8 ({B}, {frame_bytes})")
    if (
        prm.dtype != torch.float32 or tuple(prm.shape) != (N, N_PARAMS)
        or not prm.is_contiguous() or prm.device != dev
    ):
        raise InvalidInputError(f"face table must be contiguous float32 ({N}, {N_PARAMS})")
    if N > 65535:
        raise InvalidInputError(f"at most 65535 faces per launch, got {N}")
    valid_u8 = None
    if valid is not None:
        if valid.numel() != N or valid.device != dev:
            raise InvalidInputError(f"valid must hold {N} flags on {dev}")
        valid_u8 = valid.to(torch.uint8).reshape(N).contiguous()
    out = torch.empty(
        (B, K, OUT, OUT, 3),
        dtype=torch.float32 if epilogue is None else torch.bfloat16,
        device=dev,
    )
    mean, scale = (0.0, 1.0) if epilogue is None else epilogue
    lib, _ = build_library()
    with torch.cuda.device(dev):
        rc = lib.warp_xm_launch(
            pyr.data_ptr(), prm.data_ptr(),
            None if valid_u8 is None else valid_u8.data_ptr(), out.data_ptr(),
            N, K, H, W, int(epilogue is not None), float(mean), 1.0 / float(scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise KernelError(
            f"warp_xm launch failed: {lib.warp_xm_error_string(rc).decode()}"
        )
    warp_affine_xm.launches += 1
    return out


def warp_affine_xm(
    frames_u8: torch.Tensor,
    Ms: torch.Tensor,
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames + (B, K, 2, 3) forward affines →
    (B, K, 112, 112, 3) crops: raw f32 BGR, or with epilogue=(mean,
    scale) bf16 normalized RGB; valid (B, K) slots that are False get
    zeros and no reads.

    CUDA tensors launch csrc/warp_xm.cu (and count the launch); CPU
    tensors run `warp_affine_xm_reference`."""
    if frames_u8.device.type == "cpu":
        return warp_affine_xm_reference(frames_u8, Ms, epilogue, valid)
    _check_inputs(frames_u8, Ms, valid)
    _, H, W, _ = frames_u8.shape
    return resample_xm(
        build_pyramid_xm(frames_u8), face_params_xm(Ms), H, W, Ms.shape[1],
        epilogue, valid,
    )


warp_affine_xm.launches = 0
