"""The alignment warp on the GPU: hand-written CUDA kernels (csrc/warp_xm.cu,
csrc/warp_ym.cu) and their plain-torch versions.

Port of `facerecognizeonnx_tpu/ops/warp_pallas.py`: the x-major path
(`_warp_affine_pallas_xm` + `_kernel_xm`) and the y-major path
(`warp_affine_pallas(layout="ymajor")` + `_kernel`). What both compute,
per face:

  1. a 4-level mip pyramid of each frame: level l = 2x2 average of the
     UNROUNDED level l-1 (odd edges dropped), each level stored rounded
     (half-to-even) — every value is an integer 0..255, so the pyramid
     is uint8, exact, and one pyramid serves both layouts;
  2. the inverse affine, a level chosen from its source extent against
     COVER=110 px, and an aligned window origin clipped to the
     reference's zero canvas; taps outside the window read zero, so the
     origin rounding is part of the result for faces larger than
     level-3 coverage:
       x-major: window 128 (x) × 256 (y), x_lo = floor(x_min/16)·16,
                y_lo = floor(y_min/128)·128;
       y-major: window 256 (x) × 128 (y), x_lo = floor(x_min/128)·128,
                y_lo = floor(y_min/16)·16;
  3. the six float parameters: x-major in the kernel's fixed point (2^20
     for the coefficients, 2^16 for the translations, after nan_to_num
     and clips to ±2000 / ±30000); y-major as plain float32;
  4. per output pixel a bilinear resample: y hat weights rounded to
     bf16, then the x-pass in f32 (or, y-major with xpass_bf16, in bf16
     with every rounding point of the TPU kernel);
  5. x-major only: the epilogue (channel 2-c, (s-mean)/scale, bf16) and
     the valid-slot skip (zeros, no reads).

On CUDA tensors the steps run as launches of csrc/warp_xm.cu and
csrc/warp_ym.cu: `build_pyramid` (levels 1-3; level 0 is the frames
tensor itself, read in place) counted in `build_pyramid.launches`; the
x-major resample `resample_xm` and the y-major resample `resample_ym`,
each of which computes each face's table (steps 2-3) from its affine in
the kernel and returns it beside the crops, counted in
`warp_affine_xm.launches` / `warp_affine_ym.launches`. For CPU
tensors `warp_affine_xm` / `warp_affine_ym` run the plain versions
`warp_affine_xm_reference` / `warp_affine_ym_reference` (and
`build_pyramid` runs `build_pyramid_reference`). A CUDA tensor never
takes a plain version: the kernel launches or the wrapper raises.
The pyramid and the x-major resample are `torch.library` custom ops
(`frt::build_pyramid`, `frt::resample_xm`) whose CUDA registration is
the launch and whose CPU registration is the plain version, so
`torch.export` traces a call as two nodes (pipeline/aot.py). Each kernel
of csrc/warp_xm.cu also counts its launches on the device
(`device_launches`), which CUDA-graph replays do without Python.
`warp_affine` is the counterpart of `warp_affine_pallas` and dispatches
on `layout`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from facerecognizeonnx_tpu_torch.errors import InvalidInputError, KernelError
from facerecognizeonnx_tpu_torch.ops import _nvcc
from facerecognizeonnx_tpu_torch.ops.warp import invert_affine

NUM_LEVELS = 4
OUT = 112
COVER = 110.0
PAD_W, PAD_H = 656, 768  # the x-major reference's zero canvas (x, y)
WIN_X, WIN_Y = 128, 256  # x-major window: x extent, y extent
ALIGN_X, ALIGN_Y = 16, 128  # x-major window origin rounding
MAX_X_LO = float(((PAD_W - WIN_X) // ALIGN_X) * ALIGN_X)  # 528
MAX_Y_LO = float(((PAD_H - WIN_Y) // ALIGN_Y) * ALIGN_Y)  # 512
YM_PAD_W, YM_PAD_H = 768, 656  # the y-major reference's zero canvas (x, y)
YM_WIN_X, YM_WIN_Y = 256, 128
YM_ALIGN_X, YM_ALIGN_Y = 128, 16
YM_MAX_X_LO = float(((YM_PAD_W - YM_WIN_X) // YM_ALIGN_X) * YM_ALIGN_X)  # 512
YM_MAX_Y_LO = float(((YM_PAD_H - YM_WIN_Y) // YM_ALIGN_Y) * YM_ALIGN_Y)  # 528
MAX_W, MAX_H = 640, 640  # both canvases hold frames up to 640 x 640
FP_COEF = float(1 << 20)
FP_TX = float(1 << 16)
N_PARAMS = 9  # level, x_lo, y_lo, a, b, c, d, tx_loc, ty_loc
LAYOUTS = ("ymajor", "xmajor")


# ---------------------------------------------------------------- shared parts


def level_sizes(H: int, W: int):
    """[(H_l, W_l)] of the pyramid levels (VALID 2x2 pooling floors)."""
    return [(H >> lvl, W >> lvl) for lvl in range(NUM_LEVELS)]


def upper_levels_bytes(H: int, W: int) -> int:
    """Bytes per frame of pyramid levels 1-3 (what `build_pyramid` holds)."""
    return sum(3 * h * w for h, w in level_sizes(H, W)[1:])


def build_pyramid_reference(frames_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of `build_pyramid`, on any device."""
    B = frames_u8.shape[0]
    level = frames_u8.permute(0, 3, 1, 2).to(torch.float32)
    parts = []
    for _ in range(1, NUM_LEVELS):
        level = F.avg_pool2d(level, 2)
        parts.append(
            torch.round(level).to(torch.uint8).permute(0, 2, 3, 1).reshape(B, -1)
        )
    return torch.cat(parts, dim=1)


def build_pyramid(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, P) uint8: pyramid levels 1-3, each
    (H_l, W_l, 3) row-major, concatenated per frame (P =
    `upper_levels_bytes(H, W)`). Level 0 is the frame itself, which the
    warps read in place.

    Level l pools the unrounded float level l-1; every partial sum is a
    dyadic fraction with few bits, so it is exact in f32 in any order.
    The values are those of both reference pyramids (`build_pyramid_xm`
    and `build_pyramid_cf`), without their zero canvas.

    A custom op (`frt::build_pyramid`): CUDA tensors launch the pyramid
    kernel of csrc/warp_xm.cu (counted in `build_pyramid.launches`); CPU
    tensors run `build_pyramid_reference`."""
    _check_frames(frames_u8)
    return torch.ops.frt.build_pyramid(frames_u8.contiguous())


def _launch_pyramid(frames_u8: torch.Tensor) -> torch.Tensor:
    B, H, W, _ = frames_u8.shape
    out = torch.empty((B, upper_levels_bytes(H, W)), dtype=torch.uint8,
                      device=frames_u8.device)
    if B and out.shape[1]:
        lib, _ = build_library()
        with torch.cuda.device(frames_u8.device):
            rc = lib.pyramid_launch(
                frames_u8.data_ptr(), out.data_ptr(), B, H, W,
                torch.cuda.current_stream(frames_u8.device).cuda_stream,
            )
        _raise_on(lib.warp_xm_error_string, rc, "pyramid")
        build_pyramid.launches += 1
    return out


def _scaled_inverse(Ms: torch.Tensor):
    """(B, K, 2, 3) forward affines → per face (flat): the pyramid level,
    the inverse affine at that level (a, b, c, d, tx, ty) and the
    minimum corner (x_min, y_min) of its source window, in the f32 ops
    of the reference drivers (shared by both layouts)."""
    Minv = invert_affine(Ms.to(torch.float32)).reshape(-1, 2, 3)
    a, b, tx = Minv[:, 0, 0], Minv[:, 0, 1], Minv[:, 0, 2]
    c, d, ty = Minv[:, 1, 0], Minv[:, 1, 1], Minv[:, 1, 2]

    span_x = (OUT - 1) * (a.abs() + b.abs()) + 2.0
    span_y = (OUT - 1) * (c.abs() + d.abs()) + 2.0
    extent = torch.maximum(span_x, span_y)
    # XLA (and torch on CUDA) divide by a constant as a product with its
    # float32 reciprocal; torch on the CPU divides. Written as the product
    # so that both devices pick the reference's level at COVER·2^l.
    level = torch.clamp(
        torch.ceil(torch.log2(torch.clamp_min(extent * (1.0 / COVER), 1e-6))),
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
    return level, af, bf, cf, df, txf, tyf, x_min, y_min


def face_params_xm(Ms: torch.Tensor) -> torch.Tensor:
    """(B, K, 2, 3) forward affines → (B·K, 9) float32 per-face table for
    the x-major kernel: level, x_lo, y_lo, then a, b, c, d, tx_loc,
    ty_loc — the inverse affine at the chosen level in window-local
    coordinates, in the same f32 ops and fixed-point rounding as
    `_warp_affine_pallas_xm`."""
    level, af, bf, cf, df, txf, tyf, x_min, y_min = _scaled_inverse(Ms)
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


def face_params_ym(Ms: torch.Tensor) -> torch.Tensor:
    """(B, K, 2, 3) forward affines → (B·K, 9) float32 per-face table for
    the y-major kernel, in the column order of `face_params_xm`: the
    float32 parameters of `warp_affine_pallas(layout="ymajor")`
    (`fparams`, no fixed point) with its 128 (x) / 16 (y) origin."""
    level, af, bf, cf, df, txf, tyf, x_min, y_min = _scaled_inverse(Ms)
    x_lo = torch.clamp(torch.floor(x_min / YM_ALIGN_X) * YM_ALIGN_X, 0.0, YM_MAX_X_LO)
    y_lo = torch.clamp(torch.floor(y_min / YM_ALIGN_Y) * YM_ALIGN_Y, 0.0, YM_MAX_Y_LO)
    return torch.stack(
        [level, x_lo, y_lo, af, bf, cf, df, txf - x_lo, tyf - y_lo], dim=-1
    ).contiguous()


def _check_frames(frames_u8):
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise InvalidInputError(
            f"frames must be (B, H, W, 3) uint8, got {tuple(frames_u8.shape)} "
            f"{frames_u8.dtype}"
        )
    H, W = frames_u8.shape[1:3]
    if H > MAX_H or W > MAX_W:
        raise InvalidInputError(f"frames up to {MAX_H}x{MAX_W}, got {H}x{W}")


def _check_inputs(frames_u8, Ms, valid):
    _check_frames(frames_u8)
    B = frames_u8.shape[0]
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


# ---------------------------------------------------------------- plain versions


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _resample_reference(frames, pyr, prm, K, win_x, win_y, xpass_bf16=False):
    """The kernels' arithmetic in plain torch, on any device: vectorized
    gather over B frames of H x W (level 0), their levels 1-3
    (`build_pyramid`) and a per-face table (`face_params_xm` /
    `face_params_ym`) of K faces each, with a (win_x, win_y) window.
    Returns (N, 112, 112, 3) f32 sums."""
    B, H, W, _ = frames.shape
    N = B * K
    dev = pyr.device
    # one flat buffer: all frames, then all upper levels
    flat = torch.cat([frames.reshape(-1), pyr.reshape(-1)])

    sizes = level_sizes(H, W)
    offs = [0]
    for h, w in sizes[1:-1]:
        offs.append(offs[-1] + 3 * h * w)
    # a NaN entry (from a matrix whose inverse overflows) reads as 0, as
    # the kernels' float → int conversion has it
    level = torch.nan_to_num(prm[:, 0]).long().clamp(0, NUM_LEVELS - 1)
    hl = torch.tensor([h for h, _ in sizes], device=dev)[level][:, None, None]
    wl = torch.tensor([w for _, w in sizes], device=dev)[level][:, None, None]
    b = torch.arange(N, device=dev) // K
    upper = B * H * W * 3 + b * upper_levels_bytes(H, W) + torch.tensor(
        [0] + offs, device=dev
    )[level]
    base = torch.where(level == 0, b * (H * W * 3), upper)[:, None, None]
    pyr = flat
    x_lo = torch.nan_to_num(prm[:, 1]).long()[:, None, None]
    y_lo = torch.nan_to_num(prm[:, 2]).long()[:, None, None]
    a, b, c, d, tx, ty = (prm[:, k, None, None] for k in range(3, 9))

    ii = torch.arange(OUT, dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(OUT, dtype=torch.float32, device=dev)[None, :]
    lx = (a * jj + b * ii + tx).clamp(-2.0, win_x + 1.0)  # (N, 112, 112)
    ly = (c * jj + d * ii + ty).clamp(-2.0, win_y + 1.0)
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
            wy = _bf16(torch.clamp_min(1.0 - (ly - yw).abs(), 0.0))
            gx = x_lo + xw.long()
            gy = y_lo + yw.long()
            ok = (
                (xw >= 0) & (xw < win_x) & (yw >= 0) & (yw < win_y)
                & (gx < wl) & (gy < hl)
            )
            idx = base + (gy.clamp_min(0) * wl + gx.clamp_min(0)) * 3
            idx = torch.where(ok, idx, torch.zeros_like(idx))
            px = pyr[idx[..., None] + chan].to(torch.float32)
            px = torch.where(ok[..., None], px, torch.zeros_like(px))
            t = t + wy[..., None] * px
        if xpass_bf16:
            s = s + _bf16(_bf16(t) * _bf16(wx)[..., None])
        else:
            s = s + t * wx[..., None]
    return _bf16(s) if xpass_bf16 else s


def resample_xm_reference(
    frames_u8: torch.Tensor,
    pyr: torch.Tensor,
    prm: torch.Tensor,
    K: int,
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain-torch version of the x-major resample, on any device: B
    frames (level 0), their levels 1-3 (`build_pyramid`) and the per-face
    table (`face_params_xm`) of K faces each → (B, K, 112, 112, 3): raw
    f32 BGR, or with epilogue=(mean, scale) bf16 normalized RGB. valid
    (B, K): invalid slots are zeros."""
    s = _resample_reference(frames_u8, pyr, prm, K, WIN_X, WIN_Y)
    return _finish(s, frames_u8.shape[0], K, epilogue, valid)


def resample_ym_reference(
    frames_u8: torch.Tensor, pyr: torch.Tensor, prm: torch.Tensor, K: int,
    xpass_bf16: bool = False,
) -> torch.Tensor:
    """Plain-torch version of the y-major kernel, on any device: frames,
    levels 1-3 (`build_pyramid`) and per-face table (`face_params_ym`) →
    (B, K, 112, 112, 3) raw f32 BGR."""
    s = _resample_reference(frames_u8, pyr, prm, K, YM_WIN_X, YM_WIN_Y, xpass_bf16)
    return _finish(s, frames_u8.shape[0], K, None, None)


def warp_affine_xm_reference(
    frames_u8: torch.Tensor,
    Ms: torch.Tensor,
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The whole x-major warp in plain torch: pyramid, per-face table,
    resample. frames_u8 (B, H, W, 3) uint8, Ms (B, K, 2, 3) →
    (B, K, 112, 112, 3)."""
    _check_inputs(frames_u8, Ms, valid)
    return resample_xm_reference(
        frames_u8, build_pyramid_reference(frames_u8), face_params_xm(Ms), Ms.shape[1],
        epilogue, valid,
    )


def warp_affine_ym_reference(
    frames_u8: torch.Tensor, Ms: torch.Tensor, xpass_bf16: bool = False
) -> torch.Tensor:
    """The whole y-major warp in plain torch. frames_u8 (B, H, W, 3)
    uint8, Ms (B, K, 2, 3) → (B, K, 112, 112, 3) raw f32 BGR."""
    _check_inputs(frames_u8, Ms, None)
    return resample_ym_reference(
        frames_u8, build_pyramid_reference(frames_u8), face_params_ym(Ms), Ms.shape[1],
        xpass_bf16,
    )


# ---------------------------------------------------------------- the kernels


def _bind_xm(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pyramid_launch.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.pyramid_launch.restype = i32
    lib.warp_xm_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
        ctypes.c_float, ctypes.c_float, ptr,
    ]
    lib.warp_xm_launch.restype = i32
    lib.warp_xm_launch_counts.argtypes = [ptr]
    lib.warp_xm_launch_counts.restype = i32
    lib.warp_xm_error_string.argtypes = [i32]
    lib.warp_xm_error_string.restype = ctypes.c_char_p


def _bind_ym(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.warp_ym_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.warp_ym_launch.restype = ctypes.c_int
    lib.warp_ym_error_string.argtypes = [ctypes.c_int]
    lib.warp_ym_error_string.restype = ctypes.c_char_p


def build_library() -> Tuple[ctypes.CDLL, str]:
    """Compile csrc/warp_xm.cu with nvcc for sm_90a (once per source and
    flags) and load it. Returns (library, nvcc's -Xptxas -v output)."""
    return _nvcc.build_library("warp_xm.cu", _bind_xm)


def build_library_ym() -> Tuple[ctypes.CDLL, str]:
    """Compile and load csrc/warp_ym.cu, as `build_library` does."""
    return _nvcc.build_library("warp_ym.cu", _bind_ym)


def _raise_on(error_string, rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} launch failed: {error_string(rc).decode()}")


def _check_levels(frames_u8, pyr, K):
    """Frames (level 0) and their levels 1-3 as the kernels take them."""
    _check_frames(frames_u8)
    B, H, W, _ = frames_u8.shape
    dev = frames_u8.device
    if dev.type != "cuda":
        raise InvalidInputError(f"the warp kernels take CUDA tensors, got {dev}")
    if not frames_u8.is_contiguous():
        raise InvalidInputError("frames must be contiguous")
    n_up = upper_levels_bytes(H, W)
    if (
        pyr.dtype != torch.uint8 or tuple(pyr.shape) != (B, n_up)
        or not pyr.is_contiguous() or pyr.device != dev
    ):
        raise InvalidInputError(f"levels 1-3 must be contiguous uint8 ({B}, {n_up}) on {dev}")
    if B * K > 65535:
        raise InvalidInputError(f"at most 65535 faces per launch, got {B * K}")
    return B, H, W, dev


def resample_xm(
    frames_u8: torch.Tensor,
    pyr: torch.Tensor,
    Ms: torch.Tensor,
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the resample of csrc/warp_xm.cu on CUDA tensors: frames
    (level 0), their levels 1-3 (`build_pyramid`) and the (B, K, 2, 3)
    forward affines. Each block computes its face's table from Ms (the
    float32 operations of `face_params_xm`) and resamples. Returns
    (crops as `resample_xm_reference` gives them, the (B·K, 9) table
    the kernel used). Counts the launch in `warp_affine_xm.launches`."""
    K = Ms.shape[1]
    B, H, W, dev = _check_levels(frames_u8, pyr, K)
    _check_inputs(frames_u8, Ms, valid)
    N = B * K
    ms = Ms.to(torch.float32).contiguous()
    valid_u8 = None if valid is None else valid.to(torch.uint8).reshape(N).contiguous()
    out = torch.empty(
        (B, K, OUT, OUT, 3),
        dtype=torch.float32 if epilogue is None else torch.bfloat16,
        device=dev,
    )
    table = torch.empty((N, N_PARAMS), dtype=torch.float32, device=dev)
    if N == 0:
        return out, table
    mean, scale = (0.0, 1.0) if epilogue is None else epilogue
    lib, _ = build_library()
    with torch.cuda.device(dev):
        rc = lib.warp_xm_launch(
            frames_u8.data_ptr(), pyr.data_ptr(), ms.data_ptr(),
            None if valid_u8 is None else valid_u8.data_ptr(), out.data_ptr(),
            table.data_ptr(), N, K, H, W, int(epilogue is not None), float(mean),
            1.0 / float(scale), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib.warp_xm_error_string, rc, "warp_xm")
    warp_affine_xm.launches += 1
    return out, table


def resample_ym(
    frames_u8: torch.Tensor, pyr: torch.Tensor, Ms: torch.Tensor, xpass_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/warp_ym.cu on CUDA tensors: frames (level 0), their
    levels 1-3 (`build_pyramid`) and the (B, K, 2, 3) forward affines.
    The launch computes each face's table from Ms (the float32
    operations of `face_params_ym`) and resamples. Returns (crops as
    `resample_ym_reference` gives them, the (B·K, 9) table the kernel
    used). Counts the launch in `warp_affine_ym.launches`."""
    K = Ms.shape[1]
    B, H, W, dev = _check_levels(frames_u8, pyr, K)
    _check_inputs(frames_u8, Ms, None)
    N = B * K
    ms = Ms.to(torch.float32).contiguous()
    out = torch.empty((B, K, OUT, OUT, 3), dtype=torch.float32, device=dev)
    table = torch.empty((N, N_PARAMS), dtype=torch.float32, device=dev)
    if N == 0:
        return out, table
    lib, _ = build_library_ym()
    with torch.cuda.device(dev):
        rc = lib.warp_ym_launch(
            frames_u8.data_ptr(), pyr.data_ptr(), ms.data_ptr(), out.data_ptr(),
            table.data_ptr(), N, K, H, W, int(bool(xpass_bf16)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib.warp_ym_error_string, rc, "warp_ym")
    warp_affine_ym.launches += 1
    return out, table


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

    CUDA tensors launch csrc/warp_xm.cu (2 launches, each counted); CPU
    tensors run the plain versions (`warp_affine_xm_reference`'s
    arithmetic). Both steps are custom ops (`frt::build_pyramid`,
    `frt::resample_xm`), so `torch.export` traces the call as two nodes
    and an exported program runs on either device."""
    _check_inputs(frames_u8, Ms, valid)
    frames_u8 = frames_u8.contiguous()
    mean, scale = (0.0, 1.0) if epilogue is None else epilogue
    return torch.ops.frt.resample_xm(
        frames_u8, build_pyramid(frames_u8), Ms.to(torch.float32).contiguous(), valid,
        epilogue is not None, float(mean), float(scale),
    )[0]


def warp_affine_ym(
    frames_u8: torch.Tensor, Ms: torch.Tensor, xpass_bf16: bool = False
) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames + (B, K, 2, 3) forward affines →
    (B, K, 112, 112, 3) raw f32 BGR crops through the y-major window.

    CUDA tensors launch the pyramid kernel and csrc/warp_ym.cu, which
    computes the face table itself (2 launches, each counted); CPU
    tensors run `warp_affine_ym_reference`."""
    if frames_u8.device.type == "cpu":
        return warp_affine_ym_reference(frames_u8, Ms, xpass_bf16)
    _check_inputs(frames_u8, Ms, None)
    frames_u8 = frames_u8.contiguous()
    return resample_ym(frames_u8, build_pyramid(frames_u8), Ms, xpass_bf16)[0]


def warp_affine(
    frames_u8: torch.Tensor,
    Ms: torch.Tensor,
    out_size: int = OUT,
    xpass_bf16: bool = False,
    unroll: int = 1,
    layout: str = "ymajor",
    epilogue: Optional[Tuple[float, float]] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The counterpart of `warp_affine_pallas`, with its default layout:
    (B, H, W, 3) uint8 + (B, K, 2, 3) forward affines →
    (B, K, 112, 112, 3) crops (zero border).

    layout="xmajor" runs `warp_affine_xm` (epilogue and valid as there);
    layout="ymajor" runs `warp_affine_ym` (raw f32 BGR only), whose
    xpass_bf16 rounds the x-pass as the TPU kernel's bf16 option does.
    As in the reference, xpass_bf16 applies to the y-major layout only;
    unroll changes only the TPU kernel's schedule, so here it is
    validated and changes nothing."""
    if out_size != OUT:
        raise InvalidInputError(f"the warp kernels are specialized to {OUT} output")
    if int(unroll) < 1:
        raise InvalidInputError(f"unroll must be >= 1, got {unroll}")
    if layout == "xmajor":
        return warp_affine_xm(frames_u8, Ms, epilogue, valid)
    if layout != "ymajor":
        raise InvalidInputError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if epilogue is not None or valid is not None:
        raise InvalidInputError("the y-major warp returns raw BGR only (no epilogue or valid)")
    return warp_affine_ym(frames_u8, Ms, xpass_bf16)


def device_launches() -> Tuple[int, int]:
    """(pyramid, warp_xm) launches on the current device so far, as the
    kernels of csrc/warp_xm.cu count them (CUDA-graph replays included);
    waits for the device."""
    lib, _ = build_library()
    out = (ctypes.c_ulonglong * 2)()
    _raise_on(lib.warp_xm_error_string, lib.warp_xm_launch_counts(out), "warp_xm count read")
    return int(out[0]), int(out[1])


# ---------------------------------------------------------------- custom ops


def _pyramid_fake(frames_u8):
    B, H, W, _ = frames_u8.shape
    return frames_u8.new_empty((B, upper_levels_bytes(H, W)))


def _resample_plain(frames_u8, pyr, Ms, valid, epilogue, mean, scale):
    prm = face_params_xm(Ms)
    out = resample_xm_reference(
        frames_u8, pyr, prm, Ms.shape[1], (mean, scale) if epilogue else None, valid
    )
    return out, prm


def _resample_launch(frames_u8, pyr, Ms, valid, epilogue, mean, scale):
    return resample_xm(frames_u8, pyr, Ms, (mean, scale) if epilogue else None, valid)


def _resample_fake(frames_u8, pyr, Ms, valid, epilogue, mean, scale):
    B, K = Ms.shape[:2]
    out = frames_u8.new_empty(
        (B, K, OUT, OUT, 3), dtype=torch.bfloat16 if epilogue else torch.float32
    )
    return out, Ms.new_empty((B * K, N_PARAMS), dtype=torch.float32)


_pyramid_op = torch.library.custom_op(
    "frt::build_pyramid", build_pyramid_reference, mutates_args=(), device_types="cpu",
    schema="(Tensor frames_u8) -> Tensor",
)
_pyramid_op.register_kernel("cuda")(_launch_pyramid)
_pyramid_op.register_fake(_pyramid_fake)
_resample_op = torch.library.custom_op(
    "frt::resample_xm", _resample_plain, mutates_args=(), device_types="cpu",
    schema="(Tensor frames_u8, Tensor pyr, Tensor Ms, Tensor? valid, bool epilogue, "
           "float mean, float scale) -> (Tensor, Tensor)",
)
_resample_op.register_kernel("cuda")(_resample_launch)
_resample_op.register_fake(_resample_fake)

warp_affine_xm.launches = 0
build_pyramid.launches = 0
warp_affine_ym.launches = 0
