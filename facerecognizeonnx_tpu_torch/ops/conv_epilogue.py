"""The epilogue between the convolutions of a folded bfloat16 IResNet: a
hand-written CUDA kernel (csrc/conv_epilogue.cu) and its plain version.

One pass over a convolution's float32 output y (N, C, H, W) does, in the
rounding points of `models/layers.py`:

  t = bf16(y + bias)                          `conv2d`'s bias and rounding
  t = prelu(t, alpha) in bf16                 if `alpha` is given
  t = bf16(t + res)                           if `res` (bf16) is given, or
  t = bf16(t + bf16(yd + bd))                 if `down` = (yd, bd) is given

and returns (f32, bf16, bn), each None unless asked for:

  f32 = f32(t)                                `write_f32`: a conv's operand
  bf16 = t                                    `write_bf16`: a residual
  bn = f32(bf16(batch_norm(t)))               `bn` = (mean, inv, beta): the
                                              next BatchNorm, as the next
                                              conv's operand

`inv` is rsqrt(var + eps) · scale, computed with the torch ops of
`layers.batch_norm` on the tensors' device (`arcface.bn_tables`).

A `torch.library` custom op (`frt::conv_epilogue`), so `torch.export`
traces a call as one node: CUDA tensors launch the kernel (y, res, yd
channels-last and C a multiple of 8; counted in `conv_epilogue.launches`)
or raise; CPU tensors run the plain version `conv_epilogue_reference`,
the eager path's torch ops, which the kernel matches bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from facerecognizeonnx_tpu_torch.errors import InvalidInputError, KernelError
from facerecognizeonnx_tpu_torch.ops import _nvcc

Outputs = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]


# ---------------------------------------------------------------- plain version


def conv_epilogue_reference(
    y: torch.Tensor,
    bias: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    res: Optional[torch.Tensor] = None,
    down: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    bn: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    write_f32: bool = False,
    write_bf16: bool = False,
) -> Outputs:
    """The plain version of `conv_epilogue`, on any device: the eager
    path's torch ops (`layers.conv2d`'s bias and rounding, `prelu`, the
    residual add, `batch_norm` and the next conv's operand cast)."""
    shape = (-1,) + (1,) * (y.dim() - 2)
    t = (y + bias.to(torch.float32).view(shape)).to(torch.bfloat16)
    if alpha is not None:
        t = torch.where(t >= 0, t, t * alpha.to(torch.bfloat16).view(shape))
    if res is not None:
        t = t + res
    elif down is not None:
        yd, bd = down
        t = t + (yd + bd.to(torch.float32).view(shape)).to(torch.bfloat16)
    out_bn = None
    if bn is not None:
        mean, inv, beta = bn
        out_bn = (t.to(torch.float32) - mean.view(shape)) * inv.view(shape) + beta.view(shape)
        out_bn = out_bn.to(torch.bfloat16).to(torch.float32)
    return (t.to(torch.float32) if write_f32 else None, t if write_bf16 else None, out_bn)


def _plain(y, bias, alpha, res, yd, bd, mean, inv, beta, write_f32, write_bf16):
    """The custom op's CPU registration: the plain version, with an empty
    tensor for each output not asked for."""
    outs = conv_epilogue_reference(
        y, bias, alpha, res, None if yd is None else (yd, bd),
        None if mean is None else (mean, inv, beta), write_f32, write_bf16,
    )
    return tuple(o if o is not None else y.new_empty(0, dtype=dt)
                 for o, dt in zip(outs, (torch.float32, torch.bfloat16, torch.float32)))


# ---------------------------------------------------------------- the kernel


def _bind(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    lib.conv_epilogue_launch.argtypes = [ptr] * 12 + [ctypes.c_longlong, ctypes.c_int, ptr]
    lib.conv_epilogue_launch.restype = ctypes.c_int
    lib.conv_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.conv_epilogue_error_string.restype = ctypes.c_char_p


def build_library() -> Tuple[ctypes.CDLL, str]:
    """Compile csrc/conv_epilogue.cu with nvcc for sm_90a (once per source
    and flags) and load it. Returns (library, nvcc's -Xptxas -v output)."""
    return _nvcc.build_library("conv_epilogue.cu", _bind)


def _check_kernel_inputs(y, tensors) -> None:
    dev = y.device
    if y.dim() != 4 or y.dtype != torch.float32:
        raise InvalidInputError(f"y must be float32 (N, C, H, W), got {y.dtype} {tuple(y.shape)}")
    if y.shape[1] % 8:
        raise InvalidInputError(f"the epilogue kernel takes C a multiple of 8, got {y.shape[1]}")
    for name, t, dtype, full in tensors:
        if t is None:
            continue
        want = tuple(y.shape) if full else (y.shape[1],)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != want:
            raise InvalidInputError(
                f"{name} must be {dtype} {want} on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
        ok = (t.is_contiguous(memory_format=torch.channels_last) if full
              else t.is_contiguous())
        if not ok or (full and t.data_ptr() % 16):  # 16-byte loads and stores
            raise InvalidInputError(
                f"{name} must be {'channels-last and 16-byte aligned' if full else 'contiguous'}")


def _launch(y, bias, alpha, res, yd, bd, mean, inv, beta, write_f32, write_bf16):
    """csrc/conv_epilogue.cu on CUDA tensors; counted in `conv_epilogue.launches`."""
    f32, bf16 = torch.float32, torch.bfloat16
    _check_kernel_inputs(y, [
        ("y", y, f32, True), ("bias", bias, f32, False), ("alpha", alpha, f32, False),
        ("res", res, bf16, True), ("yd", yd, f32, True), ("bd", bd, f32, False),
        ("mean", mean, f32, False), ("inv", inv, f32, False), ("beta", beta, f32, False),
    ])
    if (yd is None) != (bd is None) or len({mean is None, inv is None, beta is None}) > 1:
        raise InvalidInputError("yd comes with bd, and mean with inv and beta")
    out_f32, out_bf16, out_bn = _fake(y, bias, alpha, res, yd, bd, mean, inv, beta,
                                      write_f32, write_bf16)
    if y.numel() == 0:
        return out_f32, out_bf16, out_bn

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    lib, _ = build_library()
    dev = y.device
    with torch.cuda.device(dev):
        rc = lib.conv_epilogue_launch(
            y.data_ptr(), bias.data_ptr(), ptr(alpha), ptr(res), ptr(yd), ptr(bd),
            ptr(mean), ptr(inv), ptr(beta), ptr(out_f32), ptr(out_bf16), ptr(out_bn),
            y.numel(), y.shape[1], torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise KernelError(f"conv_epilogue launch failed: {lib.conv_epilogue_error_string(rc).decode()}")
    conv_epilogue.launches += 1
    return out_f32, out_bf16, out_bn


def _fake(y, bias, alpha, res, yd, bd, mean, inv, beta, write_f32, write_bf16):
    """The outputs, unwritten: y's layout, an empty tensor for each output
    not asked for."""
    return (
        torch.empty_like(y) if write_f32 else y.new_empty(0),
        (torch.empty_like(y, dtype=torch.bfloat16) if write_bf16
         else y.new_empty(0, dtype=torch.bfloat16)),
        torch.empty_like(y) if mean is not None else y.new_empty(0),
    )


_op = torch.library.custom_op(
    "frt::conv_epilogue", _plain, mutates_args=(), device_types="cpu",
    schema=(
        "(Tensor y, Tensor bias, Tensor? alpha, Tensor? res, Tensor? yd, Tensor? bd, "
        "Tensor? mean, Tensor? inv, Tensor? beta, bool write_f32, bool write_bf16) "
        "-> (Tensor, Tensor, Tensor)"
    ),
)
_op.register_kernel("cuda")(_launch)
_op.register_fake(_fake)


def conv_epilogue(
    y: torch.Tensor,
    bias: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    res: Optional[torch.Tensor] = None,
    down: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    bn: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    write_f32: bool = False,
    write_bf16: bool = False,
) -> Outputs:
    """The epilogue of the module docstring → (f32, bf16, bn), None for
    each output not asked for. `alpha` is a float32 table whose values are
    bf16 (the kernel does not round it); `res` and `down` exclude each
    other."""
    if res is not None and down is not None:
        raise InvalidInputError("an epilogue adds one identity: res or down, not both")
    yd, bd = down if down is not None else (None, None)
    mean, inv, beta = bn if bn is not None else (None, None, None)
    f32, b16, out_bn = torch.ops.frt.conv_epilogue(
        y, bias, alpha, res, yd, bd, mean, inv, beta, bool(write_f32), bool(write_bf16)
    )
    return (f32 if write_f32 else None, b16 if write_bf16 else None,
            out_bn if bn is not None else None)


conv_epilogue.launches = 0
