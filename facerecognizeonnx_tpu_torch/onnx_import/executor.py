"""ONNX graph → torch executor on one explicit device.

Port of `facerecognizeonnx_tpu/onnx_import/executor.py`: the same op
registry (the convnet subset of the SCRFD / ArcFace / MobileFaceNet /
ViT exports plus the glue ops of torch exports) and the same results.
Activations are torch tensors in ONNX's logical NCHW layout on
`device`; weights are OIHW.

Static values stay numpy. Initializers, Constant nodes and shape math
(Shape → Gather → Div → Unsqueeze → Concat → Reshape chains) are
evaluated on the host, so integer Div is floor division there and no
shape is read back from the device: shape math reads `tensor.shape`
only. Nodes whose inputs are all constants are folded once, when the
executor is built.

Weights are uploaded once. A numpy value that meets a device op is
copied to the device the first time, in the form the op wants (a conv
weight rounded to the compute dtype, a BatchNorm's scale and shift),
and kept for every later run. Only values computed from a run's input
shapes are uploaded per run, and those are a few integers.

Fast mode (`Executor(graph, nhwc=True)`) reproduces the JAX fast path's
numerics. There a conv output is NHWC-tagged and layout-agnostic ops
keep the tag; here the tensor stays NCHW and the tag (`_Tagged`) only
records that the JAX executor would take its `nhwc_*` handler, so every
node takes the handler it takes there and rounds where it rounds:

  - a conv, BatchNorm, AveragePool or GlobalAveragePool rounds its
    output once to `compute_dtype` (a conv: float32 products and sums of
    rounded operands, the bias added in float32, then the rounding);
  - a conv with dynamic weights or `auto_pad` takes `op_conv`, which
    does not round;
  - type promotion follows JAX, not torch: a bf16 activation times a
    static float32 scalar is float32 (torch keeps a 0-d operand's
    partner dtype, so both operands are cast to the promoted type first).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from facerecognizeonnx_tpu_torch.config import resolve_device
from facerecognizeonnx_tpu_torch.errors import UnsupportedOnnxOp
from facerecognizeonnx_tpu_torch.onnx_import import proto

_NOTSET = (None, b"NOTSET", "NOTSET")


def _is_static(*vals) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float)) for v in vals)


def _np(v):
    return np.asarray(v)


def _attr(node, name, default=None):
    return node.attrs.get(name, default)


def _pads4(node):
    # ONNX 2D pads: [top, left, bottom, right]
    t, l, b, r = (int(p) for p in _attr(node, "pads", [0, 0, 0, 0]))
    return (t, b), (l, r)


def _torch_dtype(np_dtype) -> torch.dtype:
    """The dtype JAX gives a numpy array (64-bit floats as float32: JAX
    runs with x64 off)."""
    dt = np.dtype(np_dtype)
    if dt == np.float64:
        return torch.float32
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _mode_is_nearest(node) -> bool:
    return _attr(node, "mode", b"nearest") in (b"nearest", "nearest")


def resize(x: torch.Tensor, sizes, nearest: bool) -> torch.Tensor:
    """`jax.image.resize(x, sizes, "nearest" | "linear")` of an NCHW
    tensor whose batch and channel counts stay: nearest samples at
    half-pixel centres (torch's "nearest-exact"), linear is the
    half-pixel triangle filter, widened when it shrinks (torch's
    antialiased bilinear), computed in float32."""
    sizes = tuple(int(s) for s in sizes)
    if x.dim() != 4 or sizes[:2] != tuple(x.shape[:2]):
        raise NotImplementedError(
            f"resize of {tuple(x.shape)} to {sizes}: only the two trailing dims of a 4-D tensor"
        )
    if nearest:
        return F.interpolate(x, size=sizes[2:], mode="nearest-exact")
    y = F.interpolate(x.to(torch.float32), size=sizes[2:], mode="bilinear",
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


class _Tagged:
    """A value the JAX fast path holds NHWC-tagged (logical NCHW here)."""

    __slots__ = ("a",)

    def __init__(self, a: torch.Tensor):
        self.a = a


def _untag(v):
    return v.a if isinstance(v, _Tagged) else v


class Executor:
    """Evaluates a parsed Graph on `device`. Op registry covers the
    convnet subset used by SCRFD/ArcFace exports plus common glue ops."""

    def __init__(self, graph: proto.Graph, nhwc: bool = False, compute_dtype=None,
                 device="cuda"):
        self.graph = graph
        self.nhwc = nhwc
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        init_names = set(graph.initializers)
        self.input_names = [name for name, _ in graph.inputs if name not in init_names]
        self._uploads: Dict[Any, torch.Tensor] = {}
        self._persistent: set = set()
        self.consts: Dict[str, Any] = dict(graph.initializers)
        self._fold_constants()
        self._persistent = {id(v) for v in self.consts.values()}

    def _fold_constants(self) -> None:
        """Evaluate once every node whose inputs are all constants and
        whose outputs are host values."""
        for node in self.graph.nodes:
            if not all(i in self.consts for i in node.inputs if i):
                continue
            fn = getattr(self, f"op_{node.op_type.lower()}", None)
            if fn is None:
                continue  # run() raises UnsupportedOnnxOp for it
            try:
                out = fn(node, [self.consts[i] if i else None for i in node.inputs])
            except Exception:  # noqa: BLE001 — run() meets the same error where JAX does
                continue
            out = out if isinstance(out, (tuple, list)) else (out,)
            if all(_is_static(o) for o in out):
                self.consts.update((n, o) for n, o in zip(node.outputs, out) if n)

    # ----------------------------------------------------------- uploads

    def _cached(self, key, v, make):
        """make(v) on the device, made once for a constant `v` (keyed by
        its identity and `key`), per call for a value of this run."""
        if id(v) not in self._persistent:
            return make(v)
        k = (id(v), key)
        t = self._uploads.get(k)
        if t is None:
            t = self._uploads[k] = make(v)
        return t

    def _dev(self, v, dtype=None):
        """A value as a device tensor (numpy uploaded, JAX dtype)."""
        if isinstance(v, torch.Tensor):
            return v if dtype is None else v.to(dtype)

        def make(a):
            a = _np(a)
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, dtype or _torch_dtype(a.dtype))
        return self._cached(("dev", dtype), v, make)

    def _operand(self, v):
        """A binary op's operand: python numbers stay (weak, as in JAX)."""
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return v
        return self._dev(v)

    @staticmethod
    def _promote(a, b):
        """Both operands in JAX's promoted dtype (torch would keep a
        dimensioned operand's dtype against a 0-d one)."""
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype != b.dtype:
            dt = torch.promote_types(a.dtype, b.dtype)
            return a.to(dt), b.to(dt)
        return a, b

    def _bin(self, fn, a, b):
        return fn(*self._promote(self._operand(a), self._operand(b)))

    # ------------------------------------------------------------------ run

    def run(self, inputs: Dict[str, Any], nhwc_inputs: bool = False) -> List[Any]:
        """nhwc_inputs: 4D runtime inputs are NHWC (the fast path takes
        them without a transpose back and forth); only meaningful with
        nhwc=True."""
        values: Dict[str, Any] = dict(self.consts)
        for k, v in inputs.items():
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            if self.nhwc and nhwc_inputs and v.dim() == 4:
                values[k] = _Tagged(v.permute(0, 3, 1, 2))
            else:
                values[k] = v
        for node in self.graph.nodes:
            if node.outputs and all(o in self.consts for o in node.outputs if o):
                continue  # folded
            out = None
            if self.nhwc:
                handler = getattr(self, f"nhwc_{node.op_type.lower()}", None)
                if handler is not None:
                    out = handler(node, [values[i] if i else None for i in node.inputs])
            if out is None:
                fn = getattr(self, f"op_{node.op_type.lower()}", None)
                if fn is None:
                    raise UnsupportedOnnxOp(
                        f"ONNX op {node.op_type!r} (node {node.name!r}) not supported"
                    )
                out = fn(node, [_untag(values[i]) if i else None for i in node.inputs])
            if not isinstance(out, (tuple, list)):
                out = (out,)
            for name, val in zip(node.outputs, out):
                if name:
                    values[name] = val
        return [_untag(values[o]) for o in self.graph.outputs]

    # ------------------------------------------------------------- conv etc

    @staticmethod
    def _conv_geometry(node, kh, kw):
        strides = [int(s) for s in _attr(node, "strides", [1, 1])]
        dilations = [int(d) for d in _attr(node, "dilations", [1, 1])]
        group = int(_attr(node, "group", 1))
        (pt, pb), (pl, pr) = _pads4(node)
        auto_pad = _attr(node, "auto_pad")
        if auto_pad not in _NOTSET:
            if auto_pad in (b"SAME_UPPER", b"SAME_LOWER"):
                ph, pw = (kh - 1) * dilations[0], (kw - 1) * dilations[1]
                if auto_pad == b"SAME_UPPER":
                    pt, pb, pl, pr = ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
                else:
                    pb, pt, pr, pl = ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
        return strides, dilations, group, (pl, pr, pt, pb)

    @staticmethod
    def _conv(x, w, strides, dilations, group, pads):
        pl, pr, pt, pb = pads
        if pl == pr and pt == pb:  # the call the native modules make
            return F.conv2d(x, w, None, strides, (pt, pl), dilations, group)
        return F.conv2d(F.pad(x, pads), w, None, strides, 0, dilations, group)

    def op_conv(self, node, args):
        x, w = self._dev(args[0]), self._dev(args[1])
        b = args[2] if len(args) > 2 else None
        geom = self._conv_geometry(node, w.shape[2], w.shape[3])
        # float32 products and sums (preferred_element_type=f32)
        y = self._conv(x.to(torch.float32), w.to(torch.float32), *geom)
        if b is not None:
            y = y + self._dev(b).reshape(1, -1, 1, 1)
        return y

    def _bn_affine(self, scale, bias, mean, var, eps):
        """(inv, shift) of an inference BatchNorm, in float32 on the device."""
        def make(_):
            s, bb, m, v = (self._dev(a, torch.float32) for a in (scale, bias, mean, var))
            inv = torch.rsqrt(v + eps) * s
            return torch.stack([inv, bb - m * inv])
        if all(id(a) in self._persistent for a in (scale, bias, mean, var)):
            return self._cached(("bn", eps, id(bias), id(mean), id(var)), scale, make)
        return make(None)

    def op_batchnormalization(self, node, args):
        x = self._dev(args[0])
        eps = float(_attr(node, "epsilon", 1e-5))
        inv, shift = self._bn_affine(*args[1:5], eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.reshape(shape) + shift.reshape(shape)

    def op_prelu(self, node, args):
        x, slope = self._dev(args[0]), self._dev(args[1])
        if slope.dim() == 1 and x.dim() == 4:
            slope = slope.reshape(1, -1, 1, 1)
        elif slope.dim() == 3 and x.dim() == 4:
            slope = slope[None]
        x, neg = self._promote(x, torch.mul(*self._promote(x, slope)))
        return torch.where(x >= 0, x, neg)

    def op_relu(self, node, args):
        return torch.clamp_min(self._dev(args[0]), 0)

    def op_leakyrelu(self, node, args):
        alpha = float(_attr(node, "alpha", 0.01))
        x = self._dev(args[0])
        return torch.where(x >= 0, x, x * alpha)

    def op_sigmoid(self, node, args):
        return torch.sigmoid(self._dev(args[0]))

    def op_softmax(self, node, args):
        return torch.softmax(self._dev(args[0]), dim=int(_attr(node, "axis", -1)))

    def op_clip(self, node, args):
        x = self._dev(args[0])
        lo = args[1] if len(args) > 1 and args[1] is not None else _attr(node, "min")
        hi = args[2] if len(args) > 2 and args[2] is not None else _attr(node, "max")
        if lo is not None:
            x = self._bin(torch.maximum, x, lo) if not isinstance(lo, float) else \
                torch.clamp_min(x, lo)
        if hi is not None:
            x = self._bin(torch.minimum, x, hi) if not isinstance(hi, float) else \
                torch.clamp_max(x, hi)
        return x

    # --------------------------------------------------------------- pooling

    @staticmethod
    def _pool_geometry(node):
        kh, kw = (int(k) for k in _attr(node, "kernel_shape"))
        sh, sw = (int(s) for s in _attr(node, "strides", [1, 1]))
        (pt, pb), (pl, pr) = _pads4(node)
        return (kh, kw), (sh, sw), (pl, pr, pt, pb)

    def op_maxpool(self, node, args):
        x = self._dev(args[0])
        k, s, pads = self._pool_geometry(node)
        if any(pads):
            x = F.pad(x, pads, value=-math.inf)
        return F.max_pool2d(x, k, s)

    def _avg_pool(self, x, node):
        """Window sums over zero padding, divided by kh·kw (padding
        counted, as the JAX executor does; not ONNX's default)."""
        k, s, pads = self._pool_geometry(node)
        if any(pads):
            x = F.pad(x, pads)
        return F.avg_pool2d(x, k, s, 0, count_include_pad=True)

    def op_averagepool(self, node, args):
        return self._avg_pool(self._dev(args[0]), node)

    def op_globalaveragepool(self, node, args):
        return self._dev(args[0]).mean(dim=(2, 3), keepdim=True)

    # ---------------------------------------------------------------- linear

    def op_gemm(self, node, args):
        a, b = self._dev(args[0]), self._dev(args[1])
        c = args[2] if len(args) > 2 else None
        alpha = float(_attr(node, "alpha", 1.0))
        beta = float(_attr(node, "beta", 1.0))
        if int(_attr(node, "transA", 0)):
            a = a.t()
        if int(_attr(node, "transB", 0)):
            b = b.t()
        y = alpha * (a.to(torch.float32) @ b.to(torch.float32))
        if c is not None:
            y = y + beta * self._dev(c)
        return y

    def op_matmul(self, node, args):
        a, b = self._dev(args[0]), self._dev(args[1])
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))

    # ------------------------------------------------------------ elementwise

    def _binop(self, args, np_fn, torch_fn):
        a, b = args
        if _is_static(a, b):
            return np_fn(_np(a), _np(b))
        return self._bin(torch_fn, a, b)

    def op_add(self, node, args):
        return self._binop(args, np.add, torch.add)

    def op_sub(self, node, args):
        return self._binop(args, np.subtract, torch.sub)

    def op_mul(self, node, args):
        return self._binop(args, np.multiply, torch.mul)

    def op_div(self, node, args):
        # ONNX Div is integer division on integer tensors (shape math in
        # torch-export glue chains: Shape→Gather→Div→Concat→Reshape)
        a, b = args
        if _is_static(a, b):
            an, bn = _np(a), _np(b)
            if np.issubdtype(an.dtype, np.integer) and np.issubdtype(bn.dtype, np.integer):
                return an // bn
            return np.divide(an, bn)
        return self._bin(torch.true_divide, a, b)

    def op_pow(self, node, args):
        return self._binop(args, np.power, torch.pow)

    def op_sqrt(self, node, args):
        return torch.sqrt(self._dev(args[0]))

    def op_exp(self, node, args):
        return torch.exp(self._dev(args[0]))

    def op_erf(self, node, args):
        # opset-9 Erf (the exported ViT's exact GELU), in float32
        return torch.special.erf(self._dev(args[0], torch.float32))

    def op_neg(self, node, args):
        return -self._dev(args[0])

    @staticmethod
    def _reduce(fn, node, x):
        axes = _attr(node, "axes")
        keep = bool(int(_attr(node, "keepdims", 1)))
        dims = tuple(int(a) for a in axes) if axes else tuple(range(x.dim()))
        return fn(x, dim=dims, keepdim=keep)

    def op_reducemean(self, node, args):
        return self._reduce(torch.mean, node, self._dev(args[0]))

    def op_reducesum(self, node, args):
        return self._reduce(torch.sum, node, self._dev(args[0]))

    # ------------------------------------------------------- shape plumbing

    def op_shape(self, node, args):
        return np.asarray(tuple(np.shape(args[0]) if _is_static(args[0]) else args[0].shape),
                          np.int64)

    def op_gather(self, node, args):
        data, idx = args
        axis = int(_attr(node, "axis", 0))
        if _is_static(data, idx):
            return np.take(_np(data), _np(idx).astype(np.int64), axis=axis)
        x = self._dev(data)
        axis %= x.dim()
        index = self._dev(idx).to(torch.int64)
        index = torch.where(index < 0, index + x.shape[axis], index)
        return x[(slice(None),) * axis + (index,)]

    def op_unsqueeze(self, node, args):
        axes = _attr(node, "axes")
        if axes is None:  # opset 13: axes is input[1]
            axes = _np(args[1]).tolist()
        x = args[0]
        static = _is_static(x)
        x = _np(x) if static else self._dev(x)
        for a in sorted(int(v) for v in axes):
            x = np.expand_dims(x, a) if static else x.unsqueeze(a)
        return x

    def op_squeeze(self, node, args):
        axes = _attr(node, "axes")
        if axes is None and len(args) > 1 and args[1] is not None:
            axes = _np(args[1]).tolist()
        ax = tuple(int(a) for a in axes) if axes else None
        if _is_static(args[0]):  # keep shape-math subgraphs in numpy
            return np.squeeze(_np(args[0]), axis=ax)
        x = self._dev(args[0])
        if ax is None:
            return x.squeeze()
        return x.squeeze(tuple(a % x.dim() for a in ax))

    def op_concat(self, node, args):
        axis = int(_attr(node, "axis", 0))
        if _is_static(*args):
            return np.concatenate([_np(a) for a in args], axis=axis)
        ts = [self._dev(a) for a in args]
        dt = ts[0].dtype
        for t in ts[1:]:
            dt = torch.promote_types(dt, t.dtype)
        return torch.cat([t.to(dt) for t in ts], dim=axis)

    def op_reshape(self, node, args):
        x = self._dev(args[0])
        shape = [int(s) for s in _np(args[1]).tolist()]
        # ONNX: 0 copies the input dim, -1 infers
        return x.reshape([x.shape[i] if s == 0 else s for i, s in enumerate(shape)])

    def op_flatten(self, node, args):
        axis = int(_attr(node, "axis", 1))
        x = self._dev(args[0])
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return x.reshape(lead, -1)

    def op_transpose(self, node, args):
        x = self._dev(args[0])
        perm = _attr(node, "perm")
        return x.permute(*(perm if perm is not None else range(x.dim() - 1, -1, -1)))

    def op_slice(self, node, args):
        x = args[0]
        if len(args) > 1 and args[1] is not None:  # opset ≥10: inputs
            starts = _np(args[1]).tolist()
            ends = _np(args[2]).tolist()
            axes = (_np(args[3]).tolist() if len(args) > 3 and args[3] is not None
                    else list(range(len(starts))))
            steps = (_np(args[4]).tolist() if len(args) > 4 and args[4] is not None
                     else [1] * len(starts))
        else:  # opset 1: attributes
            starts = _attr(node, "starts")
            ends = _attr(node, "ends")
            axes = _attr(node, "axes", list(range(len(starts))))
            steps = [1] * len(starts)
        if _is_static(x):
            xa = _np(x)
            slicer = [slice(None)] * xa.ndim
            for s, e, a, st in zip(starts, ends, axes, steps):
                slicer[int(a)] = slice(int(s), int(e), int(st))
            return xa[tuple(slicer)]
        xa = self._dev(x)
        for s, e, a, st in zip(starts, ends, axes, steps):
            a = int(a) % xa.dim()
            sl = slice(int(s), int(e), int(st))
            if int(st) > 0:
                xa = xa[(slice(None),) * a + (sl,)]
            else:  # torch slices take no negative step
                idx = torch.arange(*sl.indices(xa.shape[a]), device=xa.device)
                xa = xa.index_select(a, idx)
        return xa

    def op_split(self, node, args):
        axis = int(_attr(node, "axis", 0))
        splits = _attr(node, "split")
        if splits is None and len(args) > 1 and args[1] is not None:
            splits = _np(args[1]).tolist()
        x = self._dev(args[0])
        if splits is None:
            n = len(node.outputs)
            if x.shape[axis] % n:
                raise ValueError(f"Split: dim {x.shape[axis]} not divisible into {n}")
            return tuple(torch.tensor_split(x, n, dim=axis))
        idx = np.cumsum([int(s) for s in splits])[:-1]
        return tuple(torch.tensor_split(x, idx.tolist(), dim=axis))

    def op_cast(self, node, args):
        np_dtype = proto.DTYPE_MAP[int(_attr(node, "to"))]
        x = args[0]
        if _is_static(x):
            return _np(x).astype(np_dtype)
        return self._dev(x).to(_torch_dtype(np_dtype))

    def op_constant(self, node, args):
        val = _attr(node, "value")
        if val is None:
            for k in ("value_float", "value_int"):
                if k in node.attrs:
                    return np.asarray(node.attrs[k])
            raise NotImplementedError("Constant without value attr")
        return val

    def op_constantofshape(self, node, args):
        shape = [int(s) for s in _np(args[0]).tolist()]
        val = _attr(node, "value")
        fill = val.ravel()[0] if val is not None else np.float32(0)
        return np.full(shape, fill)

    def op_identity(self, node, args):
        return args[0]

    def op_dropout(self, node, args):
        return args[0]  # inference mode

    def op_pad(self, node, args):
        mode = _attr(node, "mode", b"constant")
        pads = _attr(node, "pads")
        if pads is None:
            pads = _np(args[1]).tolist()
        x = self._dev(args[0])
        nd = x.dim()
        pairs = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
        if mode in (b"constant", "constant"):
            const = 0.0
            if len(args) > 2 and args[2] is not None:
                const = float(_np(args[2]))
            flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
            return F.pad(x, flat, value=const)
        for d, (lo, hi) in enumerate(pairs):  # every other mode pads edge values
            if lo or hi:
                idx = torch.arange(-lo, x.shape[d] + hi, device=x.device)
                x = x.index_select(d, idx.clamp(0, x.shape[d] - 1))
        return x

    def op_resize(self, node, args):
        x = self._dev(args[0])
        sizes = None
        if len(args) > 3 and args[3] is not None:
            sizes = [int(s) for s in _np(args[3]).tolist()]
        elif len(args) > 2 and args[2] is not None:
            scales = _np(args[2]).astype(np.float64)
            if scales.size:
                sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
        if sizes is None:
            raise NotImplementedError("Resize without scales/sizes")
        return resize(x, sizes, _mode_is_nearest(node))

    def op_spacetodepth(self, node, args):
        # blocks → channels in ONNX's (by, bx, c) order, as models/scrfd.space_to_depth
        bs = int(_attr(node, "blocksize"))
        x = self._dev(args[0])
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(n, c * bs * bs, h // bs, w // bs)

    def op_upsample(self, node, args):
        scales = _attr(node, "scales")
        if scales is None:
            scales = _np(args[1]).tolist()
        x = self._dev(args[0])
        sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
        return resize(x, sizes, _mode_is_nearest(node))

    # -------------------------------------------------- fast-path handlers
    # Each returns None to defer to the (untagging) op_* handler. A conv
    # (or a node reading the runtime input) is the only tag source; the
    # others carry the tag through layout-agnostic math.

    def _cdt(self, x):
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def nhwc_conv(self, node, args):
        x, w = args[0], args[1]
        if not isinstance(w, (np.ndarray, np.generic)):
            return None  # dynamic weights: the reference path
        if _attr(node, "auto_pad") not in _NOTSET:
            return None  # the reference path's auto_pad handling
        xa = x.a if isinstance(x, _Tagged) else self._dev(x)
        cdt = self.compute_dtype
        wc = self._cached(("conv_w", cdt), w, lambda a: self._cdt(
            torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
        ).to(torch.float32))
        geom = self._conv_geometry(node, wc.shape[2], wc.shape[3])
        y = self._conv(self._cdt(xa).to(torch.float32), wc, *geom)
        b = args[2] if len(args) > 2 else None
        if b is not None:
            y = y + self._dev(b, torch.float32).reshape(1, -1, 1, 1)
        return _Tagged(self._cdt(y))

    def nhwc_batchnormalization(self, node, args):
        x = args[0]
        if not isinstance(x, _Tagged):
            return None
        eps = float(_attr(node, "epsilon", 1e-5))
        inv, shift = self._bn_affine(*args[1:5], eps)
        y = x.a * inv.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)
        return _Tagged(self._cdt(y))

    def nhwc_prelu(self, node, args):
        x, slope = args[0], args[1]
        if not isinstance(x, _Tagged):
            return None
        s = self._dev(slope)
        if s.dim() == 3 and tuple(s.shape[1:]) != (1, 1):
            return None
        if s.dim() not in (1, 3):
            return None
        s = s.reshape(1, -1, 1, 1).to(x.a.dtype)  # ONNX (C,) or (C, 1, 1)
        return _Tagged(torch.where(x.a >= 0, x.a, x.a * s))

    @staticmethod
    def _nhwc_unary(args, fn):
        x = args[0]
        if not isinstance(x, _Tagged):
            return None
        return _Tagged(fn(x.a))

    def nhwc_relu(self, node, args):
        return self._nhwc_unary(args, lambda a: torch.clamp_min(a, 0))

    def nhwc_leakyrelu(self, node, args):
        alpha = float(_attr(node, "alpha", 0.01))
        return self._nhwc_unary(args, lambda a: torch.where(a >= 0, a, a * alpha))

    def nhwc_sigmoid(self, node, args):
        return self._nhwc_unary(args, torch.sigmoid)

    def nhwc_identity(self, node, args):
        return args[0] if isinstance(args[0], _Tagged) else None

    def nhwc_dropout(self, node, args):
        return args[0] if isinstance(args[0], _Tagged) else None

    def nhwc_clip(self, node, args):
        x = args[0]
        if not isinstance(x, _Tagged):
            return None
        lo = args[1] if len(args) > 1 and args[1] is not None else _attr(node, "min")
        hi = args[2] if len(args) > 2 and args[2] is not None else _attr(node, "max")
        a = x.a
        if lo is not None:
            a = torch.maximum(a, self._dev(np.asarray(lo)).to(a.dtype))
        if hi is not None:
            a = torch.minimum(a, self._dev(np.asarray(hi)).to(a.dtype))
        return _Tagged(a)

    def _nhwc_binop(self, args, fn):
        a, b = args
        if isinstance(a, _Tagged) and isinstance(b, _Tagged):
            return _Tagged(fn(*self._promote(a.a, b.a)))
        for t, o in ((a, b), (b, a)):
            if isinstance(t, _Tagged) and _is_static(o):
                on = _np(o)
                if on.ndim == 0 or on.size == 1:
                    oc = self._cached("scalar", o, lambda v: self._dev(_np(v).reshape(())))
                elif on.ndim == 4 and on.shape[0] == 1 and on.shape[2:] == (1, 1):
                    oc = self._dev(o)
                else:
                    continue
                pa, pb = self._promote(t.a, oc) if t is a else self._promote(oc, t.a)
                return _Tagged(fn(pa, pb))
        return None

    def nhwc_add(self, node, args):
        return self._nhwc_binop(args, torch.add)

    def nhwc_sub(self, node, args):
        return self._nhwc_binop(args, torch.sub)

    def nhwc_mul(self, node, args):
        return self._nhwc_binop(args, torch.mul)

    def nhwc_div(self, node, args):
        return self._nhwc_binop(args, torch.true_divide)

    def nhwc_maxpool(self, node, args):
        x = args[0]
        if not isinstance(x, _Tagged) or _attr(node, "auto_pad") not in _NOTSET:
            return None
        return _Tagged(self.op_maxpool(node, [x.a]))

    def nhwc_averagepool(self, node, args):
        x = args[0]
        if not isinstance(x, _Tagged) or _attr(node, "auto_pad") not in _NOTSET:
            return None
        return _Tagged(self._cdt(self._avg_pool(x.a.to(torch.float32), node)))

    def nhwc_globalaveragepool(self, node, args):
        x = args[0]
        if not isinstance(x, _Tagged):
            return None
        return _Tagged(self._cdt(x.a.to(torch.float32).mean(dim=(2, 3), keepdim=True)))

    def nhwc_upsample(self, node, args):
        x = args[0]
        if not isinstance(x, _Tagged):
            return None
        scales = _attr(node, "scales")
        if scales is None:
            if len(args) < 2 or not _is_static(args[1]):
                return None
            scales = _np(args[1]).tolist()
        sizes = [int(round(d * float(s))) for d, s in zip(x.a.shape, scales)]
        return _Tagged(resize(x.a, sizes, _mode_is_nearest(node)))

    def nhwc_spacetodepth(self, node, args):
        x = args[0]
        if not isinstance(x, _Tagged):
            return None
        return _Tagged(self.op_spacetodepth(node, [x.a]))
