"""The port's ONNX graph executor vs the JAX package's, op by op.

Each case is a small graph (one or two nodes, a few more for the glue
chain of a torch export) written by the port's writer, parsed by each
package's reader and run by each package's executor on the same numpy
input, in three modes:

  ref       the reference NCHW executor, float32: atol 1e-4
  fast_f32  the fast path at float32: atol 1e-4
  fast_bf16 the fast path at bfloat16: output dtypes equal, and values
            bit-equal where the case's ops round nothing but their own
            exact result, else within one bf16 ulp (a conv's float32 sum
            and a sigmoid's float32 math may round across a midpoint
            differently in the two libraries)

Fast-mode inputs arrive NHWC (`nhwc_inputs=True`), as the runners feed
them. The cases cover asymmetric pads, auto_pad, pooling with its pads
counted, nearest and linear upsample and resize, the integer Div of the
shape glue, and the bf16 x float32-scalar promotion of the exported
detector's bbox and kps heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.onnx_import import proto as jproto
from facerecognizeonnx_tpu.onnx_import.executor import Executor as JaxExecutor
from facerecognizeonnx_tpu_torch.errors import UnsupportedOnnxOp
from facerecognizeonnx_tpu_torch.onnx_export import writer as W
from facerecognizeonnx_tpu_torch.onnx_import import proto
from facerecognizeonnx_tpu_torch.onnx_import.executor import Executor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(5)


def _w(*shape, scale=0.3):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


X4 = ("x", (2, 4, 9, 10))


def _conv(x, out, w, b=None, **attrs):
    inputs = [x, w] + ([b] if b else [])
    return W.node("Conv", inputs, [out], **attrs)


CONV_W = {"cw": _w(6, 4, 3, 3), "cb": _w(6)}


def _case(nodes, inits, inputs=(X4,), outputs=("y",), exact=True):
    return dict(nodes=nodes, inits=inits, inputs=inputs, outputs=outputs, exact=exact)


# name → case; `exact`: bf16 outputs bit-equal (else within one ulp)
CASES = {
    "conv_asym_pads_stride2": _case(
        [_conv("x", "y", "cw", "cb", strides=[2, 2], pads=[0, 1, 2, 1], kernel_shape=[3, 3])],
        CONV_W, exact=False),
    "conv_depthwise_dilated": _case(
        [_conv("x", "y", "dw", strides=[1, 1], pads=[2, 2, 2, 2], dilations=[2, 2], group=4,
               kernel_shape=[3, 3])],
        {"dw": _w(4, 1, 3, 3)}, exact=False),
    "conv_auto_pad_same_upper": _case(
        [_conv("x", "y", "cw", "cb", strides=[2, 2], auto_pad=b"SAME_UPPER")], CONV_W,
        exact=False),
    "conv_auto_pad_same_lower": _case(
        [_conv("x", "y", "cw", strides=[2, 2], auto_pad=b"SAME_LOWER")], CONV_W, exact=False),
    "conv_dynamic_weight": _case(
        [W.node("Relu", ["cw"], ["rw"]), _conv("x", "y", "rw", "cb", pads=[1, 1, 1, 1])],
        CONV_W, exact=False),
    "conv_bn": _case(
        [_conv("x", "c", "cw", pads=[1, 1, 1, 1]),
         W.node("BatchNormalization", ["c", "g", "b", "m", "v"], ["y"], epsilon=1e-3)],
        {"cw": CONV_W["cw"], "g": _w(6) + 1, "b": _w(6), "m": _w(6),
         "v": np.abs(_w(6)) + 0.5}, exact=False),
    "bn_on_input": _case(
        [W.node("BatchNormalization", ["x", "g", "b", "m", "v"], ["y"])],
        {"g": _w(4) + 1, "b": _w(4), "m": _w(4), "v": np.abs(_w(4)) + 0.5}, exact=False),
    "prelu_c11_after_conv": _case(
        [_conv("x", "c", "cw"), W.node("PRelu", ["c", "s"], ["y"])],
        {"cw": CONV_W["cw"], "s": _w(6, 1, 1)}, exact=False),
    "prelu_1d": _case([W.node("PRelu", ["x", "s"], ["y"])], {"s": _w(4)}),
    "relu": _case([W.node("Relu", ["x"], ["y"])], {}),
    "leakyrelu": _case([W.node("LeakyRelu", ["x"], ["y"], alpha=0.2)], {}),
    "sigmoid_after_conv": _case(
        [_conv("x", "c", "cw", "cb"), W.node("Sigmoid", ["c"], ["y"])], CONV_W, exact=False),
    "clip_attrs": _case([W.node("Clip", ["x"], ["y"], min=-0.25, max=0.5)], {}),
    "clip_inputs": _case(
        [W.node("Clip", ["x", "lo", "hi"], ["y"])],
        {"lo": np.asarray(-0.25, np.float32), "hi": np.asarray(0.5, np.float32)}),
    "maxpool_asym_pads": _case(
        [W.node("MaxPool", ["x"], ["y"], kernel_shape=[3, 3], strides=[2, 2],
                pads=[1, 0, 0, 1])], {}),
    "averagepool_pads_counted": _case(
        [W.node("AveragePool", ["x"], ["y"], kernel_shape=[3, 2], strides=[2, 1],
                pads=[1, 1, 0, 1])], {}, exact=False),
    "globalaveragepool": _case([W.node("GlobalAveragePool", ["x"], ["y"])], {}, exact=False),
    "upsample_nearest_x2": _case(
        [W.node("Upsample", ["x"], ["y"], mode=b"nearest", scales=[1.0, 1.0, 2.0, 2.0])], {}),
    "upsample_linear_x2": _case(
        [W.node("Upsample", ["x"], ["y"], mode=b"linear", scales=[1.0, 1.0, 2.0, 2.0])], {},
        exact=False),
    "resize_nearest_scales": _case(
        [W.node("Resize", ["x", "", "sc"], ["y"], mode=b"nearest")],
        {"sc": np.asarray([1, 1, 2, 3], np.float32)}),
    "resize_linear_sizes": _case(
        [W.node("Resize", ["x", "", "", "sz"], ["y"], mode=b"linear")],
        {"sz": np.asarray([2, 4, 15, 20], np.int64)}, exact=False),
    "spacetodepth": _case(
        [W.node("SpaceToDepth", ["x"], ["y"], blocksize=2)], {}, inputs=(("x", (2, 3, 8, 6)),)),
    "mul_bf16_by_f32_scalar": _case(
        [_conv("x", "c", "cw", "cb", pads=[1, 1, 1, 1]), W.node("Mul", ["c", "scale"], ["y"])],
        {**CONV_W, "scale": np.asarray([0.75], np.float32)}, exact=False),
    "add_per_channel_const": _case(
        [W.node("Add", ["x", "pc"], ["y"])], {"pc": _w(1, 4, 1, 1)}),
    "div_tagged_by_tagged": _case(
        [_conv("x", "c", "cw", "cb"), W.node("Relu", ["c"], ["r"]),
         W.node("Add", ["r", "one"], ["d"]), W.node("Div", ["c", "d"], ["y"])],
        {**CONV_W, "one": np.ones((1, 6, 1, 1), np.float32)}, exact=False),
    "integer_div_shape_glue": _case(
        [W.node("Transpose", ["x"], ["t"], perm=[0, 2, 3, 1]),
         W.node("Shape", ["t"], ["s"]),
         W.node("Gather", ["s", "ax3"], ["g"], axis=0),
         W.node("Squeeze", ["g"], ["g0"], axes=[0]),
         W.node("Squeeze", ["two1"], ["two"], axes=[0]),  # the writer's tensors are ≥ 1-d
         W.node("Div", ["g0", "two"], ["c"]),
         W.node("Unsqueeze", ["c"], ["c1"], axes=[0]),
         W.node("Concat", ["neg1", "c1"], ["tgt"], axis=0),
         W.node("Reshape", ["t", "tgt"], ["y"])],
        {"ax3": np.asarray([3], np.int64), "two1": np.asarray([2], np.int64),
         "neg1": np.asarray([-1], np.int64)}),
    "gemm_transb_alpha_beta": _case(
        [W.node("Gemm", ["x", "gw", "gb"], ["y"], alpha=0.5, beta=2.0, transB=1)],
        {"gw": _w(5, 12), "gb": _w(5)}, inputs=(("x", (3, 12)),)),
    "flatten_gemm_after_conv": _case(
        [_conv("x", "c", "cw", "cb", strides=[3, 3]), W.node("Flatten", ["c"], ["f"], axis=1),
         W.node("Gemm", ["f", "gw"], ["y"], transB=1)],
        {**CONV_W, "gw": _w(7, 6 * 3 * 3)}, exact=False),
    "matmul_3d": _case(
        [W.node("MatMul", ["x", "mw"], ["y"])], {"mw": _w(6, 5)}, inputs=(("x", (2, 3, 6)),)),
    "softmax_axis": _case([W.node("Softmax", ["x"], ["y"], axis=1)], {},
                          inputs=(("x", (3, 7)),)),
    "erf_reducemean": _case(
        [W.node("Erf", ["x"], ["e"]), W.node("ReduceMean", ["e"], ["y"], axes=[1], keepdims=0)],
        {}, inputs=(("x", (2, 5, 6)),)),
    "reducesum_keepdims": _case(
        [W.node("ReduceSum", ["x"], ["y"], axes=[2, 3], keepdims=1)], {}, exact=False),
    "transpose_default_perm": _case([W.node("Transpose", ["x"], ["y"])], {}),
    "slice_negative_step": _case(
        [W.node("Slice", ["x", "st", "en", "axs", "stp"], ["y"])],
        {"st": np.asarray([7, 1], np.int64), "en": np.asarray([0, 9], np.int64),
         "axs": np.asarray([3, 2], np.int64), "stp": np.asarray([-2, 3], np.int64)}),
    "split_concat": _case(
        [W.node("Split", ["x"], ["a", "b"], axis=1, split=[1, 3]),
         W.node("Concat", ["b", "a"], ["y"], axis=1)], {}),
    "pad_constant_and_edge": _case(
        [W.node("Pad", ["x"], ["p"], mode=b"constant", pads=[0, 0, 1, 2, 0, 0, 2, 0], value=0.5),
         W.node("Pad", ["p"], ["y"], mode=b"edge", pads=[0, 1, 0, 1, 0, 0, 2, 1])], {}),
    "cast_sqrt_exp_neg_pow": _case(
        [W.node("Cast", ["x"], ["c"], to=1), W.node("Exp", ["c"], ["e"]),
         W.node("Sqrt", ["e"], ["s"]), W.node("Neg", ["s"], ["n"]),
         W.node("Pow", ["n", "two"], ["y"])],
        {"two": np.asarray(2.0, np.float32)}, exact=False),
    "unsqueeze_squeeze_gather": _case(
        [W.node("Unsqueeze", ["x"], ["u"], axes=[0]),
         W.node("Squeeze", ["u"], ["s"], axes=[0]),
         W.node("Gather", ["s", "idx"], ["y"], axis=2)],
        {"idx": np.asarray([[4, 0], [2, 2]], np.int64)}),
    "constant_identity_dropout": _case(
        [W.node("Constant", [], ["k"], value=np.asarray([1.5], np.float32)),
         W.node("ConstantOfShape", ["shp"], ["z"], value=np.asarray([0.25], np.float32)),
         W.node("Identity", ["x"], ["i"]), W.node("Dropout", ["i"], ["dd"]),
         W.node("Mul", ["dd", "k"], ["m"]), W.node("Add", ["m", "z"], ["y"])],
        {"shp": np.asarray([1, 4, 1, 1], np.int64)}),
}

MODES = {"ref": (False, None, None), "fast_f32": (True, None, None),
         "fast_bf16": (True, jnp.bfloat16, torch.bfloat16)}


def _graph_bytes(case):
    inits = [W.tensor(k, v) for k, v in case["inits"].items()]
    return W.model(W.graph(case["nodes"], inits, [(n, list(s)) for n, s in case["inputs"]],
                           [(o, []) for o in case["outputs"]]))


def _run_both(case, mode):
    nhwc, jdt, tdt = MODES[mode]
    data = _graph_bytes(case)
    jex = JaxExecutor(jproto.parse_model(data), nhwc=nhwc, compute_dtype=jdt)
    pex = Executor(proto.parse_model(data), nhwc=nhwc, compute_dtype=tdt, device="cpu")
    feeds = {}
    for name, shape in case["inputs"]:
        x = RNG.uniform(-1, 1, shape).astype(np.float32)
        feeds[name] = np.transpose(x, (0, 2, 3, 1)) if nhwc and x.ndim == 4 else x
    want = jax.jit(lambda f: jex.run(f, nhwc_inputs=nhwc))(
        {k: jnp.asarray(v) for k, v in feeds.items()})
    got = pex.run({k: torch.from_numpy(v) for k, v in feeds.items()}, nhwc_inputs=nhwc)
    return want, got


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(CASES))
def test_op_matches_jax_executor(name, mode):
    case = CASES[name]
    want, got = _run_both(case, mode)
    assert len(want) == len(got) == len(case["outputs"])
    for w, g in zip(want, got):
        g = g if isinstance(g, torch.Tensor) else torch.from_numpy(np.asarray(g))
        assert str(jnp.asarray(w).dtype) == str(g.dtype).replace("torch.", ""), (
            jnp.asarray(w).dtype, g.dtype)
        wf = np.asarray(jnp.asarray(w).astype(jnp.float32))
        gf = g.to(torch.float32).numpy()
        assert wf.shape == gf.shape
        if mode != "fast_bf16" or g.dtype != torch.bfloat16:
            np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-4)
        elif case["exact"]:
            np.testing.assert_array_equal(gf, wf)
        else:
            ulp = _bf16_ulp(np.maximum(np.abs(wf), np.abs(gf)))
            assert (np.abs(gf - wf) <= ulp).all(), float(np.abs(gf - wf).max())


def test_fast_bf16_rounds_where_jax_rounds():
    """bf16 conv → bf16 tensor; × the (1,) float32 scale → float32 (JAX's
    promotion; torch alone would keep bf16 against a 0-d operand); the
    dynamic-weight conv takes op_conv and stays float32."""
    for name, dtype in (("conv_asym_pads_stride2", torch.bfloat16),
                        ("mul_bf16_by_f32_scalar", torch.float32),
                        ("conv_dynamic_weight", torch.float32),
                        ("sigmoid_after_conv", torch.bfloat16)):
        _, got = _run_both(CASES[name], "fast_bf16")
        assert got[0].dtype == dtype, (name, got[0].dtype)


def test_weights_upload_once():
    """A second run uploads nothing: the conv weight's rounded copy and the
    BN's scale and shift are the same device tensors."""
    case = CASES["conv_bn"]
    ex = Executor(proto.parse_model(_graph_bytes(case)), nhwc=True,
                  compute_dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(RNG.uniform(-1, 1, (2, 9, 10, 4)).astype(np.float32))
    first = ex.run({"x": x}, nhwc_inputs=True)[0]
    cached = dict(ex._uploads)
    assert len(cached) >= 2
    again = ex.run({"x": x}, nhwc_inputs=True)[0]
    assert ex._uploads.keys() == cached.keys()
    assert all(ex._uploads[k] is cached[k] for k in cached)
    assert torch.equal(first, again)


def test_static_shape_math_stays_on_the_host():
    """The glue chain's Shape/Gather/Div/Concat run in numpy (integer Div
    floors there) and the Reshape reads the target as host integers."""
    case = CASES["integer_div_shape_glue"]
    ex = Executor(proto.parse_model(_graph_bytes(case)), device="cpu")
    x = torch.from_numpy(RNG.uniform(-1, 1, X4[1]).astype(np.float32))
    (y,) = ex.run({"x": x})
    assert tuple(y.shape) == (2 * 9 * 10 * 2, 2)
    assert ex.consts["neg1"].dtype == np.int64


def test_unsupported_op_raises_with_node_name():
    data = W.model(W.graph([W.node("FooBar", ["x"], ["y"], name="odd_node")], [],
                           [("x", [1, 3])], [("y", [1, 3])]))
    ex = Executor(proto.parse_model(data), device="cpu")
    with pytest.raises(UnsupportedOnnxOp, match="'FooBar'.*'odd_node'"):
        ex.run({"x": torch.zeros(1, 3)})
    assert issubclass(UnsupportedOnnxOp, NotImplementedError)
