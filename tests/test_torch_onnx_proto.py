"""The port's ONNX wire writer and reader vs the JAX package's.

The writer must give the same bytes for tensors, attributes, nodes,
graphs and models; the reader must parse a JAX-written file into the
same nodes, attributes and bit-equal initializers as the JAX reader.
"""

import numpy as np
import pytest

from facerecognizeonnx_tpu.onnx_export import writer as JW
from facerecognizeonnx_tpu.onnx_import import proto as jproto
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.onnx_export import writer as W
from facerecognizeonnx_tpu_torch.onnx_import import proto
from tests.oracles import scrfd_nas_onnx as S

RNG = np.random.default_rng(9)

TENSORS = {
    "f32_raw": (RNG.standard_normal((3, 4, 5)).astype(np.float32), True),
    "f32_packed": (RNG.standard_normal((7,)).astype(np.float32), False),
    "i64_varints": (np.asarray([0, 1, -1, 300, -(2 ** 40)], np.int64), False),
    "i64_raw": (np.arange(6, dtype=np.int64).reshape(2, 3), True),
    "u8_raw": (RNG.integers(0, 256, (4, 4)).astype(np.uint8), True),
    "i8_raw": (RNG.integers(-128, 128, (5,)).astype(np.int8), True),
    "f16_raw": (RNG.standard_normal((2, 2)).astype(np.float16), True),
    "f64_raw": (RNG.standard_normal((3,)), True),
    "scalar": (np.asarray(2.5, np.float32), True),
}


@pytest.mark.parametrize("name", list(TENSORS))
def test_tensor_bytes_equal_and_round_trip(name):
    arr, raw = TENSORS[name]
    data = W.tensor(name, arr, use_raw=raw)
    assert data == JW.tensor(name, arr, use_raw=raw)
    t = proto.parse_tensor(data)
    assert t.name == name and t.array.dtype == np.atleast_1d(arr).dtype
    np.testing.assert_array_equal(t.array, np.atleast_1d(arr) if arr.ndim == 0 else arr)


ATTRS = {
    "int": 3, "neg_int": -7, "bool": True, "float": 0.125, "bytes": b"nearest", "str": "edge",
    "ints": [1, 2, -3], "floats": [1.0, 2.5], "tensor": np.asarray([1.5, -2.0], np.float32),
}


@pytest.mark.parametrize("name", list(ATTRS))
def test_attribute_and_node_bytes_equal(name):
    value = ATTRS[name]
    assert W._attribute(name, value) == JW._attribute(name, value)
    args = ("Op", ["a", "b"], ["c"])
    assert W.node(*args, name="n", **{name: value}) == JW.node(*args, name="n", **{name: value})
    assert W.node(*args, **{name: value}) == JW.node(*args, **{name: value})


def test_graph_and_model_bytes_equal():
    nodes = [W.node("Conv", ["input", "w"], ["c"], pads=[1, 1, 1, 1]),
             W.node("Relu", ["c"], ["y"])]
    inits = [W.tensor("w", RNG.standard_normal((4, 3, 3, 3)).astype(np.float32)),
             W.tensor("shape", np.asarray([0, -1], np.int64), use_raw=False)]
    io = ([("input", [None, 3, 8, 8])], [("y", [1, -1, None, 8])])
    g = W.graph(nodes, inits, *io, name="g")
    assert g == JW.graph(nodes, inits, *io, name="g")
    for opset in (8, 9, 13):
        assert W.model(g, opset) == JW.model(g, opset)


def _same_graph(got, want):
    assert got.name == want.name and got.inputs == want.inputs
    assert got.outputs == want.outputs
    assert len(got.nodes) == len(want.nodes)
    for a, b in zip(got.nodes, want.nodes):
        assert (a.op_type, a.name, a.inputs, a.outputs) == (b.op_type, b.name, b.inputs, b.outputs)
        assert a.attrs.keys() == b.attrs.keys()
        for k in a.attrs:
            if isinstance(a.attrs[k], np.ndarray):
                np.testing.assert_array_equal(a.attrs[k], b.attrs[k])
            else:
                assert a.attrs[k] == b.attrs[k], k
    assert list(got.initializers) == list(want.initializers)
    for k, v in got.initializers.items():
        w = want.initializers[k]
        assert v.dtype == w.dtype and v.shape == w.shape
        assert v.tobytes() == w.tobytes(), k  # bit-equal


def test_reader_parses_jax_written_det500m_shape(tmp_path):
    """The det_500m-shaped oracle (glue chains, 9 scrambled outputs),
    written by the JAX package's writer."""
    blob, _ = S.emit_scrfd_nas_onnx(S.make_weights(seed=1), 64)
    path = tmp_path / "det.onnx"
    path.write_bytes(blob)
    _same_graph(proto.load_model(str(path)), jproto.load_model(str(path)))


def test_reader_parses_jax_export_of_a_recognizer():
    """The JAX package's export of an mbf tree: 8 MB of initializers."""
    from facerecognizeonnx_tpu.onnx_export import export_recognizer

    data = export_recognizer(bridge.init_params_numpy("mbf", seed=2))
    _same_graph(proto.parse_model(data), jproto.parse_model(data))
    with pytest.raises(ValueError, match="no GraphProto"):
        proto.parse_model(b"")
