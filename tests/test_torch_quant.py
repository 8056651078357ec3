"""w8a8 post-training quantization (`models/quant.py`) vs the JAX
package's, same weights and calibration crops.

The JAX side quantizes with `quant.quantize_recognizer` (jitted) and
runs `QuantizedRecognizer` / `apply_quantized`; the port's
`quantize_recognizer` returns a copy of the module with QConv / QLinear
ops. Ops are matched in trace order (the order a forward pass calls
them), as the JAX qstate lists them. Calibration in float32 for the
scale comparisons (a bf16 activation's max moves by whole bf16 ulps with
the backend's rounding), the JAX default bf16 elsewhere.

The sequential calibration amplifies rounding: once one activation of
one op rounds to the other int8 neighbour (its float32 value differing
in the last bit between two backends), every later op sees other
inputs, and its scale moves by up to a few percent. The port moves that
much against itself when its convs run in float64 (measured on mbf:
scales equal to 1.1e-7 over the first 15 quantized ops, then up to
2.5e-2 apart). So the scales are held to rtol 1e-6 over the leading ops
and within 10% over all of them (JAX against the port, measured: iresnet18
equal over its first 12, at most 1.3e-2 apart after; mbf equal over its
first 26, at most 5.9e-2 apart after), and the features of the two
quantized forwards are compared with the same qstate in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.models import arcface, mobilefacenet
from facerecognizeonnx_tpu.models import quant as j_quant
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.models import quant
from facerecognizeonnx_tpu_torch.models.layers import Conv, Linear
from tests.test_torch_model_family import _calibrated
from tests.test_torch_models import _cos, _np_tree, iresnet_calibrated

SIZE = {"iresnet18": 112, "mbf": 64}
JAX_MOD = {"iresnet18": arcface, "mbf": mobilefacenet}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crops(n, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, size, size, 3)).astype(np.float32)
    return (x - 127.5) / 128.0


@pytest.fixture(scope="module", params=["iresnet18", "mbf"])
def folded(request):
    """(arch, BN-calibrated and folded JAX tree, the port's module of it)."""
    arch = request.param
    if arch == "iresnet18":
        tree = iresnet_calibrated()
    else:
        calib = _crops(8, SIZE[arch], 1)
        tree = _calibrated(lambda k: mobilefacenet.init_params(k, arch, SIZE[arch]),
                           mobilefacenet.apply, calib)
    tree = JAX_MOD[arch].fold_inference_params(tree)
    return arch, tree, bridge.params_from_numpy(_np_tree(tree), device="cpu")


def _jax_qstate(arch, tree, calib, dtype, min_channels):
    mod = JAX_MOD[arch]
    return jax.jit(lambda p, c: j_quant.quantize_recognizer(
        mod.apply, p, c, compute_dtype=dtype, min_channels=min_channels))(tree, jnp.asarray(calib))


def _trace(model, x, dtype):
    """The conv and FC ops of `model` in the order a forward calls them."""
    order = []
    hooks = [m.register_forward_pre_hook(lambda mod, _: order.append(mod))
             for m in model.modules()
             if isinstance(m, (Conv, Linear, quant.QConv, quant.QLinear))]
    with torch.no_grad():
        model(torch.from_numpy(x), dtype)
    for h in hooks:
        h.remove()
    return order


@pytest.mark.parametrize("min_channels", [0, 128])
def test_quantized_ops_weights_and_scales_match_jax(folded, min_channels):
    """The same ops quantized (in trace order), w_q bit for bit, w_scale
    within rtol 1e-6; in_scale within rtol 1e-6 over the first 6 quantized
    ops and within 10% over all (float32 calibration; module docstring)."""
    arch, tree, model = folded
    calib = _crops(4, SIZE[arch], 2)
    qs = _jax_qstate(arch, tree, calib, jnp.float32, min_channels)
    qmodel = quant.quantize_recognizer(model, torch.from_numpy(calib), torch.float32,
                                       min_channels)
    ops = _trace(qmodel, calib[:1], torch.float32)
    convs = [m for m in ops if isinstance(m, (Conv, quant.QConv))]
    lins = [m for m in ops if isinstance(m, (Linear, quant.QLinear))]
    assert [isinstance(m, quant.QConv) for m in convs] == [q is not None for q in qs["convs"]]
    assert len(lins) == len(qs["linears"]) and all(isinstance(m, quant.QLinear) for m in lins)
    n_q = sum(q is not None for q in qs["convs"])
    if arch == "mbf" and min_channels == 0:
        assert n_q == 32  # stem + 15x(pw1+pw2) + conv_sep; the 17 grouped stay
    if min_channels:
        assert 0 < n_q < len(qs["convs"])
    float_ops = _trace(model, calib[:1], torch.float32)  # same order, float weights
    float_ops = [m for m in float_ops if isinstance(m, Conv)] + \
        [m for m in float_ops if isinstance(m, Linear)]
    pairs = [(m, f, q) for m, f, q in zip(convs + lins, float_ops,
                                          list(qs["convs"]) + list(qs["linears"]))
             if q is not None]
    for i, (m, f, q) in enumerate(pairs):
        # JAX's weight quantizer run eagerly on the same float weight (as
        # HWIO / (din, dout)); jitted, XLA's fused division rounds about
        # one quotient in 10^7 the other way
        w_ref = f.weight.numpy().transpose(2, 3, 1, 0) if f.weight.dim() == 4 else \
            f.weight.numpy().T
        w_q, w_scale = j_quant._quantize_weight(jnp.asarray(w_ref), channel_axis=w_ref.ndim - 1)
        np.testing.assert_array_equal(m.w_q.numpy(), _port_w_q(m, w_q))
        np.testing.assert_allclose(m.w_scale.numpy(), np.asarray(q["w_scale"]), rtol=1e-6)
        np.testing.assert_allclose(m.w_scale.numpy(), np.asarray(w_scale), rtol=0)
        np.testing.assert_allclose(float(m.in_scale), float(q["in_scale"]),
                                   rtol=1e-6 if i < 6 else 0.1)


def _port_w_q(m, w_q):
    """A JAX w_q (HWIO conv, (din, dout) FC) in the port's layout."""
    w_q = np.asarray(w_q)
    if isinstance(m, quant.QConv):  # HWIO → (O, kh*kw*I)
        return w_q.transpose(3, 0, 1, 2).reshape(w_q.shape[3], -1)
    return w_q.T


def _load_qstate(qmodel, qs, x):
    """Put JAX's qstate (weights and scales) into the port's quantized ops."""
    ops = [m for m in _trace(qmodel, x, torch.float32)
           if isinstance(m, (Conv, Linear, quant.QConv, quant.QLinear))]
    convs = [m for m in ops if isinstance(m, (Conv, quant.QConv))]
    lins = [m for m in ops if isinstance(m, (Linear, quant.QLinear))]
    for m, q in zip(convs + lins, list(qs["convs"]) + list(qs["linears"])):
        if q is not None:
            m.w_q = torch.from_numpy(_port_w_q(m, q["w_q"]).copy())
            m.w_scale = torch.from_numpy(np.asarray(q["w_scale"]).copy())
            m.in_scale = torch.tensor(float(q["in_scale"]))


@pytest.mark.parametrize("op", ["first", "stride2_3x3", "stride2_1x1"])
def test_conv_accumulator_matches_jax(op):
    """The int32 accumulator of a quantized conv on the same int8 input:
    the port's im2col + int_mm vs XLA's int8 conv (conv2d_q's product)."""
    shapes = {"first": (3, 3, 3, 64, 1, 1), "stride2_3x3": (3, 3, 64, 128, 2, 1),
              "stride2_1x1": (1, 1, 64, 128, 2, 0)}
    kh, kw, cin, cout, stride, pad = shapes[op]
    rng = np.random.default_rng(4)
    w = rng.normal(size=(kh, kw, cin, cout)).astype(np.float32)
    w_q, _ = j_quant._quantize_weight(jnp.asarray(w), channel_axis=3)
    xq = rng.integers(-127, 128, (2, 15, 13, cin)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), w_q, (stride, stride), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    qconv = quant.QConv(Conv(torch.from_numpy(w.transpose(3, 2, 0, 1)), None, stride, pad))
    np.testing.assert_array_equal(
        qconv.w_q.numpy(), np.asarray(w_q).transpose(3, 0, 1, 2).reshape(cout, -1))
    got = qconv.accumulate(torch.from_numpy(xq).permute(0, 3, 1, 2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_int_mm_card_padding_is_exact():
    """The card route's zero padding to _int_mm's shape rules (> 16 rows,
    K and N multiples of 8) leaves the product exact: run here through
    the CPU `torch._int_mm` against the int64 plain version."""
    rng = np.random.default_rng(6)
    for m, k, n in ((5, 27, 20), (40, 192, 64), (17, 8, 8)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
        want = quant.int_mm_reference(a, w)
        assert torch.equal(quant._int_mm_padded(a, w), want)
        assert torch.equal(want.long(), a.long() @ w.long().t())


def test_quantized_features_match_jax(folded):
    """The port's quantized forward vs JAX's QuantizedRecognizer with the
    same qstate (JAX's float32 calibration), same inputs, float32. In
    bf16 the two forwards part further (measured 1 - cos up to 8.6e-3 on
    mbf with the same qstate): a bf16 activation one ulp apart between
    backends (0.4%) moves its int8 value, and every later op sees it."""
    arch, tree, model = folded
    jdt, tdt = jnp.float32, torch.float32
    calib, x = _crops(8, SIZE[arch], 7), _crops(3, SIZE[arch], 8)
    qs = _jax_qstate(arch, tree, calib, jdt, 0)
    mod = JAX_MOD[arch]
    qrec = j_quant.QuantizedRecognizer(mod.apply, tree, qs)
    want = np.asarray(jax.jit(lambda v: qrec.apply(v, jdt))(jnp.asarray(x)))
    qmodel = quant.quantize_recognizer(model, torch.from_numpy(calib), tdt)
    _load_qstate(qmodel, qs, x[:1])
    with torch.no_grad():
        got = qmodel(torch.from_numpy(x), tdt).numpy()
    cos = _cos(got, want)
    # measured 1 - cos: 3.8e-4 (iresnet18: a few int8 values rounded the
    # other way in the forward), 6e-8 (mbf)
    assert cos.min() > 1 - 1e-3, (arch, 1 - cos)


def test_own_calibration_close_to_jax(folded):
    """Each side calibrates itself (bf16, the JAX default): the two
    quantized models agree to quantization-noise level."""
    arch, tree, model = folded
    calib, x = _crops(8, SIZE[arch], 7), _crops(3, SIZE[arch], 8)
    qs = _jax_qstate(arch, tree, calib, jnp.bfloat16, 0)
    mod = JAX_MOD[arch]
    want = np.asarray(jax.jit(lambda p, q, v: j_quant.apply_quantized(
        mod.apply, p, q, v))(tree, qs, jnp.asarray(x)))
    qmodel = quant.quantize_recognizer(model, torch.from_numpy(calib))
    with torch.no_grad():
        got = qmodel(torch.from_numpy(x), torch.bfloat16).numpy()
    cos = _cos(got, want)
    # measured 1 - cos: 1.8e-3 (iresnet18), 7.6e-3 (mbf)
    assert cos.min() > 0.97, (arch, 1 - cos)


def test_quantized_close_to_bf16(folded):
    """PTQ-grade fidelity: the quantized port model within cosine 0.97 of
    its own bf16 features (tests/test_quant.py's bar)."""
    arch, _, model = folded
    calib, x = _crops(8, SIZE[arch], 9), _crops(4, SIZE[arch], 10)
    qmodel = quant.quantize_recognizer(model, torch.from_numpy(calib))
    with torch.no_grad():
        ref = model(torch.from_numpy(x), torch.bfloat16).numpy()
        got = qmodel(torch.from_numpy(x), torch.bfloat16).numpy()
    assert _cos(got, ref).min() > 0.97  # measured 0.99796 (iresnet18), 0.98371 (mbf)


def test_quantized_model_keeps_no_float_weight_of_a_quantized_op(folded):
    arch, _, model = folded
    qmodel = quant.quantize_recognizer(model, torch.from_numpy(_crops(4, SIZE[arch], 11)),
                                       min_channels=128)
    assert quant.is_quantized(qmodel) and not quant.is_quantized(model)
    for m in qmodel.modules():
        if isinstance(m, (quant.QConv, quant.QLinear)):
            assert m.w_q.dtype == torch.int8 and not hasattr(m, "weight")
        if isinstance(m, Conv):  # left in the compute dtype: grouped or narrow
            assert m.groups > 1 or m.weight.shape[0] < 128
    n_float = sum(p.numel() for p in qmodel.parameters())
    assert n_float < sum(p.numel() for p in model.parameters())
