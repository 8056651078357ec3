"""The port's SCRFD and IResNet modules vs the JAX models, same weights.

Weights are JAX-initialised trees brought over by
`bridge.params_from_numpy`; inputs come from numpy seeds. BN running
stats are calibrated with a variance floor (the recipe of
tests/test_arcface.py) so activations are conditioned like a trained
net's and f32 agreement is meaningful.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.models import arcface, scrfd
from facerecognizeonnx_tpu.models.layers import update_bn_stats
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.errors import ModelLoadError
from facerecognizeonnx_tpu_torch.models import recognizer_apply
from facerecognizeonnx_tpu_torch.models import arcface as t_arcface
from facerecognizeonnx_tpu_torch.models import scrfd as t_scrfd
from tests.test_arcface import _floor_bn_var


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scrfd_calibrated(seed=0, size=128):
    """JAX-initialised SCRFD-500m, BN calibrated on a batch of noise
    (init and calibration jitted: eager dispatch costs seconds here)."""
    params = jax.jit(scrfd.init_params)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32))
    _, stats = jax.jit(lambda p, v: scrfd.apply(p, v, train=True))(params, x)
    return _floor_bn_var(update_bn_stats(params, stats))


def iresnet_calibrated(arch="iresnet18", seed=0, batch=8):
    """JAX-initialised IResNet, BN calibrated as in tests/test_arcface.py."""
    params = jax.jit(lambda k: arcface.init_params(k, arch))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(1234)
    x = jnp.asarray(rng.uniform(-1, 1, (batch, 112, 112, 3)).astype(np.float32))
    _, stats = jax.jit(lambda p, v: arcface.apply(p, v, train=True))(params, x)
    return _floor_bn_var(arcface.update_bn_stats(params, stats))


@pytest.fixture(scope="module")
def det_params():
    return scrfd_calibrated()


@pytest.fixture(scope="module")
def r18_params():
    return iresnet_calibrated()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@jax.jit
def _scrfd_jax(params, x):
    return scrfd.apply(params, x)


@jax.jit
def _arcface_jax(params, x):
    return arcface.apply(params, x)


@pytest.mark.parametrize("form", ["unfolded", "jax_folded_tree", "port_folded"])
def test_scrfd_heads_match_jax(det_params, form):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    folded = scrfd.fold_inference_params(det_params)
    if form == "unfolded":
        model, ref = bridge.params_from_numpy(_np_tree(det_params), device="cpu"), det_params
    elif form == "jax_folded_tree":
        model, ref = bridge.params_from_numpy(_np_tree(folded), device="cpu"), folded
    else:
        model = t_scrfd.fold_inference_params(
            bridge.params_from_numpy(_np_tree(det_params), device="cpu")
        )
        ref = folded
        assert all(u.bn is None for u in model.head_convs)
    with jax.default_matmul_precision("highest"):
        want = _scrfd_jax(ref, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == {8, 16, 32}
    for stride in (8, 16, 32):
        for g, r in zip(got[stride], want[stride]):
            r = np.asarray(r)
            assert g.shape == r.shape
            err = np.abs(g.numpy() - r).max()
            # measured ≤ 4.7e-6 relative on this CPU (unfolded and both folds)
            assert err <= 1e-4 * np.abs(r).max(), (stride, err, np.abs(r).max())


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("folded", [False, True])
def test_iresnet18_f32_matches_jax(r18_params, folded):
    x = np.random.default_rng(5).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    model = bridge.params_from_numpy(_np_tree(r18_params), device="cpu")
    ref_params = r18_params
    if folded:
        model = t_arcface.fold_inference_params(model)
        ref_params = arcface.fold_inference_params(r18_params)
        assert model.features_bn is None
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_arcface_jax(ref_params, jnp.asarray(x)))
    with torch.no_grad():
        got = recognizer_apply(model, torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == (2, 512)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-4
    assert _cos(got, want).min() > 1 - 1e-6


def test_iresnet18_bf16_matches_jax(r18_params):
    x = np.random.default_rng(6).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    model = bridge.params_from_numpy(_np_tree(r18_params), device="cpu")
    bf16 = jax.jit(lambda p, v: arcface.apply(p, v, jnp.bfloat16))
    want = np.asarray(bf16(r18_params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32
    assert _cos(got.numpy(), want).min() > 1 - 1e-3  # BASELINE.md bf16 contract


def test_scrfd_bf16_scores_match_jax(det_params):
    x = np.random.default_rng(8).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    model = bridge.params_from_numpy(_np_tree(det_params), device="cpu")
    want = jax.jit(lambda p, v: scrfd.apply(p, v, jnp.bfloat16))(
        det_params, jnp.asarray(x)
    )
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.bfloat16)
    for stride in (8, 16, 32):
        g, r = got[stride][1].numpy().ravel(), np.asarray(want[stride][1]).ravel()
        assert _cos(g, r) > 1 - 1e-3


def test_bridge_layouts(r18_params):
    """HWIO → OIHW convs, (din, dout) → (dout, din) FC, BN/PReLU as-is."""
    tree = _np_tree(r18_params)
    model = bridge.params_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(
        model.stem.conv.weight.numpy(), tree["conv1"]["w"].transpose(3, 2, 0, 1)
    )
    blk = model.stages[1][0]
    np.testing.assert_array_equal(
        blk.down.conv.weight.numpy(),
        tree["layer2"][0]["down_conv"]["w"].transpose(3, 2, 0, 1),
    )
    assert blk.unit2.conv.stride == 2 and blk.down.conv.stride == 2
    np.testing.assert_array_equal(model.fc.weight.numpy(), tree["fc"]["w"].T)
    np.testing.assert_array_equal(model.bn2.var.numpy(), tree["bn2"]["var"])
    np.testing.assert_array_equal(
        model.stem.act.alpha.numpy(), tree["prelu1"]["alpha"]
    )
    det = bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=2), device="cpu")
    dw = det.backbone[0].dw.conv
    assert dw.weight.shape == (16, 1, 3, 3) and dw.groups == 16


def test_iresnet_head_flattens_nhwc(r18_params):
    """The FC consumes the NHWC flatten of bn2's output (the JAX row
    order); an NCHW flatten would give another answer."""
    tree = _np_tree(r18_params)
    model = bridge.params_from_numpy(tree, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(9).uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    )
    seen = {}
    model.bn2.register_forward_hook(lambda m, i, o: seen.setdefault("bn2", o))
    with torch.no_grad():
        got = model(x).numpy()
    act = seen["bn2"].numpy()  # (1, 512, 7, 7) NCHW
    bn = tree["features_bn"]

    def head(flat):
        y = flat @ tree["fc"]["w"] + tree["fc"]["b"]
        return (y - bn["mean"]) / np.sqrt(bn["var"] + 1e-5) * bn["scale"] + bn["bias"]

    nhwc = head(act.transpose(0, 2, 3, 1).reshape(1, -1))
    nchw = head(act.reshape(1, -1))
    np.testing.assert_allclose(got, nhwc, rtol=1e-4, atol=1e-4 * np.abs(nhwc).max())
    assert np.abs(nchw - nhwc).max() > 0.1 * np.abs(nhwc).max()


@pytest.mark.parametrize("arch", ["500m", "iresnet18"])
def test_init_params_numpy_matches_jax_shapes(arch, det_params, r18_params):
    ref = det_params if arch == "500m" else r18_params
    got = bridge.init_params_numpy(arch, seed=0)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == ref_def
    assert [np.shape(a) for a in got_leaves] == [np.shape(a) for a in ref_leaves]
    assert all(np.asarray(a).dtype == np.float32 for a in got_leaves)
    # the trees build modules that run
    with torch.no_grad():
        model = bridge.params_from_numpy(got, device="cpu")
        size = 64 if arch == "500m" else 112
        out = model(torch.zeros((1, size, size, 3)))
    assert out is not None


def test_unported_models_raise():
    """Every model family of the JAX package is ported: a tree or arch the
    port does not know is an error, not a missing feature (only `.onnx`
    weights still raise NotImplementedError, tests/test_torch_api.py)."""
    # a tree whose widths follow no variant's plan
    tree = bridge.init_params_numpy("500m")
    tree["backbone"][0]["pw"]["w"] = np.zeros((1, 1, 16, 30), np.float32)
    with pytest.raises(ValueError, match="SCRFD variant"):
        bridge.params_from_numpy(tree, device="cpu")
    with pytest.raises(ValueError, match="unknown arch"):
        bridge.init_params_numpy("20g")
    with pytest.raises(ModelLoadError):
        bridge.params_from_numpy({"trunk": {}}, device="cpu")
    with pytest.raises(TypeError, match="not a recognizer"):
        recognizer_apply(torch.nn.Identity(), torch.zeros(1, 112, 112, 3), torch.float32)
    for arch in ("10g", "mbf", "vit_t"):
        assert bridge.params_from_numpy(bridge.init_params_numpy(arch), device="cpu") is not None


def test_bridge_defaults_to_the_card(monkeypatch):
    """params_from_numpy builds on the card by default: with no CUDA it
    raises instead of quietly building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = bridge.init_params_numpy("500m", seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy(tree)
    assert next(bridge.params_from_numpy(tree, device="cpu").parameters()).device.type == "cpu"
