"""The port's model families vs the JAX models, same weights: every SCRFD
variant (500m, 2.5g, 10g, tpu, 500m_s2d) and the MobileFaceNet and ViT
recognizers.

Weights are JAX-initialised trees brought over by
`bridge.params_from_numpy`; BN running stats are calibrated on noise
with a variance floor (the recipe of tests/test_torch_models.py), so f32
agreement is meaningful. The JAX side is jitted (init, calibration,
apply). Small inputs: SCRFD at 128², MobileFaceNet at 64² (built for
64², so its GDC is 4x4), ViT at 32² (16 tokens).

The JAX package cannot initialise mbf_large: its `init_params` asserts
blocks[0] == 1 while its MBF_SPECS gives (2, 8, 12, 4). Its `apply` runs
the mbf_large topology all the same (the body plan ignores blocks[0]),
so the mbf_large tree comes from `bridge.init_params_numpy` (JAX
layouts) and is calibrated and applied by JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.models import mobilefacenet, scrfd, vit
from facerecognizeonnx_tpu.models.layers import update_bn_stats
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.models import recognizer_apply, recognizer_module_for
from facerecognizeonnx_tpu_torch.models import mobilefacenet as t_mbf
from facerecognizeonnx_tpu_torch.models import scrfd as t_scrfd
from facerecognizeonnx_tpu_torch.models import vit as t_vit
from tests.test_arcface import _floor_bn_var
from tests.test_torch_models import _cos, _np_tree

VARIANTS = ["500m", "2.5g", "10g", "tpu", "500m_s2d"]
REC_ARCHS = ["mbf", "mbf_large", "vit_t", "vit_s", "vit_b"]
REC_SIZE = {"mbf": 64, "mbf_large": 64, "vit_t": 32, "vit_s": 32, "vit_b": 32}
JAX_REC = {"mbf": mobilefacenet, "mbf_large": mobilefacenet,
           "vit_t": vit, "vit_s": vit, "vit_b": vit}
DET_SIZE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calibrated(init, apply, x):
    params = jax.jit(init)(jax.random.PRNGKey(0))
    _, stats = jax.jit(lambda p, v: apply(p, v, train=True))(params, jnp.asarray(x))
    return _floor_bn_var(update_bn_stats(params, stats))


@pytest.fixture(scope="module", params=VARIANTS)
def det(request):
    """(variant, calibrated JAX tree, input)."""
    v = request.param
    rng = np.random.default_rng(7)
    calib = rng.uniform(-1, 1, (2, DET_SIZE, DET_SIZE, 3)).astype(np.float32)
    tree = _calibrated(lambda k: scrfd.init_params(k, variant=v), scrfd.apply, calib)
    x = rng.uniform(-1, 1, (2, DET_SIZE, DET_SIZE, 3)).astype(np.float32)
    return v, tree, x


@pytest.fixture(scope="module", params=REC_ARCHS)
def rec(request):
    """(arch, JAX tree with non-trivial BN statistics, input)."""
    arch = request.param
    size, mod = REC_SIZE[arch], JAX_REC[arch]
    rng = np.random.default_rng(3)
    calib = rng.uniform(-1, 1, (8, size, size, 3)).astype(np.float32)
    if arch == "mbf_large":
        def init(_):
            return jax.tree_util.tree_map(
                jnp.asarray, bridge.init_params_numpy(arch, seed=0, input_size=size))
    else:
        def init(k):
            return mod.init_params(k, arch=arch, input_size=size)
    tree = _calibrated(init, mod.apply, calib)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    return arch, tree, x


def _heads(outs):
    return [np.asarray(t) for s in (8, 16, 32) for t in outs[s]]


def test_scrfd_variant_heads_match_jax(det):
    """The 9 head tensors at 128², f32: unfolded, the JAX-folded tree and
    the port's fold, at test_torch_models.py's 500m bar."""
    v, tree, x = det
    folded = scrfd.fold_inference_params(tree)
    apply = jax.jit(scrfd.apply)
    with jax.default_matmul_precision("highest"):
        want = {"unfolded": _heads(apply(tree, jnp.asarray(x)))}
        want["folded"] = _heads(apply(folded, jnp.asarray(x)))
    unfolded = bridge.params_from_numpy(_np_tree(tree), device="cpu")
    port_folded = t_scrfd.fold_inference_params(unfolded)
    assert all(u.bn is None for u in port_folded.head_convs) and port_folded.stem.bn is None
    forms = {
        "unfolded": unfolded,
        "jax_folded_tree": bridge.params_from_numpy(_np_tree(folded), device="cpu"),
        "port_folded": port_folded,
    }
    for form, model in forms.items():
        assert model.variant == v
        with torch.no_grad():
            got = [t.numpy() for s in (8, 16, 32) for t in model(torch.from_numpy(x))[s]]
        ref = want["unfolded" if form == "unfolded" else "folded"]
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape, (form, i)
            err = np.abs(g - r).max()
            assert err <= 1e-4 * np.abs(r).max(), (v, form, i, err, np.abs(r).max())


def test_scrfd_variant_bf16_heads_match_jax(det):
    v, tree, x = det
    folded = scrfd.fold_inference_params(tree)
    want = _heads(jax.jit(lambda p, u: scrfd.apply(p, u, jnp.bfloat16))(folded, jnp.asarray(x)))
    model = bridge.params_from_numpy(_np_tree(folded), device="cpu")
    with torch.no_grad():
        outs = model(torch.from_numpy(x), torch.bfloat16)
    got = [t.numpy() for s in (8, 16, 32) for t in outs[s]]
    for i, (g, r) in enumerate(zip(got, want)):
        assert _cos(g.ravel(), r.ravel()) > 1 - 1e-3, (v, i)


def test_scrfd_infer_variant_and_param_count(det):
    v, tree, _ = det
    np_tree = _np_tree(tree)
    assert t_scrfd.infer_variant(np_tree) == scrfd.infer_variant(tree) == v
    model = bridge.params_from_numpy(np_tree, device="cpu")
    assert t_scrfd.num_params(model) == scrfd.num_params(tree)
    folded = scrfd.fold_inference_params(tree)
    assert t_scrfd.num_params(t_scrfd.fold_inference_params(model)) == scrfd.num_params(folded)
    # the port's taps: the last stride-1 block of each of the three widest
    # levels, the same blocks as the JAX model's
    plan = t_scrfd.SCRFD_VARIANTS[v]["plan"]
    assert t_scrfd.variant_taps(plan) == scrfd._variant_taps(plan)
    assert set(t_scrfd.variant_taps(plan).values()) == {"c3", "c4", "c5"}


def test_space_to_depth_is_the_jax_order():
    """(B, H, W, C) blocks to channels in the JAX reshape/transpose order,
    on an asymmetric input; pixel_unshuffle's channel-major order differs."""
    x = np.arange(2 * 8 * 12 * 3, dtype=np.float32).reshape(2, 8, 12, 3)
    want = np.asarray(scrfd._space_to_depth(jnp.asarray(x), 4))
    got = t_scrfd.space_to_depth(torch.from_numpy(x), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 2, 3, 48)
    unshuffled = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 4
    ).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(unshuffled, want)


def test_unknown_scrfd_tree_raises():
    tree = bridge.init_params_numpy("500m")
    tree["backbone"][0]["pw"]["w"] = np.zeros((1, 1, 16, 30), np.float32)
    with pytest.raises(ValueError, match="SCRFD variant"):
        bridge.params_from_numpy(tree, device="cpu")


def _rec_apply(mod, dtype=jnp.float32):
    return jax.jit(lambda p, v: mod.apply(p, v, compute_dtype=dtype))


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_recognizer_f32_matches_jax(rec, folded):
    arch, tree, x = rec
    mod = JAX_REC[arch]
    model = bridge.params_from_numpy(_np_tree(tree), device="cpu")
    ref_tree = tree
    if folded:
        model = recognizer_module_for(model).fold_inference_params(model)
        ref_tree = mod.fold_inference_params(tree)
        assert model.features_bn is None
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_rec_apply(mod)(ref_tree, jnp.asarray(x)))
    with torch.no_grad():
        got = recognizer_apply(model, torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == (2, 512) and got.dtype == np.float32
    assert _cos(got, want).min() > 1 - 1e-6, (arch, _cos(got, want))


def test_recognizer_bf16_matches_jax(rec):
    arch, tree, x = rec
    mod = JAX_REC[arch]
    folded = mod.fold_inference_params(tree)
    want = np.asarray(_rec_apply(mod, jnp.bfloat16)(folded, jnp.asarray(x)))
    model = bridge.params_from_numpy(_np_tree(folded), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.bfloat16).numpy()
    assert _cos(got, want).min() > 1 - 1e-3, (arch, _cos(got, want))


def test_recognizer_structure(rec):
    """Family, arch and the layers the JAX model infers from its tree."""
    arch, tree, _ = rec
    model = bridge.params_from_numpy(_np_tree(tree), device="cpu")
    if arch.startswith("mbf"):
        assert isinstance(model, t_mbf.MobileFaceNet) and recognizer_module_for(model) is t_mbf
        assert t_mbf.arch_of_depth(len(model.body)) == mobilefacenet._arch_of(tree) == arch
        plan = t_mbf.body_plan(*t_mbf.MBF_SPECS[arch])
        assert [b.residual for b in model.body] == [s == 1 for *_, s in plan]
        assert [b.dw.conv.groups for b in model.body] == [g for _, _, g, _ in plan]
        assert model.stem_dw.conv.groups == 64 and model.gdc.conv.groups == 512
    else:
        assert isinstance(model, t_vit.ViT) and recognizer_module_for(model) is t_vit
        dim, depth, heads = t_vit.VIT_SPECS[arch]
        assert vit.VIT_SPECS_BY_DIM[dim] == (dim, depth, heads)
        assert len(model.blocks) == depth and model.blocks[0].heads == heads


def test_vit_patchify_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 24, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_vit.patchify(torch.from_numpy(x)).numpy(),
        np.asarray(vit._patchify(jnp.asarray(x), 24)),
    )


INIT_CASES = VARIANTS + ["iresnet18"] + REC_ARCHS


@pytest.mark.parametrize("arch", INIT_CASES)
def test_init_params_numpy_matches_jax_shapes(arch):
    """`init_params_numpy` draws the JAX initializer's tree (shapes from
    jax.eval_shape: no compute), and the tree builds a module that runs."""
    from facerecognizeonnx_tpu.models import recognizer_module

    size = REC_SIZE.get(arch, 112)
    got = bridge.init_params_numpy(arch, seed=0, input_size=size)
    key = jax.random.PRNGKey(0)
    if arch in VARIANTS:
        ref = jax.eval_shape(lambda k: scrfd.init_params(k, variant=arch), key)
    elif arch == "mbf_large":
        # the reference's init refuses mbf_large; its apply takes the tree
        with pytest.raises(AssertionError, match="blocks"):
            mobilefacenet.init_params(key, arch=arch, input_size=size)
        out = jax.eval_shape(mobilefacenet.apply, got, jnp.zeros((1, size, size, 3)))
        assert out.shape == (1, 512)
        ref = got
    else:
        mod = recognizer_module(arch)
        ref = jax.eval_shape(lambda k: mod.init_params(k, arch=arch, input_size=size), key)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == ref_def
    assert [np.shape(a) for a in got_leaves] == [a.shape for a in ref_leaves]
    assert all(np.asarray(a).dtype == np.float32 for a in got_leaves)
    s = 64 if arch in VARIANTS else size
    with torch.no_grad():
        out = bridge.params_from_numpy(got, device="cpu")(torch.zeros((1, s, s, 3)))
    assert out is not None


def test_conv2d_rounds_once_after_the_bias():
    """A bf16 conv with a bias rounds once, after the f32 bias add, as the
    JAX layer does (a bf16 conv output rounded before the bias differs on
    the folded SCRFD-10g by ~1.6e-3 in head cosine, and in 1-ulp flips)."""
    from facerecognizeonnx_tpu.models import layers as j_layers
    from facerecognizeonnx_tpu_torch.models import layers

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 9, 24)).astype(np.float32)
    w = rng.normal(size=(3, 3, 24, 32)).astype(np.float32) * 0.2
    b = rng.normal(size=(32,)).astype(np.float32) * 3.0
    want = np.asarray(j_layers.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                      jnp.asarray(x), 1, 1, compute_dtype=jnp.bfloat16))
    got = layers.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b),
                        1, 1, compute_dtype=torch.bfloat16)
    got = got.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
