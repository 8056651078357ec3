"""The port's train mode and ArcFace train step against the JAX package.

Same seeded numpy inputs through both packages on the CPU (float32;
iresnet18 at rec_input_size 32, C=16, B=8). Tolerances:

  - one train-mode BatchNorm on the same input: mean and variance within
    1e-6 relative to the input's scale, output within 1e-6;
  - a whole model's BN batch statistics (IResNet, MobileFaceNet, ViT,
    SCRFD): the same JAX keys; values within 2e-4 of each statistic's
    scale (the mean against the channel's standard deviation, the
    variance relative) — the float32 drift of the convolutions
    upstream, whose outputs already differ by up to 7e-5; `update_bn_stats`
    on the same statistics: bit-equal;
  - the SGD update (`SGD` against `optax.sgd`, constant and scheduled
    LR) on the same tensors: bit-equal;
  - three train steps on a 1×1 mesh, each from the JAX state of that
    step: the loss within rel 1e-5; the classifier, its momentum and the
    BN running statistics within 1e-4·max(|leaf|, 0.01) elementwise;
    the backbone's update (new − old params) and momentum within 1e-2
    relative L2 over the whole backbone. Typical is 5e-6; a PReLU input
    within float32 noise of 0 can fall on the other side of the kink in
    the other package's forward (the convolutions sum in other orders),
    which changes that element's gradient by 3/4 and spreads backwards:
    the worst of 30 steps measured on ten seeds was 3e-3
    (`python tests/diag_train_parity.py` prints these measurements);
  - remat=True against plain, and a one-rank mesh against mesh=None, in
    the port: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.models import recognizer_apply as jax_recognizer_apply
from facerecognizeonnx_tpu.models import scrfd as jax_scrfd
from facerecognizeonnx_tpu.models.layers import batch_norm as jax_batch_norm
from facerecognizeonnx_tpu.models.layers import update_bn_stats as jax_update_bn_stats
from facerecognizeonnx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facerecognizeonnx_tpu.train.fit import warmup_cosine as jax_warmup_cosine
from facerecognizeonnx_tpu.train.trainer import init_train_state, make_train_step
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.models import arcface, recognizer_apply
from facerecognizeonnx_tpu_torch.models.layers import (
    batch_norm_train,
    make_trainable,
    update_bn_stats,
)
from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh
from facerecognizeonnx_tpu_torch.train.fit import warmup_cosine
from facerecognizeonnx_tpu_torch.train.trainer import SGD, train_state_shardings
from facerecognizeonnx_tpu_torch.train.trainer import init_train_state as init_port_state
from facerecognizeonnx_tpu_torch.train.trainer import make_train_step as port_train_step
from facerecognizeonnx_tpu_torch.utils.checkpoint import _flatten

C, B, SIZE, LR = 16, 8, 32, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(s):
    return {k: (np.array(m), np.array(v)) for k, (m, v) in s.items()}


def hold_stats(got, want, bar=2e-4):
    assert set(got) == set(want)
    for k, (wm, wv) in want.items():
        gm, gv = got[k]
        sd = np.sqrt(wv)
        assert np.max(np.abs(gm - wm) / sd) <= bar, k
        assert np.max(np.abs(gv - wv) / wv) <= bar, k


def hold_leaves(got, want, rel=1e-4):
    """Elementwise within rel·max(|leaf|, 0.01), leaf by leaf."""
    fg, fw = _flatten(got), _flatten(want)
    assert fg.keys() == fw.keys()
    for k, w in fw.items():
        w = np.asarray(w)
        np.testing.assert_allclose(fg[k], w, rtol=0, atol=rel * max(float(np.abs(w).max()), 0.01),
                                   err_msg=k)


def _l2(got, want, keys):
    g = np.concatenate([np.asarray(got[k]).ravel() for k in keys])
    w = np.concatenate([np.asarray(want[k]).ravel() for k in keys])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def hold_step(got, want, before, bar=1e-2):
    """A port state after one step (numpy trees: params, classifier, trace,
    trace_cls) against the JAX state after the same step from `before`
    (module docstring)."""
    fg, fw, f0 = _flatten(got["params"]), _flatten(want.params), _flatten(before.params)
    stats = [k for k in fw if k.endswith(("/mean", "/var"))]
    hold_leaves({k: fg[k] for k in stats}, {k: fw[k] for k in stats})
    weights = [k for k in fw if k not in stats]
    upd_g = {k: fg[k] - np.asarray(f0[k]) for k in weights}
    upd_w = {k: np.asarray(fw[k]) - np.asarray(f0[k]) for k in weights}
    assert _l2(upd_g, upd_w, weights) <= bar
    tg, tw = _flatten(got["trace"]), _flatten(want.opt_state[0].trace[0])
    assert _l2(tg, tw, weights) <= bar
    hold_leaves({"c": got["classifier"], "t": got["trace_cls"]},
                {"c": want.classifier, "t": want.opt_state[0].trace[1]})


def port_arrays(state):
    return {
        "params": bridge.tree_from_module(state.model),
        "classifier": state.classifier.detach().numpy(),
        "trace": bridge.tree_from_tensors(state.model, state.opt_state["trace"]),
        "trace_cls": state.opt_state["trace"]["classifier"].numpy(),
    }


# ---------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("shape", [(4, 6, 5, 7), (8, 12)])
def test_batch_norm_train_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    c = shape[1]
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32),
         "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    nhwc = np.moveaxis(x, 1, -1)  # JAX is channel-last
    jy, (jm, jv) = jax.jit(lambda p, x: jax_batch_norm(p, x, train=True))(p, nhwc)
    y, (m, v) = batch_norm_train(torch.from_numpy(x), torch.from_numpy(p["scale"]),
                                 torch.from_numpy(p["bias"]))
    scale = np.sqrt(np.asarray(jv))
    assert np.max(np.abs(m.numpy() - jm) / scale) <= 1e-6
    assert np.max(np.abs(v.numpy() - jv) / np.asarray(jv)) <= 1e-6
    np.testing.assert_allclose(y.numpy(), np.moveaxis(np.asarray(jy), -1, 1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch,size", [("iresnet18", 32), ("mbf", 32), ("vit_t", 32),
                                       ("500m", 64)])
def test_model_train_stats_and_update_match_jax(arch, size):
    rng = np.random.default_rng(2)
    tree = bridge.init_params_numpy(arch, seed=3, input_size=size)
    x = rng.uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
    model = make_trainable(bridge.params_from_numpy(tree, device="cpu"))
    if arch == "500m":
        _, want = jax.jit(lambda p, x: jax_scrfd.apply(p, x, train=True))(tree, x)
        _, got = model(torch.from_numpy(x), train=True)
    else:
        _, want = jax.jit(lambda p, x: jax_recognizer_apply(p, x, jnp.float32, train=True))(
            tree, x)
        _, got = recognizer_apply(model, torch.from_numpy(x), torch.float32, train=True)
    want = _stats(want)
    hold_stats({k: (m.numpy(), v.numpy()) for k, (m, v) in got.items()}, want)
    # the running-average update: the same statistics in, bit-equal out
    update_bn_stats(model, {k: (torch.from_numpy(m), torch.from_numpy(v))
                            for k, (m, v) in want.items()}, momentum=0.9)
    ref = _flatten(jax.device_get(jax_update_bn_stats(tree, want, momentum=0.9)))
    out = _flatten(bridge.tree_from_module(model))
    for k in ref:
        if k.endswith(("/mean", "/var")):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_train_mode_needs_unfolded_model():
    tree = bridge.init_params_numpy("iresnet18", seed=0, input_size=32)
    folded = arcface.fold_inference_params(bridge.params_from_numpy(tree, device="cpu"))
    with pytest.raises(ValueError, match="folded"):
        recognizer_apply(folded, torch.zeros(1, 32, 32, 3), torch.float32, train=True)
    with pytest.raises(ValueError, match="folded"):
        make_trainable(folded)


def test_train_state_shardings():
    """The classifier and its momentum split by columns, the rest replicated
    (the JAX package's NamedShardings as DTensor placements)."""
    from torch.distributed.tensor import Replicate, Shard

    state = init_port_state(0, C, PipelineConfig(rec_input_size=SIZE), "iresnet18", device="cpu")
    sh = train_state_shardings(None, state)
    assert sh.classifier == Shard(1) and sh.opt_state["trace"]["classifier"] == Shard(1)
    assert sh.step == Replicate() and sh.opt_state["count"] == Replicate()
    assert set(sh.model) == set(state.model.state_dict())
    assert all(p == Replicate() for p in sh.model.values())
    assert all(p == Replicate() for k, p in sh.opt_state["trace"].items() if k != "classifier")


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("lr", [0.05, "schedule"])
def test_sgd_matches_optax(lr):
    rng = np.random.default_rng(4)
    sched = warmup_cosine(0.1, total_steps=6) if lr == "schedule" else None
    jax_lr = jax_warmup_cosine(0.1, total_steps=6) if sched else lr
    params = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=7).astype(np.float32)}
    opt = optax.sgd(jax_lr, momentum=0.9)
    jstate, jp = opt.init(params), params
    port = SGD(sched or lr, 0.9)
    tensors = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = port.init(tensors)
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, jstate = opt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        pstate = port.update(tensors, {k: torch.from_numpy(g) for k, g in grads.items()}, pstate)
        for k in params:
            np.testing.assert_array_equal(tensors[k].numpy(), np.asarray(jp[k]))
            np.testing.assert_array_equal(pstate["trace"][k].numpy(),
                                          np.asarray(jstate[0].trace[k]))
    assert int(pstate["count"]) == 4


# ---------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps on a 1×1 mesh: the states before and after each."""
    rng = np.random.default_rng(0)
    cfg = JaxConfig(compute_dtype="float32", rec_input_size=SIZE)
    mesh = jax_make_mesh(("data", "model"), (1, 1), devices=jax.devices()[:1])
    state = init_train_state(jax.random.PRNGKey(0), num_classes=C, cfg=cfg, arch="iresnet18",
                             mesh=mesh, lr=LR)
    step = make_train_step(mesh, cfg, lr=LR)
    images = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    states, losses = [jax.device_get(state)], []
    with mesh:
        for _ in range(3):
            state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
            states.append(jax.device_get(state))
            losses.append(float(loss))
    return images, labels, states, losses


def port_state(h, mesh=None):
    return bridge.train_state_from_numpy(h.params, h.classifier, h.opt_state, h.step,
                                         device="cpu", mesh=mesh)


CFG = PipelineConfig(compute_dtype="float32", rec_input_size=SIZE)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_train_step_matches_jax(jax_run, k):
    images, labels, states, losses = jax_run
    step = port_train_step(None, CFG, lr=LR)
    state, loss = step(port_state(states[k]), images, labels)
    assert abs(float(loss) - losses[k]) <= 1e-5 * abs(losses[k])
    assert int(state.step) == k + 1 and int(state.opt_state["count"]) == k + 1
    hold_step(port_arrays(state), states[k + 1], states[k])


def test_remat_and_one_rank_mesh_equal_plain(jax_run):
    images, labels, states, _ = jax_run
    runs = {}
    for tag, mesh, remat in (("plain", None, False), ("remat", None, True),
                             ("mesh", make_mesh(("data", "model"), (1, 1), device="cpu"),
                              False)):
        step = port_train_step(mesh, CFG, lr=LR, remat=remat)
        state = port_state(states[0], mesh)
        losses = []
        for _ in range(2):
            state, loss = step(state, images, labels)
            losses.append(float(loss))
        runs[tag] = (losses, port_arrays(state))
    for tag in ("remat", "mesh"):
        assert runs[tag][0] == runs["plain"][0], tag
        fa, fb = _flatten(runs[tag][1]), _flatten(runs["plain"][1])
        for key in fb:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=f"{tag} {key}")
