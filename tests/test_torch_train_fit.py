"""The port's fit loop, LR schedule, train-state checkpoints and the CLI's
`train` against the JAX package's.

  - `warmup_cosine` against the JAX package's (optax's
    warmup_cosine_decay_schedule) at every step of three schedules: within
    1e-6 of the peak LR (the same float32 formula; numpy's float32
    cosine and XLA's differ by a few ulp, which 1 + cos near −1 turns
    into more than 1e-6 of a small LR at the end of the decay);
  - `fit` with logs, evals and checkpoints at the JAX boundaries: the
    same history rows (steps, keys, eval extras) as the JAX `fit` on the
    same batches, the first window's loss within rel 1e-5;
  - resume: a run stopped at its step-3 checkpoint and resumed to step 6
    is bit-equal to an uninterrupted 6-step run (the port's CPU step is
    deterministic); save → load round trips are bit-equal and leave no
    temporary file;
  - `train_state_from_numpy` carries the JAX state's leaves exactly;
  - CLI `train`: the `.npz` it writes loads in the JAX package, whose
    features of it agree with the port's (cosine ≥ 1 − 1e-5), and
    `--train-ckpt` resumes.
"""

import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import png_bytes
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facerecognizeonnx_tpu.pipeline.api import FaceRecognizer as JaxRecognizer
from facerecognizeonnx_tpu.train.fit import fit as jax_fit
from facerecognizeonnx_tpu.train.fit import warmup_cosine as jax_warmup_cosine
from facerecognizeonnx_tpu.train.trainer import init_train_state as jax_init
from facerecognizeonnx_tpu.train.trainer import make_train_step as jax_step
from facerecognizeonnx_tpu.utils.checkpoint import load_params as jax_load_params
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.cli import main as cli
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.pipeline.api import FaceRecognizer
from facerecognizeonnx_tpu_torch.train.fit import fit, warmup_cosine
from facerecognizeonnx_tpu_torch.train.trainer import init_train_state, make_train_step
from facerecognizeonnx_tpu_torch.utils.checkpoint import (
    _flatten,
    load_train_state,
    save_train_state,
)

C, B, SIZE = 8, 4, 32
CFG = PipelineConfig(compute_dtype="float32", rec_input_size=SIZE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("peak,total,warmup", [(0.1, 50, None), (0.02, 7, 3), (0.5, 3000, None)])
def test_warmup_cosine_matches_optax(peak, total, warmup):
    got, want = warmup_cosine(peak, total, warmup), jax_warmup_cosine(peak, total, warmup)
    counts = np.arange(total + 5)
    ref = np.asarray(jax.jit(jax.vmap(want))(counts))
    out = np.array([got(int(c)) for c in counts], np.float32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * peak)


def _batches(seed=0, n=6):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
               rng.integers(0, C, B).astype(np.int32))


def _state_leaves(state):
    return (list(state.model.state_dict().values()) + [state.classifier, state.step]
            + list(state.opt_state["trace"].values()) + [state.opt_state["count"]])


def test_fit_history_matches_jax(tmp_path):
    jcfg = JaxConfig(compute_dtype="float32", rec_input_size=SIZE)
    mesh = jax_make_mesh(("data", "model"), (1, 1), devices=jax.devices()[:1])
    jstate = jax_init(jax.random.PRNGKey(0), num_classes=C, cfg=jcfg, arch="iresnet18",
                      mesh=mesh, lr=0.05)
    host = jax.device_get(jstate)
    kw = dict(eval_fn=lambda s: {"probe": 1.0}, eval_every=3, ckpt_every=3, log_every=2,
              log=lambda *_: None)
    with mesh:
        _, want = jax_fit(jstate, jax_step(mesh, jcfg, lr=0.05), _batches(), 6,
                          ckpt_path=str(tmp_path / "jax.ckpt"), **kw)
    state = bridge.train_state_from_numpy(host.params, host.classifier, host.opt_state,
                                          host.step, device="cpu")
    state, got = fit(state, make_train_step(None, CFG, lr=0.05), _batches(), 6,
                     ckpt_path=str(tmp_path / "port.ckpt"), **kw)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 3, 4, 6]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert got[0]["loss"] == pytest.approx(want[0]["loss"], rel=1e-5)
    assert int(state.step) == 6 and os.path.isfile(tmp_path / "port.ckpt")


def test_resume_equals_uninterrupted(tmp_path):
    step = make_train_step(None, CFG, lr=0.05)
    quiet = dict(log_every=0, log=lambda *_: None)
    straight, _ = fit(init_train_state(1, C, CFG, "iresnet18", device="cpu"), step,
                      _batches(), 6, **quiet)
    ckpt = str(tmp_path / "run.ckpt")

    def stopping(n):  # the data runs out after n batches: the run stops there
        return _batches(n=n)

    fit(init_train_state(1, C, CFG, "iresnet18", device="cpu"), step, stopping(3), 6,
        ckpt_path=ckpt, ckpt_every=3, **quiet)
    resumed, hist = fit(init_train_state(1, C, CFG, "iresnet18", device="cpu"), step,
                        _batches(), 6, ckpt_path=ckpt, **quiet)
    assert int(resumed.step) == 6 and len(hist) == 1
    for a, b in zip(_state_leaves(resumed), _state_leaves(straight), strict=True):
        assert torch.equal(a, b)


def test_checkpoint_round_trip(tmp_path):
    state = init_train_state(2, C, CFG, "mbf", device="cpu")
    state, _ = make_train_step(None, CFG, lr=0.05)(state, *next(_batches()))
    path = str(tmp_path / "sub" / "s.ckpt")
    save_train_state(path, state)
    assert os.listdir(tmp_path / "sub") == ["s.ckpt"]
    back = load_train_state(path, init_train_state(3, C, CFG, "mbf", device="cpu"))
    for a, b in zip(_state_leaves(back), _state_leaves(state), strict=True):
        assert torch.equal(a, b)


def test_train_state_from_numpy_exact():
    jcfg = JaxConfig(compute_dtype="float32", rec_input_size=SIZE)
    host = jax.device_get(jax_init(jax.random.PRNGKey(4), num_classes=C, cfg=jcfg,
                                   arch="iresnet18", lr=warmup_cosine(0.1, 10)))
    state = bridge.train_state_from_numpy(host.params, host.classifier, host.opt_state,
                                          host.step, device="cpu")
    fw, fg = _flatten(host.params), _flatten(bridge.tree_from_module(state.model))
    for k in fw:
        np.testing.assert_array_equal(fg[k], np.asarray(fw[k]), err_msg=k)
    np.testing.assert_array_equal(state.classifier.detach().numpy(), host.classifier)
    assert int(state.opt_state["count"]) == int(host.opt_state[1].count) == 0
    assert all(float(t.abs().max()) == 0 for t in state.opt_state["trace"].values())


def test_cli_train_npz_loads_in_jax(tmp_path, capsys):
    rng = np.random.default_rng(18)
    for who in ("ann", "ben"):
        (tmp_path / "ids" / who).mkdir(parents=True)
        for i in range(2):
            img = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
            (tmp_path / "ids" / who / f"{i}.png").write_bytes(png_bytes(img))
    out, ckpt = str(tmp_path / "rec.npz"), str(tmp_path / "rec.ckpt")
    argv = ["train", str(tmp_path / "ids"), "--batch", "2", "--rec-arch", "iresnet18",
            "--out", out, "--train-ckpt", ckpt, "--cpu"]
    assert cli.main(argv + ["--steps", "2"]) == 0
    assert "训练完成: 2 步" in capsys.readouterr().out
    assert cli.main(argv + ["--steps", "3"]) == 0
    text = capsys.readouterr().out
    assert f"resumed from {ckpt} at step 2" in text and "训练完成: 3 步" in text
    tree = jax_load_params(out)
    assert "layer1" in tree and "bn1" in tree
    port = FaceRecognizer(PipelineConfig(compute_dtype="float32", rec_arch="iresnet18"),
                          device="cpu")
    ref = JaxRecognizer(JaxConfig(compute_dtype="float32", rec_arch="iresnet18"))
    assert port.load_model(out) and ref.load_model(out)
    img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
    a, b = port.extract_feature_simple(img), ref.extract_feature_simple(img)
    assert float(np.dot(a, b)) >= 1 - 1e-5
