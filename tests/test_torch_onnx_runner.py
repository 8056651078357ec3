"""The port's OnnxRunner vs the JAX package's, on graphs shaped like the
real buffalo_sc exports.

det_500m-shaped (tests/oracles/scrfd_nas_onnx.py): NAS residual
depthwise backbone, Transpose→Shape→Gather→Div→Unsqueeze→Concat→Reshape
glue, batch-folded 2-D outputs (B·H·W·A, C) in scrambled order. At B=1
the port matches the JAX runner and the independent torch oracle with
the bars of tests/test_real_onnx_parity.py.

At B > 1 the JAX runner reads a 2-D output as batch 1: at B=2 and B=8 it
raises "cannot classify", and at B=4 (4·side² is a square) it decodes
every head on the wrong anchor grid (strides 4/8/16). The port unfolds
with the input's batch: its B=4 call equals four B=1 calls per frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.onnx_import.importer import OnnxRunner as JaxRunner
from facerecognizeonnx_tpu_torch import bridge, onnx_export
from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner
from tests.oracles import scrfd_nas_onnx as S

SIZE = 192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def det_onnx(tmp_path_factory):
    w = S.make_weights(seed=3)
    blob, _ = S.emit_scrfd_nas_onnx(w, SIZE)
    path = tmp_path_factory.mktemp("onnx") / "det_500m_shaped.onnx"
    path.write_bytes(blob)
    return w, str(path)


def _x(b, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "reference"])
def test_b1_matches_jax_runner_and_torch_oracle(det_onnx, fast):
    w, path = det_onnx
    x = _x(1)
    runner = OnnxRunner(path, fast=fast, device="cpu")
    assert runner.kind == "scrfd" and runner.input_size == SIZE
    got = runner(torch.from_numpy(x))
    jr = JaxRunner(path, fast=fast)
    want = jax.jit(lambda a: jr.apply(a))(jnp.asarray(x))
    oracle = S.torch_forward(w, np.transpose(x, (0, 3, 1, 2)))
    assert set(got) == set(want) == {8, 16, 32}
    for s in (8, 16, 32):
        for g, j, o in zip(got[s], want[s], oracle[s]):
            g = g.numpy()
            assert g.shape == (1,) + o.shape  # unfolded
            np.testing.assert_allclose(g, np.asarray(j), atol=2e-4, rtol=1e-3)
            np.testing.assert_allclose(g[0], o, atol=2e-4, rtol=1e-3)


def test_fast_matches_reference(det_onnx):
    _, path = det_onnx
    x = torch.from_numpy(_x(1, seed=1))
    fast = OnnxRunner(path, fast=True, device="cpu")(x)
    ref = OnnxRunner(path, fast=False, device="cpu")(x)
    for s in (8, 16, 32):
        for a, b in zip(fast[s], ref[s]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batch4_equals_four_batch1_calls(det_onnx, dtype):
    """Finding 1 repaired: the folded (4·rows, C) outputs unfold per frame.
    The JAX runner misclassifies exactly this call (strides 4/8/16).
    float32: equal within 1e-5. bf16: a batch of 4 may sum a conv in
    another order than a batch of 1, its bf16 rounding then falls on the
    other side of a midpoint and the flip travels on (a few values by two
    ulps), so the bar is atol 0.0625 + rtol 0.02 — and each frame's rows
    lie nearer its own B=1 call than another frame's."""
    _, path = det_onnx
    runner = OnnxRunner(path, device="cpu")
    x = torch.from_numpy(_x(4, seed=2))
    batched = runner(x, dtype)
    assert sorted(batched) == [8, 16, 32]
    singles = [runner(x[b:b + 1], dtype) for b in range(4)]
    bar = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=0.0625, rtol=0.02)
    for b in range(4):
        for s in (8, 16, 32):
            for i, bt in enumerate(batched[s]):
                st, other = singles[b][s][i], singles[(b + 1) % 4][s][i]
                assert bt.shape[1:] == st.shape[1:] and bt.dtype == st.dtype
                a = bt[b:b + 1].float()
                torch.testing.assert_close(a, st.float(), **bar)
                assert (a - st.float()).abs().mean() < (a - other.float()).abs().mean() / 10
    # what the JAX runner does with the same graph at B=4
    jr = JaxRunner(path)
    assert sorted(jr.apply(jnp.asarray(x.numpy()))) == [4, 8, 16]


def test_rows_that_fit_no_grid_raise(det_onnx):
    _, path = det_onnx
    runner = OnnxRunner(path, device="cpu")
    outs = [torch.zeros(2 * 24 * 24 + 1, c) for c in (1, 4, 10)]
    with pytest.raises(ValueError, match="cannot classify"):
        runner.classify_scrfd(outs, SIZE, 1)
    with pytest.raises(ValueError, match="at batch 5"):
        runner.classify_scrfd([torch.zeros(2 * 24 * 24 * 2, 1)], SIZE, 5)


def test_kind_inference_and_arcface_output(tmp_path):
    rec = bridge.params_from_numpy(bridge.init_params_numpy("mbf", seed=4), "cpu")
    path = str(tmp_path / "w600k_mbf.onnx")
    onnx_export.export_recognizer(rec, path)
    runner = OnnxRunner(path, device="cpu")
    assert runner.kind == "arcface" and runner.input_size == 112
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (3, 112, 112, 3))
                         .astype(np.float32))
    feats = runner(x)
    assert feats.shape == (3, 512) and feats.dtype == torch.float32
    torch.testing.assert_close(feats, rec(x), atol=1e-3, rtol=1e-4)
    det = bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=5), "cpu")
    dpath = str(tmp_path / "det.onnx")
    onnx_export.export_detector(det, dpath, input_size=128)
    drun = OnnxRunner(dpath, device="cpu")
    assert drun.kind == "scrfd" and drun.input_size == 128
    xd = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (2, 128, 128, 3))
                          .astype(np.float32))
    got, want = drun(xd), det(xd)
    for s in (8, 16, 32):
        for g, w in zip(got[s], want[s]):
            assert g.shape == w.shape == (2, (128 // s) ** 2 * 2, g.shape[-1])
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
