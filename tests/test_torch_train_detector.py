"""The port's detector fine-tuning (train/detector.py, CLI `train
--detector`) against the JAX package's.

Target assignment, mirroring and dataset loading are numpy: equal. Adam
against `optax.adam` on the same tensors: within 1 float32 ulp-scale
(rel 1e-6; the bias corrections' powers are computed by two libraries).
One `train_detector` step of SCRFD-500m at 128², B=2, from the same
tree: the loss within rel 1e-5; the BN running statistics (replaced by
the step's batch statistics) within 1e-4·max(|leaf|, 0.01); the
weights: ≥ 99.9% of the elements within 1e-6 + 1e-5·|w|, and all within
2·lr — Adam's first step moves each weight by lr·g/(|g| + eps), so a
gradient component at float32 noise level may take the other sign in
the other package (one full step either way). The CLI's JSON documents
agree (keys, counts, first loss within rel 1e-5), and the `.npz` it
writes loads as --det-model in both packages.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

import facerecognizeonnx_tpu.config as jax_config
from chip_smoke import png_bytes
from facerecognizeonnx_tpu.cli.main import main as jax_main
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.pipeline.api import FaceDetector as JaxDetector
from facerecognizeonnx_tpu.train import detector as jax_det
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.cli import main as cli
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector
from facerecognizeonnx_tpu_torch.train import detector as port_det
from facerecognizeonnx_tpu_torch.utils.checkpoint import _flatten
from tests.test_torch_train_step import hold_leaves

S = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BOXES = [
    np.array([[20, 30, 60, 80], [70, 10, 120, 50]], np.float32),
    np.array([[10, 10, 100, 100], [30, 30, 50, 50]], np.float32),  # nested: smallest wins
    np.zeros((0, 4), np.float32),
    np.array([[5, 60, 40, 127]], np.float32),
]


@pytest.mark.parametrize("i", range(len(BOXES)))
def test_make_targets_equal(i):
    got = port_det.make_targets(BOXES[i], S)
    want = jax_det.make_targets(BOXES[i], S)
    assert got.keys() == want.keys()
    for s in want:
        for g, w in zip(got[s], want[s]):
            np.testing.assert_array_equal(g, w)


def test_mirror_equal():
    rng = np.random.default_rng(14)
    images = rng.integers(0, 256, (4, S, S, 3), dtype=np.uint8)
    (gi, gb), (wi, wb) = (m.mirror_detection_data(images, BOXES) for m in (port_det, jax_det))
    np.testing.assert_array_equal(gi, wi)
    for g, w in zip(gb, wb, strict=True):
        np.testing.assert_array_equal(g, w)


def test_load_detection_dataset_equal(tmp_path):
    rng = np.random.default_rng(15)
    gt = {}
    for i, (h, w) in enumerate(((100, 150), (200, 90), (128, 128))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        (tmp_path / f"{i}.png").write_bytes(png_bytes(img[..., ::-1].copy()))
        gt[f"{i}.png"] = [[5.0, 6.0, 50.0, 70.0]]
    gt["missing.png"] = [[0.0, 0.0, 1.0, 1.0]]
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    got = port_det.load_detection_dataset(str(tmp_path), str(tmp_path / "gt.json"), 64)
    want = jax_det.load_detection_dataset(str(tmp_path), str(tmp_path / "gt.json"), 64)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1], strict=True):
        np.testing.assert_array_equal(g, w)


def test_adam_matches_optax():
    rng = np.random.default_rng(16)
    params = {"a": rng.normal(size=(4, 6)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    opt = optax.adam(2e-3)
    jstate, jp = opt.init(params), params
    port = port_det.Adam(2e-3)
    tensors = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = port.init(tensors)
    for _ in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, jstate = opt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        pstate = port.update(tensors, {k: torch.from_numpy(g) for k, g in grads.items()}, pstate)
        for k in params:
            np.testing.assert_allclose(tensors[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
            np.testing.assert_allclose(pstate["mu"][k].numpy(), np.asarray(jstate[0].mu[k]),
                                       rtol=1e-6, atol=0)
    assert int(pstate["count"]) == 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    return rng.integers(0, 256, (4, S, S, 3), dtype=np.uint8), BOXES


def test_train_detector_step_matches_jax(data):
    images, boxes = data
    tree = bridge.init_params_numpy("500m", seed=3)
    lr = 2e-3
    want, wl = jax_det.train_detector(images, boxes, JaxConfig(det_input_size=S,
                                      compute_dtype="float32"), steps=1, batch=2, lr=lr,
                                      init_params=tree, log_every=0)
    model, gl = port_det.train_detector(images, boxes, PipelineConfig(det_input_size=S,
                                        compute_dtype="float32"), steps=1, batch=2, lr=lr,
                                        init_params=tree, log_every=0, device="cpu")
    assert gl[0] == pytest.approx(wl[0], rel=1e-5)
    fw, fg = _flatten(jax.device_get(want)), _flatten(bridge.tree_from_module(model))
    assert fg.keys() == fw.keys()
    stats = [k for k in fw if k.endswith(("/mean", "/var"))]
    hold_leaves({k: fg[k] for k in stats}, {k: fw[k] for k in stats})
    n = close = 0
    for k in fw:
        if k in stats:
            continue
        w, d = np.asarray(fw[k]), np.abs(fg[k] - np.asarray(fw[k]))
        assert d.max() <= 2 * lr + 1e-5, k
        n += w.size
        close += int((d <= 1e-6 + 1e-5 * np.abs(w)).sum())
    assert close >= 0.999 * n, close / n


@pytest.fixture
def _float32(monkeypatch):
    for mod in (jax_config, cli):
        auto = mod.auto_config
        monkeypatch.setattr(
            mod, "auto_config",
            lambda _auto=auto, **kw: _auto(**{"compute_dtype": "float32", **kw}),
        )


def test_cli_train_detector_matches_jax(data, tmp_path, capsys, _float32):
    images, boxes = data
    gt = {}
    for i, (img, b) in enumerate(zip(images, boxes)):
        (tmp_path / f"{i}.png").write_bytes(png_bytes(img[..., ::-1].copy()))
        gt[f"{i}.png"] = b.tolist()
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    init = tmp_path / "init.npz"
    from facerecognizeonnx_tpu.utils.checkpoint import save_params

    save_params(str(init), bridge.init_params_numpy("500m", seed=3))
    docs = []
    for tag, main in (("port", cli.main), ("jax", jax_main)):
        out = str(tmp_path / f"{tag}.npz")
        assert main(["train", str(tmp_path), "--detector", "--det-gt", str(tmp_path / "gt.json"),
                     "--det-model", str(init), "--det-size", str(S), "--steps", "2",
                     "--batch", "2", "--no-augment", "--out", out, "--cpu", "--json"]) == 0
        docs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    got, want = docs
    assert got.keys() == want.keys() and got["mode"] == "train-detector"
    assert (got["steps"], got["images"], got["boxes"]) == (want["steps"], want["images"],
                                                           want["boxes"])
    assert got["loss_first"] == pytest.approx(want["loss_first"], rel=1e-5)
    port_npz = str(tmp_path / "port.npz")
    assert FaceDetector(PipelineConfig(det_input_size=S), device="cpu").load_model(port_npz)
    assert JaxDetector(JaxConfig(det_input_size=S)).load_model(port_npz)
