"""The port's evaluation (train/eval.py, the CLI's eval modes) against
the JAX package's.

train/eval.py is numpy: on the same inputs every number is equal. The
CLIs (both at --det-size 128, iresnet18, float32: both packages'
auto_config wrapped as in tests/test_torch_cli.py) evaluate the same
identity folder with the same `.npz` weights (the detector biased to
find faces on the folder's noise images): `eval --align` gives the same
keys and pair counts, the accuracy equal and the selected threshold
within one step of the threshold grid (0.0025: the two packages'
features differ in float32 rounding, which can move where a plateau of
the fold accuracy starts);
`eval --det-gt` the same keys and counts, AP, precision and recall
within 1e-6.
"""

import json

import numpy as np
import pytest
import torch

import facerecognizeonnx_tpu.config as jax_config
from chip_smoke import png_bytes
from facerecognizeonnx_tpu.cli.main import main as jax_main
from facerecognizeonnx_tpu.train import eval as jax_eval
from facerecognizeonnx_tpu_torch.cli import main as cli
from facerecognizeonnx_tpu_torch.runtime.native import letterbox_native
from facerecognizeonnx_tpu_torch.train import eval as port_eval
from tests.test_torch_app import seeded_weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sims():
    rng = np.random.default_rng(9)
    same = rng.random(200) < 0.5
    s = np.where(same, rng.normal(0.7, 0.1, 200), rng.normal(0.5, 0.1, 200))
    return s.astype(np.float32), same


@pytest.mark.parametrize("n_folds", [2, 10])
def test_verification_protocol_equal(sims, n_folds):
    s, same = sims
    assert port_eval.verification_accuracy(s, same, n_folds) == \
        jax_eval.verification_accuracy(s, same, n_folds)
    for far in (1e-1, 1e-2, 1e-3):
        assert port_eval.tar_at_far(s, same, far) == jax_eval.tar_at_far(s, same, far)


def test_pairs_and_evaluate_pairs_equal():
    rng = np.random.default_rng(10)
    f1, f2 = (rng.normal(size=(40, 16)).astype(np.float32) for _ in range(2))
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    f2 /= np.linalg.norm(f2, axis=1, keepdims=True)
    np.testing.assert_array_equal(port_eval.pair_similarities(f1, f2),
                                  jax_eval.pair_similarities(f1, f2))
    crops = rng.integers(0, 256, (2, 40, 4, 4, 3), dtype=np.uint8)
    proj = rng.normal(size=(48, 16)).astype(np.float32)

    def embed(x):
        f = x.reshape(len(x), -1).astype(np.float32) @ proj
        return f / np.linalg.norm(f, axis=1, keepdims=True)

    same = rng.random(40) < 0.5
    assert port_eval.evaluate_pairs(embed, crops[0], crops[1], same, 4) == \
        jax_eval.evaluate_pairs(embed, crops[0], crops[1], same, 4)


def test_detection_ap_equal():
    rng = np.random.default_rng(11)
    dets = []
    for n_pred, n_gt in ((6, 3), (0, 2), (4, 0), (8, 5)):
        xy = rng.uniform(0, 80, (n_pred + n_gt, 2)).astype(np.float32)
        wh = rng.uniform(5, 40, (n_pred + n_gt, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + wh], axis=1)
        dets.append({"boxes": boxes[:n_pred], "scores": rng.random(n_pred).astype(np.float32),
                     "gt": boxes[n_pred:]})
    a, b = dets[0]["boxes"], dets[3]["gt"]
    np.testing.assert_array_equal(port_eval.box_iou_matrix(a, b), jax_eval.box_iou_matrix(a, b))
    for iou in (0.3, 0.5):
        assert port_eval.detection_average_precision(dets, iou) == \
            jax_eval.detection_average_precision(dets, iou)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(autouse=True)
def _float32(monkeypatch):
    for mod in (jax_config, cli):
        auto = mod.auto_config
        monkeypatch.setattr(
            mod, "auto_config",
            lambda _auto=auto, **kw: _auto(**{"compute_dtype": "float32", **kw}),
        )


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three identities × three 128×128 noise PNGs, the weights, and a
    ground-truth JSON of one box per image."""
    root = tmp_path_factory.mktemp("eval_cli")
    rng = np.random.default_rng(12)
    images, gt = [], {}
    for who in ("ann", "ben", "cy"):
        (root / "ids" / who).mkdir(parents=True)
        for i in range(3):
            img = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
            (root / "ids" / who / f"{i}.png").write_bytes(png_bytes(img[..., ::-1].copy()))
            images.append(img)
            x, y = rng.uniform(10, 60, 2)
            gt[f"{who}/{i}.png"] = [[float(x), float(y), float(x) + 40.0, float(y) + 48.0]]
    (root / "gt.json").write_text(json.dumps(gt))
    det, rec = seeded_weights(root, np.stack([letterbox_native(im, 128)[0] for im in images]))
    models = ["--det-model", det, "--rec-model", rec, "--rec-arch", "iresnet18",
              "--det-size", "128", "--cpu", "--json"]
    return root, models


def _both(argv, capsys):
    docs = []
    for main in (cli.main, jax_main):
        assert main(argv) == 0
        docs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    return docs


def test_cli_eval_align_matches_jax(folder, capsys):
    root, models = folder
    got, want = _both(["eval", str(root / "ids"), "--align", *models], capsys)
    assert got.keys() == want.keys() and got["aligned"] is True
    for key in ("identities", "images", "genuine_pairs", "impostor_pairs", "n_folds",
                "accuracy", "tar_at_far_0.01", "tar_at_far_0.001"):
        assert got[key] == want[key], key
    assert abs(got["best_threshold"] - want["best_threshold"]) <= 0.0025


def test_cli_eval_detection_matches_jax(folder, capsys):
    root, models = folder
    got, want = _both(["eval", str(root / "ids"), "--det-gt", str(root / "gt.json"), *models],
                      capsys)
    assert got.keys() == want.keys() and got["mode"] == "eval-detection"
    assert (got["n_gt"], got["n_det"], got["images"]) == (want["n_gt"], want["n_det"],
                                                          want["images"])
    assert got["n_det"] > 0
    for key in ("ap", "precision", "recall"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key


def test_cli_eval_pairs_file(folder, capsys, tmp_path):
    """An LFW pairs.txt (Name/Name_%04d.jpg names): its pairs in file order."""
    root, models = folder
    ids = tmp_path / "lfw"
    src = root / "ids"
    for who in ("ann", "ben"):
        (ids / who).mkdir(parents=True)
        for i in range(3):
            (ids / who / f"{who}_{i + 1:04d}.jpg").write_bytes(
                (src / who / f"{i}.png").read_bytes())
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("2 2\nann 1 2\nben 1 3\nann 1 ben 2\nann 3 ben 3\nbogus line\n")
    got, want = _both(["eval", str(ids), "--pairs-file", str(pairs), *models], capsys)
    assert got.keys() == want.keys()
    assert (got["genuine_pairs"], got["impostor_pairs"], got["images"]) == (2, 2, 6)
    assert (want["genuine_pairs"], want["impostor_pairs"], want["images"]) == (2, 2, 6)
    assert got["accuracy"] == want["accuracy"]
