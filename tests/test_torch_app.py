"""The port's FaceApp vs the JAX package's, on the same `.npz` weights.

Weights: SCRFD-500m and IResNet-18 drawn by the port's
`bridge.init_params_numpy` (seeded numpy, JAX layouts; JAX's apply takes
them), the SCRFD cls bias set by the detections recipe of
`chip_smoke.detection_bias` on the test frames so noise yields faces,
written with the JAX package's `checkpoint.save_params` and loaded by
both packages' FaceDetector / FaceRecognizer. float32 at 128² input; the
port runs on the CPU with its CUDA warp as the plain version, the JAX
side its Pallas warp in interpret mode. Bars: boxes of int-truncated
rects equal, scores within 1e-4, embeddings at cosine ≥ 1 − 1e-5 and
similarities within 1e-4 (the HTTP and CLI bars; the x-major warp's plain
version and Pallas interpret differ by ≤ 0.8 intensity on ~0.5% of crop
values, tests/test_torch_warp.py, which moves a similarity by ~2e-5).
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.pipeline.api import FaceDetector as JaxDetector
from facerecognizeonnx_tpu.pipeline.api import FaceRecognizer as JaxRecognizer
from facerecognizeonnx_tpu.pipeline.app import FaceApp as JaxFaceApp
from facerecognizeonnx_tpu.utils import checkpoint as j_checkpoint
from facerecognizeonnx_tpu_torch import FaceApp, bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector, FaceRecognizer

SMALL = dict(det_input_size=128, compute_dtype="float32", rec_arch="iresnet18")
CFG = PipelineConfig(warp_impl="cuda", **SMALL)
JCFG = JaxConfig(warp_impl="pallas", warp_interpret=True, **SMALL)


def seeded_weights(root, frames_u8: np.ndarray):
    """(det.npz, rec.npz) written by the JAX package: seeded numpy trees,
    the detector biased to find ~32 faces a frame on `frames_u8`
    (letterboxed, at the detector's size)."""
    det_tree = detection_bias(bridge.init_params_numpy("500m", seed=0),
                              torch.from_numpy(frames_u8))
    paths = str(root / "det.npz"), str(root / "rec.npz")
    j_checkpoint.save_params(paths[0], det_tree)
    j_checkpoint.save_params(paths[1], bridge.init_params_numpy("iresnet18", seed=1))
    return paths


def load_both(paths, cfg=CFG, jcfg=JCFG):
    """((port detector, recognizer) on the CPU, (JAX detector, recognizer))."""
    port = (FaceDetector(cfg, device="cpu"), FaceRecognizer(cfg, device="cpu"))
    ref = (JaxDetector(jcfg), JaxRecognizer(jcfg))
    for d, r in (port, ref):
        assert d.load_model(paths[0]) and r.load_model(paths[1])
    return port, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    rng = np.random.default_rng(41)
    images = list(rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8))
    (det, rec), (jdet, jrec) = load_both(seeded_weights(tmp_path_factory.mktemp("w"),
                                                       np.stack(images)))
    blank = np.zeros((128, 128, 3), np.uint8)
    return FaceApp(det, rec), JaxFaceApp(jdet, jrec), images, blank


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_get_matches_jax(apps):
    app, japp, images, blank = apps
    assert app.device.type == "cpu"
    for img in images:
        with jax.default_matmul_precision("highest"):
            want = japp.get(img)
        got = app.get(img)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.box.box == w.box.box
            assert abs(g.score - w.score) <= 1e-4
            np.testing.assert_allclose(g.landmarks, w.landmarks, atol=1e-3)
            assert _cos(g.embedding, np.asarray(w.embedding)) >= 1 - 1e-5
    assert len(app.get(images[0], max_faces=2)) == 2
    assert app.get(blank) == [] and japp.get(blank) == []


def test_compare_and_verify_match_jax(apps):
    app, japp, images, blank = apps
    with jax.default_matmul_precision("highest"):
        want = [japp.compare(images[0], images[1]), japp.verify(images[0], images[0]),
                japp.verify(images[1], images[2], threshold=0.3)]
    got = [app.compare(images[0], images[1]), app.verify(images[0], images[0]),
           app.verify(images[1], images[2], threshold=0.3)]
    assert abs(got[0] - want[0]) <= 1e-4
    assert got[1][0] is want[1][0] is True and abs(got[1][1] - 1.0) <= 1e-5
    assert got[2][0] == want[2][0] and abs(got[2][1] - want[2][1]) <= 1e-4
    assert app.compare(images[0], blank) == 0.0 == japp.compare(images[0], blank)


def test_enroll_and_identify_match_jax(apps):
    app, japp, images, blank = apps
    assert app.identify(images[0]) == [] == japp.identify(images[0])  # no gallery yet
    assert isinstance(app.gallery, GalleryBank) and app.gallery.device.type == "cpu"
    for name, img in zip(("ann", "bob"), images[:2]):
        with jax.default_matmul_precision("highest"):
            assert japp.enroll(name, img)
        assert app.enroll(name, img)
    assert not app.enroll("nobody", blank) and not japp.enroll("nobody", blank)
    assert app.gallery.names == japp.gallery.names == ["ann", "bob"]
    for img in images:
        with jax.default_matmul_precision("highest"):
            want = japp.identify(img, top_k=2)
        got = app.identify(img, top_k=2)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["label"] == w["label"]
            assert [n for n, _ in g["matches"]] == [n for n, _ in w["matches"]]
            np.testing.assert_allclose([s for _, s in g["matches"]],
                                       [s for _, s in w["matches"]], atol=1e-4)
    assert app.identify(images[0])[0]["label"] == "ann"  # its own best face
    app.gallery = GalleryBank(device="cpu")
    assert app.identify(images[0]) == []


def test_from_pack_defaults_to_the_card(monkeypatch):
    """from_pack builds on the card unless asked; without CUDA it raises
    resolve_device's error rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        FaceApp.from_pack("buffalo_s")
