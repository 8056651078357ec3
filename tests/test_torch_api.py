"""The port's FaceDetector / FaceRecognizer vs the JAX package's, on the
same `.npz` weights.

The JAX side initialises SCRFD-500m and IResNet-18 from seeds (BN
calibrated on noise, and the SCRFD cls bias set by the detections recipe
of chip_smoke.detection_bias so noise frames yield faces) and saves them
with its own `checkpoint.save_params`; both packages then `load_model`
the same files (each folds its BNs) and run in float32 at 128² input.
The port runs on the CPU (device="cpu"), its CUDA warp as the plain
version; the JAX side runs its Pallas warp in interpret mode.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.pipeline.api import FaceDetector as JaxDetector
from facerecognizeonnx_tpu.pipeline.api import FaceRecognizer as JaxRecognizer
from facerecognizeonnx_tpu.types import face_boxes_to_arrays as j_face_boxes_to_arrays
from facerecognizeonnx_tpu.utils import checkpoint as j_checkpoint
from facerecognizeonnx_tpu_torch import FaceDetector, FaceRecognizer
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.types import face_boxes_to_arrays
from facerecognizeonnx_tpu_torch.utils import checkpoint
from tests.test_torch_models import _np_tree, iresnet_calibrated, scrfd_calibrated

SMALL = dict(det_input_size=128, compute_dtype="float32", rec_arch="iresnet18",
             pre_nms_topk=64, score_threshold=0.3, max_faces=16)
CFG = PipelineConfig(warp_impl="cuda", **SMALL)
JCFG = JaxConfig(warp_impl="pallas", warp_interpret=True, **SMALL)
SHAPES = [(128, 128), (96, 120), (150, 100)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    det_tree = detection_bias(_np_tree(scrfd_calibrated(size=128)), torch.from_numpy(frames))
    rec_tree = _np_tree(iresnet_calibrated())
    root = tmp_path_factory.mktemp("weights")
    det_path, rec_path = str(root / "det.npz"), str(root / "rec.npz")
    j_checkpoint.save_params(det_path, det_tree)
    j_checkpoint.save_params(rec_path, rec_tree)
    port = (FaceDetector(CFG, device="cpu"), FaceRecognizer(CFG, device="cpu"))
    ref = (JaxDetector(JCFG), JaxRecognizer(JCFG))
    for d, r in (port, ref):
        assert d.load_model(det_path) and r.load_model(rec_path)
    images = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in SHAPES]
    return port, ref, images, (det_path, rec_path)


def _same_faces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.box == w.box  # int-truncated rects, exactly
        assert abs(g.score - w.score) <= 1e-4
        np.testing.assert_allclose(g.landmarks, w.landmarks, atol=1e-3)


def test_detect_matches_jax(loaded):
    (det, _), (jdet, _), images, _ = loaded
    with jax.default_matmul_precision("highest"):
        want = [jdet.detect(img) for img in images]
    got = [det.detect(img) for img in images]
    assert all(len(w) > 0 for w in want)
    for g, w in zip(got, want):
        _same_faces(g, w)
    assert all(isinstance(v, int) for f in got[1] for v in f.box)
    # a tighter threshold passed per call
    _same_faces(det.detect(images[1], score_threshold=0.6),
                [f for f in got[1] if f.score > 0.6])


def test_detect_batch_equals_detect(loaded):
    (det, _), (jdet, _), images, _ = loaded
    batch = [images[1], images[0], images[1], np.zeros((0, 0, 3), np.uint8), images[2]]
    got = det.detect_batch(batch)
    assert got[3] == []
    for g, img in zip(got[:3] + got[4:], batch[:3] + batch[4:]):
        _same_faces(g, det.detect(img))
    with jax.default_matmul_precision("highest"):
        want = jdet.detect_batch([images[1], images[2]])
    _same_faces(got[0], want[0])
    _same_faces(got[4], want[1])


def test_extract_features_match_jax(loaded):
    (det, rec), (_, jrec), images, _ = loaded
    faces = det.detect(images[1])
    assert len(faces) >= 9
    with jax.default_matmul_precision("highest"):
        want = jrec.extract_features(images[1], faces[:3])  # the 8-slot bucket
        want_one = jrec.extract_feature(images[1], faces[0])
        want_simple = jrec.extract_feature_simple(images[2])
    got = rec.extract_features(images[1], faces[:3])
    assert got.shape == want.shape == (3, 512)
    cos = (got * want).sum(-1)  # unit-norm rows on both sides
    assert cos.min() >= 1 - 1e-5, cos.min()
    assert float(rec.extract_feature(images[1], faces[0]) @ want_one) >= 1 - 1e-5
    # 9 faces fill the 16-slot bucket; a face's feature does not depend on it
    np.testing.assert_allclose(rec.extract_features(images[1], faces[:9])[:3], got, atol=1e-6)
    simple = rec.extract_feature_simple(images[2])
    assert simple.shape == (512,) and float(simple @ want_simple) >= 1 - 1e-5


def test_guards_and_compare(loaded):
    (det, rec), _, images, (det_path, _) = loaded
    f = rec.extract_features(images[0], det.detect(images[0])[:2])
    assert FaceRecognizer.compare_faces(f[0], f[0]) == pytest.approx(1.0, abs=1e-6)
    assert rec.compareFaces(f[0], f[1]) == pytest.approx((float(f[0] @ f[1]) + 1) / 2)
    assert rec.compare_faces(f[0], f[1][:10]) == 0.0
    assert rec.compare_faces([], []) == 0.0
    assert rec.extract_features(images[0], []).shape == (0, 512)
    assert rec.extract_feature_simple(np.zeros((0, 0, 3), np.uint8)).shape == (0,)
    assert det.detect(np.zeros((0, 0, 3), np.uint8)) == []
    fresh_det, fresh_rec = FaceDetector(CFG, device="cpu"), FaceRecognizer(CFG, device="cpu")
    assert fresh_det.detect(images[0]) == [] and fresh_det.detect_batch(images[:2]) == [[], []]
    assert fresh_rec.extract_feature_simple(images[0]).shape == (0,)
    assert fresh_det.loadModel is not None and fresh_rec.extractFeature is not None


def test_load_model_contract(loaded, tmp_path):
    (_, _), _, images, _ = loaded
    det, rec = FaceDetector(CFG, device="cpu"), FaceRecognizer(CFG, device="cpu")
    assert det.load_model(str(tmp_path / "missing.npz")) is False and det.params is None
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(b"not a checkpoint")
    assert rec.load_model(str(corrupt)) is False and rec.params is None
    assert det.load_model(str(tmp_path / "det_500m.onnx")) is False and det.params is None
    # init from seeds (numpy, not jax.random): a working, folded model
    assert det.load_model() and rec.load_model()
    assert det.params.stem.bn is None and rec.params.features_bn is None
    assert rec.extract_feature_simple(images[0]).shape == (512,)
    # w8a8 (tests/test_torch_quant.py holds it against the JAX package)
    assert not FaceRecognizer(CFG, device="cpu").quantize()  # nothing loaded
    crops = np.stack([images[0][:112, :112]] * 4)
    assert rec.quantize(crops, min_channels=128) and not rec.quantize(crops)
    assert rec.extract_feature_simple(images[0]).shape == (512,)
    # the other recognizer families load from seeds too (tests/test_torch_packs.py)
    mbf = FaceRecognizer(dataclasses.replace(CFG, rec_arch="mbf"), device="cpu")
    assert mbf.load_model() and mbf.params.features_bn is None
    with pytest.raises(ValueError, match="rec_arch"):
        dataclasses.replace(CFG, rec_arch="mbf_tiny")
    assert FaceDetector(CFG, device="cpu").detect_files(["a.jpg"]) == [[]]  # not loaded


def test_checkpoint_round_trips_both_ways(loaded, tmp_path):
    _, _, _, (det_path, _) = loaded
    tree = checkpoint.load_params(det_path)  # written by the JAX package
    ref = j_checkpoint.load_params(det_path)
    j_leaves, j_def = jax.tree_util.tree_flatten(ref)
    p_leaves, p_def = jax.tree_util.tree_flatten(tree)
    assert p_def == j_def and all(np.array_equal(a, b) for a, b in zip(p_leaves, j_leaves))
    checkpoint.save_params(str(tmp_path / "sub" / "det.npz"), tree)  # makes the folder
    back = j_checkpoint.load_params(str(tmp_path / "sub" / "det.npz"))
    assert all(np.array_equal(a, b)
               for a, b in zip(jax.tree_util.tree_leaves(back), j_leaves))


def test_face_boxes_to_arrays_matches_jax(loaded):
    (det, _), _, images, _ = loaded
    faces = det.detect(images[0])[:3]
    got, want = face_boxes_to_arrays(faces, 8), j_face_boxes_to_arrays(faces, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got.valid.sum()) == 3


def test_host_letterbox_and_detect_files_match_jax(loaded, tmp_path):
    """host_letterbox=True letterboxes on the host with the native runtime
    (rounding) and rescales after NMS; detect_files reads, decodes and
    letterboxes files with the native loader (a partial batch, an
    unreadable file). Both as the JAX package does, on the same weights."""
    from PIL import Image

    from tests.test_torch_native_runtime import jax_native_built

    assert jax_native_built()  # with codecs: the JAX detect_files takes its loader
    (_, _), _, images, (det_path, _) = loaded
    hcfg = dataclasses.replace(CFG, host_letterbox=True)
    det, jdet = FaceDetector(hcfg, device="cpu"), JaxDetector(dataclasses.replace(JCFG,
                                                                                 host_letterbox=True))
    assert det.load_model(det_path) and jdet.load_model(det_path)
    with jax.default_matmul_precision("highest"):
        want = [jdet.detect(img) for img in images[1:]]
    got = [det.detect(img) for img in images[1:]]
    for g, w in zip(got, want):
        _same_faces(g, w)
    paths = []
    for i, img in enumerate(images):
        paths.append(str(tmp_path / f"im{i}.png"))
        Image.fromarray(img[..., ::-1]).save(paths[-1])  # PNG holds RGB
    (tmp_path / "bad.jpg").write_bytes(b"junk")
    paths.append(str(tmp_path / "bad.jpg"))
    got = det.detect_files(paths, batch_size=2, threads=2)
    with jax.default_matmul_precision("highest"):
        want = jdet.detect_files(paths, batch_size=2, threads=2)
    assert got[-1] == want[-1] == [] and sum(len(g) for g in got) > 0
    # the loader's threads finish in any order, so the files share batches
    # differently from run to run, and detections whose scores lie within
    # 1e-5 may swap places: compare each file's detections as a set
    for g, w in zip(got, want):
        _same_faces(sorted(g, key=lambda f: f.box), sorted(w, key=lambda f: f.box))
