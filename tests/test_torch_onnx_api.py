"""`.onnx` weights through the port's API, pipeline, packs and CLI, held
against the JAX package on the same files.

The files are the port's exports of seeded trees (`bridge.
init_params_numpy`): SCRFD-500m, its cls bias set by the detections
recipe (chip_smoke.detection_bias) so noise frames give faces, and
IResNet-18 at 112. Both packages load them — each detector as a graph
runner, each recognizer mapped onto its native model — and run in
float32 at a 128² detector input.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facerecognizeonnx_tpu.config as jax_config
from chip_smoke import detection_bias, png_bytes
from facerecognizeonnx_tpu.cli.main import main as jax_main
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.onnx_import.importer import OnnxRunner as JaxRunner
from facerecognizeonnx_tpu.pipeline.api import FaceDetector as JaxDetector
from facerecognizeonnx_tpu.pipeline.api import FaceRecognizer as JaxRecognizer
from facerecognizeonnx_tpu.pipeline.fused import frames_to_matches as j_frames_to_matches
from facerecognizeonnx_tpu.utils import checkpoint as j_checkpoint
from facerecognizeonnx_tpu_torch import FaceDetector, FaceRecognizer, bridge, onnx_export
from facerecognizeonnx_tpu_torch.cli import main as cli
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.errors import ModelLoadError
from facerecognizeonnx_tpu_torch.models import packs
from facerecognizeonnx_tpu_torch.models.arcface import IResNet
from facerecognizeonnx_tpu_torch.models.mobilefacenet import MobileFaceNet
from facerecognizeonnx_tpu_torch.onnx_import import OnnxRunner
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_matches

SMALL = dict(det_input_size=128, compute_dtype="float32", rec_arch="iresnet18")
CFG = PipelineConfig(warp_impl="cuda", **SMALL)
JCFG = JaxConfig(warp_impl="pallas", warp_interpret=True, **SMALL)
MODELS = ["--rec-arch", "iresnet18", "--det-size", "128"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _float32(monkeypatch):
    for mod in (jax_config, cli):
        auto = mod.auto_config
        monkeypatch.setattr(
            mod, "auto_config",
            lambda _auto=auto, **kw: _auto(**{"compute_dtype": "float32", **kw}),
        )


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("onnx_api")
    rng = np.random.default_rng(71)
    frames = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    det_tree = detection_bias(bridge.init_params_numpy("500m", seed=0), torch.from_numpy(frames))
    rec_tree = bridge.init_params_numpy("iresnet18", seed=1)
    out = {"root": root, "frames": frames}
    for name, tree in (("det", det_tree), ("rec", rec_tree)):
        j_checkpoint.save_params(str(root / f"{name}.npz"), tree)
        out[f"{name}_npz"] = str(root / f"{name}.npz")
    onnx_export.export_detector(bridge.params_from_numpy(det_tree, "cpu"),
                                str(root / "det.onnx"), input_size=128)
    onnx_export.export_recognizer(bridge.params_from_numpy(rec_tree, "cpu"),
                                  str(root / "rec.onnx"))
    out["det"], out["rec"] = str(root / "det.onnx"), str(root / "rec.onnx")
    out["png"] = str(root / "f0.png")
    Path(out["png"]).write_bytes(png_bytes(np.ascontiguousarray(frames[0][..., ::-1])))
    return out


@pytest.fixture(scope="module")
def loaded(files):
    port = (FaceDetector(CFG, device="cpu"), FaceRecognizer(CFG, device="cpu"))
    ref = (JaxDetector(JCFG), JaxRecognizer(JCFG))
    for d, r in (port, ref):
        assert d.load_model(files["det"]) and r.load_model(files["rec"])
    return port, ref


def _same_faces(got, want, box_tol=1.0):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.box, float), np.asarray(w.box, float),
                                   atol=box_tol)
        assert abs(g.score - w.score) <= 1e-4
        np.testing.assert_allclose(g.landmarks, w.landmarks, atol=1e-2)


def test_detector_load_onnx_and_detect_match_jax(files, loaded):
    (det, _), (jdet, _) = loaded
    assert isinstance(det.params, OnnxRunner) and det.params.kind == "scrfd"
    for img in (files["frames"][0], files["frames"][1][:96]):
        _same_faces(det.detect(img), jdet.detect(img))
    torch_faces = det.detect_batch([files["frames"][0], files["frames"][1]])
    jax_faces = jdet.detect_batch([files["frames"][0], files["frames"][1]])
    for g, w in zip(torch_faces, jax_faces):
        _same_faces(g, w)


def test_recognizer_load_onnx_maps_and_embeds_as_jax(files, loaded):
    (det, rec), (_, jrec) = loaded
    assert isinstance(rec.params, IResNet) and rec.params.features_bn is None  # mapped, folded
    img = files["frames"][0]
    faces = det.detect(img)[:4]
    got = rec.extract_features(img, faces)
    want = np.asarray(jrec.extract_features(img, faces))
    assert got.shape == want.shape == (len(faces), 512)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(rec.extract_feature_simple(img),
                               np.asarray(jrec.extract_feature_simple(img)), atol=1e-4)


def test_recognizer_runner_fallback_matches_jax(files):
    """rec_arch=mbf: no mapper of the walk order fits iresnet18 as
    iresnet50, mbf or vit, so both packages run the graph executor."""
    cfg = PipelineConfig(warp_impl="cuda", **{**SMALL, "rec_arch": "mbf"})
    jcfg = JaxConfig(warp_impl="pallas", warp_interpret=True, **{**SMALL, "rec_arch": "mbf"})
    rec, jrec = FaceRecognizer(cfg, device="cpu"), JaxRecognizer(jcfg)
    assert rec.load_model(files["rec"]) and jrec.load_model(files["rec"])
    assert isinstance(rec.params, OnnxRunner) and rec.params.kind == "arcface"
    assert rec.quantize() is False  # an ONNX graph is not quantized
    img = files["frames"][1]
    np.testing.assert_allclose(rec.extract_feature_simple(img),
                               np.asarray(jrec.extract_feature_simple(img)), atol=1e-4)


def test_missing_and_corrupt_onnx_return_false(files, tmp_path):
    det, rec = FaceDetector(CFG, device="cpu"), FaceRecognizer(CFG, device="cpu")
    assert det.load_model(str(tmp_path / "missing.onnx")) is False and det.params is None
    empty = tmp_path / "empty.onnx"
    empty.write_bytes(b"")
    assert rec.load_model(str(empty)) is False and rec.params is None


def test_frames_to_matches_with_runner_detector_b2_matches_jax(files, loaded):
    """The exported (3-D, any-batch) detector graph at B=2 through the
    fused path, the mapped recognizer behind it, against the JAX
    package's jitted frames_to_matches on the same files."""
    (_, rec), (_, jrec) = loaded
    runner, jrunner = OnnxRunner(files["det"], device="cpu"), JaxRunner(files["det"])
    bank = np.random.default_rng(3).normal(size=(24, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    frames = files["frames"]
    with torch.no_grad():
        dets, feats, sims, idx = frames_to_matches(
            runner, rec.params, torch.from_numpy(frames), torch.from_numpy(bank), 20, CFG, 4, 3)
    jd, jf, js, ji = jax.jit(lambda f, b: j_frames_to_matches(
        jrunner, jrec.params, f, b, 20, JCFG, 4, 3))(jnp.asarray(frames), jnp.asarray(bank))
    assert np.array_equal(dets.valid.numpy(), np.asarray(jd.valid))
    assert dets.valid[:, :4].any(dim=1).all()
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(jd.boxes), atol=1e-3)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), atol=1e-4)
    np.testing.assert_allclose(sims.numpy(), np.asarray(js), atol=1e-4)
    assert np.array_equal(idx.numpy(), np.asarray(ji))


def test_load_pack_loads_onnx_files(files, tmp_path):
    """buffalo_s with its two files on disk (the pack's 640 detector):
    the detector as a runner, the recognizer mapped onto MobileFaceNet."""
    onnx_export.export_recognizer(
        bridge.params_from_numpy(bridge.init_params_numpy("mbf", seed=6), "cpu"),
        str(tmp_path / "w600k_mbf.onnx"))
    onnx_export.export_detector(
        bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=7), "cpu"),
        str(tmp_path / "det_500m.onnx"))
    _, det_path, rec_path = packs.resolve_pack("buffalo_s", str(tmp_path))
    assert det_path and rec_path
    det, rec = packs.load_pack("buffalo_s", model_dir=str(tmp_path), device="cpu")
    assert isinstance(det.params, OnnxRunner) and isinstance(rec.params, MobileFaceNet)
    assert det.params.input_size == det.cfg.det_input_size == 640
    assert isinstance(det.detect(files["frames"][0]), list)
    feat = rec.extract_feature_simple(files["frames"][0])
    assert feat.shape == (512,) and abs(float(np.linalg.norm(feat)) - 1.0) < 1e-3


@pytest.mark.parametrize("what", ["recognizer", "detector"])
def test_cli_export_bytes_equal_jax_cli(files, tmp_path, what):
    extra = (["--detector", "--det-model", files["det_npz"]] if what == "detector"
             else ["--rec-model", files["rec_npz"]])
    out, jout = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    assert cli.main(["export", out, *extra, *MODELS, "--cpu"]) == 0
    assert jax_main(["export", jout, *extra, *MODELS]) in (None, 0)
    assert Path(out).read_bytes() == Path(jout).read_bytes()
    # a .frtz bundle takes the native modules' leaves, which a runner has not
    with pytest.raises(ModelLoadError, match="OnnxRunner"):
        cli.main(["export", str(tmp_path / "x.frtz"), "--det-model", files["det"], *MODELS,
                  "--cpu"])


def test_cli_detect_with_onnx_models(files, capsys):
    argv = ["detect", files["png"], "--det-model", files["det"], "--rec-model", files["rec"],
            *MODELS, "--json"]
    assert cli.main(argv + ["--cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["total_faces"] == want["total_faces"] > 0
    for g, w in zip(got["images"][0]["faces"], want["images"][0]["faces"]):
        np.testing.assert_allclose(g["box"], w["box"], atol=1.0)
        assert abs(g["score"] - w["score"]) <= 1e-4


def test_doctor_arms_real_model_parity(tmp_path, capsys, monkeypatch):
    """Stand-in files under the real names, at the real 640 / 112 sizes
    (as tests/test_cli.py does for the JAX package): doctor runs the
    parity proof and reports it ok."""
    onnx_export.export_detector(
        bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=0), "cpu"),
        str(tmp_path / "det_500m.onnx"))
    onnx_export.export_recognizer(
        bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=1), "cpu"),
        str(tmp_path / "w600k_r50.onnx"))
    monkeypatch.setenv("FRT_REAL_MODELS_DIR", str(tmp_path))
    assert cli.main(["doctor", "--json", "--rec-arch", "iresnet18", "--cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    rmp = doc["real_model_parity"]
    assert rmp["status"] == "ok", rmp
    assert rmp["dir"] == str(tmp_path) and rmp["detector"]["input_size"] == 640
    assert rmp["recognizer"]["mapped_native"] is True
    assert rmp["recognizer"]["exec_cosine"] > 1 - 1e-3
