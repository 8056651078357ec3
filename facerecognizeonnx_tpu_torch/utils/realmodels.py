"""The parity gate for the real buffalo_sc model files, armed by their
presence.

Port of `facerecognizeonnx_tpu/utils/realmodels.py`. The product
contract is the two files the reference binary loads, det_500m.onnx and
w600k_r50.onnx. No checkout ships them, so the proof arms itself the
moment a deployment has them:

- find_real_models() locates both files via FRT_REAL_MODELS_DIR, an
  explicit model dir, ./models, or models/ at the repository root.
- run_real_model_parity() loads both through the product API
  (FaceDetector / FaceRecognizer.load_model) on `device` and proves: the
  detector's fast and reference executors agree, detect is deterministic
  with FaceBox invariants, the recognizer gives 512-d unit-norm features
  with compareFaces semantics ((dot+1)/2, self-similarity 1), and the
  served feature agrees with the reference executor's at cosine 1e-3.

onnxruntime, where it imports, is an independent cross-check of both
files (it shares no code with `onnx_import/proto.py`); without it the
gate runs executor against executor.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

COSINE_TOL = 1e-3  # embeddings within 1e-3 cosine

DET_FILE = "det_500m.onnx"
REC_FILE = "w600k_r50.onnx"


def _ort_session(path: str):
    """An onnxruntime CPU session when the package imports and loads the
    file, else None: a degraded ORT install must not make the gate worse
    than having no ORT (a session that runs and disagrees still fails)."""
    try:
        import onnxruntime
    except Exception:  # noqa: BLE001 — broken native libs raise OSError on import
        return None
    try:
        try:
            return onnxruntime.InferenceSession(path, providers=["CPUExecutionProvider"])
        except TypeError:  # older ORT without the providers kwarg
            return onnxruntime.InferenceSession(path)
    except Exception:  # noqa: BLE001 — an ORT that cannot load this graph
        return None


def _ort_run(session, x_nchw: np.ndarray):
    name = session.get_inputs()[0].name
    return session.run(None, {name: np.asarray(x_nchw, np.float32)})


def find_real_models(
    model_dir: Optional[str] = None,
    det_file: str = DET_FILE,
    rec_file: str = REC_FILE,
) -> Optional[Dict[str, str]]:
    """The real buffalo_sc files, searched in the FRT_REAL_MODELS_DIR env
    var, `model_dir`, ./models relative to the working directory and
    models/ at the repository root. {"dir", "det", "rec"} only when both
    files are in the same directory, else None."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [os.environ.get("FRT_REAL_MODELS_DIR"), model_dir,
                  os.path.join(os.getcwd(), "models"), os.path.join(repo_root, "models")]
    for d in candidates:
        if not d:
            continue
        det, rec = os.path.join(d, det_file), os.path.join(d, rec_file)
        if os.path.isfile(det) and os.path.isfile(rec):
            return {"dir": d, "det": det, "rec": rec}
    return None


def _max_head_diff(got, want) -> float:
    return max(
        float((gi.float() - torch.as_tensor(wi, device=gi.device).float()).abs().max())
        for s in got for gi, wi in zip(got[s], want[s])
    )


def run_real_model_parity(det_path: str, rec_path: str, cfg=None, device="cuda") -> Dict:
    """Detect / embed / compare parity on the given .onnx files through the
    product loading paths, on `device`. AssertionError (naming the failing
    quantity) on any violation; a report dict on success. Deterministic:
    seeded synthetic inputs. cfg defaults to the reference configuration
    (640 / 112, buffalo thresholds); stand-in tests pass smaller sizes."""
    from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
    from facerecognizeonnx_tpu_torch.onnx_import.importer import OnnxRunner
    from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector, FaceRecognizer

    dev = resolve_device(device)
    if cfg is None:
        cfg = PipelineConfig()
    report: Dict = {"det_path": det_path, "rec_path": rec_path}
    rng = np.random.default_rng(0)

    # --- detector: classification + fast vs reference executor
    fast = OnnxRunner(det_path, fast=True, device=dev)
    slow = OnnxRunner(det_path, fast=False, device=dev)
    assert fast.kind == "scrfd", f"detector classified as {fast.kind}"
    size = fast.input_size or cfg.det_input_size
    assert size == cfg.det_input_size, (
        f"detector input size {size} != configured {cfg.det_input_size}"
    )
    x_np = rng.uniform(-1.0, 1.0, (1, size, size, 3)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    with torch.no_grad():
        got, want = fast(x), slow(x)
    assert set(got) == set(want) == {8, 16, 32}, f"stride heads {sorted(got)} vs {sorted(want)}"
    max_d = _max_head_diff(got, want)
    assert max_d < 1e-2, f"fast-vs-reference executor divergence {max_d}"
    report["detector"] = {"input_size": size, "fast_vs_ref_maxdiff": max_d}

    # --- the independent oracle where it imports: onnxruntime on the CPU
    report["oracle"] = "in-repo NCHW executor"
    det_sess = _ort_session(det_path)
    if det_sess is not None:
        ort_outs = _ort_run(det_sess, np.transpose(x_np, (0, 3, 1, 2)))
        ort_heads = fast.classify_scrfd(ort_outs, size, 1)
        assert set(ort_heads) == {8, 16, 32}, sorted(ort_heads)
        ort_d = _max_head_diff(got, ort_heads)
        assert ort_d < 1e-2, f"fast-executor-vs-onnxruntime divergence {ort_d}"
        report["oracle"] = "onnxruntime"
        report["detector"]["fast_vs_ort_maxdiff"] = ort_d

    # --- detector through the product API, deterministic end to end
    det = FaceDetector(cfg, device=dev)
    assert det.load_model(det_path) is True, "FaceDetector.load_model failed"
    image = rng.integers(0, 256, (size - 20, size, 3), dtype=np.uint8)
    faces1, faces2 = det.detect(image), det.detect(image)
    assert len(faces1) == len(faces2), "detect is not deterministic"
    for f1, f2 in zip(faces1, faces2):
        assert f1.box == f2.box and f1.score == f2.score
        assert len(f1.landmarks) == 5
        assert 0.0 <= f1.score <= 1.0
    report["detector"]["faces_on_noise"] = len(faces1)

    # --- recognizer through the product API (native-mapped where the
    # graph fits, the executor otherwise — never wrong weights)
    rec = FaceRecognizer(cfg, device=dev)
    assert rec.load_model(rec_path) is True, "FaceRecognizer.load_model failed"
    mapped = not isinstance(rec.params, OnnxRunner)
    rs = cfg.rec_input_size
    img1 = rng.integers(0, 256, (rs, rs, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (rs, rs, 3), dtype=np.uint8)
    f1 = np.asarray(rec.extract_feature_simple(img1))
    f2 = np.asarray(rec.extract_feature_simple(img2))
    assert f1.shape == (cfg.feature_dim,), f"feature shape {f1.shape}"
    for f in (f1, f2):
        assert abs(float(np.linalg.norm(f)) - 1.0) < 1e-3, "not L2-normalized"
    self_sim = float(rec.compare_faces(f1, f1))
    cross_sim = float(rec.compare_faces(f1, f2))
    assert abs(self_sim - 1.0) < 1e-5, f"self-similarity {self_sim} != 1"
    assert 0.0 <= cross_sim <= 1.0, f"(dot+1)/2 out of range: {cross_sim}"

    # --- the served feature vs the reference-mode executor on the same pixels
    rslow = OnnxRunner(rec_path, kind="arcface", fast=False, device=dev)
    xr = (img1[..., ::-1].astype(np.float32) - cfg.pixel_mean) / cfg.pixel_scale
    with torch.no_grad():
        ref = rslow(torch.from_numpy(np.ascontiguousarray(xr[None])).to(dev))[0].cpu().numpy()
    ref = ref / max(float(np.linalg.norm(ref)), 1e-12)
    cos = float((f1 * ref).sum())
    assert cos > 1.0 - COSINE_TOL, f"served-vs-executor cosine {cos} below {1.0 - COSINE_TOL}"
    report["recognizer"] = {
        "mapped_native": mapped,
        "self_sim": self_sim,
        "cross_sim": round(cross_sim, 4),
        "exec_cosine": cos,
    }

    # --- the served feature vs the onnxruntime oracle
    rec_sess = _ort_session(rec_path)
    if rec_sess is not None:
        ort_feat = np.asarray(_ort_run(rec_sess, np.transpose(xr[None], (0, 3, 1, 2)))[0])
        ort_feat = ort_feat.reshape(-1) / max(float(np.linalg.norm(ort_feat)), 1e-12)
        ort_cos = float((f1 * ort_feat).sum())
        assert ort_cos > 1.0 - COSINE_TOL, (
            f"served-vs-onnxruntime cosine {ort_cos} below {1.0 - COSINE_TOL}"
        )
        report["recognizer"]["ort_cosine"] = ort_cos
    return report
