"""Stage-pipelined inference of the port (`parallel/pipeline_stage.py`)
on 4 real Gloo ranks vs the fused step, the JAX package's
`pipelined_frames_to_features` and its oracle `frames_to_features`.

One spawn of 4 ranks runs every case (tests/test_pipeline_stage.py of
the JAX package): a ("stage",) mesh on ranks 0-1 (ranks 2-3 receive its
answer), dp × pp on ("data", "stage") (2, 2), 4 microbatches with B=3
padded, pp × tp on ("stage", "model") (2, 2) (the JAX test's 2×2×2
dp × pp × tp needs 8 ranks), the quantized + TP rejection and a stage
axis of 4. SCRFD-500m (the detections recipe of
`chip_smoke.detection_bias`) and IResNet-18 from
`bridge.init_params_numpy`, float32 at 128², the gather warp. Bars: the
JAX tests' own (boxes rtol 1e-5 / atol 1e-4, scores 1e-5, features
rtol 1e-4 / atol 1e-5) against the port's fused step, and against JAX
the port's parity bars (masks equal, boxes 1e-3, cosine ≥ 1 − 1e-5).
`valid_cap` (the bench control of `frames_to_features`) is held against
JAX in process.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.parallel.mesh import make_mesh as j_make_mesh
from facerecognizeonnx_tpu.parallel.pipeline_stage import (
    pipelined_frames_to_features as j_pipelined,
)
from facerecognizeonnx_tpu.pipeline.fused import frames_to_features as j_frames_to_features
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features
from tests.torch_ranks import run_ranks

JCFG = JaxConfig(det_input_size=128, compute_dtype="float32", pre_nms_topk=64, max_faces=16)
CASES = {"stage": 4, "dp_pp": 4, "micro4_b3": 3, "pp_tp": 4}  # case → frames


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    return {
        "det": detection_bias(bridge.init_params_numpy("500m", seed=2), torch.from_numpy(frames)),
        "rec": bridge.init_params_numpy("iresnet18", seed=3),
        "frames4": frames,
        "calib": rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    outs = run_ranks(tmp_path_factory.mktemp("pp"), 4, ["pp"], inputs)
    return [o["pp"] for o in outs]


@pytest.fixture(scope="module")
def jax_ref(inputs):
    with jax.default_matmul_precision("highest"):
        fused = jax.jit(lambda d, a, f: j_frames_to_features(d, a, f, JCFG, max_faces_embed=4))(
            inputs["det"], inputs["rec"], inputs["frames4"])
        pp = j_pipelined(inputs["det"], inputs["rec"], inputs["frames4"], JCFG,
                         mesh=j_make_mesh(("stage",), (2,), devices=jax.devices()[:2]),
                         max_faces_embed=4)
    return jax.tree_util.tree_map(np.asarray, {"fused": fused, "pp": pp})


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_fused_step(ranks, case):
    b = CASES[case]
    for o in ranks:
        got, plain = o[case], o["plain"]
        assert got["feats"].shape == (b, 4, 512)
        np.testing.assert_array_equal(got["valid"], plain["valid"][:b])
        assert got["valid"][:, :4].any()
        np.testing.assert_allclose(got["boxes"], plain["boxes"][:b], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["scores"], plain["scores"][:b], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["feats"], plain["feats"][:b], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(ranks, jax_ref, case):
    b = CASES[case]
    for ref in (jax_ref["fused"], jax_ref["pp"]):
        dets, feats = ref
        for o in ranks:
            got = o[case]
            np.testing.assert_array_equal(got["valid"], dets.valid[:b])
            np.testing.assert_allclose(got["boxes"], dets.boxes[:b], rtol=0, atol=1e-3)
            live = got["valid"][:, :4]
            cos = (got["feats"] * feats[:b]).sum(-1)[live]
            assert cos.min() >= 1 - 1e-5, cos.min()


def test_tp_rejects_quantized_recognizer(ranks):
    assert all(int(o["quant_tp"]) == 1 for o in ranks)


def test_bad_stage_axis_size_raises(ranks):
    assert all(int(o["bad_stage"]) == 1 for o in ranks)


def test_valid_cap_forces_occupancy(inputs):
    """frames_to_features(valid_cap=2) zeroes exactly the slots past 2,
    leaves the Detections untouched, and matches JAX's."""
    det = bridge.params_from_numpy(inputs["det"], device="cpu")
    rec = bridge.params_from_numpy(inputs["rec"], device="cpu")
    cfg = PipelineConfig(det_input_size=128, compute_dtype="float32", pre_nms_topk=64,
                         max_faces=16)
    x = torch.from_numpy(inputs["frames4"])
    with torch.no_grad():
        ref_dets, ref_feats = frames_to_features(det, rec, x, cfg, 4)
        dets, feats = frames_to_features(det, rec, x, cfg, 4, valid_cap=2)
    with jax.default_matmul_precision("highest"):
        _, j_feats = jax.jit(lambda d, a, f: j_frames_to_features(
            d, a, f, JCFG, max_faces_embed=4, valid_cap=2))(
            inputs["det"], inputs["rec"], inputs["frames4"])
    torch.testing.assert_close(dets.valid, ref_dets.valid, rtol=0, atol=0)
    torch.testing.assert_close(dets.boxes, ref_dets.boxes, rtol=0, atol=0)
    feats, ref_feats, j_feats = feats.numpy(), ref_feats.numpy(), np.asarray(j_feats)
    assert (feats[:, 2:] == 0).all() and (np.abs(feats[:, :2]).sum(-1) > 0).all()
    both = ref_dets.valid[:, :2].numpy()
    np.testing.assert_allclose(feats[:, :2][both], ref_feats[:, :2][both], rtol=1e-5, atol=1e-6)
    assert ((feats[:, :2] * j_feats[:, :2]).sum(-1)).min() >= 1 - 1e-5
