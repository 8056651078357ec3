"""The port's mesh, sharded gallery search, data-parallel embed and
data-parallel fused step (`parallel/mesh.py`, `parallel/sharded_ops.py`)
on 1, 2 and 4 real Gloo ranks (`tests/torch_ranks.py`) vs the JAX
package's functions on its 8-virtual-device mesh, and vs the port's own
unsharded calls in the same ranks.

One spawn per world size runs every check of this file. Weights: seeded
numpy trees of `bridge.init_params_numpy` (SCRFD-500m biased by the
detections recipe of `chip_smoke.detection_bias`, IResNet-18), float32
at 128². Bars: against the port's unsharded call, bit for bit on one
rank, and on 2 and 4 ranks features within 1e-5, equal masks, equal
top-k indices and sims within 1e-6, box and landmark pixels within
rtol 1e-5 / atol 1e-4 (the ranks' smaller batches may take other conv
algorithms); against JAX, the bars of the port's unsharded
parity tests (tests/test_torch_pipeline.py: masks equal, boxes within
1e-3, features at cosine ≥ 1 − 1e-5, sims within 2.3e-3) and, for the
gallery search, equal indices with sims within 1e-5.

The w8a8 recognizer (`models/quant.py`) is held against the port's own
unsharded quantized call on each rank's block only: the port's
calibration is not the JAX package's bit for bit
(tests/test_torch_quant.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.match.gallery import GalleryBank as JaxBank
from facerecognizeonnx_tpu.parallel.mesh import make_mesh as j_make_mesh
from facerecognizeonnx_tpu.parallel.sharded_ops import (
    make_dp_program as j_make_dp_program,
    sharded_batch_embed as j_sharded_batch_embed,
    sharded_frames_to_features as j_sharded_frames_to_features,
    sharded_topk_search as j_sharded_topk_search,
)
from facerecognizeonnx_tpu_torch import bridge
from tests.torch_ranks import run_ranks

SIZE = 128
CHECKS = ["mesh", "search", "bank", "embed", "dp", "dp_w8a8", "dp_matches"]
WORLDS = [1, 2, 4]


def _normed(rng, n, d=512):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1234)
    frames4 = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    det = detection_bias(bridge.init_params_numpy("500m", seed=0), torch.from_numpy(frames4))
    bank16 = _normed(rng, 16)
    bank16[12:] = 0.0  # rows 12.. are pad rows
    return {
        "g1000": _normed(rng, 1000), "q_g1000": _normed(rng, 4),
        "g1003": _normed(rng, 1003), "q_g1003": _normed(rng, 3),
        "g3": _normed(rng, 3), "q_g3": _normed(rng, 2),
        "bank": _normed(rng, 50),
        "crops": rng.integers(0, 256, (10, 112, 112, 3), dtype=np.uint8),
        "det": det,
        "rec": bridge.init_params_numpy("iresnet18", seed=1),
        "rec32": bridge.init_params_numpy("iresnet18", seed=2, input_size=32),
        "calib32": rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32),
        "frames3": frames4[:3],
        "frames4": frames4,
        "bank16": bank16,
    }


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{w}" for w in WORLDS])
def ranks(request, inputs, tmp_path_factory):
    world = request.param
    outs = run_ranks(tmp_path_factory.mktemp(f"w{world}"), world, CHECKS, inputs)
    return world, outs


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """The JAX functions on the JAX test session's 8 virtual devices."""
    out = {}
    for name, k in (("g1000", 5), ("g1003", 7), ("g3", 10)):
        s, i = j_sharded_topk_search(inputs[f"q_{name}"], inputs[name], k)
        out[name] = (np.asarray(s), np.asarray(i))
    cfg = JaxConfig(det_input_size=SIZE, compute_dtype="float32", pre_nms_topk=64,
                    max_faces=16)
    with jax.default_matmul_precision("highest"):
        out["embed"] = np.asarray(j_sharded_batch_embed(inputs["rec"], inputs["crops"], cfg))
        dets, feats = j_sharded_frames_to_features(
            inputs["det"], inputs["rec"], inputs["frames3"], cfg, max_faces_embed=4)
        out["dp"] = jax.tree_util.tree_map(np.asarray, (dets, feats))
        mcfg = JaxConfig(det_input_size=SIZE, compute_dtype="float32", pre_nms_topk=64,
                         max_faces=16, warp_impl="pallas", warp_interpret=True)
        program, _ = j_make_dp_program(
            inputs["det"], inputs["rec"], mcfg, mesh=j_make_mesh(("data",),
                                                                 devices=jax.devices()[:4]),
            max_faces_embed=2, search_top_k=3)
        res = program(inputs["frames4"], jnp.asarray(inputs["bank16"]), 12)
        out["dp_matches"] = jax.tree_util.tree_map(np.asarray, res)
    return out


def _exact_or_close(world, got, plain, atol, rtol=0.0):
    """Bit for bit on one rank, within the bar on more."""
    if world == 1:
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, plain, rtol=rtol, atol=atol)


def _same_dets(world, got, plain):
    """Masks equal; pixel coordinates within the pipeline-stage bar of
    the JAX tests (rtol 1e-5, atol 1e-4), scores within 1e-5."""
    np.testing.assert_array_equal(got["valid"], plain["valid"])
    for key in ("boxes", "kps"):
        _exact_or_close(world, got[key], plain[key], 1e-4, 1e-5)
    _exact_or_close(world, got["scores"], plain["scores"], 1e-5)


def _dets_match_jax(got, want):
    np.testing.assert_array_equal(got["valid"], want.valid)
    np.testing.assert_allclose(got["boxes"], want.boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["kps"], want.kps, rtol=0, atol=1e-3)


def _cos_at_least(got, want, valid, bar=1 - 1e-5):
    assert valid.any()
    cos = (got * want).sum(-1)[valid]
    assert cos.min() >= bar, cos.min()


def test_make_mesh_shapes(ranks):
    world, outs = ranks
    for o in outs:
        m = o["mesh"]
        assert list(m["dm"]) == ([world // 2, 2] if world >= 2 else [1, 1])
        assert int(m["model"]) == world and list(m["default"]) == [world, 1]
        assert int(m["bad"]) == 1  # ValueError "mesh shape (3,) != n devices"
        assert int(m["same"]) == 1  # meshes are cached


@pytest.mark.parametrize("case", ["g1000", "g1003", "g3"],
                         ids=["divisible", "not_divisible", "k_above_g"])
def test_sharded_topk_search(ranks, jax_ref, inputs, case):
    world, outs = ranks
    q, g = inputs[f"q_{case}"], inputs[case]
    k = {"g1000": 5, "g1003": 7, "g3": 10}[case]
    dense = (q @ g.T + 1.0) / 2.0
    ref_idx = np.argsort(-dense, axis=1, kind="stable")[:, :min(k, len(g))]
    j_sims, j_idx = jax_ref[case]
    for o in outs:
        sims, idx = o["search"][case]["sims"], o["search"][case]["idx"]
        assert sims.shape == (len(q), min(k, len(g))) and idx.max() < len(g)
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_allclose(sims, j_sims, rtol=0, atol=1e-5)
        np.testing.assert_allclose(sims, np.take_along_axis(dense, ref_idx, 1), rtol=0,
                                   atol=1e-6)


def test_gallery_bank_sharded_search(ranks, inputs):
    world, outs = ranks
    jbank = JaxBank()
    jbank.add_batch([f"id{i}" for i in range(50)], inputs["bank"])
    j_names, j_sims = jbank.search(inputs["bank"][7:9], top_k=3, sharded=True)
    for o in outs:
        s, d = o["bank"]["sharded"], o["bank"]["dense"]
        np.testing.assert_array_equal(s["idx"], d["idx"])
        np.testing.assert_allclose(s["sims"], d["sims"], rtol=0, atol=1e-6)
        assert list(s["idx"][:, 0]) == [7, 8]
        assert [[f"id{i}" for i in row] for row in s["idx"]] == j_names
        np.testing.assert_allclose(s["sims"], j_sims, rtol=0, atol=1e-5)


def test_sharded_batch_embed(ranks, jax_ref):
    world, outs = ranks
    for o in outs:
        got, plain = o["embed"]["got"], o["embed"]["plain"]
        assert got.shape == (10, 512)
        _exact_or_close(world, got, plain, 1e-5)
        _cos_at_least(got, jax_ref["embed"], np.ones(10, bool))


def test_dp_fused_step(ranks, jax_ref):
    """sharded_frames_to_features: 3 frames padded to the world size."""
    world, outs = ranks
    j_dets, j_feats = jax_ref["dp"]
    for o in outs:
        got, plain = o["dp"]["got"], o["dp"]["plain"]
        assert got["feats"].shape == (3, 4, 512)
        _same_dets(world, got, plain)
        _exact_or_close(world, got["feats"], plain["feats"], 1e-5)
        _dets_match_jax(got, j_dets)
        _cos_at_least(got["feats"], j_feats, got["valid"][:, :4])


def test_dp_fused_step_w8a8(ranks):
    """A w8a8 recognizer module passes through the dp program as it is:
    bit for bit the port's unsharded quantized call on each rank's block
    (on the whole batch, int8 rounding amplifies the ulp differences that
    other detect batch sizes give; test_dp_fused_step holds those in
    float32)."""
    world, outs = ranks
    for o in outs:
        got, plain = o["dp_w8a8"]["got"], o["dp_w8a8"]["plain"]
        assert got["valid"][:, :4].any()
        for key in ("valid", "boxes", "scores", "kps", "feats"):
            np.testing.assert_array_equal(got[key], plain[key])


def test_dp_program_with_search(ranks, jax_ref):
    """make_dp_program(search_top_k=3) with the x-major warp (its plain
    version on the CPU), against JAX's with the Pallas warp in interpret
    mode on a 4-device mesh: rows 12.. of the bank are masked pad rows.
    The warp's crops are bf16 (its normalize epilogue), so the ulp-level
    box differences of other batch sizes move features by ~5e-5: the
    port's own reference is its unsharded call on each rank's block,
    held bit for bit."""
    world, outs = ranks
    j_dets, j_feats, j_sims, j_idx = jax_ref["dp_matches"]
    for o in outs:
        got, plain = o["dp_matches"]["got"], o["dp_matches"]["plain"]
        for key in plain:  # bit for bit the unsharded call on each block
            np.testing.assert_array_equal(got[key], plain[key])
        _dets_match_jax(got, j_dets)
        live = got["valid"][:, :2]
        _cos_at_least(got["feats"], j_feats, live)
        assert (got["idx"][live] < 12).all()
        np.testing.assert_array_equal(got["idx"][live], j_idx[live])
        np.testing.assert_allclose(got["sims"][live], j_sims[live], rtol=0, atol=2.3e-3)


def test_ranks_agree(ranks):
    """SPMD, global answer: every rank returns the same result."""
    world, outs = ranks
    for o in outs[1:]:
        for check in ("search", "embed", "dp", "dp_matches"):
            a = jax.tree_util.tree_leaves(outs[0][check])
            b = jax.tree_util.tree_leaves(o[check])
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
