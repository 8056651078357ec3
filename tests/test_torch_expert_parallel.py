"""Expert parallelism of the port (`parallel/expert_parallel.py`) on 4
real Gloo ranks vs each expert alone (the port's unsharded call) and the
JAX package's `embed_crops` / `ep_embed_crops` / `enroll_batch`.

One spawn of 4 ranks runs every case (tests/test_expert_parallel.py of
the JAX package): one expert per rank, two per rank (ranks 0-1), a
single rank, dp × ep on ("data", "expert") (2, 2), capacity overflow
dropped and re-run, ids outside [0, E), an odd batch, the default mesh
(2 experts on 4 ranks → ranks 0-1) and `enroll_batch(experts=...)`.
Four IResNet-18 experts at 32² from `bridge.init_params_numpy`, float32.
Bars: routed rows within rtol 1e-5 / atol 1e-6 of their expert alone
(the capacity buffers batch faces differently), and against JAX cosine
≥ 1 − 1e-6 with features within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.embed.pipeline import embed_crops as j_embed_crops
from facerecognizeonnx_tpu.parallel.expert_parallel import ep_embed_crops as j_ep_embed_crops
from facerecognizeonnx_tpu.parallel.mesh import make_mesh as j_make_mesh
from facerecognizeonnx_tpu.pipeline.api import FaceDetector as JaxDetector
from facerecognizeonnx_tpu.pipeline.enroll import enroll_batch as j_enroll_batch
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.parallel.expert_parallel import route_by_yaw, stack_experts
from facerecognizeonnx_tpu_torch.utils.checkpoint import save_params
from tests.torch_ranks import spawn_ranks

JCFG = JaxConfig(compute_dtype="float32", rec_input_size=32)
IDS = {
    "one_per_shard": [0, 1, 2, 3, 3, 2, 1, 0],
    "two_per_shard": [3, 3, 0, 1, 2, 0, 1, 2],
    "single_rank": [2, 0, 1, 3, 0, 0, 3, 1],
    "dp_x_ep": [0, 1, 1, 0, 1, 0, 0, 1],
    "rerun": [0] * 8,
    "odd_batch": [1, 2, 0],
    "default_mesh": [0, 1, 1, 0, 1, 0, 0, 1],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    det_path = str(tmp_path_factory.mktemp("det") / "det.npz")
    save_params(det_path, detection_bias(bridge.init_params_numpy("500m", seed=0),
                                         torch.from_numpy(images)))
    return {
        "experts": [bridge.init_params_numpy("iresnet18", seed=k, input_size=32)
                    for k in range(4)],
        "crops8": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
        "images": images,
        "det_path": np.asarray(det_path),
    }


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("ep"), 4, ["ep", "enroll_experts"], inputs)


@pytest.fixture(scope="module")
def ranks(spawned, jax_alone):  # the JAX references are computed while the ranks run
    return spawned.result()


@pytest.fixture(scope="module")
def jax_alone(inputs, spawned):
    """(4, 8, 512): JAX's embed_crops of every crop by every expert."""
    fn = jax.jit(lambda p, c: j_embed_crops(p, c, JCFG))
    with jax.default_matmul_precision("highest"):
        return np.stack([np.asarray(fn(p, inputs["crops8"])) for p in inputs["experts"]])


def _by_ids(alone, ids):
    ids = np.asarray(ids)
    out = np.zeros((len(ids), alone.shape[-1]), np.float32)
    ok = (ids >= 0) & (ids < alone.shape[0])
    out[ok] = alone[ids[ok], np.nonzero(ok)[0]]
    return out


def _match_jax(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    live = np.linalg.norm(want, axis=-1) > 0
    assert ((got * want).sum(-1)[live]).min() >= 1 - 1e-6


@pytest.mark.parametrize("case", list(IDS))
def test_every_face_routed_to_its_expert(ranks, jax_alone, case):
    ids = IDS[case]
    for o in ranks:
        o = o["ep"]
        feats, routed = o[case]["feats"], o[case]["routed"]
        assert feats.shape == (len(ids), 512) and routed.all()
        np.testing.assert_allclose(feats, _by_ids(o["alone"], ids), rtol=1e-5, atol=1e-6)
        _match_jax(feats, _by_ids(jax_alone, ids))


def test_matches_jax_ep_embed_crops(ranks, inputs):
    mesh = j_make_mesh(("expert",), (4,), devices=jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        want, routed = j_ep_embed_crops(inputs["experts"], np.asarray(IDS["one_per_shard"]),
                                        inputs["crops8"], JCFG, mesh=mesh, capacity_factor=2.0)
    assert np.asarray(routed).all()
    for o in ranks:
        _match_jax(o["ep"]["one_per_shard"]["feats"], np.asarray(want))


def test_capacity_overflow_drops_visibly(ranks):
    # 4 ranks × local batch 2, E=4, cf=1.0 → 1 slot per (rank, expert):
    # both faces of every rank target expert 0, one per rank routes
    for o in ranks:
        o = o["ep"]
        feats, routed = o["drop"]["feats"], o["drop"]["routed"]
        assert routed.sum() == 4 and (feats[~routed] == 0).all()
        np.testing.assert_allclose(feats[routed], _by_ids(o["alone"], [0] * 8)[routed],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case,ids", [
    ("rerun_invalid", [0, -1, 1, 1, 1, 99, 1, 1]),
    ("invalid", [0, -1, 7, 1, 0, 99, 1, -3]),
])
def test_invalid_ids_never_route(ranks, case, ids):
    ids = np.asarray(ids)
    ok = (ids >= 0) & (ids < 2)
    for o in ranks:
        o = o["ep"]
        feats, routed = o[case]["feats"], o[case]["routed"]
        np.testing.assert_array_equal(routed, ok)
        assert (feats[~ok] == 0).all()
        np.testing.assert_allclose(feats[ok], _by_ids(o["alone"], ids)[ok], rtol=1e-5,
                                   atol=1e-6)


def test_bad_arguments_raise(ranks):
    for o in ranks:
        assert int(o["ep"]["bogus"]) == 1  # overflow must be 'rerun' or 'drop'
        assert int(o["ep"]["data_axis"]) == 1  # data_axis needs an explicit mesh


def test_enroll_batch_with_experts(ranks, inputs):
    """enroll_batch(experts=...) routes each detected face by yaw and
    enrolls its expert's feature, as the JAX package's does."""
    jcfg = JaxConfig(det_input_size=128, compute_dtype="float32", pre_nms_topk=64,
                     max_faces=16, rec_arch="iresnet18", rec_input_size=32)
    det = JaxDetector(jcfg)
    assert det.load_model(str(inputs["det_path"]))
    names = [f"p{i}" for i in range(4)]
    with jax.default_matmul_precision("highest"):
        bank, enrolled = j_enroll_batch(
            det, None, names, list(inputs["images"]), cfg=jcfg,
            mesh=j_make_mesh(("expert",), (2,), devices=jax.devices()[:2]),
            experts=inputs["experts"][:2])
    assert enrolled
    want = np.asarray(bank.features)
    for o in ranks:
        got = o["enroll_experts"]
        assert [f"p{i}" for i in got["enrolled"]] == enrolled
        # the enroll parity bar of tests/test_torch_service.py: the two
        # packages' uint8 crops may differ by a level
        assert ((got["feats"] * want).sum(-1)).min() >= 1 - 1e-5


def test_stack_experts_rejects_mixed_arch(inputs):
    with pytest.raises(ValueError, match="architecture"):
        stack_experts([inputs["experts"][0], bridge.init_params_numpy("mbf", seed=9)])
    stacked, n = stack_experts(inputs["experts"][:2])
    assert n == 2 and stacked["fc"]["w"].shape[0] == 2
    # modules of the port stack as their trees
    stacked_m, _ = stack_experts([bridge.params_from_numpy(t, device="cpu")
                                  for t in inputs["experts"][:2]])
    np.testing.assert_array_equal(stacked_m["fc"]["w"], stacked["fc"]["w"])


def test_route_by_yaw_buckets():
    def kps(nose_r):
        # eyes at x=30/70; nose_r is the nose's relative position
        return np.array(
            [[30, 50], [70, 50], [30 + 40 * nose_r, 60], [35, 80], [65, 80]], np.float32)

    ids = np.asarray(route_by_yaw(np.stack([kps(0.1), kps(0.5), kps(0.9)]), 3))
    np.testing.assert_array_equal(ids, [0, 1, 2])
    assert ids.dtype == np.int32
    degen = kps(0.5)
    degen[1, 0] = degen[0, 0]  # zero eye span: the frontal bucket, not NaN
    assert int(route_by_yaw(degen[None], 3)[0]) == 1
