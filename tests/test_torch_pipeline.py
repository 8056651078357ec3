"""The slice as a whole: `frames_to_features` / `frames_to_matches` of the
port (warp_impl="cuda", so on CPU tensors the CUDA warp's plain
version) vs the JAX package (warp_impl="pallas", interpret mode), f32,
same bridged weights, same frames.

Detections recipe (`chip_smoke.detection_bias`, shared with the card
run): randomly initialised SCRFD scores every anchor about σ(−4.59) ≈
0.01, so nothing clears the 0.5 threshold. The recipe runs the detector
once with the cls bias at 0 and sets the bias to minus the median over
frames of the midpoint between each frame's 32nd and 33rd largest
logits: about 32 anchors per frame then clear 0.5, with continuous
(separated) scores. Both sides get the same biased tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.pipeline.fused import frames_to_matches as j_frames_to_matches
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.ops import warp_cuda
from facerecognizeonnx_tpu_torch.pipeline.fused import (
    frames_to_features,
    frames_to_matches,
)
from tests.test_torch_models import _np_tree, iresnet_calibrated, scrfd_calibrated

SIZE, B, K, TOP_K = 128, 2, 4, 3
N_ROWS, G_PAD = 40, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    det_tree = detection_bias(_np_tree(scrfd_calibrated(size=SIZE)), torch.from_numpy(frames))
    rec_tree = _np_tree(iresnet_calibrated())
    bank = rng.normal(size=(G_PAD, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    bank[N_ROWS:] = 0.0
    models = (
        bridge.params_from_numpy(det_tree, device="cpu"),
        bridge.params_from_numpy(rec_tree, device="cpu"),
    )
    return frames, det_tree, rec_tree, bank, models


def _jax_run(setup, valid_cap):
    frames, det_tree, rec_tree, bank, _ = setup
    cfg = JaxConfig(det_input_size=SIZE, compute_dtype="float32",
                    warp_impl="pallas", warp_interpret=True)
    fn = jax.jit(
        lambda d, r, f, g, n: j_frames_to_matches(
            d, r, f, g, n, cfg, K, TOP_K, valid_cap=valid_cap
        )
    )
    with jax.default_matmul_precision("highest"):
        out = fn(det_tree, rec_tree, jnp.asarray(frames), jnp.asarray(bank),
                 jnp.int32(N_ROWS))
    return jax.tree_util.tree_map(np.asarray, out)


CFG = PipelineConfig(det_input_size=SIZE, compute_dtype="float32", warp_impl="cuda")


@pytest.mark.parametrize("valid_cap", [None, 0, 2], ids=["cap_none", "cap0", "cap2"])
def test_frames_to_matches_matches_jax(setup, valid_cap):
    frames, _, _, bank, (det, rec) = setup
    w_dets, w_feats, w_sims, w_idx = _jax_run(setup, valid_cap)
    with torch.no_grad():
        dets, feats, sims, idx = frames_to_matches(
            det, rec, torch.from_numpy(frames), torch.from_numpy(bank), N_ROWS, CFG,
            K, TOP_K, valid_cap=valid_cap,
        )
    assert warp_cuda.warp_affine_xm.launches == 0  # CPU: the plain version ran
    assert idx.dtype == torch.int32 and w_idx.dtype == np.int32  # as lax.top_k gives them

    # detections: identical masks, boxes/kps within 1e-3
    np.testing.assert_array_equal(dets.valid.numpy(), w_dets.valid)
    assert 4 <= dets.count().min() and dets.count().max() <= 40  # a few dozen
    np.testing.assert_allclose(dets.boxes.numpy(), w_dets.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(dets.kps.numpy(), w_dets.kps, atol=1e-3, rtol=0)

    # the embed slots: valid per valid_cap, features on valid slots only
    slot_valid = dets.valid[:, :K].numpy()
    if valid_cap is not None:
        slot_valid = np.broadcast_to(np.arange(K) < valid_cap, (B, K))
    f, wf = feats.numpy(), w_feats
    assert (f[~slot_valid] == 0).all() and (wf[~slot_valid] == 0).all()
    if slot_valid.any():
        cos = (f * wf).sum(-1)[slot_valid]  # both unit-norm on valid slots
        assert cos.min() >= 1 - 1e-5, cos.min()
        np.testing.assert_array_equal(idx.numpy()[slot_valid], w_idx[slot_valid])
        # |Δsim| ≤ |Δf|/2 ≤ sqrt(2·1e-5)/2 under the cosine bar; measured 6e-5
        np.testing.assert_allclose(
            sims.numpy()[slot_valid], w_sims[slot_valid], atol=2.3e-3, rtol=0
        )
        assert (idx.numpy()[slot_valid] < N_ROWS).all()


def test_frames_to_features_skip_flag_and_gather_warp(setup):
    """skip_invalid_faces=False gives the default path's features on
    valid slots; the gather warp (exact cv2 bilinear, no mips — on noise
    frames it differs from the mip warp for large faces) gives unit
    features on valid slots and zeros elsewhere."""
    frames, _, _, _, (det, rec) = setup
    x = torch.from_numpy(frames)
    with torch.no_grad():
        dets, feats = frames_to_features(det, rec, x, CFG, K)
        _, no_skip = frames_to_features(
            det, rec, x, dataclasses.replace(CFG, skip_invalid_faces=False), K
        )
        _, gather = frames_to_features(
            det, rec, x, dataclasses.replace(CFG, warp_impl="gather"), K
        )
    v = dets.valid[:, :K]
    assert v.any()
    torch.testing.assert_close(no_skip, feats, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        gather.norm(dim=-1)[v], torch.ones(int(v.sum())), rtol=0, atol=1e-5
    )
    assert (gather[~v] == 0).all() and (feats[~v] == 0).all()


def test_embed_program_matches_jax(setup):
    """One frame + K landmark sets (one degenerate → crop fallback) through
    embed_program on both sides: same features on valid slots, zeros on
    invalid ones."""
    from facerecognizeonnx_tpu.embed.pipeline import embed_program as j_embed_program
    from facerecognizeonnx_tpu_torch.embed.pipeline import embed_program
    from facerecognizeonnx_tpu_torch.ops.umeyama import ARCFACE_DST_5PTS

    frames, _, rec_tree, _, (_, rec) = setup
    rng = np.random.default_rng(12)
    kps = (ARCFACE_DST_5PTS[None] * rng.uniform(0.4, 1.0, (K, 1, 1))
           + rng.uniform(0, 60, (K, 1, 2))).astype(np.float32)
    kps[1] = 30.0  # all points coincide: the crop fallback
    boxes = np.concatenate([kps.min(1) - 5, kps.max(1) + 5], -1).astype(np.float32)
    valid = np.array([True, True, False, True])
    cfg = JaxConfig(det_input_size=SIZE, compute_dtype="float32",
                    warp_impl="pallas", warp_interpret=True)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(
            lambda r, f, k, b, v: j_embed_program(r, f, k, b, v, cfg)
        )(rec_tree, jnp.asarray(frames[0]), kps, boxes, valid))
    with torch.no_grad():
        got = embed_program(rec, torch.from_numpy(frames[0]), torch.from_numpy(kps),
                            torch.from_numpy(boxes), torch.from_numpy(valid), CFG).numpy()
    assert (got[~valid] == 0).all() and (want[~valid] == 0).all()
    assert (got * want).sum(-1)[valid].min() >= 1 - 1e-5
