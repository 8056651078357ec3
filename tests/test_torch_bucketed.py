"""The port's occupancy-adaptive bucketed embed (pipeline/bucketed.py) vs
the JAX package's, and vs the port's own dense path.

Setup as tests/test_bucketed.py (128² input, float32, pre_nms_topk=64,
iresnet18, K=4 slots, buckets 2/4/8), with the detections recipe of
tests/test_torch_pipeline.py (calibrated weights, `detection_bias`) so
noise frames carry faces; the port runs its CUDA warp's plain version,
the JAX side its Pallas warp in interpret mode.

Bars: the bucketed path against the dense path of the same package at
atol 1e-5 (tests/test_bucketed.py's bar); program B against JAX's on the
same compacted crops at atol 1e-5 (features) and 1e-5 (sims), indices
equal; the compaction (perm, valid, counts) equal, its crops within the
warp's epilogue bar 0.0256 (tests/test_torch_warp.py). End to end across
the packages the detector's float32 landmarks differ by ~7e-5 px (XLA
and torch convolutions), which moves the features by ~3e-5, so there the
bar is tests/test_torch_pipeline.py's: cosine ≥ 1 − 1e-5, identical
masks, counts and corrections.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.pipeline import bucketed as jb
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.pipeline import bucketed as pb
from facerecognizeonnx_tpu_torch.pipeline.fused import frames_to_features, frames_to_matches
from tests.test_torch_models import _np_tree, iresnet_calibrated, scrfd_calibrated

SIZE, K = 128, 4
BUCKETS = [2, 4, 8]
SMALL = dict(det_input_size=SIZE, compute_dtype="float32", pre_nms_topk=64, max_faces=16,
             rec_arch="iresnet18")
CFG = PipelineConfig(warp_impl="cuda", **SMALL)
JCFG = JaxConfig(warp_impl="pallas", warp_interpret=True, **SMALL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    det_tree = detection_bias(_np_tree(scrfd_calibrated(size=SIZE)), torch.from_numpy(frames))
    rec_tree = _np_tree(iresnet_calibrated())
    bank = rng.normal(size=(16, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank = np.concatenate([bank, np.zeros((16, 512), np.float32)])
    models = (bridge.params_from_numpy(det_tree, "cpu"), bridge.params_from_numpy(rec_tree, "cpu"))
    return frames, det_tree, rec_tree, bank, models


@pytest.fixture(scope="module")
def jax_ref(setup):
    """Every JAX result the tests compare with, computed once."""
    frames, det_tree, rec_tree, bank, _ = setup
    x = jnp.asarray(frames)
    ref = {}
    with jax.default_matmul_precision("highest"):
        compact = jax.jit(lambda v: jb.detect_and_compact(det_tree, v, JCFG, K, valid_cap=3))(x)
        ref["compact"] = jax.tree_util.tree_map(np.asarray, compact)
        _, crops_c, perm, valid_flat, _ = compact
        ref["embed"] = np.asarray(jax.jit(
            lambda c, p, v: jb.embed_compacted(rec_tree, c, p, v, JCFG, K, 8))(crops_c, perm, valid_flat))
        ref["embed_matches"] = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda c, p, v, g: jb.embed_compacted_matches(rec_tree, c, p, v, g, jnp.int32(16), JCFG,
                                                          K, 4, 3))(crops_c, perm, valid_flat,
                                                                    jnp.asarray(bank)))
        for cap in (None, 3):
            pipe = jb.BucketedEmbedPipeline(det_tree, rec_tree, JCFG, max_faces_embed=K,
                                            buckets=BUCKETS, valid_cap=cap)
            dets, feats, n = pipe(x)
            ref[cap] = (np.asarray(dets.valid), np.asarray(feats), n, pipe.corrections,
                        pipe.last_bucket)
        pipe._last_rate = 1.0  # a bucket-2 guess for 6 faces: corrected in the step
        _, feats, n = pipe(x)
        ref["corrected"] = (np.asarray(feats), n, pipe.corrections, pipe.last_bucket)
        fused = jb.BucketedEmbedPipeline(det_tree, rec_tree, JCFG, max_faces_embed=K,
                                         buckets=BUCKETS, valid_cap=2, search_top_k=3)
        out = fused(x, jnp.asarray(bank), jnp.int32(16))
        ref["fused"] = jax.tree_util.tree_map(np.asarray, out[1:4]) + (out[4],)
    return ref


def _pipe(setup, **kw):
    _, _, _, _, (det, rec) = setup
    return pb.BucketedEmbedPipeline(det, rec, kw.pop("cfg", CFG), max_faces_embed=K,
                                    buckets=BUCKETS, device="cpu", **kw)


def _dense(setup, valid_cap=None, cfg=CFG):
    frames, _, _, _, (det, rec) = setup
    with torch.no_grad():
        return frames_to_features(det, rec, torch.from_numpy(frames), cfg, K, valid_cap=valid_cap)


def _close(got, want, atol=1e-5):
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_default_buckets_match_jax():
    for total in (1, 8, 32, 48, 64, 100, 1024):
        assert pb.default_buckets(total) == jb.default_buckets(total)
    assert pb.MIN_BUCKET == jb.MIN_BUCKET


def test_detect_and_compact_matches_jax(setup, jax_ref):
    frames, _, _, _, (det, _) = setup
    with torch.no_grad():
        dets, crops_c, perm, valid, counts = pb.detect_and_compact(
            det, torch.from_numpy(frames), CFG, K, valid_cap=3)
    w_dets, w_crops, w_perm, w_valid, w_counts = jax_ref["compact"]
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    np.testing.assert_array_equal(perm.numpy(), w_perm)
    np.testing.assert_array_equal(counts.numpy(), w_counts)
    assert counts.dtype == torch.int32 and counts.tolist() == [3, 3]
    np.testing.assert_array_equal(dets.valid.numpy(), w_dets.valid)
    # valid slots first, each class in slot order
    n = int(counts.sum())
    assert valid[perm[:n]].all() and not valid[perm[n:]].any()
    assert (perm[:n].diff() > 0).all() and (perm[n:].diff() > 0).all()
    assert np.abs(crops_c.float().numpy() - w_crops.astype(np.float32)).max() <= 0.0256


def test_program_b_matches_jax_on_the_same_crops(setup, jax_ref):
    """embed_compacted / embed_compacted_matches on JAX's own compacted
    crops: features and sims within 1e-5, indices equal and int32; slots
    beyond the bucket and invalid slots are exactly zero."""
    _, _, _, bank, (_, rec) = setup
    w_crops, w_perm, w_valid = jax_ref["compact"][1:4]
    crops_c = torch.from_numpy(w_crops.astype(np.float32))  # bf16 values, exactly
    perm, valid = torch.tensor(w_perm).long(), torch.tensor(w_valid)
    with torch.no_grad():
        feats = pb.embed_compacted(rec, crops_c, perm, valid, CFG, K, bucket=8)
        f4, sims, idx = pb.embed_compacted_matches(
            rec, crops_c, perm, valid, torch.from_numpy(bank), 16, CFG, K, 4, 3)
    _close(feats, jax_ref["embed"])
    w_f4, w_sims, w_idx = jax_ref["embed_matches"]
    _close(f4, w_f4)
    _close(sims, w_sims)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    v = valid.reshape(2, K)
    assert (feats[~v] == 0).all()
    torch.testing.assert_close(feats[v].norm(dim=-1), torch.ones(int(v.sum())), atol=1e-5, rtol=0)
    # bucket 4 of 6 valid crops: the two beyond the bucket get zeros
    beyond = torch.zeros(2 * K, dtype=torch.bool)
    beyond[perm[4:6]] = True
    assert (f4.reshape(2 * K, -1)[beyond] == 0).all()


@pytest.mark.parametrize("valid_cap", [None, 0, 1, 3])
def test_parity_with_dense(setup, jax_ref, valid_cap):
    dets_d, feats_d = _dense(setup, valid_cap)
    pipe = _pipe(setup, valid_cap=valid_cap)
    dets, feats, n = pipe(torch.from_numpy(setup[0]))
    assert torch.equal(dets.valid, dets_d.valid)
    _close(dets.boxes, dets_d.boxes)
    _close(feats, feats_d)
    if valid_cap is not None:
        assert n == valid_cap * 2
    if valid_cap in jax_ref:
        w_valid, w_feats, w_n, w_corr, w_bucket = jax_ref[valid_cap]
        np.testing.assert_array_equal(dets.valid.numpy(), w_valid)
        assert (n, pipe.corrections, pipe.last_bucket) == (w_n, w_corr, w_bucket)
        slot = dets.valid[:, :K].numpy() if valid_cap is None else \
            np.broadcast_to(np.arange(K) < valid_cap, (2, K))
        assert (feats.numpy()[~slot] == 0).all() and (w_feats[~slot] == 0).all()
        assert (feats.numpy() * w_feats).sum(-1)[slot].min() >= 1 - 1e-5


def test_parity_without_skip_invalid(setup):
    cfg = dataclasses.replace(CFG, skip_invalid_faces=False)
    _, feats_d = _dense(setup, 2, cfg)
    _, feats, n = _pipe(setup, valid_cap=2, cfg=cfg)(torch.from_numpy(setup[0]))
    assert n == 4
    _close(feats, feats_d)


def test_speculation_correction_is_exact(setup, jax_ref):
    _, feats_d = _dense(setup, 3)
    pipe = _pipe(setup, valid_cap=3)
    pipe(torch.from_numpy(setup[0]))
    pipe._last_rate = 1.0  # a bucket-2 guess for 6 valid faces
    _, feats, n = pipe(torch.from_numpy(setup[0]))
    w_feats, w_n, w_corr, w_bucket = jax_ref["corrected"]
    assert (n, pipe.corrections, pipe.last_bucket) == (w_n, w_corr, w_bucket) == (6, 1, 8)
    _close(feats, feats_d)
    assert (feats.numpy() * w_feats).sum(-1)[:, :3].min() >= 1 - 1e-5
    _, feats2, _ = pipe(torch.from_numpy(setup[0]))  # steady state: no new correction
    assert pipe.corrections == 1 and pipe.steps == 3
    _close(feats2, feats_d)


def test_zero_faces_give_zero_features_without_an_embed(setup, monkeypatch):
    pipe = _pipe(setup, valid_cap=0)
    pipe._last_rate = 0.0
    monkeypatch.setattr(pb, "embed_compacted", None)  # the embed must not run
    _, feats, n = pipe(torch.from_numpy(setup[0]))
    assert n == 0 and pipe.corrections == 0 and pipe.last_bucket == 0
    assert torch.equal(feats, torch.zeros((2, K, 512)))


def test_pad_frames_excluded_from_occupancy(setup):
    _, feats_d = _dense(setup, 2)
    pipe = _pipe(setup, valid_cap=2)
    frames = torch.from_numpy(setup[0])
    _, feats, n = pipe.finish(pipe.start(frames, n_frames=1))  # frame 1 is a pad copy
    assert n == 2 and pipe._last_rate == 2.0
    _close(feats[0], feats_d[0])
    _, feats2, n2 = pipe(frames)  # guess from the real rate: 2 x 2 frames → bucket 4
    assert n2 == 4 and pipe.corrections == 0 and pipe.last_bucket == 4
    _close(feats2, feats_d)


def test_zero_guess_then_faces_is_not_a_correction(setup):
    pipe = _pipe(setup, valid_cap=1)
    pipe._last_rate = 0.0
    _, feats, n = pipe(torch.from_numpy(setup[0]))
    assert n == 2 and pipe.corrections == 0
    _close(feats, _dense(setup, 1)[1])


def test_fused_search_matches_dense_and_jax(setup, jax_ref):
    frames, _, _, bank, (det, rec) = setup
    g = torch.from_numpy(bank)
    with torch.no_grad():
        dets_d, feats_d, sims_d, idx_d = frames_to_matches(
            det, rec, torch.from_numpy(frames), g, 16, CFG, K, 3, valid_cap=2)
    pipe = _pipe(setup, valid_cap=2, search_top_k=3)
    dets, feats, sims, idx, n = pipe(torch.from_numpy(frames), g, 16)
    assert n == 4 and idx.dtype == idx_d.dtype == torch.int32
    slot = np.broadcast_to(np.arange(K) < 2, (2, K))
    _close(feats, feats_d)
    np.testing.assert_array_equal(idx.numpy()[slot], idx_d.numpy()[slot])
    np.testing.assert_allclose(sims.numpy()[slot], sims_d.numpy()[slot], atol=1e-5, rtol=0)
    w_feats, w_sims, w_idx, w_n = jax_ref["fused"]
    assert n == w_n
    np.testing.assert_array_equal(idx.numpy()[slot], w_idx[slot])
    # |Δsim| ≤ |Δf|/2 under the cosine bar (tests/test_torch_pipeline.py)
    np.testing.assert_allclose(sims.numpy()[slot], w_sims[slot], atol=2.3e-3, rtol=0)
    with pytest.raises(ValueError):
        pipe.start(torch.from_numpy(frames))
    with pytest.raises(ValueError, match="n_rows"):
        pipe.start(torch.from_numpy(frames), bank_padded=g)
    with pytest.raises(ValueError):
        _pipe(setup).start(torch.from_numpy(frames), bank_padded=g, n_rows=16)


def test_two_phase_start_finish(setup):
    """Two batches in flight at once resolve in order, each exactly."""
    _, feats_d = _dense(setup, 2)
    pipe = _pipe(setup, valid_cap=2)
    frames = torch.from_numpy(setup[0])
    h1, h2 = pipe.start(frames), pipe.start(frames)
    assert pipe.steps == 0  # start() resolves nothing
    (_, f1, n1), (_, f2, n2) = pipe.finish(h1), pipe.finish(h2)
    assert n1 == n2 == 4 and pipe.steps == 2
    _close(f1, feats_d)
    _close(f2, feats_d)


@pytest.mark.parametrize("search", [False, True], ids=["features", "matches"])
def test_mesh_is_not_ported_and_the_card_is_the_default(setup, search):
    """The mesh form (ported now) on a one-rank Gloo mesh in process is the
    unsharded pipeline bit for bit, counts and corrections included;
    without a card the default device raises."""
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh

    frames, _, _, bank, _ = setup
    kw = dict(search_top_k=3) if search else {}
    call = dict(bank_padded=torch.from_numpy(bank), n_rows=16) if search else {}
    plain = _pipe(setup, **kw)
    ours = _pipe(setup, mesh=make_mesh(("data",), device="cpu"), **kw)
    for cap in (2, None):  # the second step corrects a short guess
        plain.valid_cap = ours.valid_cap = cap
        want = plain(torch.from_numpy(frames), **call)
        got = ours(frames, **call)
        assert got[-1] == want[-1]
        for a, b in zip(jax.tree_util.tree_leaves(got[:-1]), jax.tree_util.tree_leaves(want[:-1])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (ours.corrections, ours.last_bucket) == (plain.corrections, plain.last_bucket)
    if not torch.cuda.is_available():
        _, _, _, _, (det, rec) = setup
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pb.BucketedEmbedPipeline(det, rec, CFG)
