"""The port's tracker (pipeline/track.py) vs the JAX package's.

Host logic (iou_matrix, IOUTracker) must agree exactly. The pipeline runs
eight 192×256 frames of 2×2-repeated noise, each scene held for 4 frames
and then shifted 2 px (random-weight detectors find other faces after any
shift, so a held scene is what keeps tracks alive), which both
letterboxes take to 128² at scale 0.5 exactly (the port's native one
rounds, the JAX device one truncates: on repeated pixels both give the
pixel), through micro-batches of 2, K=4 slots, refresh_every=3, dense and
adaptive, labelled by a reference feature and by a bank.
Weights and configs as tests/test_torch_app.py (float32, the port's CUDA
warp as its plain version, the JAX Pallas warp in interpret mode). Bars:
per frame and slot the track ids, labels and masks equal, embed_frames
equal, cached features at cosine ≥ 1 − 1e-5; boxes within 2e-3 px.
"""

import jax
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.match.gallery import GalleryBank as JaxBank
from facerecognizeonnx_tpu.pipeline import track as jtrack
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.pipeline.track import (
    IOUTracker,
    TrackingVideoPipeline,
    iou_matrix,
)
from facerecognizeonnx_tpu_torch.runtime.native import letterbox_native
from tests.test_torch_app import CFG, JCFG, load_both, seeded_weights

K, BATCH, REFRESH, N_FRAMES = 4, 2, 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, n, degenerate=False):
    xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    wh = np.zeros((n, 2), np.float32) if degenerate else rng.uniform(-5, 40, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "degenerate", "empty"])
def test_iou_matrix_matches_jax(kind):
    rng = np.random.default_rng(5)
    if kind == "empty":
        a, b = _boxes(rng, 3), np.zeros((0, 4), np.float32)
    else:
        a = _boxes(rng, 7, degenerate=kind == "degenerate")
        b = np.concatenate([a[:3], _boxes(rng, 5, degenerate=kind == "degenerate")])
    got, want = iou_matrix(a, b), jtrack.iou_matrix(a, b)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kind == "degenerate":
        assert np.all(np.diag(got[:3, :3]) == 1.0)  # a zero-area box matches itself


def test_tracker_script_matches_jax():
    """A random script of appearing, moving and vanishing boxes: the same
    ids, hits and misses after every frame."""
    rng = np.random.default_rng(11)
    ours, ref = IOUTracker(iou_threshold=0.3, max_misses=2), jtrack.IOUTracker(0.3, 2)
    base = _boxes(rng, 6)
    for step in range(30):
        keep = rng.random(6) < 0.7
        boxes = base[keep] + rng.normal(0, 1.5, (int(keep.sum()), 4)).astype(np.float32)
        boxes = boxes[rng.permutation(len(boxes))]
        scores = rng.random(len(boxes)).astype(np.float32)
        got, want = ours.update(boxes, scores), ref.update(boxes, scores)
        assert [t.track_id for t in got] == [t.track_id for t in want], step
        assert [(t.track_id, t.hits, t.misses, t.frames_since_embed) for t in ours.tracks] == \
            [(t.track_id, t.hits, t.misses, t.frames_since_embed) for t in ref.tracks]
        if step == 15:
            base = _boxes(rng, 6)  # every face leaves at once: fresh ids
    assert ours._next_id == ref._next_id > 6


def _frames():
    rng = np.random.default_rng(23)
    small = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    base = np.repeat(np.repeat(small, 2, axis=0), 2, axis=1)
    return [np.roll(base, 2 * (i // 4), axis=1) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    frames = _frames()
    boxed = np.stack([letterbox_native(f, 128)[0] for f in frames])
    return frames, load_both(seeded_weights(tmp_path_factory.mktemp("w"), boxed))


@pytest.fixture(scope="module")
def runs(world):
    frames, ((det, rec), (jdet, jrec)) = world
    out = {}
    kw = dict(batch=BATCH, max_faces_embed=K, refresh_every=REFRESH)
    for adaptive in (False, True):
        pipe = TrackingVideoPipeline(det.params, rec.params, CFG, adaptive_embed=adaptive,
                                     device="cpu", **kw)
        jpipe = jtrack.TrackingVideoPipeline(jdet.params, jrec.params, JCFG,
                                             adaptive_embed=adaptive, **kw)
        # the reference feature: frame 0's first face; the bank: every track's
        # first feature from the reference run, plus chaff
        ref = None
        for label in ("ref", "bank"):
            for p in (pipe, jpipe):  # a fresh tracker, the same compiled programs
                p.tracker = type(p.tracker)(iou_threshold=0.3, max_misses=5)
                p.total_frames = p.embed_frames = 0
            if label == "ref":
                ref = ref if ref is not None else _first_feature(det, rec, frames[0])
                kwargs, jkwargs = dict(ref_feature=ref), dict(ref_feature=ref)
            else:
                bank, jbank = _banks(out[adaptive, "ref"])
                kwargs, jkwargs = dict(bank=bank), dict(bank=jbank)
            got = _snapshot(pipe.run(iter(frames), **kwargs))
            with jax.default_matmul_precision("highest"):
                want = _snapshot(jpipe.run(iter(frames), **jkwargs))
            out[adaptive, label] = (got, want, pipe.stats(), jpipe.stats(), pipe.slot_mismatches)
    return out


def _first_feature(det, rec, frame):
    faces = det.detect(frame)
    return rec.extract_feature(frame, faces[0])


def _snapshot(gen):
    """Per frame: (index, dets, [(id, label, feature copy) or None per slot])."""
    return [
        (i, {k: np.asarray(v) for k, v in dets.items()},
         [None if t is None else (t.track_id, t.label,
                                  None if t.feature is None else t.feature.copy())
          for t in tracks])
        for i, dets, tracks in gen
    ]


def _banks(ref_run):
    """Port and JAX banks: each track's feature at its first frame, under
    its id, plus 3 random rows."""
    got = ref_run[0]
    feats = {}
    for _, _, slots in got:
        for s in slots:
            if s is not None and s[2] is not None:
                feats.setdefault(s[0], s[2])
    names = [f"track{i}" for i in feats] + ["chaff0", "chaff1", "chaff2"]
    rows = np.concatenate([np.stack(list(feats.values())),
                           np.random.default_rng(3).normal(size=(3, 512)).astype(np.float32)])
    bank, jbank = GalleryBank(device="cpu"), JaxBank()
    bank.add_batch(names, rows)
    jbank.add_batch(names, rows)
    return bank, jbank


@pytest.mark.parametrize("label", ["ref", "bank"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["dense", "adaptive"])
def test_pipeline_matches_jax(runs, adaptive, label):
    got, want, stats, jstats, mismatches = runs[adaptive, label]
    assert len(got) == len(want) == N_FRAMES
    assert stats == jstats  # embed_frames, active tracks (and the bucket)
    assert 0 < stats["embed_frames"] < stats["total_frames"] == N_FRAMES
    assert mismatches == 0  # every refresh slot held the detect-only run's face
    n_tracked = labels = 0
    for (i, d, slots), (ji, jd, jslots) in zip(got, want):
        assert i == ji
        np.testing.assert_array_equal(d["valid"], jd["valid"])
        np.testing.assert_allclose(d["boxes"], jd["boxes"], atol=2e-3, rtol=0)
        for s, js in zip(slots, jslots):
            assert (s is None) == (js is None)
            if s is None:
                continue
            assert s[:2] == js[:2], (i, s[:2], js[:2])
            assert (s[2] is None) == (js[2] is None)
            if s[2] is not None:
                assert float(s[2] @ np.asarray(js[2])) >= 1 - 1e-5
            n_tracked += 1
            labels += s[1] not in ("", "Unknown")
    assert n_tracked > N_FRAMES and labels > 0
    ids = {s[0] for _, _, slots in got for s in slots if s is not None}
    assert len(ids) < n_tracked  # ids persist across frames


def test_dense_and_adaptive_agree(runs):
    for label in ("ref", "bank"):
        dense, adaptive = runs[False, label][0], runs[True, label][0]
        for (_, _, ds), (_, _, as_) in zip(dense, adaptive):
            assert [None if s is None else s[:2] for s in ds] == \
                [None if s is None else s[:2] for s in as_]
    stats = runs[True, "ref"][2]
    assert stats["embed_bucket"] > 0 and stats["embed_corrections"] >= 0


def test_slot_mismatches_counts_a_different_face(world, monkeypatch):
    """A refresh run whose slots do not hold the detect-only run's faces is
    counted (here the refresh batch is forced to hold mirrored frames)."""
    frames, ((det, rec), _) = world
    pipe = TrackingVideoPipeline(det.params, rec.params, CFG, batch=2, max_faces_embed=K,
                                 device="cpu")
    embed = pipe._embed
    monkeypatch.setattr(pipe, "_embed", lambda x, n: embed(torch.flip(x, dims=[2]), n))
    list(pipe.run(iter(frames[:2])))
    assert pipe.slot_mismatches > 0


def test_pipeline_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TrackingVideoPipeline(None, None, CFG)
