"""The port's enrollment and IdentifyService vs the JAX package's, on the
same weights, bank and images.

Weights: one `.npz` pair written by the JAX package (seeded init, BN
calibrated, the detections recipe of chip_smoke.detection_bias), loaded
by both packages' FaceDetector / FaceRecognizer. float32 at 128² input;
the port runs on the CPU (its CUDA warp as the plain version), the JAX
side with its Pallas warp in interpret mode. Most service images are
128×128, where the letterbox is the identity; the camera-size test sends
720×1280 and 1280×720 frames, which both services letterbox with their
native C++ runtimes (uint8, rounding).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.match.gallery import GalleryBank as JaxBank
from facerecognizeonnx_tpu.pipeline.api import FaceDetector as JaxDetector
from facerecognizeonnx_tpu.pipeline.api import FaceRecognizer as JaxRecognizer
from facerecognizeonnx_tpu.pipeline.enroll import enroll_batch as j_enroll_batch
from facerecognizeonnx_tpu.pipeline.service import IdentifyService as JaxService
from facerecognizeonnx_tpu.utils import checkpoint as j_checkpoint
from facerecognizeonnx_tpu_torch.errors import ModelLoadError
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.pipeline.api import FaceDetector, FaceRecognizer
from facerecognizeonnx_tpu_torch.pipeline.enroll import detect_align_crops, enroll_batch
from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService
from tests.test_torch_api import CFG, JCFG
from tests.test_torch_models import _np_tree, iresnet_calibrated, scrfd_calibrated
from tests.test_torch_native_runtime import jax_native_built

MAX_FACES, TOP_K = 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two Gloo ranks of the last tests, started first: they run while
    this module's JAX side builds."""
    from chip_smoke import detection_bias
    from facerecognizeonnx_tpu_torch import bridge
    from tests.torch_ranks import spawn_ranks

    rng = np.random.default_rng(17)
    images = rng.integers(0, 256, (6, 128, 128, 3), dtype=np.uint8)
    bank = rng.normal(size=(20, 512)).astype(np.float32)
    inputs = {
        "det": detection_bias(bridge.init_params_numpy("500m", seed=0), torch.from_numpy(images)),
        "rec": bridge.init_params_numpy("iresnet18", seed=1),
        "bank": bank / np.linalg.norm(bank, axis=1, keepdims=True),
        "images": images,
    }
    return spawn_ranks(tmp_path_factory.mktemp("service_ranks"), 2, ["service"], inputs)


@pytest.fixture(scope="module")
def world(tmp_path_factory, two_ranks):
    jax_native_built()  # the JAX service letterboxes with it
    rng = np.random.default_rng(31)
    frames = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    det_tree = detection_bias(_np_tree(scrfd_calibrated(size=128)), torch.from_numpy(frames))
    root = tmp_path_factory.mktemp("weights")
    paths = str(root / "det.npz"), str(root / "rec.npz")
    j_checkpoint.save_params(paths[0], det_tree)
    j_checkpoint.save_params(paths[1], _np_tree(iresnet_calibrated()))
    port = (FaceDetector(CFG, device="cpu"), FaceRecognizer(CFG, device="cpu"))
    ref = (JaxDetector(JCFG), JaxRecognizer(JCFG))
    for d, r in (port, ref):
        assert d.load_model(paths[0]) and r.load_model(paths[1])
    # enrollment images: two shapes (two buckets) and an all-black frame
    enroll_images = [frames[0], rng.integers(0, 256, (100, 140, 3), dtype=np.uint8),
                     frames[1], np.zeros((100, 140, 3), np.uint8)]
    return port, ref, frames, enroll_images


@pytest.fixture(scope="module")
def enrolled(world):
    (det, rec), (jdet, jrec), _, images = world
    names = ["ann", "bob", "cid", "dan"]
    bank, kept = enroll_batch(det, rec, names, images, device="cpu")
    jbank, jkept = j_enroll_batch(jdet, jrec, names, images)
    return bank, kept, jbank, jkept


def test_enroll_batch_matches_jax(world, enrolled):
    bank, kept, jbank, jkept = enrolled
    assert kept == jkept and len(kept) >= 3 and bank.names == jbank.names
    assert bank.device.type == "cpu"
    cos = (bank.features * jbank.features).sum(-1)  # unit rows on both sides
    assert cos.min() >= 1 - 1e-5, cos.min()
    (det, _), _, _, images = world
    crops = detect_align_crops(det, images, device="cpu")
    assert crops.dtype == np.uint8 and crops.shape == (len(kept), 112, 112, 3)
    # mesh= is ported: the data-parallel embed on a one-rank Gloo mesh in
    # process gives the plain enroll's bank bit for bit
    from facerecognizeonnx_tpu_torch.parallel.mesh import make_mesh

    names = ["ann", "bob", "cid", "dan"]
    (_, rec), _, _, _ = world
    mbank, mkept = enroll_batch(det, rec, names, images, mesh=make_mesh(("data",), device="cpu"),
                                device="cpu")
    assert mkept == kept
    np.testing.assert_array_equal(mbank.features, bank.features)


def _banks(enrolled):
    """Port and JAX banks holding the enrolled faces plus 9 random rows."""
    bank, _, jbank, _ = enrolled
    rng = np.random.default_rng(4)
    extra = rng.normal(size=(9, 512)).astype(np.float32)
    names = [f"rand{i}" for i in range(9)]
    pb, jb = GalleryBank(device="cpu"), JaxBank()
    for b, src in ((pb, bank), (jb, jbank)):
        b.add_batch(src.names + names, np.concatenate([src.features, extra]))
    return pb, jb


def _same_result(got, want, sims_atol=1e-4, boxes_atol=1e-4):
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.names == want.names
    np.testing.assert_allclose(got.sims, want.sims, atol=sims_atol)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=boxes_atol)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)


@pytest.mark.parametrize("warp", ["gather", "kernel"])
@pytest.mark.parametrize("fuse", [False, True], ids=["two_dispatch", "fuse_search"])
def test_service_matches_jax(world, enrolled, fuse, warp):
    """Both warps: the exact gather warp on both sides (sims within 1e-4),
    and the kernel path (the port's CUDA warp as its plain version vs the
    Pallas warp in interpret mode), whose crops differ by ≤ 0.8 intensity
    on ~0.5% of values (tests/test_torch_warp.py): there the sims are
    held to 2.3e-3, the bound that the features' cosine bar 1 − 1e-5
    puts on |Δsim| ≤ |Δf|/2 (as tests/test_torch_pipeline.py does)."""
    (det, rec), (jdet, jrec), frames, _ = world
    pb, jb = _banks(enrolled)
    kw = dict(max_batch=2, batch_window_ms=20, max_faces=MAX_FACES, fuse_search=fuse,
              search_top_k=TOP_K)
    cfg, jcfg, sims_atol = CFG, JCFG, 2.3e-3
    if warp == "gather":
        cfg = dataclasses.replace(CFG, warp_impl="gather")
        jcfg, sims_atol = dataclasses.replace(JCFG, warp_impl="gather"), 1e-4
    svc = IdentifyService(det.params, rec.params, pb, cfg, device="cpu", **kw)
    jsvc = JaxService(jdet.params, jrec.params, jb, jcfg, **kw)
    try:
        for round_label in ("initial", "after-enroll"):
            futs = [svc.identify_async(f, top_k=TOP_K) for f in frames]
            jfuts = [jsvc.identify_async(f, top_k=TOP_K) for f in frames]
            got = [f.result(600) for f in futs]
            want = [f.result(600) for f in jfuts]
            assert sum(int(w.valid.sum()) for w in want) > 0
            for g, w in zip(got, want):
                _same_result(g, w, sims_atol)
            # each frame's best face was enrolled: it finds itself first
            assert got[0].names[0][0] == "ann" and got[0].sims[0, 0] >= 0.999
            if round_label == "initial":  # an enroll inside the 64-row bucket
                extra = np.random.default_rng(9).normal(size=512).astype(np.float32)
                pb.add("late", extra)
                jb.add("late", extra)
        wide = svc.identify(frames[1], top_k=TOP_K + 2, timeout=600)
        jwide = jsvc.identify(frames[1], top_k=TOP_K + 2, timeout=600)
        _same_result(wide, jwide, sims_atol)
        assert all(len(wide.names[j]) == TOP_K + 2 for j in range(int(wide.valid.sum())))
        stats = svc.stats()
        assert stats["requests"] == 7 and stats["latency_ms"]["window"] == 7
    finally:
        svc.close()
        jsvc.close()
    assert not svc._worker.is_alive()


def test_close_drains_pending_futures(world, enrolled):
    (det, rec), _, frames, _ = world
    pb, _ = _banks(enrolled)
    svc = IdentifyService(det.params, rec.params, pb, CFG, max_batch=2, batch_window_ms=1,
                          max_faces=MAX_FACES, device="cpu")
    futs = [svc.identify_async(frames[i % 3]) for i in range(5)]
    svc.close()
    assert not svc._worker.is_alive()
    assert all(f.done() and f.exception() is None for f in futs)
    assert svc.stats()["requests"] == 5


@pytest.mark.parametrize("fuse", [False, True], ids=["two_dispatch", "fuse_search"])
def test_bank_growth_between_dispatch_and_resolve(world, enrolled, fuse):
    """A batch is answered against the bank version of its dispatch: rows
    enrolled before it resolves (here exact copies of the query faces,
    under other names, ahead in no tie) change nothing."""
    (det, rec), _, frames, _ = world
    pb, _ = _banks(enrolled)
    svc = IdentifyService(det.params, rec.params, pb, CFG, max_batch=2, max_faces=MAX_FACES,
                          fuse_search=fuse, search_top_k=TOP_K, device="cpu")
    svc.close()  # drive dispatch and resolve by hand
    from facerecognizeonnx_tpu_torch.pipeline.service import _Request

    def run(grow):
        batch = [_Request(image=frames[0], top_k=TOP_K), _Request(image=frames[2], top_k=TOP_K)]
        ctx = svc._dispatch(batch)
        if grow:
            pb.add_batch(["copy0", "copy1"], pb.features[:2])
            pb.remove("rand0")
        svc._resolve(ctx)
        return [r.future.result(0) for r in batch]

    before = run(grow=False)
    after = run(grow=True)
    for a, b in zip(after, before):
        _same_result(a, b)
    assert all(n != "copy0" for r in after for row in r.names for n in row)
    later = run(grow=False)  # the next batch sees the grown bank
    assert later[0].names[0][:2] == ["ann", "copy0"]


@pytest.mark.parametrize("kw", [dict(sharded=True), dict(mesh=2), dict(mesh=1, fuse_search=True),
                                dict(mesh=1, adaptive_embed=True)],
                         ids=["sharded", "mesh", "mesh_fused", "mesh_adaptive"])
def test_service_rejects_unported_options(world, enrolled, kw):
    """sharded and mesh are ported: on a one-rank Gloo mesh in process
    (mesh=2 takes the min(2, world) = 1 rank there is) the service answers
    as the plain one does. aot still loads a path."""
    (det, rec), _, _, images = world
    pb, _ = _banks(enrolled)
    cfg = dataclasses.replace(CFG)
    args = (det.params, rec.params, pb, cfg)
    opts = dict(max_batch=2, max_faces=MAX_FACES, device="cpu")
    plain_kw = {k: v for k, v in kw.items() if k in ("fuse_search", "adaptive_embed")}
    ours, plain = IdentifyService(*args, **opts, **kw), IdentifyService(*args, **opts, **plain_kw)
    try:
        for im in images[:3]:
            _same_result(ours.identify(im, top_k=TOP_K), plain.identify(im, top_k=TOP_K),
                         sims_atol=1e-6, boxes_atol=1e-5)
        if "mesh" in kw:
            assert ours.mesh is not None and ours.mesh.size() == 1
    finally:
        ours.close()
        plain.close()
    with pytest.raises(ValueError, match="sharded"):
        IdentifyService(*args, sharded=True, fuse_search=True, device="cpu")
    with pytest.raises(ModelLoadError, match="not found"):  # aot is ported: a path is loaded
        IdentifyService(det.params, rec.params, pb, dataclasses.replace(CFG), device="cpu",
                        aot="bundle.frtz")


def _camera_frames():
    """Two 720×1280 frames and a portrait 1280×720 one: their letterbox
    to the detector's 128² is not the identity."""
    rng = np.random.default_rng(13)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((720, 1280), (720, 1280), (1280, 720))]


def test_service_letterbox_matches_jax_at_camera_sizes(world, enrolled):
    """The port's service letterboxes with its native runtime, as the JAX
    service does: names, masks and boxes equal JAX's on frames whose
    letterbox rounds (the torch host letterbox truncates)."""
    (det, rec), (jdet, jrec), _, _ = world
    pb, jb = _banks(enrolled)
    kw = dict(max_batch=2, batch_window_ms=20, max_faces=MAX_FACES, search_top_k=TOP_K)
    svc = IdentifyService(det.params, rec.params, pb, CFG, device="cpu", **kw)
    jsvc = JaxService(jdet.params, jrec.params, jb, JCFG, **kw)
    try:
        images = _camera_frames()
        got = [f.result(600) for f in [svc.identify_async(im, TOP_K) for im in images]]
        want = [f.result(600) for f in [jsvc.identify_async(im, TOP_K) for im in images]]
    finally:
        svc.close()
        jsvc.close()
    assert all(w.valid.any() for w in want)
    for g, w in zip(got, want):
        # boxes: the 1e-4 bar at the detector's scale, times 1 / scale = 10
        _same_result(g, w, 2.3e-3, boxes_atol=1e-3)


@pytest.mark.parametrize("fuse", [False, True], ids=["two_dispatch", "fuse_search"])
def test_adaptive_service_matches_dense(world, enrolled, fuse):
    """IdentifyService(adaptive_embed=True) through the bucketed pipeline
    gives the dense service's names, masks and boxes (features within
    1e-5, sims likewise), on a partial last batch too."""
    (det, rec), _, frames, _ = world
    pb, _ = _banks(enrolled)
    kw = dict(max_batch=2, batch_window_ms=20, max_faces=MAX_FACES, fuse_search=fuse,
              search_top_k=TOP_K, device="cpu")
    images = list(frames) + _camera_frames()[:2]
    results = {}
    for adaptive in (False, True):
        svc = IdentifyService(det.params, rec.params, pb, CFG, adaptive_embed=adaptive, **kw)
        try:
            results[adaptive] = [f.result(600) for f in
                                 [svc.identify_async(im, TOP_K) for im in images]]
        finally:
            svc.close()
        if adaptive:
            assert svc._bucketed.steps == svc.stats()["batches"] >= 3
    assert sum(int(r.valid.sum()) for r in results[False]) > 0
    for g, w in zip(results[True], results[False]):
        _same_result(g, w, 1e-5)


def test_two_rank_service_issues_collectives_in_one_order(two_ranks):
    """Two Gloo ranks each run IdentifyService(sharded=True, mesh=2) on the
    same requests in the same order, their callers paced differently: the
    workers agree on every micro-batch, so the dp program's and the
    sharded search's collectives pair up, and every rank answers as the
    plain service does: names equal, sims within 1e-5 (float32 with the
    gather warp; a rank's batch of 1 frame may take other conv algorithms
    than the plain service's batch of 2, which moves features by ~1e-6)."""
    outs = [o["service"] for o in two_ranks.result()]
    for o in outs:
        ours, plain = o["ours"], o["plain"]
        assert ours["valid"].any()
        np.testing.assert_array_equal(ours["valid"], plain["valid"])
        np.testing.assert_array_equal(ours["names"], plain["names"])
        np.testing.assert_allclose(ours["sims"], plain["sims"], rtol=0, atol=1e-5)
    assert outs[0]["ours"]["batches"] == outs[1]["ours"]["batches"]


def test_two_rank_service_orders_bank_updates(two_ranks):
    """Bank updates (`update_bank`) submitted between the requests of the
    same two ranks, without waiting: every request is answered against
    the bank with exactly the updates submitted before it, as the plain
    service answers the same calls one at a time (each answer lists the
    whole bank, so a misplaced update changes its names)."""
    for o in (o["service"] for o in two_ranks.result()):
        ours, plain = o["ours_updates"], o["plain_updates"]
        assert ours["valid"].any()
        np.testing.assert_array_equal(ours["valid"], plain["valid"])
        np.testing.assert_array_equal(ours["names"], plain["names"])
        np.testing.assert_allclose(ours["sims"], plain["sims"], rtol=0, atol=1e-5)
        rows = (plain["names"][:, 0] >= 0).sum(-1)  # the bank's rows at each answer
        assert rows.tolist() == [20, 21, 21, 20, 20, 20]
