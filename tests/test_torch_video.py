"""The port's VideoPipeline vs the JAX package's, dense and adaptive.

Five 200×256 noise frames (letterboxed to the detector's 128² by each
package's native runtime, scale 0.5), micro-batches of 2 (the last one
partial), K=4 slots, float32, iresnet18; SCRFD weights calibrated and
biased by `chip_smoke.detection_bias` on the letterboxed frames, so they
carry faces. The reference feature is one detected face's own feature,
so its slot reads "Match" and the others "Unknown". The port runs its
CUDA warp's plain version, the JAX side its Pallas warp in interpret
mode. Bars: labels and masks equal across the three runs; features of
the two port paths within 1e-5, against JAX cosine ≥ 1 − 1e-5
(tests/test_torch_pipeline.py's bar).
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import detection_bias
from facerecognizeonnx_tpu.pipeline.video import VideoPipeline as JaxVideo
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.pipeline.video import VideoPipeline
from facerecognizeonnx_tpu_torch.runtime.native import letterbox_native
from tests.test_torch_bucketed import CFG, JCFG
from tests.test_torch_models import _np_tree, iresnet_calibrated, scrfd_calibrated
from tests.test_torch_native_runtime import jax_native_built

K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    jax_native_built()  # the JAX pipeline's PrefetchLoader letterboxes with it
    rng = np.random.default_rng(17)
    frames = [rng.integers(0, 256, (200, 256, 3), dtype=np.uint8) for _ in range(5)]
    boxed = np.stack([letterbox_native(f, 128)[0] for f in frames])
    det_tree = detection_bias(_np_tree(scrfd_calibrated(size=128)), torch.from_numpy(boxed))
    rec_tree = _np_tree(iresnet_calibrated())
    det, rec = (bridge.params_from_numpy(t, "cpu") for t in (det_tree, rec_tree))
    first = list(VideoPipeline(det, rec, CFG, batch=2, max_faces_embed=K,
                               device="cpu").run(iter(frames[:1])))
    ref = first[0][2][0]  # frame 0's first face
    out = {}
    for adaptive in (False, True):
        pipe = VideoPipeline(det, rec, CFG, batch=2, max_faces_embed=K, adaptive_embed=adaptive,
                             device="cpu")
        out[adaptive] = list(pipe.run(iter(frames), ref_feature=ref))
        out[adaptive, "stats"] = pipe.stats()
    with jax.default_matmul_precision("highest"):
        out["jax"] = list(JaxVideo(det_tree, rec_tree, JCFG, batch=2, max_faces_embed=K)
                          .run(iter(frames), ref_feature=ref))
    return frames, (det, rec), ref, out


def test_dense_and_adaptive_labels_equal_jax(runs):
    _, _, _, out = runs
    dense, adaptive, ref = out[False], out[True], out["jax"]
    assert len(dense) == len(adaptive) == len(ref) == 5
    labels = [r[3] for r in dense]
    assert labels[0][0] == "Match" and any("Unknown" in lab for lab in labels)
    for d, a, j in zip(dense, adaptive, ref):
        assert d[0] == a[0] == j[0]
        assert d[3] == a[3] == j[3]
        np.testing.assert_array_equal(d[1].valid, np.asarray(j[1].valid))
        np.testing.assert_array_equal(a[1].valid, d[1].valid)
        np.testing.assert_allclose(a[2], d[2], atol=1e-5, rtol=0)
        slot = d[1].valid[:K]
        assert (d[2] * np.asarray(j[2])).sum(-1)[slot].min() >= 1 - 1e-5
        # boxes in original pixels: the detector's 1e-3 bar times 1 / scale
        np.testing.assert_allclose(d[1].boxes, np.asarray(j[1].boxes), atol=2e-3, rtol=0)
    for adaptive in (False, True):
        stats = out[adaptive, "stats"]
        assert stats["count"] == 3 and stats["frames_per_sec"] > 0


def test_max_frames_stops_the_stream(runs):
    frames, (det, rec), ref, _ = runs

    def endless():
        while True:
            yield from frames

    pipe = VideoPipeline(det, rec, CFG, batch=2, max_faces_embed=K, adaptive_embed=True,
                         device="cpu")
    got = list(pipe.run(endless(), ref_feature=ref, max_frames=3))
    assert [r[0] for r in got] == [0, 1, 2]


def test_observability_timer_counter_and_trace(tmp_path):
    from facerecognizeonnx_tpu_torch.utils import observability as obs
    from facerecognizeonnx_tpu_torch.utils.observability import Counter, trace

    obs.reset()
    for _ in range(3):  # inactive: nothing is timed or counted
        with obs.span("a"):
            obs.count("faces", 8)
    assert obs.snapshot() == {"spans": {}, "counters": {}}
    obs.enable()
    try:
        for _ in range(3):
            with obs.span("a"):
                obs.count("faces", 8)
                torch.ones(4).sum()
        snap = obs.snapshot()
    finally:
        obs.enable(False)
        obs.reset()
    assert snap["spans"]["a"]["calls"] == 3 and snap["spans"]["a"]["host_s"] > 0
    assert snap["counters"] == {"faces": 24}
    counter = Counter("faces")
    with counter.event(items=8):
        pass
    summary = counter.summary()
    assert summary["count"] == 1 and summary["faces_per_sec"] > 0
    with trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0 and log_dir.endswith("trace")
