"""The port's detect / geometry ops vs the JAX package on the same inputs:
decode, NMS, postprocess (with bf16 score ties), top-k tie order,
Umeyama, affine helpers, the gather warp, image ops and similarity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.detect import decode as j_decode
from facerecognizeonnx_tpu.detect.pipeline import postprocess as j_postprocess
from facerecognizeonnx_tpu.match import similarity as j_sim
from facerecognizeonnx_tpu.ops import image as j_image
from facerecognizeonnx_tpu.ops import nms as j_nms
from facerecognizeonnx_tpu.ops.umeyama import umeyama as j_umeyama
from facerecognizeonnx_tpu.ops import warp as j_warp
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.detect import decode
from facerecognizeonnx_tpu_torch.detect.pipeline import postprocess
from facerecognizeonnx_tpu_torch.match import similarity
from facerecognizeonnx_tpu_torch.ops import image, nms, umeyama, warp
from facerecognizeonnx_tpu_torch.ops.topk import topk_stable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _head_outputs(rng, size=128, b=2):
    outs = {}
    for s in (8, 16, 32):
        n = (size // s) ** 2 * 2
        outs[s] = (
            rng.uniform(0, 1, (b, n, 1)).astype(np.float32),
            rng.uniform(0, 4, (b, n, 4)).astype(np.float32),
            rng.normal(0, 2, (b, n, 10)).astype(np.float32),
        )
    return outs


def test_decode_outputs_match_jax():
    outs = _head_outputs(np.random.default_rng(0))
    want = j_decode.decode_outputs(
        {s: tuple(map(jnp.asarray, v)) for s, v in outs.items()}, 128
    )
    got = decode.decode_outputs({s: tuple(map(_t, v)) for s, v in outs.items()}, 128)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        decode.anchor_centers(128, 16), j_decode.anchor_centers(128, 16)
    )


def _clustered_boxes(rng, B, K):
    """Boxes around a few centers, so suppression chains form."""
    centers = rng.uniform(20, 300, (B, 6, 2))
    pick = rng.integers(0, 6, (B, K))
    c = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 6, (B, K, 2))
    wh = rng.uniform(20, 60, (B, K, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("int_rects", [True, False])
@pytest.mark.parametrize("assume_sorted", [True, False])
def test_nms_fixed_keep_identical(int_rects, assume_sorted):
    rng = np.random.default_rng(1)
    B, K = 3, 96
    boxes = _clustered_boxes(rng, B, K)
    scores = rng.uniform(0, 1, (B, K)).astype(np.float32)
    if assume_sorted:
        scores = -np.sort(-scores, axis=-1)
    valid = rng.uniform(0, 1, (B, K)) > 0.2
    got = nms.nms_fixed(_t(boxes), _t(scores), 0.4, _t(valid), assume_sorted, int_rects)
    for b in range(B):
        want = j_nms.nms_fixed(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.4,
            jnp.asarray(valid[b]), assume_sorted, int_rects,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    assert 0 < got[2].sum() < valid.sum()  # some boxes really were suppressed


def test_topk_stable_tie_order_matches_lax():
    x = np.round(np.random.default_rng(2).uniform(0, 1, (4, 300)) * 8) / 8
    x = x.astype(np.float32)
    v, i = topk_stable(_t(x), 40)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 40)
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


@pytest.mark.parametrize("int_rects", [True, False])
def test_postprocess_bf16_ties_identical(int_rects):
    """Scores quantised to bf16 tie often; survivors and their order must
    still match the JAX postprocess exactly."""
    rng = np.random.default_rng(3)
    B, N = 2, 672
    boxes = _clustered_boxes(rng, B, N)
    kps = rng.uniform(0, 300, (B, N, 5, 2)).astype(np.float32)
    scores = np.asarray(
        jnp.asarray(rng.uniform(0.3, 0.9, (B, N)), jnp.bfloat16).astype(jnp.float32)
    )
    assert len(np.unique(scores[0])) < N // 3  # ties really are common
    kw = dict(pre_nms_topk=128, max_faces=32, nms_int_rects=int_rects)
    got = postprocess(_t(scores), _t(boxes), _t(kps), 1.0, PipelineConfig(**kw))
    for b in range(B):
        want = j_postprocess(
            jnp.asarray(scores[b]), jnp.asarray(boxes[b]), jnp.asarray(kps[b]), 1.0,
            JaxConfig(**kw),
        )
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.boxes[b].numpy(), np.asarray(want.boxes))
        np.testing.assert_array_equal(got.scores[b].numpy(), np.asarray(want.scores))
        np.testing.assert_array_equal(got.kps[b].numpy(), np.asarray(want.kps))
    assert got.count().min() > 1
    faces = type(got)(*(t[0] for t in got)).to_face_boxes()
    assert len(faces) == int(got.count()[0])
    np.testing.assert_allclose(
        [f.x2 for f in faces],
        got.boxes[0, : len(faces), 2].numpy(), rtol=1e-6,
    )


def test_umeyama_and_affines_match_jax():
    rng = np.random.default_rng(4)
    src = (
        umeyama.ARCFACE_DST_5PTS * rng.uniform(0.5, 3, (2, 4, 1, 1))
        + rng.uniform(0, 400, (2, 4, 1, 2))
        + rng.normal(0, 2, (2, 4, 5, 2))
    ).astype(np.float32)
    src[0, 1] = 50.0  # degenerate: all points coincide
    M, valid = umeyama.umeyama(_t(src), umeyama.ARCFACE_DST_5PTS)
    wM, wvalid = j_umeyama(jnp.asarray(src), umeyama.ARCFACE_DST_5PTS)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    assert not valid[0, 1]
    np.testing.assert_allclose(M.numpy(), np.asarray(wM), atol=1e-5, rtol=1e-5)

    Minv = warp.invert_affine(M)
    np.testing.assert_allclose(
        Minv.numpy(), np.asarray(j_warp.invert_affine(wM)), atol=1e-5, rtol=1e-5
    )
    zero = np.zeros((2, 3), np.float32)
    np.testing.assert_array_equal(
        warp.invert_affine(_t(zero)).numpy(), np.asarray(j_warp.invert_affine(zero))
    )
    box = np.array([[10, 20, 110, 150], [5, 5, 5.0005, 300]], np.float32)
    np.testing.assert_allclose(
        warp.crop_resize_affine(_t(box), 112, 112).numpy(),
        np.asarray(j_warp.crop_resize_affine(jnp.asarray(box), 112, 112)),
        atol=1e-5, rtol=1e-5,
    )


@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_warp_affine_batch_matches_jax(border):
    from tests.test_warp_pallas import _spread_matrices

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 320, 320, 3), dtype=np.uint8)
    Ms = _spread_matrices(rng, 2, 4)
    got = warp.warp_affine_batch(_t(frames), _t(Ms), 112, 112, border)
    want = j_warp.warp_affine_batch(jnp.asarray(frames), jnp.asarray(Ms), 112, 112, border)
    assert got.shape == want.shape == (2, 4, 112, 112, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_image_ops_match_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (90, 150, 3), dtype=np.uint8)
    assert image.letterbox_params(90, 150, 128) == j_image.letterbox_params(90, 150, 128)
    got, scale = image.letterbox(_t(img), 128)
    want, wscale = j_image.letterbox(jnp.asarray(img), 128)
    assert scale == wscale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(
        image.normalize_to_rgb(_t(img)).numpy(),
        np.asarray(j_image.normalize_to_rgb(jnp.asarray(img))),
    )


def test_similarity_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(6, 512)).astype(np.float32)
    g = rng.normal(size=(50, 512)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(j_sim.similarity_matrix(jnp.asarray(q), jnp.asarray(g)))
    np.testing.assert_allclose(
        similarity.similarity_matrix(_t(q), _t(g)).numpy(), want, atol=1e-5
    )
    np.testing.assert_allclose(
        similarity.compare_faces(_t(q), _t(q[::-1].copy())).numpy(),
        np.asarray(j_sim.compare_faces(jnp.asarray(q), jnp.asarray(q[::-1]))),
        atol=1e-6,
    )


def test_nms_chain_longer_than_one_check(monkeypatch):
    """A suppression chain of 3·ITERS_PER_CHECK boxes, each overlapping
    only the next: the fixpoint takes about one iteration per box, so
    several batches of iterations. Keep masks equal JAX's; the host is
    read once per batch of ITERS_PER_CHECK iterations, and the call is
    counted under the iterations the reference's loop runs."""
    n = 3 * nms.ITERS_PER_CHECK
    x1 = np.arange(n, dtype=np.float32) * 7.0  # neighbours' IoU 3/17, others 0
    chain = np.stack([x1, np.zeros(n), x1 + 10.0, np.full(n, 10.0)], -1).astype(np.float32)
    rng = np.random.default_rng(4)
    boxes = np.stack([chain, _clustered_boxes(rng, 1, n)[0]])
    scores = np.stack([np.linspace(1.0, 0.5, n), rng.uniform(0, 1, n)]).astype(np.float32)

    # the reference's loop: iterate until nothing changes
    iou = np.asarray(j_nms.iou_matrix(jnp.asarray(chain), jnp.asarray(chain)))
    sup = np.triu(iou > 0.1, 1)
    keep, iterations = np.ones(n, bool), 0
    while True:
        iterations += 1
        new = ~(sup & keep[:, None]).any(0)
        if (new == keep).all():
            break
        keep = new
    assert iterations > 2 * nms.ITERS_PER_CHECK

    reads = []
    for name in ("__int__", "__bool__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, real=real: reads.append(1) or real(t))
    before = nms.nms_fixed.iterations[iterations]
    got = nms.nms_fixed(_t(boxes), _t(scores), 0.1, None, False, True)
    monkeypatch.undo()
    assert len(reads) == -(-iterations // nms.ITERS_PER_CHECK)
    assert nms.nms_fixed.iterations[iterations] >= before + 1
    for b in range(2):
        want = j_nms.nms_fixed(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.1,
                               None, False, True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    assert got[2][0].numpy().tolist() == [i % 2 == 0 for i in range(n)]
