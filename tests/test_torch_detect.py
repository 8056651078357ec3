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


def _kernel_transcription(boxes, valid, threshold, int_rects):
    """csrc/nms_greedy.cu in numpy, for the CPU: float32 IoU in the
    kernel's order (every numpy float32 op rounds once, as the kernel's
    _rn intrinsics do), suppression rows of 32-bit words for the valid
    candidates only, and the scan word by word, lowest pending bit first."""
    f = np.float32
    B, K, _ = boxes.shape
    W = (K + 31) // 32
    keep = np.zeros((B, K), bool)
    with np.errstate(invalid="ignore", divide="ignore"):
        for b in range(B):
            x1, y1, x2, y2 = (boxes[b, :, c].astype(f) for c in range(4))
            if int_rects:
                w, h = np.trunc(x2 - x1), np.trunc(y2 - y1)
                x1, y1 = np.trunc(x1), np.trunc(y1)
                x2, y2 = x1 + w, y1 + h
            area = (x2 - x1) * (y2 - y1)
            iw = np.maximum(np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1), f(0))
            ih = np.maximum(np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1), f(0))
            inter = iw * ih
            iou = inter / np.maximum((area[:, None] + area) - inter, f(1e-12))
            rows = (iou > f(threshold)) & np.triu(np.ones((K, K), bool), 1)
            rows &= valid[b][:, None]  # only a valid candidate's row is computed
            bits = np.zeros((K, W * 32), np.uint64)
            bits[:, :K] = rows
            mask = [[int(v) for v in r] for r in
                    (bits.reshape(K, W, 32) << np.arange(32, dtype=np.uint64)).sum(-1)]
            valid_w = [sum(1 << i for i in range(32) if 32 * w + i < K and valid[b, 32 * w + i])
                       for w in range(W)]
            removed = [0] * W
            for w in range(W):
                pending = valid_w[w] & ~removed[w]
                while pending:
                    bit = (pending & -pending).bit_length() - 1
                    keep[b, 32 * w + bit] = True
                    removed = [r | m for r, m in zip(removed, mask[32 * w + bit])]
                    pending &= ~(1 << bit) & ~removed[w]
    return keep


@pytest.mark.parametrize("int_rects", [True, False])
@pytest.mark.parametrize("B, K", [(1, 512), (16, 64)])
def test_nms_kernel_transcription_matches_plain_and_jax_at_the_edge(B, K, int_rects):
    """chip_smoke's sweep of overlaps at IoU 0.4 (exactly, or within a few
    ulps), with holes in the valid mask: the kernel's algorithm and
    rounding order (transcribed) give the plain fixpoint's mask, which is
    JAX's."""
    from chip_smoke import nms_edge_boxes

    rng = np.random.default_rng(5)
    boxes = nms_edge_boxes(rng, B, K, int_rects)
    valid = rng.uniform(0, 1, (B, K)) > 0.15
    plain = nms.nms_greedy(_t(boxes), _t(valid), 0.4, int_rects).numpy()
    np.testing.assert_array_equal(_kernel_transcription(boxes, valid, 0.4, int_rects), plain)
    scores = jnp.arange(K, 0, -1).astype(jnp.float32)
    for b in range(B):
        want = j_nms.nms_fixed(jnp.asarray(boxes[b]), scores, 0.4, jnp.asarray(valid[b]),
                               True, int_rects)[2]
        np.testing.assert_array_equal(plain[b], np.asarray(want))
    ib = nms._int_rects(_t(boxes)) if int_rects else _t(boxes)
    ulps = (nms.iou_matrix(ib, ib).view(torch.int32) - torch.tensor(0.4).view(torch.int32)).abs()
    assert int((ulps <= 4).sum()) >= 2 * B  # the sweep reaches the edge
    assert 0 < plain.sum() < valid.sum()


def _chain_case():
    n = 3 * nms.ITERS_PER_CHECK
    x1 = np.arange(n, dtype=np.float32) * 7.0
    chain = np.stack([x1, np.zeros(n), x1 + 10.0, np.full(n, 10.0)], -1).astype(np.float32)
    rng = np.random.default_rng(4)
    boxes = np.stack([chain, _clustered_boxes(rng, 1, n)[0]])
    scores = np.stack([np.linspace(1.0, 0.5, n), rng.uniform(0, 1, n)]).astype(np.float32)
    return boxes, scores, np.ones((2, n), bool), 0.1


@pytest.mark.parametrize("case", ["chain", "clustered_int_rects", "clustered_float",
                                  "edge_sweep"])
def test_nms_custom_op_in_an_exported_program_equals_eager(case):
    """torch.export traces nms_fixed with the NMS as one custom-op node
    (no data-dependent Python); the program gives eager nms_fixed's
    outputs, the chain of tests above included."""
    rng = np.random.default_rng(9)
    int_rects = case != "clustered_float"
    if case == "chain":
        boxes, scores, valid, thr = _chain_case()
    elif case == "edge_sweep":
        from chip_smoke import nms_edge_boxes

        boxes = nms_edge_boxes(rng, 2, 128, True)
        scores = np.tile(np.linspace(1, 0, 128, dtype=np.float32), (2, 1))
        valid, thr = rng.uniform(0, 1, (2, 128)) > 0.2, 0.4
    else:
        boxes = _clustered_boxes(rng, 3, 96)
        scores = rng.uniform(0, 1, (3, 96)).astype(np.float32)
        valid, thr = rng.uniform(0, 1, (3, 96)) > 0.2, 0.4

    class Step(torch.nn.Module):
        def forward(self, b, s, v):
            return nms.nms_fixed(b, s, thr, v, False, int_rects)

    args = (_t(boxes), _t(scores), _t(valid))
    ep = torch.export.export(Step(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("frt.nms_greedy.default") == 1, targets
    for g, w in zip(ep.module()(*args), nms.nms_fixed(*args[:2], thr, args[2], False,
                                                      int_rects)):
        assert torch.equal(g, w)
    assert 0 < int(ep.module()(*args)[2].sum()) < valid.sum()


@pytest.mark.parametrize("case", ["box_shape", "valid_dtype", "valid_shape"])
def test_nms_greedy_rejects_bad_inputs(case):
    from facerecognizeonnx_tpu_torch.errors import InvalidInputError

    boxes, valid = torch.zeros((2, 8, 4)), torch.ones((2, 8), dtype=torch.bool)
    if case == "box_shape":
        boxes = torch.zeros((2, 8, 5))
    elif case == "valid_dtype":
        valid = valid.to(torch.uint8)
    else:
        valid = valid[:, :7]
    with pytest.raises(InvalidInputError):
        nms.nms_greedy(boxes, valid, 0.4)
