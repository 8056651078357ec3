"""The port's banded warp (plain torch) vs the JAX package's
`ops/warp_banded.py`, and the config names of the reference's warps.

The bars are `tests/test_warp_banded.py`'s: against the exact gather
warp, level-0 faces within a median of 0.5 and a maximum of 2.0
intensity units (bf16 hat weights), 2.0 on a face off the frame's
corner, and a mean within 3.0 and a correlation above 0.9 on a face
that takes a mip level. Against the JAX banded warp on the same inputs
the bar is one intensity unit (a bf16 weight one ulp apart); measured
equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.ops.warp_banded import build_pyramid as j_build_pyramid
from facerecognizeonnx_tpu.ops.warp_banded import warp_affine_banded as j_warp_banded
from facerecognizeonnx_tpu_torch.config import PipelineConfig
from facerecognizeonnx_tpu_torch.ops.warp import warp_affine_batch
from facerecognizeonnx_tpu_torch.ops.warp_banded import build_pyramid, warp_affine_banded
from tests.test_warp_banded import _face_matrix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(2, 256, 256, 3), (1, 301, 257, 3)])
def test_pyramid_equals_jax(shape):
    frames = _frames(0, shape)
    got = build_pyramid(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_build_pyramid(jnp.asarray(frames))))


def test_banded_equals_jax_banded():
    """Levels 0-3, rotations, a face off the frame and a degenerate
    matrix, on 300x257 frames."""
    rng = np.random.default_rng(1)
    frames = _frames(2, (2, 300, 257, 3))
    Ms = np.stack([[
        _face_matrix(rng, 1.0, 0.3, 100, 120), _face_matrix(rng, 0.2, 0.2, 50, 40),
        _face_matrix(rng, 2.5, -0.7, 250, 10), _face_matrix(rng, 0.6, 1.0, -20, 280),
    ] for _ in range(2)]).astype(np.float32)
    Ms[1, 3] = 0.0
    got = warp_affine_banded(torch.from_numpy(frames), torch.from_numpy(Ms)).numpy()
    want = np.asarray(j_warp_banded(jnp.asarray(frames), jnp.asarray(Ms)))
    assert got.shape == want.shape == (2, 4, 112, 112, 3)
    assert np.abs(got - want).max() <= 1.0


@pytest.mark.parametrize("theta", [0.0, 0.3, -0.7])
def test_level0_matches_gather_warp(theta):
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(_frames(4, (1, 640, 640, 3)))
    Ms = torch.from_numpy(np.stack(
        [_face_matrix(rng, 1.0, theta, 200, 150) for _ in range(2)])[None])
    diff = (warp_affine_banded(frames, Ms) - warp_affine_batch(frames, Ms, 112, 112)).abs()
    assert diff.median() <= 0.5 and diff.max() <= 2.0


def test_zero_border_large_face_and_degenerate_matrix():
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(np.random.default_rng(6).integers(
        1, 256, (1, 640, 640, 3), dtype=np.uint8))
    Ms = torch.from_numpy(np.stack([
        _face_matrix(rng, 1.0, 0.0, -56, -56),  # hangs off the top-left corner
        _face_matrix(rng, 0.2, 0.2, 50, 40),  # source extent 560 px: level >= 2
        np.zeros((2, 3), np.float32),
    ])[None])
    got = warp_affine_banded(frames, Ms)[0]
    ref = warp_affine_batch(frames, Ms, 112, 112)[0]
    assert (got[0] - ref[0]).abs().max() <= 2.0 and got[0, :40, :40].max() == 0.0
    assert abs(float(got[1].mean() - ref[1].mean())) < 3.0
    assert np.corrcoef(got[1].ravel().numpy(), ref[1].ravel().numpy())[0, 1] > 0.9
    assert torch.isfinite(got[2]).all()


def test_reference_warp_names_construct_and_run():
    """The reference's names: "banded" runs the banded warp, "pallas" the
    x-major CUDA warp (here its plain version), bit for bit as "cuda"."""
    from facerecognizeonnx_tpu_torch.embed.pipeline import _align_matrices, align_faces_batch
    from facerecognizeonnx_tpu_torch.ops.image import normalize_to_rgb

    rng = np.random.default_rng(7)
    frames = torch.from_numpy(_frames(8, (1, 160, 160, 3)))
    kps = torch.from_numpy(rng.uniform(40, 110, (1, 3, 5, 2)).astype(np.float32))
    boxes = torch.tensor([[[30.0, 30.0, 120.0, 120.0]] * 3])
    valid = torch.tensor([[True, False, True]])
    out = {}
    for impl in ("gather", "banded", "cuda", "pallas"):
        cfg = dataclasses.replace(PipelineConfig(), warp_impl=impl)
        out[impl] = align_faces_batch(frames, kps, boxes, cfg, valid, normalized=True)
    assert torch.equal(out["pallas"], out["cuda"])
    banded = warp_affine_banded(frames, _align_matrices(kps, boxes, 160, 160, 112))
    want = normalize_to_rgb(banded, 127.5, 128.0) * valid[..., None, None, None]
    assert torch.equal(out["banded"], want)
    assert not torch.equal(out["banded"], out["gather"])
    with pytest.raises(ValueError, match="warp_impl"):
        PipelineConfig(warp_impl="mosaic")
