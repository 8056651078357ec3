"""The CUDA warp's plain-torch version vs the JAX x-major Pallas kernel
(interpret mode), and the wrapper's CPU dispatch.

`warp_affine_xm_reference` computes what csrc/warp_xm.cu computes, in
the same f32 ops; on the card the kernel is held against it by
chip_smoke.py. Here it is held against `warp_affine_pallas(...,
layout="xmajor", interpret=True)` on the same frames and matrices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.ops.warp_pallas import build_pyramid_xm as j_build_pyramid
from facerecognizeonnx_tpu.ops.warp_pallas import warp_affine_pallas
from facerecognizeonnx_tpu_torch.ops import warp_cuda
from tests.test_warp_banded import _face_matrix

EPI = (127.5, 128.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrices(rng, B, H, W):
    """Per frame: levels 0-3 (source extents ~70 to ~1300 px, the last
    beyond level-3 coverage), rotations, windows at the frame's edges,
    and one all-zero (degenerate) matrix."""
    faces = []
    for b in range(B):
        faces.append([
            _face_matrix(rng, scale=0.6, theta=0.3, tx=W * 0.4, ty=H * 0.3),
            _face_matrix(rng, scale=1.3, theta=-0.7, tx=W - 20, ty=H - 30),
            _face_matrix(rng, scale=2.6, theta=0.1, tx=-15, ty=10),
            _face_matrix(rng, scale=5.0, theta=1.2, tx=W * 0.5, ty=H - 5),
            _face_matrix(rng, scale=11.0, theta=-0.4, tx=W * 0.7, ty=H * 0.2),
            np.zeros((2, 3), np.float32) if b == 0 else
            _face_matrix(rng, scale=0.9, theta=3.0, tx=W - 5, ty=5),
        ])
    return np.asarray(faces, np.float32)


SHAPES = [(640, 640), (251, 317)]  # the largest frame, and odd sides


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def case(request):
    H, W = request.param
    rng = np.random.default_rng(H)
    frames = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    Ms = _matrices(rng, 2, H, W)
    valid = np.array([[1, 0, 1, 1, 0, 1], [0, 1, 1, 0, 1, 1]], bool)
    return frames, Ms, valid


def _jax(frames, Ms, **kw):
    return np.asarray(
        warp_affine_pallas(
            jnp.asarray(frames), jnp.asarray(Ms), interpret=True, layout="xmajor", **kw
        )
    ).astype(np.float32)


def _port(frames, Ms, **kw):
    return warp_cuda.warp_affine_xm_reference(
        torch.from_numpy(frames), torch.from_numpy(Ms), **kw
    )


def test_face_levels_cover_0_to_3(case):
    _, Ms, _ = case
    prm = warp_cuda.face_params_xm(torch.from_numpy(Ms))
    assert set(prm[:, 0].tolist()) == {0.0, 1.0, 2.0, 3.0}
    assert torch.isfinite(prm).all()


def test_pyramid_equals_jax_levels(case):
    frames, _, _ = case
    B, H, W, _ = frames.shape
    got = warp_cuda.build_pyramid(torch.from_numpy(frames))  # levels 1-3
    want = np.asarray(j_build_pyramid(jnp.asarray(frames))).astype(np.float32)
    assert got.dtype == torch.uint8
    assert got.shape == (B, warp_cuda.upper_levels_bytes(H, W))
    off = 0
    for lvl, (h, w) in enumerate(warp_cuda.level_sizes(H, W)):
        if lvl == 0:  # level 0 is the frame itself
            level = frames
        else:
            level = got[:, off: off + 3 * h * w].reshape(B, h, w, 3).numpy()
            off += 3 * h * w
        # JAX canvas: (B, level, channel, x, y), zero outside the level
        np.testing.assert_array_equal(
            level.transpose(0, 3, 2, 1), want[:, lvl, :, :w, :h]
        )
        assert not want[:, lvl, :, w:, :].any() and not want[:, lvl, :, :, h:].any()
    assert off == got.shape[1]


def test_raw_matches_pallas_interpret(case):
    frames, Ms, _ = case
    got = _port(frames, Ms)
    want = _jax(frames, Ms)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()  # the zero matrix stays finite
    d = np.abs(got.numpy() - want)
    # measured on this CPU: max 0.80 (640x640) and 0.77 (251x317), on ~0.5%
    # of the values: one-ulp flips of a bf16 y weight where XLA rounds lx/ly
    # differently (FMA); the rest agree to ~1e-3
    assert d.max() <= 1.0, d.max()


def test_epilogue_matches_pallas_interpret(case):
    frames, Ms, _ = case
    got = _port(frames, Ms, epilogue=EPI)
    want = _jax(frames, Ms, epilogue=EPI)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    # measured on this CPU: max 0.0078 (one bf16 ulp at 1.0)
    assert d.max() <= 2.0 / 128.0 + 0.01, d.max()
    raw = _port(frames, Ms)
    normalized = (raw.flip(-1) - EPI[0]) / EPI[1]
    assert (got.float() - normalized).abs().max() <= 2.0 / 128.0 + 0.01


@pytest.mark.parametrize("epilogue", [None, EPI], ids=["raw", "epilogue"])
def test_valid_skip(case, epilogue):
    frames, Ms, valid = case
    got = _port(frames, Ms, epilogue=epilogue, valid=torch.from_numpy(valid))
    full = _port(frames, Ms, epilogue=epilogue)
    assert (got[torch.from_numpy(~valid)] == 0).all()
    torch.testing.assert_close(got[torch.from_numpy(valid)], full[torch.from_numpy(valid)],
                               rtol=0, atol=0)
    want = _jax(frames, Ms, epilogue=epilogue, valid=jnp.asarray(valid))
    assert (want[~valid] == 0).all()
    bar = 1.0 if epilogue is None else 2.0 / 128.0 + 0.01
    assert np.abs(got.float().numpy() - want).max() <= bar


def test_wrapper_on_cpu_takes_plain_version(case):
    frames, Ms, valid = case
    before = warp_cuda.warp_affine_xm.launches
    got = warp_cuda.warp_affine_xm(
        torch.from_numpy(frames), torch.from_numpy(Ms), EPI, torch.from_numpy(valid)
    )
    want = _port(frames, Ms, epilogue=EPI, valid=torch.from_numpy(valid))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert warp_cuda.warp_affine_xm.launches == before == 0


def test_wrapper_rejects_bad_inputs():
    from facerecognizeonnx_tpu_torch.errors import InvalidInputError

    frames = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    Ms = torch.zeros((1, 2, 2, 3))
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine_xm(frames.float(), Ms)
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine_xm(torch.zeros((1, 700, 64, 3), dtype=torch.uint8), Ms)
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine_xm(frames, torch.zeros((2, 2, 2, 3)))
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine_xm(frames, Ms, valid=torch.ones((1, 3), dtype=torch.bool))


# ------------------------------------------------ the edges of the face table


@pytest.fixture(scope="module")
def sweep():
    from chip_smoke import _table_inputs, table_sweep_matrices

    M = table_sweep_matrices()
    extent = _table_inputs(M)[0]
    rng = np.random.default_rng(160)
    frames = rng.integers(0, 256, (M.shape[0] // 8, 160, 160, 3), dtype=np.uint8)
    return frames, M.reshape(-1, 8, 2, 3), extent


def test_table_sweep_matches_pallas_interpret(sweep):
    """The adversarial sweep of chip_smoke.py (extents at COVER·2^l and
    the float32 values beside them, window minima on and one ulp off
    16 / 128, singular and overflowing inverses, translations past
    ±30000) through the plain version and the Pallas kernel.

    XLA on the CPU contracts the span 111·(|a|+|b|) + 2 into an FMA, so a
    face whose level ratio lies within a few ulps of a power of two may
    take the next level there: measured on this CPU, 1 face of 320 (max
    |Δ| 98.9 on that face), every other face within the raw bar."""
    frames, Ms, extent = sweep
    got = _port(frames, Ms).numpy()
    want = _jax(frames, Ms)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    d = np.abs(got - want).reshape(len(extent), -1).max(axis=1)
    off = np.nonzero(d > 1.0)[0]
    ratio = extent[off].astype(np.float64) / 110.0
    near_pow2 = np.abs(ratio / 2.0 ** np.round(np.log2(ratio)) - 1.0) < 8 * 2.0 ** -23
    assert len(off) <= 2 and near_pow2.all(), (off, d[off], extent[off])


def test_table_sweep_levels_and_fixed_point(sweep):
    _, Ms, extent = sweep
    prm = warp_cuda.face_params_xm(torch.from_numpy(Ms)).numpy()
    finite = np.isfinite(prm).all(axis=1)
    assert finite.sum() >= len(prm) - 2  # only the overflowing inverses give NaN
    lvl = prm[finite, 0]
    assert set(lvl.tolist()) == {0.0, 1.0, 2.0, 3.0}
    # the level is the ceil of log2(extent / COVER), the quotient taken as
    # a product with the float32 reciprocal, as XLA and torch on CUDA do
    ratio = extent[finite] * np.float32(1.0 / 110.0)
    np.testing.assert_array_equal(lvl, np.clip(np.ceil(np.log2(np.maximum(ratio, 1e-6))), 0, 3))
    np.testing.assert_array_equal(prm[finite, 1] % 16, 0)
    np.testing.assert_array_equal(prm[finite, 2] % 128, 0)
    assert np.abs(prm[finite, 3:7]).max() <= 2000.0 and np.abs(prm[finite, 7:]).max() <= 30000.0
    np.testing.assert_array_equal(prm[finite, 3:7] * 2.0 ** 20 % 1, 0)
    np.testing.assert_array_equal(prm[finite, 7:] * 2.0 ** 16 % 1, 0)


@pytest.mark.parametrize("hw", [(8, 8), (9, 13)], ids=["8x8", "9x13"])
def test_pyramid_small_frames_equal_jax_levels(hw):
    """Level 3 of an 8x8 frame is one pixel; 9x13 drops odd edges."""
    H, W = hw
    frames = np.random.default_rng(H * W).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    got = warp_cuda.build_pyramid(torch.from_numpy(frames))
    want = np.asarray(j_build_pyramid(jnp.asarray(frames))).astype(np.float32)
    off = 0
    for lvl, (h, w) in enumerate(warp_cuda.level_sizes(H, W)[1:], start=1):
        level = got[:, off: off + 3 * h * w].reshape(2, h, w, 3).numpy()
        off += 3 * h * w
        np.testing.assert_array_equal(level.transpose(0, 3, 2, 1), want[:, lvl, :, :w, :h])
    assert off == got.shape[1] == warp_cuda.upper_levels_bytes(H, W)


def test_kernel_launchers_take_cuda_tensors_only():
    """On the CPU the wrappers run the plain versions and count nothing; the
    launchers themselves refuse CPU tensors rather than fall back."""
    from facerecognizeonnx_tpu_torch.errors import InvalidInputError

    frames = torch.zeros((1, 32, 48, 3), dtype=torch.uint8)
    Ms = torch.zeros((1, 2, 2, 3))
    pyr = warp_cuda.build_pyramid(frames)
    assert pyr.shape == (1, warp_cuda.upper_levels_bytes(32, 48))
    assert warp_cuda.build_pyramid.launches == 0
    with pytest.raises(InvalidInputError, match="CUDA"):
        warp_cuda.resample_xm(frames, pyr, Ms)
    with pytest.raises(InvalidInputError, match="CUDA"):
        warp_cuda.resample_ym(frames, pyr, Ms)
    with pytest.raises(InvalidInputError, match="CUDA"):
        warp_cuda.resample_ym(frames, pyr, Ms, xpass_bf16=True)
