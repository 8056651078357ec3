"""The y-major warp's plain version vs the JAX y-major Pallas kernel
(interpret mode), and `warp_cuda.warp_affine`'s dispatch.

`warp_affine_ym_reference` computes what csrc/warp_ym.cu computes, in
the same f32 ops and bf16 rounding points; on the card the kernel is held
against it by chip_smoke.py. Here it is held against
`warp_affine_pallas(..., layout="ymajor", interpret=True)` — the default
layout of that entry point — on the x-major tests' frames and matrices
(pyramid levels 0-3, frame edges, a degenerate matrix).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.ops.warp_pallas import warp_affine_pallas
from facerecognizeonnx_tpu_torch.errors import InvalidInputError
from facerecognizeonnx_tpu_torch.ops import warp_cuda
from tests.test_torch_warp import SHAPES, _matrices
from tests.test_warp_pallas import _spread_matrices


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def case(request):
    H, W = request.param
    rng = np.random.default_rng(H)
    frames = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    return frames, _matrices(rng, 2, H, W)


def _jax(frames, Ms, **kw):
    return np.asarray(
        warp_affine_pallas(jnp.asarray(frames), jnp.asarray(Ms), interpret=True, **kw)
    )


def _port(frames, Ms, **kw):
    return warp_cuda.warp_affine(torch.from_numpy(frames), torch.from_numpy(Ms), **kw)


def test_face_levels_cover_0_to_3(case):
    _, Ms = case
    prm = warp_cuda.face_params_ym(torch.from_numpy(Ms))
    assert set(prm[:, 0].tolist()) == {0.0, 1.0, 2.0, 3.0}
    assert (prm[:, 1] % 128 == 0).all() and (prm[:, 2] % 16 == 0).all()
    assert (prm[:, 1] <= 512).all() and (prm[:, 2] <= 528).all()


def test_raw_matches_pallas_interpret(case):
    frames, Ms = case
    got = _port(frames, Ms)
    want = _jax(frames, Ms)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()  # the zero matrix stays finite
    d = np.abs(got.numpy() - want)
    # measured on this CPU: max 0.85 (640x640) and 0.59 (251x317); 1.3% and
    # 0.9% of the values differ at all, 0.17% and 0.14% by more than 1e-3:
    # one-ulp flips of a bf16 y weight where XLA rounds lx/ly differently
    # (FMA), as on the x-major kernel
    assert d.max() <= 1.0, d.max()
    assert (d > 1e-3).mean() < 0.01


def test_xpass_bf16_matches_pallas_interpret(case):
    """Two bf16 roundings apart at most. The port rounds each x-pass
    product to bf16 as the TPU kernel's types say; XLA on the CPU keeps
    those products in f32 (excess precision), so ~7% of values sit one
    bf16 ulp of the sum apart (measured max 1.0 at 640x640, 2.0 at
    251x317)."""
    frames, Ms = case
    got = _port(frames, Ms, xpass_bf16=True)
    want = _jax(frames, Ms, xpass_bf16=True)
    d = np.abs(got.numpy() - want)
    assert d.max() <= 2.0, d.max()
    assert (d > 1e-3).mean() < 0.1


def test_xpass_bf16_within_lsb_of_f32(case):
    """The bars of the JAX kernel's own bf16 x-pass test."""
    frames, Ms = case
    d = (_port(frames, Ms, xpass_bf16=True) - _port(frames, Ms)).abs().numpy()
    assert np.percentile(d, 99) <= 1.0, np.percentile(d, 99)
    assert d.max() <= 2.5, d.max()


def test_ymajor_matches_xmajor(rng):
    """The two layouts agree within the JAX test's bars (they differ only
    in window geometry and the x-major fixed point)."""
    frames = rng.integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
    Ms = _spread_matrices(rng, 2, 4).astype(np.float32)
    ym = _port(frames, Ms)
    xm = _port(frames, Ms, layout="xmajor")
    d = (ym - xm).abs().numpy()
    assert d.max() <= 2.0, d.max()
    assert np.median(d) <= 0.5


def test_degenerate_matrix_stays_finite():
    frames = np.zeros((1, 640, 640, 3), np.uint8)
    got = _port(frames, np.zeros((1, 1, 2, 3), np.float32))
    assert torch.isfinite(got).all()


def test_dispatch_and_options(case):
    frames, Ms = case
    f, m = torch.from_numpy(frames), torch.from_numpy(Ms)
    before = (warp_cuda.warp_affine_xm.launches, warp_cuda.warp_affine_ym.launches)
    ym = warp_cuda.warp_affine(f, m)
    torch.testing.assert_close(ym, warp_cuda.warp_affine_ym_reference(f, m), rtol=0, atol=0)
    torch.testing.assert_close(warp_cuda.warp_affine(f, m, unroll=3), ym, rtol=0, atol=0)
    torch.testing.assert_close(
        warp_cuda.warp_affine(f, m, layout="xmajor"),
        warp_cuda.warp_affine_xm_reference(f, m), rtol=0, atol=0,
    )
    # CPU tensors take the plain versions: no launch is counted
    assert (warp_cuda.warp_affine_xm.launches, warp_cuda.warp_affine_ym.launches) == before
    assert before == (0, 0)
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine(f, m, epilogue=(127.5, 128.0))
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine(f, m, valid=torch.ones(m.shape[:2], dtype=torch.bool))
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine(f, m, layout="zmajor")
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine(f, m, unroll=0)
    with pytest.raises(InvalidInputError):
        warp_cuda.warp_affine(f, m, out_size=96)
