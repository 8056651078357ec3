"""The y-major warp's plain version vs the JAX y-major Pallas kernel
(interpret mode), and `warp_cuda.warp_affine`'s dispatch.

`warp_affine_ym_reference` (`face_params_ym` + `resample_ym_reference`)
computes what csrc/warp_ym.cu computes, in the same f32 ops and bf16
rounding points; on the card the kernel's table and crops are held against
it bit for bit by chip_smoke.py. Here it is held against
`warp_affine_pallas(..., layout="ymajor", interpret=True)` — the default
layout of that entry point — on the x-major tests' frames and matrices
(pyramid levels 0-3, frame edges, a degenerate matrix) and on the y-major
sweep of the table's edges (`chip_smoke.table_sweep_matrices(layout=
"ymajor")`).
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


# ------------------------------------------------ the edges of the y-major table


@pytest.fixture(scope="module")
def ym_sweep():
    from chip_smoke import _table_inputs, table_sweep_matrices

    M = table_sweep_matrices(layout="ymajor")
    extent, x_min, y_min = _table_inputs(M)
    rng = np.random.default_rng(161)
    frames = rng.integers(0, 256, (M.shape[0] // 8, 160, 160, 3), dtype=np.uint8)
    return frames, M.reshape(-1, 8, 2, 3), extent, x_min, y_min


def test_ymajor_table_sweep_matches_pallas_interpret(ym_sweep):
    """The y-major sweep (extents at COVER·2^l and the float32 values beside
    them, window minima on and one ulp off 128 / 16, origins at and past the
    512 / 528 clips, singular and overflowing inverses, translations past
    ±30000) through the plain version and the Pallas kernel, at the raw bar
    of `test_raw_matches_pallas_interpret`.

    As in the x-major sweep, XLA on the CPU contracts the span 111·(|a|+|b|)
    + 2 into an FMA, so a face whose level ratio lies within a few ulps of a
    power of two may take the next level there: at most 2 such faces
    (measured on this CPU: 1, max |Δ| 98.3 on it). The y-major table has no
    fixed point to clip its coefficients (the x-major one clips them to
    ±2000), so on a singular matrix, whose determinant the inverse raises to
    1e-12, coefficients of ~1e11-1e14 cancel in a·j + b·i + tx, and XLA's
    FMA there moves the result anywhere in the window (measured: the two
    rank-1 matrices of the sweep, max |Δ| 137 and 43.3). A face whose
    inverse overflows (NaN entries; 1 face here) gives NaN crops in both;
    every other face is finite."""
    frames, Ms, extent, _, _ = ym_sweep
    got = _port(frames, Ms).numpy().reshape(len(extent), -1)
    want = _jax(frames, Ms).reshape(len(extent), -1)
    nan_table = ~torch.isfinite(warp_cuda.face_params_ym(torch.from_numpy(Ms))).all(1).numpy()
    assert nan_table.sum() <= 2
    assert np.isfinite(got[~nan_table]).all() and np.isfinite(want[~nan_table]).all()
    assert not np.isfinite(got[nan_table]).any() and not np.isfinite(want[nan_table]).any()
    d = np.where(nan_table, 0.0, np.abs(got - want).max(axis=1))
    M = Ms.reshape(-1, 2, 3)
    with np.errstate(over="ignore", invalid="ignore"):  # the overflowing specials
        singular = np.abs(M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0]) < 1e-12
    off = np.nonzero((d > 1.0) & ~singular)[0]
    ratio = extent[off].astype(np.float64) / 110.0
    near_pow2 = np.abs(ratio / 2.0 ** np.round(np.log2(ratio)) - 1.0) < 8 * 2.0 ** -23
    assert len(off) <= 2 and near_pow2.all(), (off, d[off], extent[off])
    assert singular.sum() <= 8  # the sweep's singular specials only


def test_ymajor_table_sweep_invariants(ym_sweep):
    """Levels 0-3 all hit; the origin on its 128 (x) / 16 (y) grid within its
    clips, reached at and past them; the level is the ceil of log2(extent /
    COVER), the quotient taken as a product with the float32 reciprocal."""
    _, Ms, extent, x_min, y_min = ym_sweep
    prm = warp_cuda.face_params_ym(torch.from_numpy(Ms)).numpy()
    finite = np.isfinite(prm).all(axis=1)
    assert finite.sum() >= len(prm) - 2  # only the overflowing inverses give NaN
    lvl, x_lo, y_lo = prm[finite, 0], prm[finite, 1], prm[finite, 2]
    assert set(lvl.tolist()) == {0.0, 1.0, 2.0, 3.0}
    ratio = extent[finite] * np.float32(1.0 / 110.0)
    np.testing.assert_array_equal(lvl, np.clip(np.ceil(np.log2(np.maximum(ratio, 1e-6))), 0, 3))
    np.testing.assert_array_equal(x_lo % 128, 0)
    np.testing.assert_array_equal(y_lo % 16, 0)
    assert x_lo.min() >= 0 and x_lo.max() == 512 and y_lo.min() >= 0 and y_lo.max() == 528
    # the clips are reached from beyond them, and each grid line from within
    # two ulps on either side
    assert (x_min[finite][x_lo == 512] >= 640).any() and (y_min[finite][y_lo == 528] >= 544).any()
    lines = [(x_min, 128.0 * m) for m in range(1, 7)] + [
        (y_min, 16.0 * m) for m in (1, 2, 3, 8, 16, 32, 33, 34, 35, 41)]
    for v, line in lines:
        ulp = np.spacing(np.float32(line))
        assert ((v < line) & (v >= line - 2 * ulp)).any(), line
        assert ((v >= line) & (v <= line + 2 * ulp)).any(), line


def test_kernel_tap_arithmetic_equals_the_plain_version():
    """The float32 shortcuts csrc/warp_ym.cu takes (it cannot run here; the
    card holds its crops against the plain version bit for bit), checked
    against the plain version's own operations over the clipped coordinate
    range:
      - hat weights: f = l - floor(l), h0 = 1 - f, h1 = 1 - h0 equal
        max(0, 1 - |l - floor(l)|) and max(0, 1 - |l - (floor(l) + 1)|);
      - w * byte as fma(w, 2^23 + byte, -w * 2^23) for bf16 weights w;
      - floor(l) as int: the bits of floor(l) + 1.5 * 2^23, less 0x4B400000."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    ulps = (f32(1.0) + np.arange(-64, 65) * f32(2.0 ** -23)).astype(f32)
    l = np.concatenate([
        rng.uniform(-2.0, 258.0, 200_000).astype(f32),
        (np.arange(-2, 258)[:, None] * ulps[None, :]).ravel().astype(f32),  # near integers
        -np.logspace(-30, 0, 2_000).astype(f32), np.logspace(-30, 0, 2_000).astype(f32),
    ])
    l = np.clip(l, f32(-2.0), f32(257.0))
    fl = np.floor(l)
    h0 = f32(1.0) - (l - fl)
    h1 = f32(1.0) - h0
    np.testing.assert_array_equal(h0, np.maximum(f32(0.0), f32(1.0) - np.abs(l - fl)))
    np.testing.assert_array_equal(h1, np.maximum(f32(0.0), f32(1.0) - np.abs(l - (fl + f32(1.0)))))
    ints = ((fl + f32(12582912.0)).view(np.int32) - 0x4B400000)
    np.testing.assert_array_equal(ints, fl.astype(np.int32))

    w = torch.from_numpy(np.concatenate([h0, h1])).to(torch.bfloat16).float().numpy()
    b = rng.integers(0, 256, w.shape).astype(f32)
    biased = (0x4B000000 | b.astype(np.uint32)).view(f32)
    np.testing.assert_array_equal(biased, f32(8388608.0) + b)
    # the FMA's single rounding of an exact value: exact in float64, then rounded
    fma = (w.astype(np.float64) * biased + (w * f32(-8388608.0)).astype(np.float64)).astype(f32)
    np.testing.assert_array_equal(fma, w * b)
