"""The gallery top-k paths and `GalleryBank` of the port vs the JAX package.

`gallery_topk_reference` is the plain version of csrc/gallery_topk.cu
(held against the kernel on the card by chip_smoke.py); here it, the
wrapper's CPU dispatch and `gallery_topk_tiled` are held against the
JAX Pallas kernel (interpret mode) and the JAX XLA paths, and the port's
`GalleryBank` against the JAX `GalleryBank` on the same rows. Sims on
both sides are float32 matmuls summed in different orders, so they agree
to ~1e-7; the bar is the JAX kernel test's 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.match.gallery import GalleryBank as JaxBank
from facerecognizeonnx_tpu.ops.pallas_gallery import (
    gallery_topk_pallas,
)
from facerecognizeonnx_tpu.ops.pallas_gallery import (
    gallery_topk_reference as j_reference,
)
from facerecognizeonnx_tpu.ops.pallas_gallery import (
    gallery_topk_tiled as j_tiled,
)
from facerecognizeonnx_tpu_torch.errors import KernelError
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.ops import gallery_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normed(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port(fn, q, g, *args, **kw):
    s, i = fn(torch.from_numpy(q), torch.from_numpy(g), *args, **kw)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("g,k,tile", [(512, 5, 128), (1000, 8, 256), (130, 3, 128)])
def test_plain_version_matches_pallas_and_xla(rng, g, k, tile):
    queries, gallery = _normed(rng, 4), _normed(rng, g)
    s_p, i_p = gallery_topk_pallas(
        jnp.asarray(queries), jnp.asarray(gallery), k, tile=tile, interpret=True
    )
    s_x, i_x = j_reference(jnp.asarray(queries), jnp.asarray(gallery), k)
    for fn in (gallery_cuda.gallery_topk_reference, gallery_cuda.gallery_topk_cuda):
        s, i = _port(fn, queries, gallery, k)
        for s_j, i_j in ((s_p, i_p), (s_x, i_x)):
            np.testing.assert_array_equal(i, np.asarray(i_j))
            np.testing.assert_allclose(s, np.asarray(s_j), atol=1e-5)


def test_planted_ties_come_lowest_index_first(rng):
    """Duplicate rows give exactly equal sims; both packages return them
    in ascending index order (lax.top_k's order, _merge_topk's first
    maximum)."""
    gallery = _normed(rng, 300)
    gallery[[40, 7, 250, 199]] = gallery[123]  # five copies of one row
    queries = gallery[[123, 5]].copy()
    s_p, i_p = gallery_topk_pallas(
        jnp.asarray(queries), jnp.asarray(gallery), 6, tile=128, interpret=True
    )
    s, i = _port(gallery_cuda.gallery_topk_cuda, queries, gallery, 6)
    np.testing.assert_array_equal(i[0, :5], [7, 40, 123, 199, 250])
    np.testing.assert_array_equal(i, np.asarray(i_p))
    assert (s[0, :5] == s[0, 0]).all()
    np.testing.assert_allclose(s, np.asarray(s_p), atol=1e-5)


def test_padding_never_wins_and_self_query_first(rng):
    queries = _normed(rng, 2)
    gallery = _normed(rng, 5) * 0.01  # low-similarity rows, k = G
    s, i = _port(gallery_cuda.gallery_topk_cuda, queries, gallery, 5)
    assert i.max() < 5 and np.isfinite(s).all()
    assert sorted(i[0].tolist()) == [0, 1, 2, 3, 4]
    gallery = _normed(rng, 64)
    s, i = _port(gallery_cuda.gallery_topk_cuda, gallery[:3], gallery, 2)
    np.testing.assert_array_equal(i[:, 0], [0, 1, 2])
    np.testing.assert_allclose(s[:, 0], 1.0, atol=1e-5)


@pytest.mark.parametrize("k,tile", [(5, 128), (16, 512)])
def test_tiled_matches_jax_tiled(rng, k, tile):
    queries, gallery = _normed(rng, 6, 64), _normed(rng, 1500, 64)
    s_j, i_j = j_tiled(jnp.asarray(queries), jnp.asarray(gallery), k, tile=tile)
    s, i = _port(gallery_cuda.gallery_topk_tiled, queries, gallery, k, tile=tile)
    np.testing.assert_array_equal(i, np.asarray(i_j))
    np.testing.assert_allclose(s, np.asarray(s_j), atol=1e-5)
    with pytest.raises(ValueError):
        gallery_cuda.gallery_topk_tiled(torch.zeros(1, 4), torch.zeros(8, 4), 9, tile=8)


def test_bf16_storage_recall_parity(rng):
    """bf16 rows at rest (float32 products and sums) keep the top-1 and
    ≥ 99% of the top-5 of the f32 search, as in the JAX package's test,
    and agree with the JAX bf16 path."""
    g = _normed(rng, 20_000, 512)
    q = torch.from_numpy(g[:256])
    gt = torch.from_numpy(g)
    _, i32 = gallery_cuda.gallery_topk_reference(q, gt, 5)
    sbf, ibf = gallery_cuda.gallery_topk_reference(q, gt, 5, storage_dtype=torch.bfloat16)
    s32 = gallery_cuda.gallery_topk_reference(q, gt, 5)[0]
    i32, ibf = i32.numpy(), ibf.numpy()
    np.testing.assert_array_equal(i32[:, 0], ibf[:, 0])
    overlap = np.mean([len(set(a) & set(b)) / 5.0 for a, b in zip(i32, ibf)])
    assert overlap >= 0.99, overlap
    np.testing.assert_allclose(sbf.numpy(), s32.numpy(), atol=5e-3)
    s_j, _ = j_reference(jnp.asarray(g[:256]), jnp.asarray(g), 5, storage_dtype=jnp.bfloat16)
    np.testing.assert_allclose(sbf.numpy(), np.asarray(s_j), atol=1e-5)


def test_wrapper_on_cpu_takes_plain_version_and_checks_k(rng):
    queries, gallery = _normed(rng, 3), _normed(rng, 600)
    before = gallery_cuda.gallery_topk_cuda.launches
    got = _port(gallery_cuda.gallery_topk_cuda, queries, gallery, 4)
    want = _port(gallery_cuda.gallery_topk_reference, queries, gallery, 4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert gallery_cuda.gallery_topk_cuda.launches == before == 0
    with pytest.raises(KernelError, match="512"):
        gallery_cuda.gallery_topk_cuda(torch.from_numpy(queries), torch.from_numpy(gallery), 513)
    with pytest.raises(KernelError, match="rows"):
        gallery_cuda.gallery_topk_cuda(torch.from_numpy(queries), torch.from_numpy(gallery[:3]), 4)


def test_split_plan_covers_the_gallery():
    for Q, G, qt in [(128, 100_000, 64), (2048, 1_000_000, 64), (128, 100_000, 16),
                     (3, 5, 64), (1, 129, 16)]:
        rows, splits = gallery_cuda.split_plan(Q, G, qt, 132)
        assert rows % gallery_cuda.ROWS_PER_TILE == 0
        assert rows * splits >= G > rows * (splits - 1)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
    (+2^12 on the magnitude bits, then drop the low 13)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _sims_3xtf32(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """What csrc/gallery_topk.cu sums: hi*hi + (hi*lo + lo*hi), hi and lo
    the TF32 parts of each operand, then (s + 1) * 0.5 (test only)."""
    q_hi, g_hi = _tf32_rna(q), _tf32_rna(g)
    q_lo, g_lo = _tf32_rna(q - q_hi), _tf32_rna(g - g_hi)
    big = q_hi @ g_hi.t()
    small = q_hi @ g_lo.t() + q_lo @ g_hi.t()
    return (big + small + 1.0) * 0.5


def test_tf32_split_rounds_half_away_and_is_exact_in_sum():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), 0.1, -3.7e-3])
    hi = _tf32_rna(x)
    np.testing.assert_array_equal(hi[:3].numpy(), [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                                   -(1.0 + 2.0 ** -10)])
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(hi + (x - hi), x)  # the split loses nothing before lo's rounding


@pytest.mark.parametrize("k", [5, 512])
def test_3xtf32_products_match_jax_reference(k):
    """The kernel's product precision (3xTF32) against the JAX package's
    float32 reference at Q=16, G=4,096, D=512: sims within the 1e-5 bar
    (measured on this CPU: max |Δ| 1.2e-7 at k=5, 6.0e-8 at k=512), indices identical outside
    1e-5 near-ties, planted duplicates tied exactly and lowest index first."""
    from chip_smoke import check_topk
    from facerecognizeonnx_tpu_torch.ops.topk import topk_stable

    rng = np.random.default_rng(k)
    gallery = _normed(rng, 4096, 512)
    gallery[[300, 17, 4000]] = gallery[2048]  # exact copies of one row
    queries = _normed(rng, 16, 512)
    queries[0] = gallery[2048]
    s_j, i_j = j_reference(jnp.asarray(queries), jnp.asarray(gallery), k + 1)
    s_j, i_j = torch.from_numpy(np.array(s_j)), torch.from_numpy(np.array(i_j))
    sims = _sims_3xtf32(torch.from_numpy(queries), torch.from_numpy(gallery))
    v, i = topk_stable(sims, k)
    err, ties = check_topk(v, i.to(torch.int32), s_j[:, :k], i_j[:, :k], s_j[:, k])
    assert err <= 1e-5, err
    assert i[0, :4].tolist() == [17, 300, 2048, 4000] and ties >= 3


# ---------------------------------------------------------------- GalleryBank


@pytest.fixture(scope="module")
def banks():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(150, 512)).astype(np.float32) * 3.0  # unnormalized
    feats[17] = feats[90] * 2.0  # a duplicate enrollment under another name
    names = [f"p{i % 60}" for i in range(150)]
    port, jax_bank = GalleryBank(device="cpu"), JaxBank()
    for b in (port, jax_bank):
        b.add_batch(names[:100], feats[:100])
        for n, f in zip(names[100:], feats[100:]):
            b.add(n, f)
    queries = _normed(rng, 7, 512)
    queries[0] = feats[90] / np.linalg.norm(feats[90])
    return port, jax_bank, queries


def _assert_same_search(port, jax_bank, queries, top_k, method, jax_method):
    n_p, s_p = port.search(queries, top_k, method=method)
    n_j, s_j = jax_bank.search(queries, top_k, method=jax_method)
    assert n_p == n_j
    np.testing.assert_allclose(s_p, s_j, atol=1e-5)


@pytest.mark.parametrize(
    "method,jax_method", [("auto", "auto"), ("dense", "xla"), ("tiled", "tiled"),
                          ("cuda", "xla")],
)
def test_bank_search_matches_jax(banks, method, jax_method):
    port, jax_bank, queries = banks
    np.testing.assert_allclose(port.features, jax_bank.features, rtol=1e-6, atol=1e-7)
    assert port.names == jax_bank.names and len(port) == len(jax_bank) == 150
    for top_k in (1, 5, 400):  # 400 > rows: clamped to the 150 rows
        _assert_same_search(port, jax_bank, queries, top_k, method, jax_method)
    names, sims = port.search(queries[0], 2, method=method)  # one (D,) query
    assert names[0] == ["p17", "p30"] and sims.shape == (1, 2)


def test_bank_mutations_match_jax(banks):
    port0, jax0, queries = banks
    port, jax_bank = GalleryBank(device="cpu"), JaxBank()
    for b, src in ((port, port0), (jax_bank, jax0)):
        b.add_batch(src.names, src.features)
    assert port.remove("p3") == jax_bank.remove("p3") == 3
    assert port.remove("nobody") == jax_bank.remove("nobody") == 0
    port.search(queries, 3)  # fills the device cache
    cache = port._store.cache
    assert port.rename("p4", "q4") == jax_bank.rename("p4", "q4") == 3
    assert port._store.cache is cache  # a rename keeps the device rows
    assert port.names == jax_bank.names
    _assert_same_search(port, jax_bank, queries, 5, "dense", "xla")
    port.add("zero", np.zeros(512, np.float32))
    jax_bank.add("zero", np.zeros(512, np.float32))
    np.testing.assert_array_equal(port.features[-1], 0.0)
    _assert_same_search(port, jax_bank, queries, 5, "auto", "auto")


def test_bank_dense_bf16_at_rest_matches_jax(banks):
    port, jax_bank, queries = banks
    n_p, s_p = port.search(queries, 5, method="dense", storage_dtype=torch.bfloat16)
    n_j, s_j = jax_bank.search(queries, 5, method="xla", storage_dtype=jnp.bfloat16)
    assert [r[0] for r in n_p] == [r[0] for r in n_j]
    np.testing.assert_allclose(s_p, s_j, atol=1e-5)
    assert port._device_feats(torch.bfloat16).dtype == torch.bfloat16


def test_bank_find_duplicates_and_padded_match_jax(banks):
    port, jax_bank, _ = banks
    d_p, d_j = port.find_duplicates(0.6, chunk=64), jax_bank.find_duplicates(0.6, chunk=64)
    assert [(a, b) for a, b, _ in d_p] == [(a, b) for a, b, _ in d_j]
    np.testing.assert_allclose([s for *_, s in d_p], [s for *_, s in d_j], atol=1e-5)
    assert d_p[0][:2] == ("p17", "p30") and d_p[0][2] == pytest.approx(1.0, abs=1e-5)
    dev, n, names = port.device_bank_padded()
    jdev, jn, jnames = jax_bank.device_bank_padded()
    assert dev.shape == tuple(jdev.shape) == (256, 512) and n == jn == 150
    assert names == jnames
    np.testing.assert_allclose(dev.numpy(), np.asarray(jdev), atol=1e-7)
    assert port.device_bank_padded()[0] is dev  # cached on the store version
    empty = GalleryBank(device="cpu")
    assert empty.device_bank_padded()[0].shape == (64, 512) and empty.find_duplicates() == []
    names, sims = empty.search(np.zeros((2, 512), np.float32), 3)
    assert names == [[], []] and sims.shape == (2, 0)


def test_bank_npz_cross_loads(banks, tmp_path):
    port, jax_bank, queries = banks
    port.save(str(tmp_path / "port.npz"))
    jax_bank.save(str(tmp_path / "jax.npz"))
    from_port = JaxBank.load(str(tmp_path / "port.npz"))
    from_jax = GalleryBank.load(str(tmp_path / "jax.npz"), device="cpu")
    assert from_port.names == from_jax.names == port.names
    np.testing.assert_array_equal(from_port.features, port.features)
    np.testing.assert_array_equal(from_jax.features, jax_bank.features)
    _assert_same_search(from_jax, from_port, queries, 5, "dense", "xla")


def test_bank_rejects_jax_names_and_unported_options(banks):
    from facerecognizeonnx_tpu_torch.errors import GalleryError, InvalidInputError

    port, _, queries = banks
    with pytest.raises(ValueError, match="'dense'"):
        port.search(queries, method="xla")
    with pytest.raises(ValueError, match="'cuda'"):
        port.search(queries, method="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.search(queries, sharded=True)
    with pytest.raises(InvalidInputError):
        port.search(np.zeros((2, 7), np.float32))
    with pytest.raises(GalleryError):
        port.add("x", np.zeros(7, np.float32))
    with pytest.raises(GalleryError):
        GalleryBank.load("/nonexistent/bank.npz", device="cpu")


def test_auto_rule_is_the_jax_boundary():
    """method="auto" streams through the kernel only past Q·G = 2·10⁹, and
    only on a CUDA bank (a CPU bank always takes the dense path)."""
    from facerecognizeonnx_tpu_torch.match.gallery import auto_uses_kernel

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert auto_uses_kernel(2_048, 1_000_000, cuda)  # 2.05e9
    assert not auto_uses_kernel(2_000, 1_000_000, cuda)  # exactly 2e9
    assert not auto_uses_kernel(2_048, 1_000_000, cpu)
