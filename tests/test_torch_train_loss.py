"""The port's ArcFace loss (train/arcface_loss.py) against the JAX
package's on the same seeded numpy inputs (float32, CPU).

Tolerances: margin logits and the mean cross entropy within 1e-6 (of
the logits' scale s=64: relative); their gradients with respect to the
features and the classifier within 1e-5 of each gradient's scale; the
partial-FC cross entropy (`partial_fc_xent`) on all columns equal to
`softmax_xent` within 1e-6, its objective's gradient within 1e-6 of the
cross entropy's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.train.arcface_loss import arcface_margin_logits as jax_margin
from facerecognizeonnx_tpu.train.arcface_loss import softmax_xent as jax_xent
from facerecognizeonnx_tpu_torch.train.arcface_loss import (
    arcface_margin_logits,
    init_classifier,
    partial_fc_xent,
    softmax_xent,
)

D, C, B = 64, 24, 8


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(B, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    w = rng.normal(size=(D, C)).astype(np.float32) * 0.7  # normalized inside the loss
    labels = rng.integers(0, C, B).astype(np.int32)
    return feats, w, labels


def test_init_classifier_unit_columns_and_seeded():
    a = init_classifier(torch.Generator().manual_seed(7), D, C, device="cpu")
    b = init_classifier(torch.Generator().manual_seed(7), D, C, device="cpu")
    assert a.shape == (D, C) and a.dtype == torch.float32
    torch.testing.assert_close(a.norm(dim=0), torch.ones(C), rtol=0, atol=1e-6)
    assert torch.equal(a, b)
    assert not torch.equal(a, init_classifier(torch.Generator().manual_seed(8), D, C,
                                              device="cpu"))


@pytest.mark.parametrize("margin", [0.5, 0.0])
def test_margin_logits_and_xent_match_jax(inputs, margin):
    feats, w, labels = inputs
    want = np.asarray(jax_margin(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(labels),
                                 margin=margin))
    got = arcface_margin_logits(torch.from_numpy(feats), torch.from_numpy(w),
                                torch.from_numpy(labels).long(), margin=margin)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=64 * 1e-6)
    xent = float(softmax_xent(got, torch.from_numpy(labels)))
    assert xent == pytest.approx(float(jax_xent(jnp.asarray(want), jnp.asarray(labels))),
                                 rel=1e-6)
    # a block of columns with its offset: the same columns of the full logits
    block = arcface_margin_logits(torch.from_numpy(feats), torch.from_numpy(w[:, 8:16]),
                                  torch.from_numpy(labels).long(), margin=margin, col_offset=8)
    np.testing.assert_allclose(block.numpy(), got.numpy()[:, 8:16], rtol=0, atol=64 * 1e-6)


def test_loss_gradients_match_jax(inputs):
    feats, w, labels = inputs

    def jax_loss(f, c):
        return jax_xent(jax_margin(f, c, jnp.asarray(labels)), jnp.asarray(labels))

    gf, gc = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    f = torch.from_numpy(feats).requires_grad_(True)
    c = torch.from_numpy(w.copy()).requires_grad_(True)
    loss = softmax_xent(arcface_margin_logits(f, c, torch.from_numpy(labels).long()),
                        torch.from_numpy(labels))
    tf, tc = torch.autograd.grad(loss, (f, c))
    for got, want in ((tf, gf), (tc, gc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_partial_fc_xent_equals_softmax_xent(inputs):
    feats, w, labels = inputs
    logits = arcface_margin_logits(torch.from_numpy(feats), torch.from_numpy(w),
                                   torch.from_numpy(labels).long())
    x = logits.detach().requires_grad_(True)
    y = torch.from_numpy(labels).long()
    loss_rows, objective = partial_fc_xent(x, y)
    want = softmax_xent(x, y)
    assert float(loss_rows.mean()) == pytest.approx(float(want.detach()), rel=1e-6)
    (g_obj,) = torch.autograd.grad(objective.sum() / B, x)
    (g_xent,) = torch.autograd.grad(want, x)
    torch.testing.assert_close(g_obj, g_xent, rtol=0, atol=1e-6)
