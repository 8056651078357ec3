"""The port's debug helpers (utils/debug.py) vs the JAX package's on the
same numpy trees (tests/test_debug_ckpt.py:11-33), on tensors and
modules, and the port's `nan_checks`, a global forward hook."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognizeonnx_tpu.utils import debug as j_debug
from facerecognizeonnx_tpu_torch import bridge
from facerecognizeonnx_tpu_torch.models.layers import Linear
from facerecognizeonnx_tpu_torch.utils.debug import nan_checks, tree_summary, validate_params

TREES = {
    "good": {"a": np.ones(3, np.float32), "b": [np.zeros(2, np.float32)]},
    "nan_and_empty": {"a": np.asarray([1.0, np.nan], np.float32), "e": np.zeros(0)},
    "nested": {"z": {"w": np.full((2, 2), np.inf, np.float32), "n": None},
               "a": [np.ones(1), (np.asarray([np.nan, 1, np.nan]), np.arange(3))]},
    "integers": {"i": np.arange(4, dtype=np.int32), "k": [np.zeros((0, 3), np.int8)]},
}


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("form", ["numpy", "torch"])
def test_validate_params_and_tree_summary_match_jax(name, form):
    tree = TREES[name]
    want = j_debug.validate_params(tree)
    got = validate_params(tree if form == "numpy" else _as_tensors(tree))
    assert got == want
    assert tree_summary(tree if form == "numpy" else _as_tensors(tree)) == \
        j_debug.tree_summary(tree)


def test_validate_params_flags_nans():
    """tests/test_debug_ckpt.py's case, on tensors and a module."""
    assert validate_params({"a": torch.ones(3), "b": [torch.zeros(2)]}) == []
    problems = validate_params({"a": torch.tensor([1.0, float("nan")]), "e": torch.zeros(0)})
    assert len(problems) == 2
    assert any("non-finite" in p for p in problems)
    assert any("empty" in p for p in problems)
    lin = Linear(torch.ones(2, 3), torch.tensor([0.0, float("inf")]))
    assert validate_params(lin, "fc") == ["fc['bias']: 1/2 non-finite values"]
    assert validate_params({"x": torch.tensor([1.0, float("nan")], dtype=torch.bfloat16)})


def test_tree_summary_of_a_module():
    model = bridge.params_from_numpy(bridge.init_params_numpy("iresnet18", seed=0), "cpu")
    state = model.state_dict()
    assert tree_summary(model) == (len(state), sum(t.numel() for t in state.values()))
    assert tree_summary({"a": jnp.ones((2, 3)), "b": torch.ones(4)}) == (2, 10)


def test_nan_checks_raises_and_names_the_module():
    """The first module output holding a NaN or an infinity raises while
    the context is open; the hook is gone afterwards."""
    bad = Linear(torch.tensor([[1.0, float("nan")]]))
    x = torch.ones(1, 2)
    with pytest.raises(FloatingPointError, match="Linear"):
        with nan_checks():
            bad(x)
    assert torch.isnan(bad(x)).all()  # restored: no check outside the context
    inf = Linear(torch.tensor([[3e38, 3e38]]))
    with pytest.raises(FloatingPointError, match="1/1"):
        with nan_checks():
            inf(x)


def test_nan_checks_pass_a_finite_model():
    model = bridge.params_from_numpy(bridge.init_params_numpy("500m", seed=1), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad(), nan_checks():
        out = model(x)
    assert set(out) == {8, 16, 32}
