"""The port's ArcFace train step on real Gloo ranks against the JAX
step on its (4, 2) virtual-device mesh.

Four CPU ranks (`tests/torch_ranks.py`) each take one SGD step from each
of three JAX states on three meshes: pure data parallel (4, 1), pure
model parallel (1, 4: the classifier split by columns) and (2, 2). The
JAX package takes the same steps on its (4 data × 2 model) mesh. Each
rank's state after each step is held as in tests/test_torch_train_step.py
(`hold_step`: loss rel 1e-5; classifier, momentum and BN statistics
elementwise at 1e-4 of the leaf's scale; the backbone's update and
momentum at 1e-2 relative L2, for the float32 kinks of PReLU). The
classifier blocks are the JAX classifier's column blocks, equal on
every rank of a "data" line. A train-state checkpoint saved on the
(2, 2) mesh and loaded back is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig
from facerecognizeonnx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facerecognizeonnx_tpu.train.trainer import init_train_state, make_train_step
from tests.test_torch_train_step import hold_step
from tests.torch_ranks import run_ranks

WORLD = 4
C, B, SIZE, LR = 16, 8, 32, 0.1


def _arrays(h):
    return {"params": h.params, "classifier": h.classifier, "trace": h.opt_state[0].trace[0],
            "trace_cls": h.opt_state[0].trace[1], "step": h.step}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(5)
    cfg = JaxConfig(compute_dtype="float32", rec_input_size=SIZE)
    mesh = jax_make_mesh(("data", "model"), (4, 2))
    state = init_train_state(jax.random.PRNGKey(0), num_classes=C, cfg=cfg,
                             arch="iresnet18", mesh=mesh, lr=LR)
    images = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    step = make_train_step(mesh, cfg, lr=LR)
    states, losses = [jax.device_get(state)], []
    with mesh:
        for _ in range(3):
            state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
            states.append(jax.device_get(state))
            losses.append(float(loss))
    inputs = {f"s{k}": _arrays(states[k]) for k in range(3)}
    inputs.update(images=images, labels=labels, lr=np.float32(LR))
    outs = run_ranks(tmp_path_factory.mktemp("train_ranks"), WORLD, ["train"], inputs)
    return outs, states, losses


@pytest.mark.parametrize("case,n_model", [("dp", 1), ("mp", WORLD), ("dxm", 2)])
def test_mesh_train_step_matches_jax(runs, case, n_model):
    outs, states, losses = runs
    for k in range(3):
        got = [outs[r]["train"][case][f"s{k}"] for r in range(WORLD)]
        # rank r holds the classifier columns of its "model" index, r % n_model
        blocks = {key: np.concatenate([got[m][key] for m in range(n_model)], axis=1)
                  for key in ("classifier", "trace_cls")}
        for r in range(WORLD):
            m = r % n_model
            for key in ("classifier", "trace_cls"):
                np.testing.assert_array_equal(got[r][key], got[m][key])
            assert abs(float(got[r]["loss"]) - losses[k]) <= 1e-5 * abs(losses[k])
            assert int(got[r]["step"]) == k + 1
            hold_step({**got[r], **blocks}, states[k + 1], states[k])


def test_mesh_checkpoint_round_trip(runs):
    outs, _, _ = runs
    assert all(int(outs[r]["train"]["ckpt_equal"]) == 1 for r in range(WORLD))
