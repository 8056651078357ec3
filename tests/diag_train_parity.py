"""How far the port's ArcFace train step lies from the JAX package's, on
the CPU: the measurement behind the tolerances of
tests/test_torch_train_step.py and tests/test_torch_train_parallel.py.

    python tests/diag_train_parity.py [--seeds 10] [--lr 0.1]

For each seed (iresnet18 at 32², C=16, B=8, float32, the JAX state from
PRNGKey(0) on a 1×1 mesh) it prints, for each of 3 steps taken by both
packages from the JAX state of that step: the loss's relative error,
and the relative L2 error over the whole backbone of the update (new −
old params) and of the momentum; then the loss's relative error at each
of 3 free-running steps (each package stepping from its own state).
First it prints, per model family, the largest difference of the
train-mode outputs and of the BN batch statistics (the mean against the
channel's standard deviation, the variance relative). A PReLU input
within float32 noise of 0 can take the other side of the kink in one
package: a step where that happens reads 1e-4–1e-2 where the others
read ~5e-6.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from facerecognizeonnx_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from facerecognizeonnx_tpu.models import recognizer_apply as jax_recognizer_apply  # noqa: E402
from facerecognizeonnx_tpu.models import scrfd as jax_scrfd  # noqa: E402
from facerecognizeonnx_tpu.parallel.mesh import make_mesh  # noqa: E402
from facerecognizeonnx_tpu.train.trainer import init_train_state, make_train_step  # noqa: E402
from facerecognizeonnx_tpu_torch import bridge  # noqa: E402
from facerecognizeonnx_tpu_torch.config import PipelineConfig  # noqa: E402
from facerecognizeonnx_tpu_torch.models import recognizer_apply  # noqa: E402
from facerecognizeonnx_tpu_torch.models.layers import make_trainable  # noqa: E402
from facerecognizeonnx_tpu_torch.train.trainer import make_train_step as port_step  # noqa: E402
from facerecognizeonnx_tpu_torch.utils.checkpoint import _flatten  # noqa: E402

C, B, SIZE = 16, 8, 32


def forward_errors():
    rng = np.random.default_rng(2)
    for arch, size in (("iresnet18", 32), ("mbf", 32), ("vit_t", 32), ("500m", 64)):
        tree = bridge.init_params_numpy(arch, seed=3, input_size=size)
        x = rng.uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
        model = make_trainable(bridge.params_from_numpy(tree, device="cpu"))
        if arch == "500m":
            jout, jst = jax.jit(lambda p, x: jax_scrfd.apply(p, x, train=True))(tree, x)
            out, st = model(torch.from_numpy(x), train=True)
            jout, out = np.asarray(jout[8][1]), out[8][1].detach().numpy()
        else:
            jout, jst = jax.jit(lambda p, x: jax_recognizer_apply(p, x, jnp.float32,
                                                                  train=True))(tree, x)
            out, st = recognizer_apply(model, torch.from_numpy(x), torch.float32, train=True)
            jout, out = np.asarray(jout), out.detach().numpy()
        em = max(float(np.max(np.abs(st[k][0].numpy() - np.asarray(m)) / np.sqrt(np.asarray(v))))
                 for k, (m, v) in jst.items())
        ev = max(float(np.max(np.abs(st[k][1].numpy() - np.asarray(v)) / np.asarray(v)))
                 for k, (_, v) in jst.items())
        print(f"{arch:10s} output max|d| {np.abs(out - jout).max():.2e}  BN mean {em:.2e}  "
              f"var {ev:.2e}")


def _l2(a, b, keys):
    da = np.concatenate([np.asarray(a[k]).ravel() for k in keys])
    db = np.concatenate([np.asarray(b[k]).ravel() for k in keys])
    return float(np.linalg.norm(da - db) / np.linalg.norm(db))


def step_errors(seeds: int, lr: float):
    cfg = JaxConfig(compute_dtype="float32", rec_input_size=SIZE)
    mesh = make_mesh(("data", "model"), (1, 1), devices=jax.devices()[:1])
    start = jax.device_get(init_train_state(jax.random.PRNGKey(0), num_classes=C, cfg=cfg,
                                            arch="iresnet18", mesh=mesh, lr=lr))
    jstep = make_train_step(mesh, cfg, lr=lr)
    pstep = port_step(None, PipelineConfig(compute_dtype="float32", rec_input_size=SIZE), lr=lr)

    def port_state(h):
        return bridge.train_state_from_numpy(h.params, h.classifier, h.opt_state, h.step,
                                             device="cpu")

    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.integers(0, C, B).astype(np.int32)
        row, free = [], []
        state, free_port = jax.device_put(start), port_state(start)
        for _ in range(3):
            before = jax.device_get(state)
            with mesh:
                state, jloss = jstep(state, jnp.asarray(x), jnp.asarray(y))
            after = jax.device_get(state)
            forced, ploss = pstep(port_state(before), x, y)
            free_port, floss = pstep(free_port, x, y)
            p0, pj = _flatten(before.params), _flatten(after.params)
            pp = _flatten(bridge.tree_from_module(forced.model))
            w = [k for k in pj if not k.endswith(("/mean", "/var"))]
            tp = _flatten(bridge.tree_from_tensors(forced.model, forced.opt_state["trace"]))
            upd = _l2({k: pp[k] - np.asarray(p0[k]) for k in w},
                      {k: np.asarray(pj[k]) - np.asarray(p0[k]) for k in w}, w)
            mom = _l2(tp, _flatten(after.opt_state[0].trace[0]), w)
            row.append(f"loss {abs(float(ploss) - float(jloss)) / abs(float(jloss)):.0e} "
                       f"update {upd:.0e} momentum {mom:.0e}")
            free.append(f"{abs(float(floss) - float(jloss)) / abs(float(jloss)):.0e}")
        print(f"seed {seed}: " + " | ".join(row) + "  free-running loss " + " ".join(free))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.1)
    args = ap.parse_args()
    torch.set_num_threads(4)
    forward_errors()
    step_errors(args.seeds, args.lr)


if __name__ == "__main__":
    main()
