"""ArcFace train step, data × model parallel (partial-FC).

Port of `facerecognizeonnx_tpu/train/trainer.py` on `torch.distributed`
(see `parallel/mesh.py` for what a mesh is here). Every rank calls the
step with the same global batch:

  - images / labels: each rank takes its block along "data";
  - backbone: replicated; its BN batch statistics are averaged over
    "data" with autograd through the collective (the statistics of the
    global batch, as GSPMD computes them), and its gradients summed over
    "data" (the loss is already divided by the global batch);
  - classifier (D, C): split by columns over "model"; the log-normalizer
    is an all-reduce of row maxima and sums of exponentials
    (`partial_fc_xent`), and the gradient of the features, which are
    replicated over "model", is summed there;
  - optimizer: SGD with momentum, `optax.sgd`'s formula (trace = g +
    m·trace, update = −lr(count)·trace with a schedule read at the
    0-based count); the BN running stats are updated with the step's
    batch statistics after the update.

mesh=None runs on one device with no collective; a one-rank mesh gives
the same numbers. `remat=True` recomputes the backbone forward in the
backward pass (`torch.utils.checkpoint`, non-reentrant); the BN
statistics are those of the first forward.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from facerecognizeonnx_tpu_torch.config import PipelineConfig, resolve_device
from facerecognizeonnx_tpu_torch.models import recognizer_apply
from facerecognizeonnx_tpu_torch.models.layers import (
    l2_normalize,
    make_trainable,
    trainable_tensors,
    update_bn_stats,
)
from facerecognizeonnx_tpu_torch.train.arcface_loss import (
    arcface_margin_logits,
    init_classifier,
    partial_fc_xent,
)

LR = Union[float, Callable[[int], float]]


class TrainState(NamedTuple):
    model: torch.nn.Module  # trainable backbone (BN running stats are its buffers)
    classifier: torch.Tensor  # (D, C), or this rank's block of columns
    opt_state: dict  # {"trace": {name: tensor}, "count": CPU int64 scalar}
    step: torch.Tensor  # CPU int64 scalar


class SGD:
    """`optax.sgd(lr, momentum)`: trace = g + m·trace, then param +=
    −lr·trace, lr a float or a schedule of the 0-based update count. The
    count lives on the host, so a schedule costs no device sync."""

    def __init__(self, lr: LR = 0.02, momentum: float = 0.9):
        self.lr, self.momentum = lr, momentum

    def init(self, tensors: Dict[str, torch.Tensor]) -> dict:
        return {
            "trace": {k: torch.zeros_like(t, requires_grad=False) for k, t in tensors.items()},
            "count": torch.zeros((), dtype=torch.int64),
        }

    @torch.no_grad()
    def update(self, tensors: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: dict) -> dict:
        """Steps `tensors` and the trace in place; returns the new state."""
        count = state["count"]
        lr = float(self.lr(int(count))) if callable(self.lr) else self.lr
        for k, t in tensors.items():
            trace = state["trace"][k]
            trace.mul_(self.momentum).add_(grads[k])
            t.add_(trace * (-lr))
        return {"trace": state["trace"], "count": count + 1}


def make_optimizer(lr: LR = 0.02, momentum: float = 0.9) -> SGD:
    return SGD(lr, momentum)


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """{name: tensor} of what a step updates: the backbone's trainable
    parameters by module name, and "classifier"."""
    return {**trainable_tensors(state.model), "classifier": state.classifier}


def mesh_axis(mesh, name: str) -> Tuple[Optional[object], int, int]:
    """(group or None, this rank's index, size) of a mesh axis; no group
    for an absent axis, an axis of size 1, or mesh=None."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 0, 1
    size = int(mesh.size(mesh.mesh_dim_names.index(name)))
    if size == 1:
        return None, 0, 1
    return mesh.get_group(name), mesh.get_local_rank(name), size


def column_block(full: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """This rank's block of columns of a (D, C) matrix (C must split
    evenly, as a JAX NamedSharding requires)."""
    _, idx, n = mesh_axis(mesh, axis)
    if full.shape[1] % n:
        raise ValueError(f"{full.shape[1]} classes do not split over {n} '{axis}' ranks")
    c = full.shape[1] // n
    return full[:, idx * c:(idx + 1) * c].contiguous()


def _state_device(mesh, device) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    from facerecognizeonnx_tpu_torch.parallel.mesh import mesh_device

    return mesh_device(mesh)


def init_train_state(
    seed: int,
    num_classes: int,
    cfg: PipelineConfig = PipelineConfig(),
    arch: str = "iresnet50",
    mesh=None,
    lr: LR = 0.02,
    device="cuda",
) -> TrainState:
    """A fresh state: the backbone drawn from `seed` (`bridge.
    init_params_numpy`), the classifier from a CPU `torch.Generator`
    seeded with `seed` (the same values on every device and rank; each
    rank keeps its "model" block), zero momentum. On the mesh's device
    when a mesh is given, else on `device`."""
    from facerecognizeonnx_tpu_torch import bridge

    dev = _state_device(mesh, device)
    tree = bridge.init_params_numpy(
        arch, seed=seed, input_size=cfg.rec_input_size, feature_dim=cfg.feature_dim
    )
    model = make_trainable(bridge.params_from_numpy(tree, device=dev))
    gen = torch.Generator().manual_seed(seed)
    full = init_classifier(gen, cfg.feature_dim, num_classes, device=dev)
    classifier = column_block(full, mesh, cfg.model_axis).requires_grad_(True)
    state = TrainState(model, classifier, {}, torch.zeros((), dtype=torch.int64))
    return state._replace(opt_state=make_optimizer(lr).init(state_tensors(state)))


def train_state_shardings(mesh, state: TrainState, cfg: PipelineConfig = PipelineConfig()):
    """The placements of a state over `mesh`'s "model" axis (DTensor
    terms): the classifier and its trace `Shard(1)`, the rest
    `Replicate()`; every leaf is also replicated over "data"."""
    from torch.distributed.tensor import Replicate, Shard

    repl, cols = Replicate(), Shard(1)
    return TrainState(
        model={name: repl for name in state.model.state_dict()},
        classifier=cols,
        opt_state={
            k: ({n: cols if n == "classifier" else repl for n in v}
                if isinstance(v, dict) else repl)
            for k, v in state.opt_state.items()
        },
        step=repl,
    )


class _SumGrad(torch.autograd.Function):
    """Identity; the backward sums the gradient over `group` (the ranks
    that hold the same replicated tensor and use it on different columns
    of the classifier)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _rows(x, idx: int, n: int, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} does not split over {n} 'data' ranks")
    b = t.shape[0] // n
    return t[idx * b:(idx + 1) * b].to(dev)


def make_train_step(
    mesh=None,
    cfg: PipelineConfig = PipelineConfig(),
    margin: float = 0.5,
    scale: float = 64.0,
    lr: LR = 0.02,
    bn_momentum: float = 0.9,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
):
    """Returns step(state, images, labels) -> (state, loss).

    images: (B, S, S, 3) normalized RGB (numpy or tensor, the global
    batch); labels: (B,) int class ids. The state's tensors are updated
    in place (the JAX step donates its state); the loss is a 0-dim tensor
    on the device, not synchronized."""
    opt = make_optimizer(lr)
    data_g, d_idx, d_n = mesh_axis(mesh, cfg.data_axis)
    model_g, m_idx, _ = mesh_axis(mesh, cfg.model_axis)

    def backbone(model, x):
        return recognizer_apply(model, x, compute_dtype, train=True, stats_group=data_g)

    def step(state: TrainState, images, labels) -> Tuple[TrainState, torch.Tensor]:
        dev = state.classifier.device
        x = _rows(images, d_idx, d_n, dev).to(torch.float32)
        y = _rows(labels, d_idx, d_n, dev).long()
        n_global = x.shape[0] * d_n
        if remat:
            feats, stats = checkpoint(backbone, state.model, x, use_reentrant=False)
        else:
            feats, stats = backbone(state.model, x)
        feats = l2_normalize(feats)
        if model_g is not None:
            feats = _SumGrad.apply(feats, model_g)
        col0 = m_idx * state.classifier.shape[1]
        logits = arcface_margin_logits(feats, state.classifier, y, margin, scale, col0)
        loss_rows, objective = partial_fc_xent(logits, y, col0, model_g)
        tensors = state_tensors(state)
        grads = torch.autograd.grad(objective.sum() / n_global, list(tensors.values()))
        loss = loss_rows.sum() / n_global
        if data_g is not None:  # one all-reduce for every gradient and the loss
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
            dist.all_reduce(flat, group=data_g)
            parts = torch.split(flat, [g.numel() for g in grads] + [1])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
            loss = parts[-1][0]
        opt_state = opt.update(tensors, dict(zip(tensors, grads)), state.opt_state)
        update_bn_stats(state.model, stats, momentum=bn_momentum)
        return TrainState(state.model, state.classifier, opt_state, state.step + 1), loss.detach()

    return step
