"""Training driver: LR schedule, step loop, periodic eval + checkpoint.

Port of `facerecognizeonnx_tpu/train/fit.py`. The step (train/trainer.py)
runs inside a host loop that synchronizes only at log boundaries: each
step's loss stays on the device, and the pending losses of a log window
are read in one copy. Resume is crash-safe: `fit(ckpt_path=...)`
restores the checkpoint at that path (`utils.checkpoint.
load_train_state`, the port's own format) and skips the steps already
taken by consuming the batch iterator without stepping, so the data
order matches an uninterrupted run.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def warmup_cosine(
    peak_lr: float,
    total_steps: int,
    warmup_steps: Optional[int] = None,
    end_scale: float = 0.01,
) -> Callable[[int], np.float32]:
    """The standard large-batch recipe: linear warmup → cosine decay.

    Returns count → float32 learning rate, `optax.
    warmup_cosine_decay_schedule`'s formula in float32 (its op order, for
    the same value at every step); pass it as make_train_step(..., lr=...).
    warmup defaults to min(total/10, 1000) steps; the floor is peak_lr *
    end_scale."""
    if warmup_steps is None:
        warmup_steps = max(1, min(total_steps // 10, 1000))
    warmup_steps = min(warmup_steps, max(total_steps - 1, 1))
    f32 = np.float32
    init = end = peak_lr * end_scale
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs total_steps > warmup_steps, got {total_steps}")

    def linear(count: int) -> np.float32:
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return f32(init - peak_lr) * frac + f32(peak_lr)

    def cosine(count: int) -> np.float32:
        c = f32(min(count, decay_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
        return f32(peak_lr) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> np.float32:
        count = int(count)
        return linear(count) if count < warmup_steps else cosine(count - warmup_steps)

    return schedule


def fit(
    state,
    step_fn: Callable,
    batches,
    steps: int,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 0,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 0,
    log_every: int = 50,
    log: Callable[[str], None] = print,
    mesh=None,
) -> Tuple[object, List[Dict]]:
    """Run `steps` training steps; returns (state, history).

    state/step_fn: from train.trainer init_train_state/make_train_step
    (with the same `mesh`). batches: iterator of (images, labels) —
    train.data.IdentityFolderDataset.batches(...) or any equivalent.
    eval_fn(state) -> dict runs every `eval_every` steps (0 = never) and
    its metrics land in history. ckpt_path + ckpt_every save the whole
    state (the final state is always saved); an existing checkpoint at
    ckpt_path resumes. `mesh` is the step's mesh: a checkpoint gathers
    the classifier's columns on save and splits them on load.
    """
    from facerecognizeonnx_tpu_torch.utils.checkpoint import (
        load_train_state,
        save_train_state,
    )

    start_step = 0
    if ckpt_path and os.path.exists(ckpt_path):
        state = load_train_state(ckpt_path, state, mesh=mesh)
        start_step = int(state.step)
        log(f"resumed from {ckpt_path} at step {start_step}")
    if start_step >= steps:
        return state, []

    history: List[Dict] = []
    pending: List[Tuple[int, torch.Tensor]] = []  # (step, device loss)
    t_log = time.time()

    def drain(extra: Optional[Dict] = None):
        """Read the pending device losses in one copy; one history row per
        logged step window."""
        nonlocal t_log
        if not pending:
            return
        losses = torch.stack([v for _, v in pending]).cpu().tolist()
        row = {
            "step": pending[-1][0],
            "loss": losses[-1],
            "loss_mean": float(np.mean(losses)),
            "steps_per_sec": len(pending) / max(time.time() - t_log, 1e-9),
        }
        if extra:
            row.update(extra)
        history.append(row)
        log(
            f"step {row['step']}/{steps} loss {row['loss_mean']:.4f} "
            f"({row['steps_per_sec']:.2f} steps/s)"
            + (f" {extra}" if extra else "")
        )
        pending.clear()
        t_log = time.time()

    it = iter(batches)
    for n in range(steps):
        try:
            images, labels = next(it)
        except StopIteration:
            log(f"data exhausted at step {n}; stopping early")
            break
        if n < start_step:
            continue  # consume for deterministic resume order
        state, loss = step_fn(state, images, labels)
        pending.append((n + 1, loss))
        done = n + 1
        if log_every and (done % log_every == 0 or done == steps):
            extra = None
            if eval_fn and eval_every and done % eval_every == 0:
                extra = eval_fn(state)
            drain(extra)
        elif eval_fn and eval_every and done % eval_every == 0:
            drain(eval_fn(state))
        if ckpt_path and ckpt_every and done % ckpt_every == 0:
            drain()
            save_train_state(ckpt_path, state, mesh=mesh)
    drain()
    if ckpt_path:
        save_train_state(ckpt_path, state, mesh=mesh)
    return state, history
