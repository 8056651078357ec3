"""Inputs made from `--seed`: sub-seeds per purpose, the frame pool and
the gallery, all drawn on the device in a few large calls.

Every seed gets the same sizes (the traffic file's), so seeds change
values and never the amount of work.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PURPOSES = ("detector", "recognizer", "frames", "gallery", "sample", "spare")


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds, one per purpose, from any whole number."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(len(PURPOSES), np.uint64)
    return {p: int(w) >> 1 for p, w in zip(PURPOSES, words)}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def frame_pool(traffic: Dict, seed: int, device) -> torch.Tensor:
    """(pool_batches, batch, S, S, 3) uint8 BGR frames, already letterboxed
    to S x S: uniform noise, each batch distinct."""
    if traffic["frames"] != "uniform_noise":
        raise ValueError(f"unknown frames kind {traffic['frames']!r}")
    s = traffic["frame_size"]
    shape = (traffic["pool_batches"], traffic["batch"], s, s, 3)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=generator(seed, device))


def gallery(traffic: Dict, dim: int, seed: int, device) -> torch.Tensor:
    """(gallery_rows, dim) float32 rows, not normalized (the program's
    bank and the reference each normalize them)."""
    return torch.randn((traffic["gallery_rows"], dim), device=device,
                       generator=generator(seed, device))


def sample_positions(traffic: Dict, seed: int) -> list:
    """Which batches of the window are compared: `compare_batches` of the
    first `compare_among`, drawn from the seed."""
    rng = np.random.default_rng(seed)
    pos = rng.choice(traffic["compare_among"], traffic["compare_batches"], replace=False)
    return sorted(int(p) for p in pos)
