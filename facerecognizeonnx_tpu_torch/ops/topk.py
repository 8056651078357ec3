"""Top-k with `lax.top_k`'s tie order.

`lax.top_k` returns equal values in ascending-index order; `torch.topk`
promises no order among ties (least of all on CUDA). With bf16 compute
the detector's scores tie often, and the tie order decides NMS
survivors, so every place the JAX package calls `lax.top_k` the port
calls this.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, descending,
    ties in ascending-index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
