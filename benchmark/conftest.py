"""Shared fixtures of the benchmark's own tests in `tests/` (run with
`python -m pytest benchmark` from the repository root)."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import spec


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """Skips a test marked `card` where torch sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest benchmark -m card` on the chip")
    return torch.device("cuda")


def tiny_cell(name: str) -> dict:
    """The named cell at a size the CPU runs in seconds: 128² frames, an
    IResNet of one block a stage, 2 frames a batch, a 300-row gallery."""
    c = copy.deepcopy(spec.cell(name))
    c["config"]["detector"]["input_size"] = 128
    rec = c["config"]["recognizer"]
    if rec["kind"] == "iresnet":
        rec.update(blocks=[1, 1, 1, 1], arch="iresnet18")
    c["traffic"].update(frame_size=128, batch=2, pool_batches=2, anchors_per_frame=8,
                        gallery_rows=300, compare_batches=2, compare_among=3, trace_after=1,
                        trace_batches=2, warmup_batches=1)
    return c


@pytest.fixture
def tiny():
    return tiny_cell
