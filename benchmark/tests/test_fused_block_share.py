"""The readers of the program's IResNet block counters
(`fused_block_share`, `fused_block_share.bucketed`), on tallies made
through the program's own tracer."""

from __future__ import annotations

import pytest

from benchmark import spec
from facerecognizeonnx_tpu_torch.utils import observability as obs


def _traced(family, batches, blocks, fused):
    obs.enable()
    for _ in range(batches):
        with obs.span("identify" if family == "dense" else "start"):
            obs.count("iresnet_blocks", blocks)
            obs.count("iresnet_blocks_fused", fused)
    obs.enable(False)


def read(name, family, batches=4):
    return spec.metric(name).read({"kind": "identify", "family": family, "batches": batches})


@pytest.mark.parametrize("family", ["dense", "bucketed"])
def test_fused_block_share_reads_the_program_counters(family):
    name = "fused_block_share" + ("" if family == "dense" else ".bucketed")
    other = "fused_block_share" + (".bucketed" if family == "dense" else "")
    obs.reset()
    try:
        _traced(family, 4, 24, 24)
        assert read(name, family) == pytest.approx(100.0)
        assert read(other, family) is None
        obs.reset()
        _traced(family, 4, 24, 6)
        assert read(name, family) == pytest.approx(25.0)
        obs.reset()
        _traced(family, 4, 0, 0)  # no IResNet (MobileFaceNet), or a program without the counter
        assert read(name, family) is None
        obs.reset()
        _traced(family, 3, 24, 24)  # the tally is not the traced window's
        assert read(name, family) is None
    finally:
        obs.enable(False)
        obs.reset()
