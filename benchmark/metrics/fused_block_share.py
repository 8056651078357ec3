"""Share of the IResNet blocks that ran the fused path (the program's
`iresnet_blocks_fused` over its `iresnet_blocks` counter), over the
traced batches, in the dense cells; None where no block ran."""

from benchmark.metrics import _program

UNIT = "%"


def read(s):
    blocks = _program.counter_per_batch(s, "dense", "iresnet_blocks")
    if not blocks:
        return None
    return 100.0 * _program.counter_per_batch(s, "dense", "iresnet_blocks_fused") / blocks
