"""`_identify.mfu` in the dense cells."""

from benchmark.metrics import _identify

UNIT = "%"


def read(s):
    return _identify.mfu(s, "dense")
