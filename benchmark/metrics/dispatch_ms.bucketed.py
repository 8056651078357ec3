"""`_identify.dispatch_ms` in the bucketed cells."""

from benchmark.metrics import _identify

UNIT = "ms"


def read(s):
    return _identify.dispatch_ms(s, "bucketed")
