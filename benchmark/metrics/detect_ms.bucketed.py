"""`_identify.detect_ms` in the bucketed cells."""

from benchmark.metrics import _identify

UNIT = "ms"


def read(s):
    return _identify.detect_ms(s, "bucketed")
