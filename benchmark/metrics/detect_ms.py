"""`_identify.detect_ms` in the dense cells."""

from benchmark.metrics import _identify

UNIT = "ms"


def read(s):
    return _identify.detect_ms(s, "dense")
