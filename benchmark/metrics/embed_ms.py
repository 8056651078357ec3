"""`_identify.embed_ms` in the dense cells."""

from benchmark.metrics import _identify

UNIT = "ms"


def read(s):
    return _identify.embed_ms(s, "dense")
