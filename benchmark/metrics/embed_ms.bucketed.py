"""`_identify.embed_ms` in the bucketed cells."""

from benchmark.metrics import _identify

UNIT = "ms"


def read(s):
    return _identify.embed_ms(s, "bucketed")
