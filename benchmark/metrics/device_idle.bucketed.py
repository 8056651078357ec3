"""`_identify.device_idle` in the bucketed cells."""

from benchmark.metrics import _identify

UNIT = "%"


def read(s):
    return _identify.device_idle(s, "bucketed")
