"""Calls of the program that made the host wait for the device's stream,
per traced batch (its `host_waits` counter), in the bucketed cells."""

from benchmark.metrics import _program

UNIT = "per_batch"


def read(s):
    return _program.counter_per_batch(s, "bucketed", "host_waits")
