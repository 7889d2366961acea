"""Device time of the device-to-host copies per tick (every viewer's
reduced frame)."""

from benchmark.trace import copy_ms


def read(trace):
    return copy_ms(trace, "dtoh")
