"""Device time of the host-to-device copies per tick (the staged frame
and the gazes)."""

from benchmark.trace import copy_ms


def read(trace):
    return copy_ms(trace, "htod")
