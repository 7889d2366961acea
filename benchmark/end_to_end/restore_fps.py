"""Restored frames in host memory per second over the whole window: the
restores a client's card completes, closed loop."""

from benchmark.stats import rate


def read(run):
    return rate(run)
