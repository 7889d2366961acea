"""Viewer frames in host memory per second over the whole window: viewers
x ticks completed / window seconds.  Viewers a card serves at 30 fps =
this / 30."""

from benchmark.stats import rate


def read(run):
    return rate(run)
