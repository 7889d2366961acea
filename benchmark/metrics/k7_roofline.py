"""K7's share of its roofline (``roofline/k7.py``): one
``sat_sample_kernel`` launch a tick."""

from benchmark.trace import roofline_share


def read(trace):
    return roofline_share(trace, "k7")
