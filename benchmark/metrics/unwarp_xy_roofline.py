"""``unwarp_xy``'s share of its roofline (``roofline/unwarp_xy.py``)."""

from benchmark.trace import roofline_share


def read(trace):
    return roofline_share(trace, "unwarp_xy")
