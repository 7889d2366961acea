"""``segreduce_xy``'s share of its roofline (``roofline/segreduce_xy.py``)."""

from benchmark.trace import roofline_share


def read(trace):
    return roofline_share(trace, "segreduce_xy")
