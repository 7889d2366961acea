"""Device kernels launched inside the ``unwarp`` span, per restore: the
unwarp's per-axis vector math and ``unwarp_xy``."""

from benchmark.trace import launches


def read(trace):
    return launches(trace, "unwarp")
