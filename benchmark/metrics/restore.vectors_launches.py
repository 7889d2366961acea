"""Device kernels launched inside the program's ``unwarp.vectors`` span
(``kernels/unwarp.py::fused_vectors``, once a restore), the median over
the restores: the per-axis vector math, the larger part of
``restore.launches``."""

from benchmark.program_spans import launches_in


def read(trace):
    return launches_in(trace, "unwarp.vectors")
