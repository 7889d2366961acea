"""Device kernels launched inside the program's ``sampler.taps`` span
(``core/sample.py::gaze_taps``, once a tick), the median over the ticks:
the taps' vector math, the larger part of ``sampler.launches``."""

from benchmark.program_spans import launches_in


def read(trace):
    return launches_in(trace, "sampler.taps")
