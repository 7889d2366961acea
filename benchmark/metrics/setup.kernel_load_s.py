"""Seconds the process spent building and loading the hand-written
kernels' libraries (the program's ``setup.kernel_load`` spans; ``nvcc``
where no build was cached), a part of ``setup_s``."""

from benchmark.program_spans import setup_s


def read(trace):
    return setup_s("setup.kernel_load")
