"""Seconds the process spent building pipelines (the program's
``setup.pipeline`` spans: the device context's first use and the grid
tables), a part of ``setup_s``."""

from benchmark.program_spans import setup_s


def read(trace):
    return setup_s("setup.pipeline")
