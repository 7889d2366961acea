"""Share of the traced stretch in which the device ran no kernel, copy or
memset, in the restore cells."""

from benchmark.trace import idle_share


def read(trace):
    return idle_share(trace)
