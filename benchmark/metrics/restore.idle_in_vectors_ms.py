"""Device idle time while the host was inside the program's
``unwarp.vectors`` spans, ms per restore: what enqueueing the vector
math's launches costs the card."""

from benchmark.program_spans import idle_in_ms


def read(trace):
    return idle_in_ms(trace, "unwarp.vectors")
