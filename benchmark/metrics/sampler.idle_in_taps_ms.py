"""Device idle time while the host was inside the program's
``sampler.taps`` spans, ms per tick: what enqueueing the taps' launches
costs the card."""

from benchmark.program_spans import idle_in_ms


def read(trace):
    return idle_in_ms(trace, "sampler.taps")
