"""Host time of the ``sample`` span, mean per tick: the enqueue of the
sampler's launches (nothing in it waits for the device)."""


def read(trace):
    ms = trace.span_ms("sample")
    return sum(ms) / len(ms) if ms else None
