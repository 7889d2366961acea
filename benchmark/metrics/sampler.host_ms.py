"""Host time of the tick's ``sample`` step (the port's ``serve.sample``
span, the gaze's staging in it included), mean per tick: the enqueue of
the sampler's launches (nothing in it waits for the device)."""


def read(trace):
    ms = trace.span_ms("sample")
    return sum(ms) / len(ms) if ms else None
