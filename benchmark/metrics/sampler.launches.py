"""Device kernels launched inside the tick's ``sample`` step (the port's
``serve.sample`` span, outside the gaze's ``serve.stage`` nested in it),
per tick: the taps' vector math and the sampler kernel.  An exact count,
the same at 1 viewer and at 8, since the taps are batched over gazes."""

from benchmark.trace import launches


def read(trace):
    return launches(trace, "sample")
