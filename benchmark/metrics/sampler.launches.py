"""Device kernels launched inside the ``sample`` span, per tick: the
taps' vector math and the sampler kernel.  An exact count, the same at
1 viewer and at 8, since the taps are batched over gazes."""

from benchmark.trace import launches


def read(trace):
    return launches(trace, "sample")
