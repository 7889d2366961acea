"""Device time of a restore's copies (the reduced frame and gaze up, the
restored frame down), per restore."""

from benchmark.trace import copy_ms


def read(trace):
    return copy_ms(trace, "htod", "dtoh")
