"""95th percentile over every restore of the window, from a decoded
reduced frame and its gaze in host memory to the restored full frame in
host memory: the client's share of motion-to-photon."""

from benchmark.stats import p95_ms


def read(run):
    return p95_ms(run)
