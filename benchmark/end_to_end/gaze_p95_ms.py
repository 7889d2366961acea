"""95th percentile over every tick of the window, from the tick's gaze
snapshot to every viewer's reduced frame in host memory: the server's
gaze-to-frame latency."""

from benchmark.stats import p95_ms


def read(run):
    return p95_ms(run)
