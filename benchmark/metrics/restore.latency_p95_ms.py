"""95th percentile of the restores of the window outside the traced
stretch, from a decoded reduced frame and its gaze in host memory to the
restored full frame in host memory, in ms: the client's share of
motion-to-photon.  Its runs spread too widely for any end-to-end bound
(a host that slows for tens of seconds moves the tail), so it is read
here, beside ``restore_fps``, with no bound."""

from benchmark.stats import percentile


def read(trace):
    return percentile(trace.latencies, 95) * 1e3 if trace.latencies else None
