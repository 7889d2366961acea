"""Statistics of the benchmark: tails over every unit, the union of device
intervals, and the spread the bounds are set from."""

from __future__ import annotations

import statistics

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between the two
    nearest ranks, numpy's default)."""
    if len(values) == 0:
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def busy(intervals, lo: float | None = None, hi: float | None = None) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]
    where given: the time the device ran at least one of them."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle (start, end) gaps of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return out


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median, as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def rate(run) -> float:
    """Viewer frames (or restores) in host memory per second over the
    whole window: viewers x units completed / window seconds."""
    return run.viewers * run.units / run.window_s


def p95_ms(run) -> float:
    """The 95th percentile of every unit's latency in the window, in ms."""
    return percentile(run.latencies, 95) * 1e3
