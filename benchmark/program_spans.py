"""The program's own spans beside the device trace.

``foveax_torch.pipeline.profiling`` records spans inside the port (the
sampler's taps, the unwarp's vectors, set-up) on ``torch.profiler``'s
clock, in this same process.  The readers here tie each device operation
of a :class:`~benchmark.trace.Trace` to those spans by the time its launch
was made (``Op.launched``), and cut the device's idle gaps
(``stats.gaps``) to the spans' intervals.  Each returns None where the
program records no such span in the stretch, or records no spans at all
(a build of the port without the tracer).
"""

from __future__ import annotations

import bisect
import statistics

from benchmark import stats


def _profiling():
    """The port's tracer, or None where the port has none."""
    try:
        from foveax_torch.pipeline import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "setup_spans")):
        return None
    return profiling


def intervals(trace, name: str) -> list[tuple[int, int]] | None:
    """The union of the program's ``name`` spans inside [trace.lo,
    trace.hi], as sorted disjoint (start, end) ns; None where there are
    none."""
    prof = _profiling()
    if prof is None:
        return None
    merged: list[list[int]] = []
    for a, b in sorted((r.start, r.end) for r in prof.spans(trace.lo, trace.hi, names=(name,))):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged] or None


def launches_in(trace, name: str) -> float | None:
    """Device kernels launched inside an instance of the program's
    ``name`` span: the median over the stretch's instances (one a tick or
    a restore for the taps and the vectors; the count repeats exactly,
    and the median passes over an instance whose first kernels fell
    before the device trace started)."""
    inst = intervals(trace, name)
    if inst is None or not trace.units:
        return None
    starts = [a for a, _ in inst]
    counts = [0] * len(inst)
    for o in trace.ops:
        if o.kind == "kernel" and o.launched is not None:
            i = bisect.bisect_right(starts, o.launched) - 1
            if i >= 0 and o.launched <= inst[i][1]:
                counts[i] += 1
    return statistics.median(counts)


def idle_in_ms(trace, name: str) -> float | None:
    """Time the device ran no kernel, copy or memset while the host was
    inside the program's ``name`` spans, in ms per unit of the stretch."""
    inst = intervals(trace, name)
    if inst is None or not trace.units:
        return None
    gaps = stats.gaps([(o.start, o.end) for o in trace.ops], trace.lo, trace.hi)
    total, j = 0, 0
    for a, b in gaps:
        while j < len(inst) and inst[j][1] <= a:
            j += 1
        k = j
        while k < len(inst) and inst[k][0] < b:
            total += min(b, inst[k][1]) - max(a, inst[k][0])
            k += 1
    return total / trace.units / 1e6


def setup_s(name: str) -> float | None:
    """The summed durations of the process's ``name`` set-up spans, in s."""
    prof = _profiling()
    if prof is None:
        return None
    found = [r.end - r.start for r in prof.setup_spans() if r.name == name]
    return sum(found) / 1e9 if found else None
