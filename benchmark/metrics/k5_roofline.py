"""K5's share of its roofline (``roofline/k5.py``), per SAT build.

A build is one host call of three kernels (``band_totals_kernel``,
``band_carry_kernel``, ``sat_band_kernel``), launched inside the
program's ``sampler.kernel`` span whose ``kernel`` attribute is "K5"
(``core/sat.py::build_sat``).  A build's device time is the union of the
intervals of the kernels launched inside its span: K5's programmatic
dependent launches start before the kernel ahead of them ends, so a sum
of kernel times would count that overlap twice.  The share is the least
time over the mean of those per build.  None where the stretch holds no
such span with a kernel launched in it, the card's peaks are not known,
or the program has no tracer."""

import bisect

from benchmark import stats
from benchmark.program_spans import _profiling
from benchmark.trace import load_module


def build_times_ns(trace) -> list[int]:
    """Device ns of each K5 build in the stretch that launched a kernel."""
    prof = _profiling()
    if prof is None:
        return []
    builds = sorted((r.start, r.end)
                    for r in prof.spans(trace.lo, trace.hi, names=("sampler.kernel",))
                    if r.attrs.get("kernel") == "K5")
    starts = [a for a, _ in builds]
    kernels: list[list[tuple[int, int]]] = [[] for _ in builds]
    for o in trace.ops:
        if o.kind == "kernel" and o.launched is not None:
            i = bisect.bisect_right(starts, o.launched) - 1
            if i >= 0 and o.launched <= builds[i][1]:
                kernels[i].append((o.start, o.end))
    return [stats.busy(k) for k in kernels if k]


def read(trace):
    times = build_times_ns(trace)
    if not times or trace.peak is None:
        return None
    nbytes, ops = load_module("roofline", "k5").cost(trace.cell)
    bound_s = max(nbytes / trace.peak["bytes_per_s"], ops / trace.peak["ops_per_s"])
    return 100.0 * bound_s / (sum(times) / len(times) / 1e9)
