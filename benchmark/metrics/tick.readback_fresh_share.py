"""Share of the stretch's readbacks, in %, that had to grow the port's
pinned host pool: the program's ``serve.readback`` spans whose ``fresh``
attribute is true (``serve/tick.py::_readback``).  None where the stretch
holds no such span with that attribute, or the program has no tracer."""

from benchmark.program_spans import _profiling


def read(trace):
    prof = _profiling()
    if prof is None:
        return None
    fresh = [bool(r.attrs["fresh"])
             for r in prof.spans(trace.lo, trace.hi, names=("serve.readback",))
             if "fresh" in r.attrs]
    if not fresh:
        return None
    return 100.0 * sum(fresh) / len(fresh)
