"""Share of the stretch's restore readbacks, in %, that had to grow the
port's pinned host pool: the program's ``client.readback`` spans whose
``fresh`` attribute is true (``serve/client.py::ClientRestore``, through
``serve/tick.py::_readback``).  None where the stretch holds no such span
with that attribute, or the program has no tracer."""

from benchmark.program_spans import _profiling


def read(trace):
    prof = _profiling()
    if prof is None:
        return None
    fresh = [bool(r.attrs["fresh"])
             for r in prof.spans(trace.lo, trace.hi, names=("client.readback",))
             if "fresh" in r.attrs]
    if not fresh:
        return None
    return 100.0 * sum(fresh) / len(fresh)
