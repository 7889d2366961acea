"""Share of the stretch's restore uploads, in bytes and %, copied from
host memory registered with CUDA: the program's ``client.upload``
spans whose ``registered`` attribute is true
(``serve/client.py::ClientRestore``, through ``serve/tick.py::upload``),
weighted by their ``bytes``.  None where the stretch holds no such span
with that attribute, or the program has no tracer."""

from benchmark.program_spans import _profiling


def read(trace):
    prof = _profiling()
    if prof is None:
        return None
    staged = [(r.attrs["bytes"], bool(r.attrs["registered"]))
              for r in prof.spans(trace.lo, trace.hi, names=("client.upload",))
              if "registered" in r.attrs]
    total = sum(b for b, _ in staged)
    if not total:
        return None
    return 100.0 * sum(b for b, registered in staged if registered) / total
