"""The traced run: ``torch.profiler`` over a steady stretch of the window,
reduced in memory to what the per-layer metrics read.

The profiler's raw records are read without its own post-processing (a
1080p session stretch holds tens of thousands of launches).  The port's
spans appear in them as the ``record_function`` mirrors its tracer opens
under a profiler.  A driver names the steps of its unit by the port's
spans that carry them (its ``SPANS``); each device operation (kernel,
copy, memset) is tied, through its launch's correlation id, to the
innermost step the host was in when it launched it, and each idle gap of
the device to the innermost port span the host was in.  Nothing is
written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import itertools
import json
import statistics
from pathlib import Path

from benchmark import stats

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass
class Op:
    name: str
    kind: str  # "kernel", "htod", "dtoh", "memcpy" (other), "memset"
    start: int  # ns
    end: int
    span: str | None  # the innermost step its launch was made in
    launched: int | None = None  # ns: when the host launched it


@dataclasses.dataclass
class Trace:
    """What the per-layer metric readers read."""

    units: int  # units completed inside the stretch
    lo: int  # ns: the first traced unit's first step starts
    hi: int  # ns: the last traced unit's last step ends
    ops: list[Op]
    spans: list[tuple[str, int, int]]  # the steps, by the driver's names
    cell: dict  # shapes, viewers: what the rooflines need
    peak: dict | None  # the card's published peaks, None for an unknown card
    unmatched: int  # device operations whose launch was not found
    unnamed: int = 0  # device records with no name, left out
    # every span of the port in the stretch, by its own name
    annotations: list[tuple[str, int, int]] = dataclasses.field(default_factory=list)
    # s, on the host's clock: the latency of every unit of the window
    # outside the traced stretch
    latencies: list[float] = dataclasses.field(default_factory=list)

    def per_span(self, span: str, kind: str = "kernel") -> list[int]:
        """For each instance of the step ``span`` in the stretch, the
        number of ``kind`` operations launched inside it and in no step
        nested in it."""
        inst = sorted((a, b) for n, a, b in self.spans if n == span)
        starts = [a for a, _ in inst]
        counts = [0] * len(inst)
        for o in self.ops:
            if o.kind == kind and o.span == span and o.launched is not None:
                i = bisect.bisect_right(starts, o.launched) - 1
                if i >= 0:
                    counts[i] += 1
        return counts

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return stats.busy([(o.start, o.end) for o in self.ops], self.lo, self.hi) / 1e9

    def kind(self, *kinds: str) -> list[Op]:
        return [o for o in self.ops if o.kind in kinds]

    def span_ms(self, name: str) -> list[float]:
        return [(b - a) / 1e6 for n, a, b in self.spans if n == name]


def start():
    """A running profiler of host and device activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> list:
    """Stop ``prof`` and return its raw records."""
    prof.stop()
    return list(prof.profiler.kineto_results.events())


def _device_kind(name: str) -> str:
    """A device record's kind, by the name CUPTI gives it."""
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return "htod"
        if "DtoH" in name:
            return "dtoh"
        return "memcpy"
    return "kernel"


class Nest:
    """Properly nested (name, start, end) intervals: which is the innermost
    to cover a time."""

    def __init__(self, spans):
        # by start, and the outer of two that start together first
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in self.spans]
        # the latest end among the spans up to each: past it, none covers
        self.reach = list(itertools.accumulate((s[2] for s in self.spans), max))

    def at(self, t: float) -> str | None:
        """The name of the innermost interval that covers ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            name, _, end = self.spans[i]
            if end >= t:
                return name
            i -= 1
        return None


def summarize(records, steps: dict[str, str], units: int, cell: dict,
              peak: dict | None) -> Trace:
    """Reduce raw profiler records to a :class:`Trace`.  ``steps`` maps
    each step of the driver's unit to the port span that carries it."""
    from torch.autograd import DeviceType

    step_of = {port: step for step, port in steps.items()}
    annotations, launches, device = [], {}, []
    unnamed = 0
    for e in records:
        name = e.name()
        if e.is_user_annotation():
            # the profiler mirrors each span on the device's timeline:
            # only the host's copy is a span, and the mirror is no work
            if e.device_type() != DeviceType.CUDA:
                annotations.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CUDA:
            if not name:
                unnamed += 1
                continue
            a = e.start_ns()
            device.append((name, _device_kind(name), a, a + e.duration_ns(), e.correlation_id()))
        elif name.startswith("cu"):  # a CUDA runtime or driver call on the host
            launches[e.correlation_id()] = e.start_ns()
    spans = sorted(((step_of[n], a, b) for n, a, b in annotations if n in step_of),
                   key=lambda s: s[1])
    if not spans:
        raise RuntimeError(f"the trace holds none of the port's spans {sorted(step_of)}")
    lo, hi = spans[0][1], max(s[2] for s in spans)
    step_at = Nest(spans).at

    ops, unmatched = [], 0
    for name, kind, a, b, corr in device:
        if b <= lo or a >= hi:
            continue
        t = launches.get(corr)
        unmatched += t is None
        ops.append(Op(name, kind, a, b, step_at(t) if t is not None else None, t))
    inside = [s for s in annotations if s[2] > lo and s[1] < hi]
    return Trace(units, lo, hi, ops, spans, cell, peak, unmatched, unnamed, inside)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace marker and
    parameter list, at most 100 letters."""
    if name.startswith("Mem"):
        return name[:100]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:100]


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle time of the
    device by the innermost port span the host was in, 10 of each, in
    seconds."""
    by_op: dict[str, float] = {}
    for o in trace.ops:
        d = (min(o.end, trace.hi) - max(o.start, trace.lo)) / 1e9
        by_op[short_name(o.name)] = by_op.get(short_name(o.name), 0.0) + d
    span_at = Nest(trace.annotations).at

    by_gap: dict[str, float] = {}
    for a, b in stats.gaps([(o.start, o.end) for o in trace.ops], trace.lo, trace.hi):
        name = span_at((a + b) / 2)
        k = f"host in {name}" if name is not None else "host between spans"
        by_gap[k] = by_gap.get(k, 0.0) + (b - a) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module: how the harness finds a
    driver, a metric reader or a roofline by its name."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_peak(kind: str) -> dict | None:
    """The published peaks of a card by its name (``peaks.json``)."""
    return json.loads((ROOT / "peaks.json").read_text()).get(kind)


def copy_ms(trace: Trace, *kinds: str) -> float | None:
    """Device time of the copies of ``kinds`` ("htod", "dtoh") per unit,
    in ms, from the profiler's memcpy records."""
    ops = trace.kind(*kinds)
    if not ops or not trace.units:
        return None
    return sum(o.end - o.start for o in ops) / trace.units / 1e6


def launches(trace: Trace, span: str) -> float | None:
    """Device kernels launched inside the step ``span``, per unit: the
    median over the stretch's instances of the step (the count repeats
    exactly)."""
    counts = trace.per_span(span)
    return statistics.median(counts) if counts and max(counts) else None


def idle_share(trace: Trace) -> float | None:
    """Share of the stretch, in %, in which the device ran no kernel, copy
    or memset."""
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def roofline_share(trace: Trace, kernel: str) -> float | None:
    """A kernel's share of its roofline, in %: the least time the card
    could take for one call (the larger of bytes over peak bandwidth and
    operations over peak rate, from ``roofline/<kernel>.py``) over the
    mean device time of the kernel's calls in the stretch.  None where the
    stretch ran no such kernel or the card's peaks are not known."""
    mod = load_module("roofline", kernel)
    calls = [o for o in trace.ops if o.kind == "kernel" and mod.MATCH in o.name]
    if not calls or trace.peak is None:
        return None
    mean_s = sum(o.end - o.start for o in calls) / len(calls) / 1e9
    nbytes, ops = mod.cost(trace.cell)
    bound_s = max(nbytes / trace.peak["bytes_per_s"], ops / trace.peak["ops_per_s"])
    return 100.0 * bound_s / mean_s
