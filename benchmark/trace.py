"""The traced run: ``torch.profiler`` over a steady stretch of the window,
reduced in memory to what the per-layer metrics read.

The profiler's raw records are read without its own post-processing (a
1080p session stretch holds tens of thousands of launches).  Device
operations (kernels, copies, memsets) are tied to the benchmark's span
the host was in when it launched them, through the launch's correlation
id.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
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
    span: str | None  # the benchmark span its launch was made in
    launched: int | None = None  # ns: when the host launched it


@dataclasses.dataclass
class Trace:
    """What the per-layer metric readers read."""

    units: int  # units completed inside the stretch
    lo: int  # ns: the first traced unit's first span starts
    hi: int  # ns: the last traced unit's last span ends
    ops: list[Op]
    spans: list[tuple[str, int, int]]
    cell: dict  # shapes, viewers: what the rooflines need
    peak: dict | None  # the card's published peaks, None for an unknown card
    unmatched: int  # device operations whose launch was not found
    unnamed: int = 0  # device records with no name, left out

    def per_span(self, span: str, kind: str = "kernel") -> list[int]:
        """For each instance of ``span`` in the stretch, the number of
        ``kind`` operations launched inside it."""
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


def summarize(records, span_names, units: int, cell: dict, peak: dict | None) -> Trace:
    """Reduce raw profiler records to a :class:`Trace`."""
    from torch.autograd import DeviceType

    spans, launches, device = [], {}, []
    unnamed = 0
    for e in records:
        name = e.name()
        if e.is_user_annotation():
            # the profiler mirrors each span on the device's timeline:
            # only the host's copy is a span, and the mirror is no work
            if e.device_type() != DeviceType.CUDA and name in span_names:
                spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.device_type() == DeviceType.CUDA:
            if not name:
                unnamed += 1
                continue
            a = e.start_ns()
            device.append((name, _device_kind(name), a, a + e.duration_ns(), e.correlation_id()))
        elif name.startswith("cu"):  # a CUDA runtime or driver call on the host
            launches[e.correlation_id()] = e.start_ns()
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in spans]
    lo, hi = spans[0][1], max(s[2] for s in spans)

    def span_at(t: int) -> str | None:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] <= t <= spans[i][2]:
            return spans[i][0]
        return None

    ops, unmatched = [], 0
    for name, kind, a, b, corr in device:
        if b <= lo or a >= hi:
            continue
        t = launches.get(corr)
        unmatched += t is None
        ops.append(Op(name, kind, a, b, span_at(t) if t is not None else None,
                      t))
    return Trace(units, lo, hi, ops, spans, cell, peak, unmatched, unnamed)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace marker and
    parameter list, at most 100 letters."""
    if name.startswith("Mem"):
        return name[:100]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:100]


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle time of the
    device by the span the host was in, 10 of each, in seconds."""
    by_op: dict[str, float] = {}
    for o in trace.ops:
        d = (min(o.end, trace.hi) - max(o.start, trace.lo)) / 1e9
        by_op[short_name(o.name)] = by_op.get(short_name(o.name), 0.0) + d
    starts = [s[1] for s in trace.spans]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and trace.spans[i][1] <= t <= trace.spans[i][2]:
            return f"host in {trace.spans[i][0]}"
        return "host between spans"

    by_gap: dict[str, float] = {}
    for a, b in stats.gaps([(o.start, o.end) for o in trace.ops], trace.lo, trace.hi):
        k = label((a + b) / 2)
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
    """Device kernels launched inside ``span``, per unit: the median over
    the stretch's instances of the span (the count repeats exactly)."""
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
