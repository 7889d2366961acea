"""The port's tracer: spans, counters, per-stage summaries and device
traces (counterpart of ``foveax/pipeline/profiling.py``).

The reference's observability is ad-hoc chrono spans accumulated per phase
and printed at exit (reference: src/video_client.h:68-73,
src/video_client.cc:375-383; server pacing checkpoint
src/video_server.cc:207-208,310-318).  Here every timed region of the port
is a :class:`span`, recorded always:

- A span keeps its name, attributes, start and end, thread, parent span
  and the id of the unit it belongs to (a serve tick, a client restore).
  :class:`root` opens a unit's first span and gives the unit a new id; the
  spans opened inside it share that id.
- The open span, and with it the unit id, lives in a context variable,
  so each asyncio task (a session's send loop, a channel's tick loop) has
  its own, whatever the tasks interleave on the event loop's thread.
  ``loop.run_in_executor`` does not carry it to the thread that runs the
  call: :func:`bind` runs the callable in a copy of the caller's context,
  under the caller's open span.
- Finished spans go into a ring of the last :data:`RING_SPANS`;
  ``setup.*`` spans go into a list of their own that the ring never
  evicts.  :func:`spans` and :func:`setup_spans` read them.
- A span opened while a ``torch.profiler`` runs also goes, as it
  finishes, into a store of its own (up to :data:`RING_SPANS`) that the
  ring never evicts, so a traced stretch's spans can be read after the
  ring has wrapped past them.  :func:`spans` reads the ring and that
  store together, each span once.  The counter ``profiling.ring_evicted``
  (:func:`counts`) says how many spans the ring has dropped.
- Stamps are ``time.perf_counter_ns()``.  :func:`spans` returns them on
  ``torch.profiler``'s clock (Unix-epoch ns, ``time.time_ns()``), through
  an offset taken at read time from the tightest of a few paired clock
  reads, so that a span and the device operations launched inside it can
  be compared directly.
- While a ``torch.profiler`` runs, each span also opens a
  ``torch.profiler.record_function`` of its name, so that a
  :func:`device_trace` shows the spans over the kernels.  Without a
  profiler a span costs two clock reads, an append and an addition.

:func:`count` keeps counters beside the spans.  A :class:`StageTimer` is
a bounded per-name summary (count, total, max, p50, p95) that spans feed
as they exit: those it opens (``stage``), and those opened inside a span
given it as ``tally`` (a server's ticks, a client's restores).  It reads
no ring, so a busy process cannot wrap its summaries.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import random
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# Finished spans kept, newest last, for :func:`spans` (a trace's readers):
# a few seconds of a busy server.  What a server or client reports is
# summarised as its spans exit (StageTimer), not read from here.
RING_SPANS = 65536
# ``setup.*`` spans kept apart from the ring: pipelines built and kernel
# libraries loaded.
SETUP_SPANS = 4096

_ring: deque = deque(maxlen=RING_SPANS)
_setup: deque = deque(maxlen=SETUP_SPANS)
# Ring spans opened under a running profiler, kept past the ring.
_kept: deque = deque(maxlen=RING_SPANS)
# Spans appended to the ring since start or clear(): less the ring's
# length, the spans it dropped.  A plain int, so a span takes no lock:
# CPython switches threads only at bytecodes that check for a switch, and
# none of those of ``+=`` on a global int does (tests/test_torch_tracing.py
# holds the count exact across threads).
_ring_appended = 0
_open: contextvars.ContextVar = contextvars.ContextVar("foveax_torch_span", default=None)
_counts: dict[str, int] = defaultdict(int)
_counts_lock = threading.Lock()
# Bound once: a span's hot path makes no attribute lookups through modules.
_now = time.perf_counter_ns
_ident = threading.get_ident
_next_span = itertools.count(1).__next__
_next_unit = itertools.count(1).__next__
# Where each span name's finished spans go: the ring, or the set-up list.
_stores: dict[str, deque] = {}


class span:
    """A timed region: ``with span("serve.sample", viewers=8): ...``.

    A class rather than a generator, so that entering and leaving cost two
    clock reads, a context-variable write and an append.  ``attrs`` may be
    filled in while the span is open.  ``tally`` (a :class:`StageTimer`),
    or where it is None the parent span's, is fed the span's duration at
    exit."""

    __slots__ = ("name", "attrs", "tally", "id", "parent", "unit", "thread", "start",
                 "end", "_token", "_mirror")

    def __init__(self, name: str, tally: "StageTimer | None" = None, **attrs):
        self.name = name
        self.tally = tally
        self.attrs = attrs

    def __enter__(self):
        parent = _open.get()
        if parent is None:
            self.parent = self.unit = None
        else:
            self.parent, self.unit = parent.id, parent.unit
            if self.tally is None:
                self.tally = parent.tally
        self.id = _next_span()
        self.thread = _ident()
        self._token = _open.set(self)
        self._mirror = None
        self.start = _now()
        if _autograd_profiler._is_profiler_enabled:
            self._mirror = record_function(self.name)
            self._mirror.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        global _ring_appended
        mirror = self._mirror
        if mirror is not None:
            mirror.__exit__(*exc)
            self._mirror = None
        self.end = _now()
        _open.reset(self._token)
        self._token = None  # the ring keeps no context (a token holds one)
        store = _stores.get(self.name)
        if store is None:
            store = _stores[self.name] = _setup if self.name.startswith("setup.") else _ring
        store.append(self)
        if store is _ring:
            _ring_appended += 1
            if mirror is not None:
                _kept.append(self)
        if self.tally is not None:
            self.tally.add(self)
            self.tally = None  # the ring keeps plain records
        return False

    @property
    def ms(self) -> float:
        """The finished span's duration in ms."""
        return (self.end - self.start) / 1e6


class root(span):
    """The first span of a unit of work: a new unit id, which every span
    opened inside it shares (:func:`bind` carries it to executor
    threads)."""

    __slots__ = ()

    def __enter__(self):
        span.__enter__(self)
        self.unit = _next_unit()
        return self


def bind(fn):
    """``fn`` to run on another thread (``loop.run_in_executor``) in a copy
    of the caller's context: in the caller's unit, under the caller's open
    span.  Bind once per call: a copy runs one call at a time."""
    ctx = contextvars.copy_context()
    return lambda *args: ctx.run(fn, *args)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _counts_lock:
        _counts[name] += n


def counts() -> dict[str, int]:
    """Every counter's value, with ``profiling.ring_evicted`` (the spans
    the ring has dropped) once the ring has dropped any."""
    with _counts_lock:
        out = dict(_counts)
    evicted = _ring_appended - len(_ring)
    if evicted > 0:
        out["profiling.ring_evicted"] = evicted
    return out


class Record(NamedTuple):
    """A finished span on the profiler's clock (ns since the Unix epoch)."""

    name: str
    start: int
    end: int
    thread: int
    parent: int | None
    unit: int | None
    id: int
    attrs: dict


def clock_offset_ns(reads: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of
    ``reads`` paired reads."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def now_ns() -> int:
    """Now on the profiler's clock."""
    return time.perf_counter_ns() + clock_offset_ns()


def _records(source, lo_ns, hi_ns, names=None) -> list[Record]:
    off = clock_offset_ns()
    out = []
    for s in tuple(source):
        if names is not None and s.name not in names:
            continue
        a, b = s.start + off, s.end + off
        if (lo_ns is None or a >= lo_ns) and (hi_ns is None or b <= hi_ns):
            out.append(Record(s.name, a, b, s.thread, s.parent, s.unit, s.id, s.attrs))
    return out


def spans(lo_ns: int | None = None, hi_ns: int | None = None,
          names=None) -> list[Record]:
    """The spans of the ring and of the profiled store that start at or
    after ``lo_ns`` and end at or before ``hi_ns`` (profiler clock), each
    once, oldest first by end; only those called one of ``names`` where
    it is given."""
    both = {s.id: s for s in (*_kept, *_ring)}
    out = _records(both.values(), lo_ns, hi_ns, names)
    out.sort(key=lambda r: r.end)
    return out


def setup_spans() -> list[Record]:
    """Every ``setup.*`` span of the process (up to :data:`SETUP_SPANS`)."""
    return _records(_setup, None, None)


def clear() -> None:
    """Forget every span and counter."""
    global _ring_appended
    _ring.clear()
    _setup.clear()
    _kept.clear()
    _ring_appended = 0
    with _counts_lock:
        _counts.clear()


@dataclasses.dataclass
class StageStat:
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0
    p50_ms: float = 0.0
    p95_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


# Durations a StageTimer keeps per name for its percentiles: past this, a
# uniform sample of them all (count, total and max stay exact).
RESERVOIR = 2048


class _Summary:
    __slots__ = ("count", "total", "max", "kept")

    def __init__(self):
        self.count, self.total, self.max, self.kept = 0, 0.0, 0.0, []

    def stat(self) -> StageStat:
        p50, p95 = np.percentile(self.kept, (50, 95))
        return StageStat(self.count, self.total, self.max, float(p50), float(p95))


class StageTimer:
    """Per-name summary (count, total, max, p50, p95) of the spans called
    ``<prefix>.<name>`` that feed it: those ``stage(name)`` opens, and
    those opened inside a span given it as ``tally``.  Memory is bounded:
    :data:`RESERVOIR` durations a name, a uniform sample of them all
    (reservoir sampling) once there are more."""

    def __init__(self, prefix: str = "stage"):
        self.prefix = prefix
        self._dot = prefix + "."
        self._sums: dict[str, _Summary] = {}  # by span name
        self._lock = threading.Lock()
        self._random = random.Random(0).random

    def stage(self, name: str) -> span:
        return span(self._dot + name, tally=self)

    def add(self, sp: span) -> None:
        """Take a finished span's duration, if its name has the prefix."""
        name = sp.name
        if not name.startswith(self._dot):
            return
        ms = (sp.end - sp.start) / 1e6
        with self._lock:
            s = self._sums.get(name)
            if s is None:
                s = self._sums[name] = _Summary()
            s.count += 1
            s.total += ms
            if ms > s.max:
                s.max = ms
            if len(s.kept) < RESERVOIR:
                s.kept.append(ms)
            else:  # kept with probability RESERVOIR / count
                j = int(self._random() * s.count)
                if j < RESERVOIR:
                    s.kept[j] = ms

    def _stats(self, sums) -> dict[str, StageStat]:
        k = len(self._dot)
        return {name[k:]: s.stat() for name, s in sums.items()}

    @property
    def stats(self) -> dict[str, StageStat]:
        with self._lock:
            return self._stats(self._sums)

    def drain(self) -> dict[str, StageStat]:
        """:attr:`stats`, and start afresh: one period's summary."""
        with self._lock:
            sums, self._sums = self._sums, {}
        return self._stats(sums)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name}: n={s.count} avg={s.avg_ms:.2f}ms p50={s.p50_ms:.2f}ms "
                f"p95={s.p95_ms:.2f}ms max={s.max_ms:.2f}ms"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {name: dataclasses.asdict(s) | {"avg_ms": s.avg_ms}
                for name, s in self.stats.items()}


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """Profile a region with ``torch.profiler`` (host ops, and the card's
    kernels where CUDA is available) and write it to
    ``log_dir/trace.json``, a Chrome trace (chrome://tracing, Perfetto).
    The port's spans inside the region appear in it by name."""
    import torch
    import torch.profiler

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
