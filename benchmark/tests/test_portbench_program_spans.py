"""The readers of the program's own spans (``benchmark/program_spans.py``
and the six ``metrics/`` files that use it) on a synthetic trace and a
synthetic ring: launches counted per span instance, idle time cut to the
spans' intervals, None where the stretch holds no such span or the
program has no tracer."""

import time

import pytest

from benchmark.trace import Op, Trace, load_module
from foveax_torch.pipeline import profiling

READERS = ("sampler.taps_launches", "sampler.idle_in_taps_ms", "restore.vectors_launches",
           "restore.idle_in_vectors_ms", "setup.pipeline_s", "setup.kernel_load_s")


def _rec(name, a, b, unit=None):
    return profiling.Record(name, a, b, 1, None, unit, 0, {})


@pytest.fixture()
def ring(monkeypatch):
    """A synthetic ring and set-up list in place of the tracer's."""
    recs, setup = [], []

    def spans(lo_ns=None, hi_ns=None, names=None):
        return [r for r in recs
                if (lo_ns is None or r.start >= lo_ns) and (hi_ns is None or r.end <= hi_ns)
                and (names is None or r.name in names)]

    monkeypatch.setattr(profiling, "spans", spans)
    monkeypatch.setattr(profiling, "setup_spans", lambda: list(setup))
    return recs, setup


def _trace(ops, units=2, lo=0, hi=1_000_000):
    spans = [("sample", 100_000, 400_000), ("sample", 600_000, 900_000)]
    return Trace(units, lo, hi, ops, spans, {}, None, 0)


def _kernel(a, b, launched):
    return Op("elementwise", "kernel", a, b, "sample", launched)


def _read(name, trace):
    return load_module("metrics", name).read(trace)


def test_launches_counted_per_span_instance(ring):
    recs, _ = ring
    recs += [_rec("sampler.taps", 110_000, 250_000, 1), _rec("sampler.layout", 100_000, 110_000, 1),
             _rec("sampler.taps", 610_000, 750_000, 2),
             _rec("sampler.taps", 1_100_000, 1_200_000, 3)]  # after the stretch
    ops = [_kernel(120_000, 130_000, 111_000), _kernel(140_000, 150_000, 200_000),
           _kernel(160_000, 170_000, 250_000),  # launched at the span's end: inside
           _kernel(300_000, 320_000, 105_000),  # launched in sampler.layout
           _kernel(620_000, 630_000, 612_000), _kernel(640_000, 650_000, 700_000),
           Op("Memcpy HtoD", "htod", 615_000, 618_000, "sample", 611_000),  # a copy
           _kernel(700_000, 710_000, None),  # no launch found
           _kernel(1_150_000, 1_160_000, 1_110_000)]
    t = _trace(ops)
    assert _read("sampler.taps_launches", t) == pytest.approx(5 / 2)
    assert _read("restore.vectors_launches", t) is None


def test_idle_cut_to_span_intervals(ring):
    recs, _ = ring
    recs += [_rec("unwarp.vectors", 100_000, 300_000), _rec("unwarp.vectors", 600_000, 700_000),
             _rec("unwarp.kernel", 300_000, 320_000)]
    # device busy 0-150k, 200k-250k, 650k-1M: idle 150k-200k and 250k-650k
    ops = [Op("k", "kernel", 0, 150_000, None, 110_000),
           Op("k", "kernel", 200_000, 250_000, None, 250_000),
           Op("Memcpy DtoH", "dtoh", 650_000, 1_000_000, None, 640_000)]
    t = _trace(ops)
    # inside the vectors spans: 150k-200k, 250k-300k and 600k-650k
    assert _read("restore.idle_in_vectors_ms", t) == pytest.approx(150_000 / 2 / 1e6)
    assert _read("sampler.idle_in_taps_ms", t) is None
    # nested or overlapping instances of one name count once
    recs.append(_rec("unwarp.vectors", 120_000, 290_000))
    assert _read("restore.idle_in_vectors_ms", t) == pytest.approx(150_000 / 2 / 1e6)
    assert _read("restore.vectors_launches", t) == pytest.approx(2 / 2)


def test_setup_seconds_from_the_setup_list(ring):
    _, setup = ring
    t = _trace([])
    assert _read("setup.pipeline_s", t) is None and _read("setup.kernel_load_s", t) is None
    setup += [_rec("setup.pipeline", 0, 1_500_000_000),
              _rec("setup.kernel_load", 2_000_000_000, 2_250_000_000),
              _rec("setup.kernel_load", 3_000_000_000, 3_010_000_000)]
    assert _read("setup.pipeline_s", t) == pytest.approx(1.5)
    assert _read("setup.kernel_load_s", t) == pytest.approx(0.26)


def test_nothing_where_the_stretch_has_no_span_or_units(ring):
    recs, _ = ring
    recs.append(_rec("sampler.taps", 10, 20))
    for name in READERS[:4]:
        assert _read(name, _trace([], lo=100, hi=200)) is None, name
    assert _read("sampler.taps_launches", _trace([_kernel(10, 20, 15)], units=0)) is None


def test_nothing_without_the_programs_tracer(monkeypatch):
    """A port without the tracer (the parent of the change that added it):
    every reader returns None and raises nothing."""
    monkeypatch.delattr(profiling, "spans")
    t = _trace([_kernel(10, 20, 15)])
    for name in READERS:
        assert _read(name, t) is None, name


def test_the_real_ring_on_the_profilers_clock():
    """Spans the port records, read back on the clock the device trace
    uses: a launch stamped inside the span counts, one after it does not."""
    profiling.clear()
    lo = profiling.now_ns()
    with profiling.span("sampler.taps"):
        time.sleep(0.002)
    time.sleep(0.001)
    hi = profiling.now_ns()
    (taps,) = profiling.spans(lo, hi)
    assert lo <= taps.start < taps.end <= hi and taps.end - taps.start >= 2_000_000
    ops = [_kernel(taps.start + 10_000, taps.start + 20_000, taps.start + 1_000),
           _kernel(taps.end + 200_000, taps.end + 300_000, taps.end + 100_000)]
    t = Trace(1, lo, hi, ops, [], {}, None, 0)
    assert _read("sampler.taps_launches", t) == 1
    idle = _read("sampler.idle_in_taps_ms", t)
    assert idle == pytest.approx((taps.end - taps.start - 10_000) / 1e6)
    profiling.clear()
