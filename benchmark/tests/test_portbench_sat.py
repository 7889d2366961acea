"""The SAT cell's rooflines: K5's and K7's least bytes, and their readers
on synthetic traces (K5's three kernels under one span count as one build;
K7's one launch a tick by its kernel name)."""

import numpy as np
import pytest

from benchmark.reference.foveation import axis_taps, grid_axis
from benchmark.trace import Op, Trace, load_module
from foveax_torch.pipeline import profiling

SHAPE_8K = dict(source_width=7680, source_height=4320, reduced_width=4272, reduced_height=2400,
                viewers=8)
PEAK = {"bytes_per_s": 3.35e12, "ops_per_s": 6.7e13}
# K7 at 8K x 8: four SAT words a value, and the output plus the taps alone.
FOUR_WORDS = 4_183_622_784
OUT_AND_TAPS = 246_547_584


def _read(name, trace):
    return load_module("metrics", name).read(trace)


def test_k5_bytes_at_8k():
    b, ops = load_module("roofline", "k5").cost(SHAPE_8K)
    assert b == 497_664_000
    assert b / 3.35e12 * 1e3 == pytest.approx(0.1486, abs=1e-4)
    assert ops / 6.7e13 < b / 3.35e12 / 2  # bytes bound it


def test_k7_bytes_at_8k_lie_between_output_and_four_words():
    k7 = load_module("roofline", "k7")
    b, ops = k7.cost(SHAPE_8K)
    assert k7.sat_words(SHAPE_8K) == 3 * 4059 * 1200
    assert b == 714_144_384
    assert 4 * 8 * 3 * 2400 * 4272 * 4 + OUT_AND_TAPS == FOUR_WORDS
    assert OUT_AND_TAPS < b < FOUR_WORDS
    assert ops / 6.7e13 < b / 3.35e12 / 2


def test_k7_sat_words_never_exceed_a_gazes():
    """At 1080p every integer gaze column and row touches at least the
    SAT words the roofline counts."""
    k7 = load_module("roofline", "k7")
    cell = dict(source_width=1920, source_height=1080, reduced_width=1072, reduced_height=608)
    gx, gy = grid_axis(1072, 1920), grid_axis(608, 1080)

    def fewest(g, dim, wrap):
        counts = []
        for c in range(dim):
            hi, lo, valid = axis_taps(g, c, dim, wrap)
            counts.append(len(np.unique(np.concatenate([hi[valid], lo[valid]]))))
        return min(counts)

    assert k7.sat_words(cell) == 3 * fewest(gx, 1920, True) * fewest(gy, 1080, False)


@pytest.fixture()
def ring(monkeypatch):
    """A synthetic ring in place of the tracer's."""
    recs = []

    def spans(lo_ns=None, hi_ns=None, names=None):
        return [r for r in recs
                if (lo_ns is None or r.start >= lo_ns) and (hi_ns is None or r.end <= hi_ns)
                and (names is None or r.name in names)]

    monkeypatch.setattr(profiling, "spans", spans)
    return recs


def _rec(name, a, b, **attrs):
    return profiling.Record(name, a, b, 1, None, None, 0, attrs)


def _kernel(name, a, b, launched):
    return Op(name, "kernel", a, b, "prepare", launched)


def _trace(ops, peak=PEAK):
    return Trace(2, 0, 10_000_000, ops, [("prepare", 0, 10_000_000)], SHAPE_8K, peak, 0)


def test_k5_three_kernels_under_one_span_are_one_build(ring):
    ring += [_rec("sampler.kernel", 1_000_000, 1_100_000, kernel="K5", bytes=12 * 4320 * 7680),
             _rec("sampler.kernel", 2_000_000, 2_100_000, kernel="K7", viewers=8),
             _rec("sampler.kernel", 5_000_000, 5_100_000, kernel="K5", bytes=12 * 4320 * 7680)]
    ops = [
        # build 1: three kernels, the third overlapping the second (a
        # programmatic dependent launch): 1.2 ms to 1.7 ms of device time
        _kernel("band_totals_kernel", 1_200_000, 1_300_000, 1_010_000),
        _kernel("band_carry_kernel", 1_300_000, 1_350_000, 1_020_000),
        _kernel("sat_band_kernel", 1_340_000, 1_700_000, 1_030_000),
        # K7, launched inside its own span and not K5's
        _kernel("sat_sample_kernel", 1_700_000, 2_900_000, 2_010_000),
        # a copy inside the K5 span is no kernel of the build
        Op("Memcpy HtoD", "htod", 1_050_000, 1_150_000, "prepare", 1_040_000),
        # build 2: 5.2 ms to 5.5 ms
        _kernel("band_totals_kernel", 5_200_000, 5_300_000, 5_010_000),
        _kernel("band_carry_kernel", 5_300_000, 5_350_000, 5_020_000),
        _kernel("sat_band_kernel", 5_350_000, 5_500_000, 5_030_000),
        # launched after the build's span
        _kernel("elementwise", 5_600_000, 5_700_000, 5_200_000),
    ]
    t = _trace(ops)
    k5 = load_module("metrics", "k5_roofline")
    assert k5.build_times_ns(t) == [500_000, 300_000]
    bound_s = 497_664_000 / 3.35e12
    assert k5.read(t) == pytest.approx(100 * bound_s / 400e-6)
    assert _read("k5_roofline", _trace(ops, peak=None)) is None


def test_k5_nothing_without_a_k5_span(ring, monkeypatch):
    ops = [_kernel("band_totals_kernel", 1_200_000, 1_300_000, 1_010_000)]
    assert _read("k5_roofline", _trace(ops)) is None
    ring.append(_rec("sampler.kernel", 1_000_000, 1_100_000, kernel="segreduce_xy"))
    assert _read("k5_roofline", _trace(ops)) is None
    ring.append(_rec("sampler.kernel", 3_000_000, 3_100_000, kernel="K5"))
    assert _read("k5_roofline", _trace(ops)) is None  # no kernel launched inside it
    monkeypatch.delattr(profiling, "spans")  # a port without the tracer
    assert _read("k5_roofline", _trace(ops)) is None


def test_k7_roofline_by_its_kernel_name():
    ops = [_kernel("sat_sample_kernel", 0, 1_000_000, 0),
           _kernel("sat_sample_kernel", 2_000_000, 2_600_000, 2_000_000),
           _kernel("sat_band_kernel", 3_000_000, 9_000_000, 3_000_000)]
    bound_s = 714_144_384 / 3.35e12
    assert _read("k7_roofline", _trace(ops)) == pytest.approx(100 * bound_s / 800e-6)
    assert _read("k7_roofline", _trace(ops[2:])) is None
