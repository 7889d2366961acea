"""Tails over every unit, the busy union and the idle share."""

import statistics

import numpy as np
import pytest

from benchmark import stats
from benchmark.trace import Op, Trace
from benchmark.trace import breakdown as trace_breakdown
from benchmark.trace import load_module


def test_p95_over_all_units():
    lat = [1.0] * 95 + [10.0] * 5
    assert stats.percentile(lat, 95) == pytest.approx(float(np.percentile(lat, 95)))
    # a stall moves the tail: medians of chunks would not
    base = [1.0] * 1000
    stalled = base[:940] + [50.0] * 60
    assert stats.percentile(base, 95) == 1.0
    assert stats.percentile(stalled, 95) > 40


def test_busy_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert stats.busy(iv) == 25
    assert stats.busy(iv, 8, 22) == 9
    assert stats.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert stats.gaps([], 0, 5) == [(0, 5)]


def test_spread_matches_statistics_quantiles():
    v = [10.0, 10.5, 9.8, 10.2, 11.0, 9.9]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def _trace(ops, units=2, lo=0, hi=1_000_000):
    spans = [("stage", 0, 100_000), ("sample", 100_000, 400_000), ("readback", 400_000, 500_000),
             ("stage", 500_000, 600_000), ("sample", 600_000, 900_000), ("readback", 900_000, 1_000_000)]
    cell = {"source_width": 1920, "source_height": 1080, "reduced_width": 1072,
            "reduced_height": 608, "viewers": 1}
    peak = {"bytes_per_s": 3.35e12, "ops_per_s": 6.7e13}
    # the port's spans: each tick's root, the gaze's staging nested in the
    # first sample, the taps in the second
    port = {"stage": "serve.stage", "sample": "serve.sample", "readback": "serve.readback"}
    annotations = [(port[n], a, b) for n, a, b in spans] + [
        ("serve.tick", 0, 500_000), ("serve.tick", 500_000, 1_000_000),
        ("serve.stage", 100_000, 130_000), ("sampler.taps", 600_000, 750_000)]
    return Trace(units, lo, hi, ops, spans, cell, peak, 0, annotations=annotations)


def test_idle_share_and_readers_from_synthetic_intervals():
    ops = [Op("Memcpy HtoD (Pageable -> Device)", "htod", 10_000, 90_000, "stage"),
           Op("void segment_reduce_xy_kernel<1>(unsigned char const*)", "kernel", 300_000, 320_000, "sample", 200_000),
           Op("elementwise", "kernel", 150_000, 160_000, "sample", 110_000),
           Op("Memcpy DtoH (Device -> Pageable)", "dtoh", 410_000, 490_000, "readback"),
           Op("Memcpy HtoD (Pageable -> Device)", "htod", 510_000, 590_000, "stage"),
           Op("void segment_reduce_xy_kernel<1>(unsigned char const*)", "kernel", 800_000, 820_000, "sample", 700_000),
           Op("Memcpy DtoH (Device -> Pageable)", "dtoh", 910_000, 990_000, "readback")]
    t = _trace(ops)
    assert t.busy_s == pytest.approx(370_000 / 1e9)
    read = {n: load_module("metrics", n).read(t) for n in
            ("device_idle.tick", "tick.upload_ms", "tick.readback_ms", "sampler.launches",
             "sampler.host_ms", "segreduce_xy_roofline")}
    assert read["device_idle.tick"] == pytest.approx(63.0)
    assert read["tick.upload_ms"] == pytest.approx(0.08)
    assert read["tick.readback_ms"] == pytest.approx(0.08)
    assert read["sampler.launches"] == 1.5  # the median of 2 and 1
    assert read["sampler.host_ms"] == pytest.approx(0.3)
    nbytes = 3 * 1080 * 1920 + 9 * (1072 + 608) + 3 * 608 * 1072
    assert read["segreduce_xy_roofline"] == pytest.approx(100 * nbytes / 3.35e12 / 20e-6)
    b = trace_breakdown(t)
    assert b["device_ops"][0][0].startswith("Memcpy")
    assert b["device_ops"][0][1] == pytest.approx(160_000 / 1e9)
    # each gap by the innermost port span the host was in
    names = dict(b["idle_gaps"])
    assert names == pytest.approx({"host in serve.sample": 320_000 / 1e9,
                                   "host in sampler.taps": 210_000 / 1e9,
                                   "host in serve.stage": 90_000 / 1e9,
                                   "host in serve.readback": 10_000 / 1e9})
    t.annotations = []
    assert dict(trace_breakdown(t)["idle_gaps"]) == pytest.approx(
        {"host between spans": 630_000 / 1e9})


def test_readers_return_nothing_without_their_work():
    t = _trace([])
    for n in ("tick.upload_ms", "tick.readback_ms", "sampler.launches", "segreduce_xy_roofline",
              "restore.launches", "restore.copy_ms", "unwarp_xy_roofline"):
        assert load_module("metrics", n).read(t) is None, n
    t.peak = None
    t.ops = [Op("void unwarp_xy_kernel(unsigned char const*)", "kernel", 0, 10, "unwarp")]
    assert load_module("metrics", "unwarp_xy_roofline").read(t) is None



def test_restore_tail_reads_the_untraced_units():
    t = _trace([])
    assert load_module("metrics", "restore.latency_p95_ms").read(t) is None
    t.latencies = [0.05] * 95 + [0.2] * 5
    assert load_module("metrics", "restore.latency_p95_ms").read(t) == pytest.approx(
        float(np.percentile(t.latencies, 95)) * 1e3)
