"""The drivers drive the port's own serve tick and client restore
(``ServeTick``, ``ClientRestore``): each unit records the port's spans,
gives byte for byte what the inline tick and restore the drivers used to
write gave, and a traced run ties each kernel to the innermost step the
host launched it in."""

import json
import re
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from benchmark import trace as tracing
from benchmark.harness import CHECKOUT, ROOT, Ctx, load_cell, run_cell
from benchmark.inputs import Inputs
from foveax_torch.config import FoveaxConfig
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve.server import _input_stager

torch.set_num_threads(1)

SMALL = dict(source_width=192, source_height=108, reduced_width=112, reduced_height=64)
# driver -> (configuration, traffic mix, the port's readback span)
DRIVERS = {"broadcast": ("equirect8k", "broadcast8", "serve.readback"),
           "session": ("ref1080p", "session1", "serve.readback"),
           "restore": ("equirect8k", "restore1", "client.readback")}


def _ctx(driver, seed=2**31 + 5):
    conf, mix, _ = DRIVERS[driver]
    config = dict(json.loads((ROOT / "configs" / f"{conf}.json").read_text()), **SMALL)
    traffic = json.loads((ROOT / "traffic" / f"{mix}.json").read_text())
    pipeline = FoveationPipeline(FoveaxConfig(fps=float(config["fps"]), **SMALL), device="cpu")
    return Ctx(pipeline, Inputs(seed, config, traffic, "cpu"), config, traffic)


# The units as the drivers wrote them inline before they called the port.
def _inline_broadcast(ctx):
    pipeline, inputs = ctx.pipeline, ctx.inputs
    stage = _input_stager(pipeline.device)
    prepare, batch_sample = pipeline.batch_pair(ctx.config["batch_sampler"])

    def unit(k):
        i = inputs.frame(k)
        prepared = prepare(stage(inputs.pool[i]))
        gaze = inputs.gaze(k)
        out = batch_sample(prepared, stage(np.asarray(gaze, dtype=np.float32)))
        return ("reduced", i, gaze, out.cpu().numpy())

    return unit


def _inline_session(ctx):
    pipeline, inputs = ctx.pipeline, ctx.inputs
    stage = _input_stager(pipeline.device)
    prepare, sample_one = pipeline.single_pair()

    def unit(k):
        i = inputs.frame(k)
        prepared = prepare(stage(inputs.pool[i]))
        gaze = inputs.gaze(k)
        out = sample_one(prepared, pipeline.center(float(gaze[0, 0]), float(gaze[0, 1])))
        return ("reduced", i, gaze, out.cpu().numpy()[np.newaxis])

    return unit


def _inline_restore(ctx):
    pipeline, inputs = ctx.pipeline, ctx.inputs
    dev = pipeline.device

    def unit(k):
        i = inputs.frame(k)
        gaze = inputs.gaze(k)
        reduced = torch.from_numpy(np.ascontiguousarray(inputs.pool[i])).to(dev)
        center = torch.tensor((float(gaze[0, 0]), float(gaze[0, 1])), dtype=torch.float32).to(dev)
        return ("restored", i, gaze, pipeline.unwarp_auto(reduced, center).cpu().numpy())

    return unit


INLINE = {"broadcast": _inline_broadcast, "session": _inline_session, "restore": _inline_restore}


@pytest.mark.parametrize("driver", DRIVERS)
def test_unit_goes_through_the_ports_callable(driver):
    """One readback span of the port a unit, inside the unit's root span,
    and nothing copied to or from the device by the driver itself."""
    source = (ROOT / "drivers" / f"{driver}.py").read_text()
    assert not re.search(r"\.(cpu|to|cuda)\(", source)
    ctx = _ctx(driver)
    unit = tracing.load_module("drivers", driver).make(ctx)
    profiling.clear()
    for k in range(3):
        unit(k)
    recs = profiling.spans()
    roots = [r for r in recs if r.name == ("client.restore" if driver == "restore" else "serve.tick")]
    readbacks = [r for r in recs if r.name == DRIVERS[driver][2]]
    assert len(roots) == len(readbacks) == 3
    assert sorted(r.unit for r in readbacks) == sorted(r.unit for r in roots)
    if driver != "restore":
        assert [r.attrs["viewers"] for r in roots] == [ctx.inputs.viewers] * 3
        assert sum(r.name == "serve.sample" for r in recs) == 3
    profiling.clear()


@pytest.mark.parametrize("driver", DRIVERS)
def test_unit_output_equals_the_inline_unit(driver):
    ctx = _ctx(driver)
    new = tracing.load_module("drivers", driver).make(ctx)
    old = INLINE[driver](ctx)
    for k in (0, 1, 5, 4097):
        latency, (kind, i, gaze, out) = new(k)
        kind0, i0, gaze0, out0 = old(k)
        assert latency > 0 and (kind, i) == (kind0, i0) and np.array_equal(gaze, gaze0)
        assert out.dtype == out0.dtype == np.uint8 and out.shape == out0.shape
        assert out.tobytes() == out0.tobytes()


@pytest.mark.parametrize("driver", DRIVERS)
def test_steps_are_spans_of_the_port(driver):
    """Each step a driver names is carried by a span the port opens."""
    names = set()
    pat = re.compile(r"""\b(?:span|root)\(\s*["']([^"']+)["']""")
    for path in (CHECKOUT / "foveax_torch").rglob("*.py"):
        names |= set(pat.findall(path.read_text()))
    steps = tracing.load_module("drivers", driver).SPANS
    assert steps and set(steps.values()) <= names
    assert not any("." in s for s in steps)


class _Event:
    """A raw profiler record as ``summarize`` reads it."""

    def __init__(self, name, start, end=None, *, device=False, annotation=False, corr=0):
        self._name, self._start = name, start
        self._dur = (end if end is not None else start + 1) - start
        self._device = DeviceType.CUDA if device else DeviceType.CPU
        self._annotation, self._corr = annotation, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._corr


def _span(name, a, b):
    return _Event(name, a, b, annotation=True)


def _kernel(name, launched, corr, at):
    """A kernel launched at ``launched`` that runs from ``at`` for 5 us."""
    return [_Event("cudaLaunchKernel", launched, corr=corr),
            _Event(name, at, at + 5_000, device=True, corr=corr)]


def _tick(t0):
    """One broadcast tick's records from ``t0``: the frame's staging, the
    sample with the gaze's staging nested in it and the taps after it,
    the readback."""
    return [
        _span("serve.tick", t0, t0 + 900_000),
        _span("serve.stage", t0 + 10_000, t0 + 100_000),
        _Event("cudaMemcpyAsync", t0 + 20_000, corr=t0 + 1),
        _Event("Memcpy HtoD (Pageable -> Device)", t0 + 30_000, t0 + 90_000, device=True,
               corr=t0 + 1),
        _span("serve.prepare", t0 + 100_000, t0 + 110_000),
        _span("serve.sample", t0 + 200_000, t0 + 600_000),
        _span("serve.stage", t0 + 210_000, t0 + 250_000),
        _Event("cudaMemcpyAsync", t0 + 220_000, corr=t0 + 2),
        _Event("Memcpy HtoD (Pageable -> Device)", t0 + 230_000, t0 + 240_000, device=True,
               corr=t0 + 2),
        _span("sampler.taps", t0 + 260_000, t0 + 400_000),
        *_kernel("elementwise", t0 + 270_000, t0 + 3, t0 + 300_000),
        *_kernel("elementwise", t0 + 390_000, t0 + 4, t0 + 410_000),
        *_kernel("void segment_reduce_xy_kernel<1>()", t0 + 500_000, t0 + 5, t0 + 520_000),
        _span("serve.readback", t0 + 600_000, t0 + 890_000),
        _Event("cudaMemcpyAsync", t0 + 610_000, corr=t0 + 6),
        _Event("Memcpy DtoH (Device -> Pageable)", t0 + 620_000, t0 + 880_000, device=True,
               corr=t0 + 6),
    ]


def test_kernels_after_a_nested_stage_count_in_their_step():
    """A kernel launched in ``serve.sample`` after the gaze's nested
    ``serve.stage`` is the sample's (``sampler.launches``), the gaze's copy
    the stage's; each idle gap goes to the innermost port span."""
    steps = tracing.load_module("drivers", "broadcast").SPANS
    records = _tick(1_000_000) + _tick(2_000_000)
    t = tracing.summarize(records, steps, 2, {}, None)
    assert (t.lo, t.hi) == (1_010_000, 2_890_000)
    assert [s[0] for s in t.spans] == ["stage", "prepare", "sample", "stage", "readback"] * 2
    assert t.per_span("sample") == [3, 3]
    assert t.per_span("stage", "htod") == [1, 1, 1, 1]
    read = {n: tracing.load_module("metrics", n).read(t)
            for n in ("sampler.launches", "sampler.host_ms", "tick.upload_ms", "tick.readback_ms")}
    assert read == pytest.approx({"sampler.launches": 3, "sampler.host_ms": 0.4,
                                  "tick.upload_ms": 0.07, "tick.readback_ms": 0.26})
    # a gap goes whole to the innermost port span at its middle; the one
    # across the two ticks lies in none
    gaps = dict(tracing.breakdown(t)["idle_gaps"])
    assert gaps == pytest.approx({f"host in {n}": v / 1e9 for n, v in (
        ("serve.stage", 20_000), ("serve.tick", 280_000), ("sampler.taps", 330_000),
        ("serve.sample", 400_000), ("serve.readback", 10_000))} | {
        "host between spans": 150_000 / 1e9})


def test_a_trace_without_the_steps_is_refused():
    with pytest.raises(RuntimeError, match="none of the port's spans"):
        tracing.summarize([_span("sampler.taps", 0, 10)], {"sample": "serve.sample"}, 1, {}, None)


def test_traced_restore_reads_its_steps():
    """A whole traced run of the restore cell on the CPU: the restore's
    steps are found and its per-layer metrics read."""
    cell = load_cell("equirect8k.restore")
    cell.config = dict(cell.config, **SMALL)
    r = run_cell(cell, 7, 1.0, True, device="cpu", t_start=time.perf_counter(),
                 log=lambda s: None)
    assert r["correct"]
    gaps = {k for k, _ in r["breakdown"]["idle_gaps"]}
    assert gaps <= {"host between spans"} | {f"host in {n}" for n in (
        "client.restore", "client.upload", "client.readback", "unwarp.vectors",
        "unwarp.layout", "unwarp.kernel")}
    assert r["metrics"]["restore.idle_in_vectors_ms"]["value"] > 0
    assert r["metrics"]["restore.latency_p95_ms"]["value"] > 0
    assert r["device"]["window_s"] > 0
