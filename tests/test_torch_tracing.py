"""The port's tracer (``foveax_torch/pipeline/profiling.py``) on the CPU:
the span tree and unit ids across asyncio tasks and executor threads, the
ring's bound, the ``setup.*`` list, the profiled spans kept past the
ring, the ``record_function`` mirror on the profiler's clock, the
program's span names against the benchmark drivers', and the serve tick
and client restore as callables against the inline code they replaced."""

import ast
import asyncio
import logging
import re
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.parallel import make_mesh
from foveax_torch.parallel.sharded import jit_serve_parts, jit_serve_parts_fused
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve.client import ClientRestore, ClientStats
from foveax_torch.serve.server import FoveaxServer, _input_stager
from foveax_torch.serve.tick import ServeTick

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(source_width=96, source_height=64, reduced_width=48, reduced_height=32)
# The spans the port opens, layer by layer (PERF.md §3).
PROGRAM_SPANS = {
    "setup.pipeline", "setup.kernel_load", "serve.tick", "serve.read", "serve.stage",
    "serve.prepare", "serve.pace", "serve.sample", "sampler.taps", "sampler.layout",
    "sampler.kernel", "serve.readback", "serve.encode", "serve.send", "client.restore",
    "client.decode", "client.upload", "client.readback", "unwarp.vectors", "unwarp.layout",
    "unwarp.kernel",
}


@pytest.fixture()
def clean():
    profiling.clear()
    yield
    profiling.clear()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_span_tree_and_unit_ids_across_tasks_and_threads(clean):
    """Three ticks interleave on the event loop; each binds its executor
    call to its own unit.  Every span of a tick shares the tick's unit id,
    each child names its parent, and the executor's spans run on another
    thread."""
    main = threading.get_ident()

    async def tick(k):
        loop = asyncio.get_running_loop()
        with profiling.root("serve.tick", k=k) as root:
            await asyncio.sleep(0)  # let the other ticks open theirs

            def work():
                with profiling.span("serve.prepare") as sp:
                    with profiling.span("sampler.taps"):
                        pass
                return sp.unit

            seen = await loop.run_in_executor(None, profiling.bind(work))
            await asyncio.sleep(0)
            with profiling.span("serve.send"):
                await asyncio.sleep(0)
        return root.unit, seen

    async def run():
        return await asyncio.gather(*(tick(k) for k in range(3)))

    results = asyncio.run(run())
    units = [u for u, _ in results]
    assert len(set(units)) == 3 and all(u is not None for u in units)
    assert [seen for _, seen in results] == units
    recs = profiling.spans()
    by_id = {r.id: r for r in recs}
    for u in units:
        mine = _by_name([r for r in recs if r.unit == u])
        assert sorted(mine) == ["sampler.taps", "serve.prepare", "serve.send", "serve.tick"]
        root, prep = mine["serve.tick"][0], mine["serve.prepare"][0]
        taps, send = mine["sampler.taps"][0], mine["serve.send"][0]
        assert root.parent is None and root.thread == main
        assert prep.parent == root.id and taps.parent == prep.id and send.parent == root.id
        assert prep.thread != main and taps.thread == prep.thread and send.thread == main
        for child in (prep, taps, send):
            parent = by_id[child.parent]
            assert parent.start <= child.start <= child.end <= parent.end
    # outside a unit nothing is set
    with profiling.span("serve.read") as sp:
        pass
    assert sp.unit is None and sp.parent is None


def test_executor_call_without_bind_is_outside_the_unit(clean):
    """run_in_executor does not carry the context: only bind() puts the
    executor's spans in the caller's unit."""

    def work():
        with profiling.span("serve.prepare") as sp:
            pass
        return sp.unit, sp.parent

    async def run():
        loop = asyncio.get_running_loop()
        with profiling.root("serve.tick") as root:
            plain = await loop.run_in_executor(None, work)
            bound = await loop.run_in_executor(None, profiling.bind(work))
        return (root.unit, root.id), plain, bound

    root, plain, bound = asyncio.run(run())
    assert plain == (None, None) and bound == root


def test_ring_is_bounded_and_setup_spans_survive(clean):
    for k in range(3):
        with profiling.span("setup.pipeline", k=k):
            pass
    n = profiling.RING_SPANS + 100
    for k in range(n):
        with profiling.span("serve.read", k=k):
            pass
    recs = profiling.spans()
    assert len(recs) == profiling.RING_SPANS
    assert [r.attrs["k"] for r in recs[:2]] == [100, 101]
    assert recs[-1].attrs["k"] == n - 1
    assert [r.attrs["k"] for r in profiling.setup_spans()] == [0, 1, 2]
    assert not any(r.name.startswith("setup.") for r in recs)
    assert profiling.spans(names=("serve.tick",)) == []


def _fields(r):
    """A record without its stamps, which each read puts on the profiler's
    clock through an offset of its own."""
    return (r.name, r.end - r.start, r.thread, r.parent, r.unit, r.id, r.attrs)


def test_profiled_spans_outlive_the_ring(clean):
    """Spans that finish under a running torch.profiler are still read
    whole, once each, after the ring has wrapped past them; the ring's
    drops are counted, and clear() forgets both stores."""
    from torch.profiler import ProfilerActivity, profile

    with profiling.span("serve.read"):
        pass
    # Each read puts the stamps on the profiler's clock through an offset of
    # its own, so the window's edges keep a gap wider than the offsets differ.
    time.sleep(0.05)
    lo = profiling.now_ns()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for k in range(50):
        with profiling.root("serve.tick", k=k):
            with profiling.span("sampler.taps", viewers=32):
                pass
    prof.stop()
    hi = profiling.now_ns()
    time.sleep(0.05)
    traced = profiling.spans(lo, hi)
    assert len(traced) == 100 and len({r.id for r in traced}) == 100  # in both stores, read once
    assert [r.attrs["k"] for r in traced if r.name == "serve.tick"] == list(range(50))
    assert "profiling.ring_evicted" not in profiling.counts()

    n = profiling.RING_SPANS + 100
    for k in range(n):
        with profiling.span("serve.read", k=k):
            pass
    assert profiling.counts()["profiling.ring_evicted"] == 1 + 100 + 100
    assert [_fields(r) for r in profiling.spans(lo, hi)] == [_fields(r) for r in traced]
    recs = profiling.spans()
    assert len(recs) == profiling.RING_SPANS + 100 and len({r.id for r in recs}) == len(recs)
    assert [r.end for r in recs] == sorted(r.end for r in recs)
    assert [_fields(r) for r in recs[:100]] == [_fields(r) for r in traced]
    assert [_fields(r) for r in profiling.spans(names=("sampler.taps",))] == [
        _fields(r) for r in traced if r.name == "sampler.taps"]

    profiling.clear()
    assert profiling.spans() == [] and "profiling.ring_evicted" not in profiling.counts()
    with profiling.span("serve.read"):
        pass
    assert len(profiling.spans()) == 1 and profiling.counts() == {}


def test_ring_evictions_counted_across_threads(clean):
    """More threads than cores make spans with a short switch interval:
    ``profiling.ring_evicted`` counts every span the ring dropped, with
    no lock taken per span."""
    import os
    import sys

    workers, each = 2 * (os.cpu_count() or 1) + 2, 8000
    assert workers * each > profiling.RING_SPANS

    def feed():
        for _ in range(each):
            with profiling.span("serve.read"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=feed) for _ in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(profiling.spans()) == profiling.RING_SPANS
    assert profiling.counts()["profiling.ring_evicted"] == workers * each - profiling.RING_SPANS


def test_spans_window_and_counters(clean):
    with profiling.span("serve.read"):
        pass
    mid = profiling.now_ns()
    with profiling.span("serve.stage"):
        pass
    assert [r.name for r in profiling.spans(lo_ns=mid)] == ["serve.stage"]
    assert [r.name for r in profiling.spans(hi_ns=mid)] == ["serve.read"]
    profiling.count("serve.stage_bytes", 10)
    profiling.count("serve.stage_bytes", 5)
    profiling.count("x.y")
    assert profiling.counts() == {"serve.stage_bytes": 15, "x.y": 1}


def test_mirror_lies_inside_the_span_on_the_profilers_clock(clean):
    """Under torch.profiler each span opens a record_function of its name;
    on the shared clock each mirror lies inside its program span, within
    10 us at each end."""
    from torch.profiler import ProfilerActivity, profile

    n = 200
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for k in range(n):
        with profiling.span("unwarp.vectors", k=k):
            torch.ones(8).sum()
    prof.stop()
    mirrors = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation() and e.name() == "unwarp.vectors")
    progs = sorted((r.start, r.end) for r in profiling.spans() if r.name == "unwarp.vectors")
    assert len(mirrors) == len(progs) == n
    slack = 10_000
    for (ma, mb), (pa, pb) in zip(mirrors, progs):
        assert pa - slack <= ma and mb <= pb + slack, (ma - pa, pb - mb)


def test_no_mirror_without_a_profiler(clean, monkeypatch):
    made = []

    class Fake:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Fake)
    with profiling.span("serve.sample"):
        pass
    assert made == []
    monkeypatch.setattr(profiling._autograd_profiler, "_is_profiler_enabled", True)
    with profiling.span("serve.sample") as sp:
        assert sp._mirror is not None
    assert made == ["serve.sample"]
    assert sp._mirror is None and sp._token is None  # the ring keeps plain records


def _program_span_names() -> set[str]:
    names = set()
    pat = re.compile(r"""\b(?:span|root)\(\s*["']([^"']+)["']""")
    for path in (ROOT / "foveax_torch").rglob("*.py"):
        names |= set(pat.findall(path.read_text()))
    return names


def _driver_spans() -> set[str]:
    names = set()
    for path in (ROOT / "benchmark" / "drivers").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "SPANS" for t in node.targets):
                names |= set(ast.literal_eval(node.value))
    return names


def test_program_span_names_are_dotted_and_not_the_drivers():
    """Each key of a benchmark driver's ``SPANS`` is a step of its unit,
    carried by the port span it names.  The benchmark keeps user
    annotations by name, so a port span named like a step would be read
    as that step."""
    names = _program_span_names()
    assert names == PROGRAM_SPANS
    assert all("." in n for n in names)
    drivers = _driver_spans()
    assert {"stage", "sample", "upload", "unwarp"} <= drivers
    assert not names & drivers, (
        f"port spans named like a driver's steps (each SPANS key is a step carried by the "
        f"port span it names): {sorted(names & drivers)}")
    assert not {f"stage.{n}" for n in ("h2d+dispatch", "d2h", "sink")} & drivers


def test_stage_timer_percentiles(clean):
    t = profiling.StageTimer()
    for _ in range(20):
        with t.stage("x"):
            pass
    s = t.stats["x"]
    assert s.count == 20 and 0 <= s.p50_ms <= s.p95_ms <= s.max_ms
    assert [r.name for r in profiling.spans()] == ["stage.x"] * 20
    assert t.as_dict()["x"]["count"] == 20 and "p95=" in t.report()


def _finished(name, ms):
    """A span-like record of ``ms`` for StageTimer.add."""
    return SimpleNamespace(name=name, start=0, end=round(ms * 1e6))


def test_stage_timer_is_bounded_and_drains():
    """Past RESERVOIR durations a name keeps a uniform sample: count, total
    and max stay exact, the percentiles stay near the whole stream's, and
    drain() starts a new period."""
    t = profiling.StageTimer("serve")
    n = 10 * profiling.RESERVOIR
    for k in range(1, n + 1):
        t.add(_finished("serve.tick", float(k)))
    t.add(_finished("client.decode", 1.0))  # another prefix: not taken
    assert len(t._sums["serve.tick"].kept) == profiling.RESERVOIR
    s = t.stats["tick"]
    assert s.count == n and s.max_ms == n and s.total_ms == pytest.approx(n * (n + 1) / 2)
    assert s.p50_ms == pytest.approx(n / 2, rel=0.05)
    assert s.p95_ms == pytest.approx(0.95 * n, rel=0.02)
    assert set(t.drain()) == {"tick"} and t.stats == {} and t.drain() == {}


def test_stage_timer_counts_every_span_across_threads(clean):
    """Executor threads feed one tally while a stats loop drains it: every
    span lands in exactly one period, and no update is lost."""
    import os
    import sys

    t = profiling.StageTimer("serve")
    workers, each = 2 * (os.cpu_count() or 1) + 2, 8000
    periods = []
    done = threading.Event()

    def feed(k):
        for _ in range(each):
            t.add(_finished("serve.read", float(k)))

    def drain():
        while not done.is_set():
            periods.append(t.drain())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=feed, args=(k,)) for k in range(workers)]
        drainer = threading.Thread(target=drain)
        drainer.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        done.set()
        drainer.join(timeout=60)
        assert not any(th.is_alive() for th in threads + [drainer])
    finally:
        sys.setswitchinterval(old)
    periods.append(t.drain())
    read = [p["read"] for p in periods if "read" in p]
    assert len(read) > 1  # the drains cut the stream into periods
    assert sum(s.count for s in read) == workers * each
    assert sum(s.total_ms for s in read) == pytest.approx(each * workers * (workers - 1) / 2)
    assert max(s.max_ms for s in read) == workers - 1


def test_spans_feed_the_tally_of_their_unit_across_threads(clean):
    """A unit's spans, in its executor calls too, feed its root's tally;
    a span outside the unit does not."""
    t = profiling.StageTimer("serve")

    async def run():
        loop = asyncio.get_running_loop()
        with profiling.root("serve.tick", tally=t):
            def work():
                with profiling.span("serve.prepare"):
                    with profiling.span("sampler.taps"):
                        pass
            await loop.run_in_executor(None, profiling.bind(work))
            with profiling.span("serve.send"):
                pass
        with profiling.span("serve.read"):
            pass

    asyncio.run(run())
    assert {k: v.count for k, v in t.stats.items()} == {"tick": 1, "prepare": 1, "send": 1}


@pytest.fixture(scope="module")
def small():
    p = FoveationPipeline(FoveaxConfig(**SMALL), device="cpu")
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    centers = [(0.5, 0.5), (0.02, 0.9), (0.97, 0.1)]
    return p, frame, centers


def _inline_batch(pipeline, pair, frame, centers, pad_to=1):
    """BroadcastChannel._loop's tick before the ServeTick."""
    build, batch_sample = pair
    stage = _input_stager(pipeline.device)
    prepared = build(stage(frame))
    padded = centers + [centers[-1]] * (-len(centers) % pad_to)
    return batch_sample(
        prepared, stage(np.asarray(padded, dtype=np.float32))
    ).cpu().numpy()[: len(centers)]


@pytest.mark.parametrize("sampler", ["fused", "sat", "direct"])
def test_serve_tick_equals_inline_batch_tick(small, sampler, clean):
    p, frame, centers = small
    pair = p.batch_pair(sampler)
    want = _inline_batch(p, pair, frame, centers)
    tick = ServeTick(p, pair)
    with ServeTick.unit(viewers=len(centers)) as root:
        got = tick.sample(tick.prepare(frame), centers)
    assert got.dtype == np.uint8 and got.shape == (3, 32, 48, 3)
    np.testing.assert_array_equal(got, want)
    names = {r.name for r in profiling.spans() if r.unit == root.unit}
    assert {"serve.tick", "serve.stage", "serve.prepare", "serve.sample", "sampler.taps",
            "serve.readback"} <= names
    if sampler != "direct":
        assert "sampler.kernel" in names
    if sampler == "fused":
        assert "sampler.layout" in names


@pytest.mark.parametrize("fused", [True, False])
def test_serve_tick_equals_inline_sharded_tick(small, fused):
    p, frame, centers = small
    mesh = make_mesh(n_space=1, n_data=2, devices=["cpu"] * 2)
    pair = (jit_serve_parts_fused(p.grid, mesh) if fused else jit_serve_parts(p.grid, mesh))
    want = _inline_batch(p, pair, frame, centers, pad_to=2)
    tick = ServeTick(p, pair, pad_to=2)
    np.testing.assert_array_equal(tick.sample(tick.prepare(frame), centers), want)


def test_serve_tick_equals_inline_session_tick(small):
    p, frame, _ = small
    prepare, sample_one = p.single_pair()
    stage = _input_stager(p.device)
    cx, cy = 0.31, 0.77
    want = sample_one(prepare(stage(frame)), p.center(cx, cy)).cpu().numpy()
    tick = ServeTick(p, p.single_pair(), single=True)
    got = tick.sample(tick.prepare(frame), (cx, cy))
    assert got.shape == (32, 48, 3)
    np.testing.assert_array_equal(got, want)


def test_client_restore_equals_inline_restore(small, clean):
    p, frame, _ = small
    reduced = p.foveate(torch.from_numpy(frame), p.center(0.4, 0.6)).numpy()
    center = (0.4, 0.6)
    want = p.unwarp_auto(
        torch.from_numpy(np.ascontiguousarray(reduced)).to(p.device),
        torch.tensor(center, dtype=torch.float32).to(p.device)).cpu().numpy()
    got = ClientRestore(p)(reduced, center)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ClientRestore(p)(torch.from_numpy(reduced), center), want)
    assert ClientRestore(p, readback=False)(reduced, center) is None
    recs = profiling.spans()
    roots = [r for r in recs if r.name == "client.restore"]
    assert len(roots) == 3 and len({r.unit for r in roots}) == 3
    first = {r.name for r in recs if r.unit == roots[0].unit}
    assert first == {"client.restore", "client.upload", "unwarp.vectors", "unwarp.layout",
                     "unwarp.kernel", "client.readback"}


def test_client_stats_percentiles():
    """The means come from record(), the percentiles from the client.*
    spans that fed the stats (decode, the restore as unwarp, upload,
    readback)."""
    s = ClientStats()
    assert s.averages()["p95_unwarp_ms"] == 0.0
    for k in range(1, 101):
        s.record(0, 1.0, float(k), 2.0 * k)
        s.spans.add(_finished("client.decode", float(k)))
        s.spans.add(_finished("client.restore", 2.0 * k))
        s.spans.add(_finished("client.upload", 0.5))
        s.spans.add(_finished("client.readback", 3.0))
    a = s.averages()
    assert a["avg_decode_ms"] == pytest.approx(50.5) and a["avg_unwarp_ms"] == pytest.approx(101)
    assert a["p50_decode_ms"] == pytest.approx(50.5) and a["p95_decode_ms"] == pytest.approx(95.05)
    assert a["p95_unwarp_ms"] == pytest.approx(190.1)
    assert a["p50_upload_ms"] == pytest.approx(0.5) and a["p95_readback_ms"] == pytest.approx(3.0)
    assert "p95 190.10" in s.report() and "readback p50 3.00" in s.report()


def test_client_restore_feeds_the_client_stats(small, clean):
    """ClientRestore's spans feed the stats it is given; its last root
    span is what the client records as the frame's unwarp time."""
    p, frame, _ = small
    s = ClientStats()
    restore = ClientRestore(p, tally=s.spans)
    reduced = p.foveate(torch.from_numpy(frame), p.center(0.4, 0.6)).numpy()
    for _ in range(3):
        restore(reduced, (0.4, 0.6))
    stats = s.spans.stats
    assert {k: v.count for k, v in stats.items()} == {"restore": 3, "upload": 3, "readback": 3}
    assert stats["restore"].max_ms >= restore.last.ms > 0


def test_stats_loop_logs_tick_percentiles(clean, caplog):
    server = FoveaxServer(FoveaxConfig(**SMALL), device="cpu")

    async def run():
        task = asyncio.create_task(server._stats_loop(period_s=0.2))
        await asyncio.sleep(0)
        for _ in range(4):
            with ServeTick.unit(tally=server.tally):
                with profiling.span("serve.sample"):
                    pass
                with profiling.span("serve.readback"):
                    pass
                with profiling.span("serve.encode", member=0):
                    pass
        profiling.count("serve.readback_bytes", 4_000_000)
        server.total_sent += 4
        for _ in range(100):  # the first period that saw the ticks logs them
            await asyncio.sleep(0.05)
            if any("fps=" in r.getMessage() for r in caplog.records):
                break
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    with caplog.at_level(logging.INFO, logger="foveax_torch.serve"):
        asyncio.run(run())
    line = next(r.getMessage() for r in caplog.records if "fps=" in r.getMessage())
    assert "tick p50=" in line and "sample p50=" in line and "readback p50=" in line
    assert "encode p50=" in line
    assert "readback=20MB/s" in line
