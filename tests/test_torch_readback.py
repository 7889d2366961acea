"""The serve tick's readback (``serve/tick.py::ServeTick.sample``) and the
client restore's (``serve/client.py::ClientRestore``), both
``serve/tick.py::readback``: on the CPU the frames are read as they are,
the same bytes as ``.cpu()``; on the card they land in pinned blocks that
each caller owns, so frames a caller holds are never overwritten by later
ticks or restores, and a steady loop takes its blocks from the pool.  The
``serve.readback`` and ``client.readback`` spans' ``fresh`` attribute,
the copies' spans and counters (``upload``, ``readback``) and
``tick.readback_fresh_share``'s reader over hand-made spans.

The card tests skip without a CUDA device.  On the card, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_readback.py
"""

import numpy as np
import pytest
import torch

from benchmark.reference.foveation import BoxFilter
from benchmark.trace import Trace, load_module
from foveax_torch.config import FoveaxConfig
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve.client import ClientRestore
from foveax_torch.serve.tick import ServeTick, readback, upload

SMALL = dict(source_width=96, source_height=64, reduced_width=48, reduced_height=32)
# Distinct gazes, across the wrap seam and the poles.
GAZES = [(0.5, 0.5), (0.02, 0.9), (0.97, 0.1), (0.31, 0.77), (0.66, 0.03), (0.12, 0.45)]


@pytest.fixture()
def clean():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def small():
    p = FoveationPipeline(FoveaxConfig(**SMALL), device="cpu")
    frame = np.random.default_rng(11).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    return p, frame


def _plain(tick, prepared, centers):
    """``ServeTick.sample``'s frames read back with a plain ``.cpu()``."""
    if tick.single:
        return tick._sample(prepared, tick.pipeline.center(*centers)).cpu().numpy()
    padded = list(centers) + [centers[-1]] * (-len(centers) % tick.pad_to)
    staged = torch.from_numpy(np.asarray(padded, dtype=np.float32)).to(tick.pipeline.device)
    return tick._sample(prepared, staged).cpu().numpy()[: len(centers)]


@pytest.mark.parametrize("case", ["batch", "padded", "single"])
def test_cpu_readback_is_plain_cpu(small, case, clean):
    p, frame = small
    if case == "single":
        tick, centers, shape = ServeTick(p, p.single_pair(), single=True), GAZES[3], (32, 48, 3)
    else:
        pad_to = 3 if case == "padded" else 1
        tick, centers = ServeTick(p, p.batch_pair("auto"), pad_to=pad_to), GAZES[:2]
        shape = (2, 32, 48, 3)
    prepared = tick.prepare(frame)
    got = tick.sample(prepared, centers)
    want = _plain(tick, prepared, centers)
    assert got.shape == shape and got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


class _Caller:
    """A caller of ``serve/tick.py::readback``: a serve tick's sample of
    the prepared ``frame`` at a batch of gazes (``tick``), or a client's
    restore of ``reduced`` at the first of them (``restore``).  ``span``
    and ``fresh`` name the span it reads back in and the counter of its
    fresh blocks; ``plain`` is its output read back with a plain
    ``.cpu()``."""

    def __init__(self, caller, p, frame, reduced):
        if caller == "tick":
            self.span, self.fresh = "serve.readback", "serve.readback_fresh"
            tick = ServeTick(p, p.batch_pair("auto"))
            prepared = tick.prepare(frame)
            self.run = lambda gazes: tick.sample(prepared, gazes)
            self.plain = lambda gazes: _plain(tick, prepared, gazes)
        else:
            self.span, self.fresh = "client.readback", "client.readback_fresh"
            restore = ClientRestore(p)
            self.run = lambda gazes: restore(reduced, gazes[0])
            self.plain = lambda gazes: _plain_restore(p, reduced, gazes[0])


CALLERS = ["tick", "restore"]


@pytest.mark.parametrize("caller", CALLERS)
def test_cpu_readback_span_is_not_fresh(small, caller, clean):
    p, frame = small
    reduced = np.random.default_rng(4).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    c = _Caller(caller, p, frame, reduced)
    before = profiling.counts().get(c.fresh, 0)
    with ServeTick.unit(viewers=2):
        got = c.run(GAZES[:2])
    (rb,) = profiling.spans(names=(c.span,))
    assert rb.attrs == {"bytes": got.nbytes, "fresh": False}
    assert profiling.counts().get(c.fresh, 0) == before


@pytest.mark.parametrize("span, counted", [
    ("serve.stage", True), ("client.upload", False), ("serve.readback", True),
    ("client.readback", False),
])
def test_copies_name_their_span_and_counters(span, counted, clean):
    """``upload`` and ``readback`` give the span their caller opens its
    ``bytes`` (and a readback ``fresh``), add the bytes to
    ``<span>_bytes`` only where ``counted``, and return the same bytes."""
    x = np.random.default_rng(9).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    before = profiling.counts()
    if span.endswith("readback"):
        got = readback(torch.from_numpy(x), profiling.span(span), counted=counted)
        want_attrs = {"bytes": x.nbytes, "fresh": False}
    else:
        got = upload(x, torch.device("cpu"), profiling.span(span), counted=counted).numpy()
        want_attrs = {"bytes": x.nbytes}
    assert got.tobytes() == x.tobytes()
    (rec,) = profiling.spans(names=(span,))
    assert rec.attrs == want_attrs
    grown = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
             if v != before.get(k, 0)}
    assert grown == ({f"{span}_bytes": x.nbytes} if counted else {})


def test_upload_with_gaze_and_readback_wait(clean):
    """A restore's upload carries its gaze in the same span, outside
    ``bytes``; a readback that only waits reads one element."""
    x = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    up, gaze = upload(x, torch.device("cpu"), profiling.span("client.upload"),
                      gaze=(0.25, 0.75))
    assert up.numpy().tobytes() == x.tobytes()
    assert gaze.dtype == torch.float32 and gaze.tolist() == [0.25, 0.75]
    assert readback(up, profiling.span("client.readback"), whole=False) is None
    assert [(r.name, r.attrs) for r in profiling.spans()] == [
        ("client.upload", {"bytes": 24}), ("client.readback", {"bytes": 1})]


def test_held_outputs_stay_their_own_gaze(small, clean):
    p, frame = small
    tick = ServeTick(p, p.batch_pair("auto"))
    held = []
    for g in GAZES[:5]:
        with ServeTick.unit(viewers=1):
            held.append(tick.sample(tick.prepare(frame), [g]))
    box = BoxFilter(96, 64, 48, 32)
    f = torch.from_numpy(frame)
    for g, out in zip(GAZES[:5], held):
        np.testing.assert_array_equal(out[0], box(f, g, key=0).numpy())


def _plain_restore(p, reduced, center):
    """``ClientRestore``'s frame read back with a plain ``.cpu()``."""
    red = torch.from_numpy(np.ascontiguousarray(reduced)).to(p.device)
    return p.unwarp_auto(red, torch.tensor(center, dtype=torch.float32).to(p.device)).cpu().numpy()


@pytest.mark.parametrize("given", ["host", "tensor"])
def test_cpu_client_restore_is_plain_cpu(small, given, clean):
    p, _ = small
    reduced = np.random.default_rng(3).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    arg = reduced if given == "host" else torch.from_numpy(reduced)
    got = ClientRestore(p)(arg, GAZES[1])
    want = _plain_restore(p, reduced, GAZES[1])
    assert got.shape == (64, 96, 3) and got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


def test_client_restore_without_readback_sets_no_fresh(small, clean):
    p, _ = small
    reduced = np.random.default_rng(4).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    assert ClientRestore(p, readback=False)(reduced, GAZES[2]) is None
    (rb,) = profiling.spans(names=("client.readback",))
    assert rb.attrs == {"bytes": 1}
    assert "client.readback_fresh" not in profiling.counts()


def _rec(a, b, **attrs):
    return profiling.Record("serve.readback", a, b, 1, None, None, 0, attrs)


@pytest.mark.parametrize("fresh, want", [
    ([False, False, False], 0.0),
    ([True, False], 50.0),
    ([], None),
    (None, None),  # spans without the attribute: a program without the mechanism
])
def test_fresh_share_reader(monkeypatch, fresh, want):
    if fresh is None:
        recs = [_rec(100, 200, bytes=8), _rec(300, 400, bytes=8)]
    else:
        recs = [_rec(100 * (2 * i + 1), 100 * (2 * i + 2), bytes=8, fresh=f)
                for i, f in enumerate(fresh)]
    recs += [_rec(5_000, 6_000, bytes=8, fresh=True),  # after the stretch
             profiling.Record("client.readback", 100, 200, 1, None, None, 0, {"fresh": True})]

    def spans(lo_ns=None, hi_ns=None, names=None):
        return [r for r in recs if r.start >= lo_ns and r.end <= hi_ns
                and (names is None or r.name in names)]

    monkeypatch.setattr(profiling, "spans", spans)
    trace = Trace(2, 0, 1_000, [], [], {}, None, 0)
    assert load_module("metrics", "tick.readback_fresh_share").read(trace) == want


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned memory and the sampler's kernel)")
    cfg = FoveaxConfig(source_width=1920, source_height=1080, reduced_width=1072,
                       reduced_height=608)
    p = FoveationPipeline(cfg, device="cuda")
    frame = np.random.default_rng(5).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    return p, frame


@pytest.fixture(scope="module")
def card_reduced(card):
    p, _ = card
    return np.random.default_rng(6).integers(0, 256, p.reduced_shape, dtype=np.uint8)


# Twenty distinct gazes for the held outputs, over the whole sphere.
GAZES20 = [tuple(map(float, g)) for g in np.random.default_rng(20).random((20, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("caller", CALLERS)
def test_card_readback_is_pinned(card, card_reduced, caller, clean):
    c = _Caller(caller, *card, card_reduced)
    got = c.run(GAZES[1:3])
    assert torch.from_numpy(got).is_pinned()
    (rb,) = profiling.spans(names=(c.span,))
    assert rb.attrs["bytes"] == got.nbytes and isinstance(rb.attrs["fresh"], bool)


@pytest.mark.cuda
@pytest.mark.parametrize("caller", CALLERS)
def test_card_held_outputs_stay_equal(card, card_reduced, caller, clean):
    c = _Caller(caller, *card, card_reduced)
    held = [c.run([g]) for g in GAZES20]
    for g, out in zip(GAZES20, held):
        assert out.tobytes() == c.plain([g]).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("caller", CALLERS)
def test_card_steady_readbacks_allocate_no_block(card, card_reduced, caller, clean):
    c = _Caller(caller, *card, card_reduced)
    for k in range(2):
        c.run(GAZES[k: k + 4])
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    fresh = profiling.counts().get(c.fresh, 0)
    for k in range(10):
        c.run(GAZES[k % 3: k % 3 + 4])
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert profiling.counts().get(c.fresh, 0) == fresh
    assert not any(r.attrs["fresh"] for r in profiling.spans(names=(c.span,))[2:])
