"""The serve tick's readback (``serve/tick.py::ServeTick.sample``): on the
CPU the frames are read as they are, the same bytes as ``.cpu()``; on the
card they land in pinned blocks that each caller owns, so frames a caller
holds are never overwritten by later ticks, and a steady loop takes its
blocks from the pool.  The ``serve.readback`` span's ``fresh`` attribute
and ``tick.readback_fresh_share``'s reader over hand-made spans.

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
from foveax_torch.serve.tick import ServeTick

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


def test_cpu_readback_span_is_not_fresh(small, clean):
    p, frame = small
    tick = ServeTick(p, p.batch_pair("auto"))
    before = profiling.counts().get("serve.readback_fresh", 0)
    with ServeTick.unit(viewers=2):
        got = tick.sample(tick.prepare(frame), GAZES[:2])
    (rb,) = [r for r in profiling.spans() if r.name == "serve.readback"]
    assert rb.attrs == {"bytes": got.nbytes, "fresh": False}
    assert profiling.counts().get("serve.readback_fresh", 0) == before


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


@pytest.mark.cuda
def test_card_readback_is_pinned(card, clean):
    p, frame = card
    tick = ServeTick(p, p.batch_pair("auto"))
    got = tick.sample(tick.prepare(frame), GAZES[:2])
    assert torch.from_numpy(got).is_pinned()
    (rb,) = [r for r in profiling.spans() if r.name == "serve.readback"]
    assert rb.attrs["bytes"] == got.nbytes and isinstance(rb.attrs["fresh"], bool)


@pytest.mark.cuda
def test_card_held_outputs_stay_equal(card, clean):
    p, frame = card
    tick = ServeTick(p, p.batch_pair("auto"))
    prepared = tick.prepare(frame)
    held = [tick.sample(prepared, [g]) for g in GAZES]
    for g, out in zip(GAZES, held):
        assert out.tobytes() == _plain(tick, prepared, [g]).tobytes()


@pytest.mark.cuda
def test_card_steady_ticks_allocate_no_block(card, clean):
    p, frame = card
    tick = ServeTick(p, p.batch_pair("auto"))
    prepared = tick.prepare(frame)
    for _ in range(2):
        tick.sample(prepared, GAZES[:4])
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    fresh = profiling.counts().get("serve.readback_fresh", 0)
    for k in range(10):
        tick.sample(prepared, GAZES[k % 3: k % 3 + 4])
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert profiling.counts().get("serve.readback_fresh", 0) == fresh
    assert not any(r.attrs["fresh"] for r in profiling.spans(names=("serve.readback",))[2:])
