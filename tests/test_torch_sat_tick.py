"""The serve tick over the SAT pair (``batch_pair("sat")``: K5's build,
then K7's taps for every gaze), as the benchmark's ``equirect8k_sat``
cell drives it, on the CPU at small shapes: its reduced frames equal the
plain reference's (``benchmark/reference/foveation.py::BoxFilter``) and
the fused pair's, byte for byte; the K5 span carries the SAT's bytes, the
``sampler.sat_bytes`` counter adds them up a tick, and the K7 span carries
the gaze count.  The card's case at 7680x4320, where a channel's total
wraps past 2^32, is ``test_sat_tick_wraps_at_8k`` in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from benchmark.reference.foveation import BoxFilter
from foveax_torch.config import FoveaxConfig
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve.tick import ServeTick

# (source width, height, reduced width, height): the 96x64 stream and an
# odd shape on every axis.
SHAPES = [(96, 64, 48, 32), (101, 57, 55, 33)]
# Eight gazes: both sides of the wrap seam, both poles, the centre.
GAZES = [(0.0, 0.5), (0.999, 0.5), (0.5, 0.0), (0.5, 0.999), (0.02, 0.02), (0.98, 0.98),
         (0.5, 0.5), (0.31, 0.77)]


@pytest.fixture()
def clean():
    profiling.clear()
    yield
    profiling.clear()


def _pipeline(w, h, wr, hr):
    cfg = FoveaxConfig(source_width=w, source_height=h, reduced_width=wr, reduced_height=hr)
    return FoveationPipeline(cfg, device="cpu")


def _frame(h, w, fill):
    if fill == "all-255":
        return np.full((h, w, 3), 255, np.uint8)
    return np.random.default_rng(2**31 + 23).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _tick(p, sampler, frame, gazes):
    tick = ServeTick(p, p.batch_pair(sampler))
    with ServeTick.unit(viewers=len(gazes)) as root:
        out = tick.sample(tick.prepare(frame), gazes)
    return out, root.unit


@pytest.mark.parametrize("fill", ["noise", "all-255"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_sat_tick_equals_reference_and_fused(shape, fill, clean):
    w, h, wr, hr = shape
    p = _pipeline(*shape)
    frame = _frame(h, w, fill)
    got, _ = _tick(p, "sat", frame, GAZES)
    assert got.dtype == np.uint8 and got.shape == (len(GAZES), hr, wr, 3)
    box = BoxFilter(w, h, wr, hr)
    want = np.stack([box(torch.from_numpy(frame), g, key=0).numpy() for g in GAZES])
    np.testing.assert_array_equal(got, want)
    fused, _ = _tick(p, "fused", frame, GAZES)
    np.testing.assert_array_equal(got, fused)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_sat_tick_spans_and_counter(shape, clean):
    w, h, wr, hr = shape
    p = _pipeline(*shape)
    frame = _frame(h, w, "noise")
    before = profiling.counts().get("sampler.sat_bytes", 0)
    for ticks in (1, 2, 3):
        _, unit = _tick(p, "sat", frame, GAZES[: 2 + ticks])
        assert profiling.counts()["sampler.sat_bytes"] - before == ticks * 12 * h * w
        kernels = [r for r in profiling.spans(names=("sampler.kernel",)) if r.unit == unit]
        assert [r.attrs["kernel"] for r in kernels] == ["K5", "K7"]
        k5, k7 = kernels
        assert k5.attrs["bytes"] == 12 * h * w
        assert k7.attrs["viewers"] == 2 + ticks
        # K5 runs in the tick's prepare step, before the gazes; K7 in its sample step
        parents = {r.id: r.name for r in profiling.spans() if r.unit == unit}
        assert parents[k5.parent] == "serve.prepare" and parents[k7.parent] == "serve.sample"
    # the fused pair builds no SAT
    _tick(p, "fused", frame, GAZES)
    assert profiling.counts()["sampler.sat_bytes"] - before == 3 * 12 * h * w
