"""The serve tick over ``batch_pair("auto")`` at the ``ref1080p``
deployment's shapes, as the benchmark's ``ref1080p.broadcast32`` cell
drives it, on the CPU: its reduced frames equal the plain reference's
(``benchmark/reference/foveation.py::BoxFilter``) byte for byte, and the
``serve.sample`` and ``sampler.taps`` spans carry the batch as
``viewers``.  Two cases: the upstream's own stream, 1920x1080 ->
1072x608, with 12 gazes (8 from the cell's gaze model, both sides of the
wrap seam, both poles), and a channel's full batch of 32 gazes at
480x270.  The card's case, 1080p x 32 against the plain twin, is
``test_channel_1080p_32_on_card`` in ``tests/test_torch_cuda.py``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.inputs import gaze_trace
from benchmark.reference.foveation import BoxFilter
from foveax_torch.config import FoveaxConfig, reduced_dim
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve.tick import ServeTick

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/ref1080p.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark/traffic/broadcast32.json").read_text())
EDGES = [(0.0, 0.5), (0.999, 0.5), (0.5, 0.0), (0.5, 0.999)]
CASES = {
    "1920x1080-12": ((CONFIG["source_width"], CONFIG["source_height"], CONFIG["reduced_width"],
                      CONFIG["reduced_height"]), 8),
    "480x270-32": ((480, 270, reduced_dim(480), reduced_dim(270)), TRAFFIC["viewers"]),
}


@pytest.fixture()
def clean():
    profiling.clear()
    yield
    profiling.clear()


def _gazes(n: int, seed: int) -> list[tuple[float, float]]:
    """``n`` gazes of one 30 Hz step of the cell's gaze model."""
    trace = gaze_trace(np.random.default_rng(seed), n, TRAFFIC["gaze"])
    return [tuple(map(float, g)) for g in trace[seed % len(trace)]]


@pytest.mark.parametrize("case", list(CASES))
def test_channel_tick_equals_reference(case, clean):
    (w, h, wr, hr), modelled = CASES[case]
    assert CONFIG["batch_sampler"] == "auto" and TRAFFIC["viewers"] == 32
    seed = 2**31 + 28
    gazes = _gazes(modelled, seed)
    if modelled < TRAFFIC["viewers"]:
        gazes += EDGES
    frame = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    p = FoveationPipeline(FoveaxConfig(source_width=w, source_height=h, reduced_width=wr,
                                       reduced_height=hr, fps=float(CONFIG["fps"])), device="cpu")
    assert p.sampler == CONFIG["resolves_to"]
    tick = ServeTick(p, p.batch_pair(CONFIG["batch_sampler"]))
    with ServeTick.unit(viewers=len(gazes)) as root:
        got = tick.sample(tick.prepare(frame), gazes)
    assert got.dtype == np.uint8 and got.shape == (len(gazes), hr, wr, 3)
    box = BoxFilter(w, h, wr, hr)
    f = torch.from_numpy(frame)
    for v, g in enumerate(gazes):
        np.testing.assert_array_equal(got[v], box(f, g, key=0).numpy(), err_msg=f"gaze {v} {g}")
    recs = [r for r in profiling.spans(names=("serve.sample", "sampler.taps")) if r.unit == root.unit]
    assert sorted(r.name for r in recs) == ["sampler.taps", "serve.sample"]
    assert all(r.attrs["viewers"] == len(gazes) for r in recs)
