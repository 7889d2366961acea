"""The port's prefetch runner and stage timer
(``foveax_torch/pipeline/runner.py``, ``profiling.py``) on the CPU, the
cases of ``test_runner.py``; the transcode's outputs are held bit-equal to
foveax's ``run_transcode`` on the same synthetic frames."""

import time

import numpy as np
import pytest
import torch

from foveax.config import FoveaxConfig as FxConfig
from foveax.pipeline.frames import FoveationPipeline as FxPipeline
from foveax.pipeline.runner import run_transcode as fx_run_transcode
from foveax_torch.config import FoveaxConfig
from foveax_torch.io.video import SyntheticReader
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.pipeline.profiling import StageTimer, device_trace
from foveax_torch.pipeline.runner import PrefetchReader, run_transcode

torch.set_num_threads(1)

SMALL = dict(source_width=96, source_height=64, reduced_width=48, reduced_height=32)


def test_prefetch_preserves_order_and_count():
    r = PrefetchReader(SyntheticReader(32, 16, n_frames=20), depth=2)
    direct = list(SyntheticReader(32, 16, n_frames=20))
    got = list(r)
    assert len(got) == 20
    for a, b in zip(got, direct):
        np.testing.assert_array_equal(a, b)


def test_prefetch_propagates_errors():
    class Bad:
        def __init__(self):
            self.n = 0

        def read(self):
            self.n += 1
            if self.n > 3:
                raise RuntimeError("decoder exploded")
            return np.zeros((4, 4, 3), np.uint8)

    r = PrefetchReader(Bad(), depth=1)
    got = 0
    with pytest.raises(RuntimeError, match="decoder exploded"):
        while r.read() is not None:
            got += 1
    assert got == 3


def test_run_transcode_overlap_correctness():
    p = FoveationPipeline(FoveaxConfig(**SMALL), device="cpu")
    outs = {}
    timer = run_transcode(
        SyntheticReader(96, 64, n_frames=7),
        p.foveate,
        lambda i: (0.5, 0.5 - 0.02 * i),
        lambda frame, i: outs.__setitem__(i, frame),
        timer=StageTimer(),
        device="cpu",
    )
    assert sorted(outs) == list(range(7))
    # The same frames through foveax's runner and pipeline.
    fx = FxPipeline(FxConfig(**SMALL))
    want = {}
    fx_run_transcode(
        SyntheticReader(96, 64, n_frames=7),
        fx.foveate,
        lambda i: (0.5, 0.5 - 0.02 * i),
        lambda frame, i: want.__setitem__(i, frame),
    )
    src = SyntheticReader(96, 64, n_frames=7)
    for i, frame in enumerate(src):
        np.testing.assert_array_equal(outs[i], want[i])
        ref = p.foveate(torch.from_numpy(frame), p.center(0.5, 0.5 - 0.02 * i))
        np.testing.assert_array_equal(outs[i], ref.numpy())
    d = timer.as_dict()
    assert d["h2d+dispatch"]["count"] == 7
    assert d["sink"]["count"] == 7
    assert d["d2h"]["count"] == 7
    assert timer.report()


def test_stage_timer_max_and_avg():
    t = StageTimer()
    for dur in (0.001, 0.003):
        with t.stage("x"):
            time.sleep(dur)
    s = t.stats["x"]
    assert s.count == 2
    assert s.max_ms >= s.avg_ms > 0


def test_run_transcode_sink_failure_raises_not_hangs():
    """A failing sink must surface its error instead of deadlocking the
    producer on the bounded readback queue."""
    p = FoveationPipeline(FoveaxConfig(**SMALL), device="cpu")

    def bad_sink(frame, i):
        raise IOError("disk full")

    with pytest.raises(IOError):
        run_transcode(
            SyntheticReader(96, 64, n_frames=30),
            p.foveate,
            lambda i: (0.5, 0.5),
            bad_sink,
            device="cpu",
        )


def test_prefetch_close_mid_stream():
    r = PrefetchReader(SyntheticReader(32, 16, n_frames=500), depth=2)
    assert r.read() is not None
    r.close()  # must not hang or crash with frames still queued


def test_run_transcode_default_device_is_cuda():
    """Without ``device`` the runner asks for cuda and raises without a GPU
    before it reads a frame."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_transcode(SyntheticReader(32, 16, n_frames=2), lambda f, c: f,
                      lambda i: (0.5, 0.5), lambda f, i: None)


def test_torch_profiler_stages_and_trace(tmp_path):
    """Under a running profiler each stage's span is mirrored in the trace
    as a record_function range of its dotted name (no knob: the mirror is
    automatic); device_trace writes a Chrome trace."""
    t = StageTimer()
    with device_trace(tmp_path):
        with t.stage("foveate"):
            torch.ones(4).sum()
    text = (tmp_path / "trace.json").read_text()
    assert '"stage.foveate"' in text
    assert t.stats["foveate"].count == 1
