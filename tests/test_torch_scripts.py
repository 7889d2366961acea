"""The port's tools (``foveax_torch/scripts``) on the CPU: the stage
loops of ``stage_bench`` against ``FoveationPipeline`` (tolerance 0), the
shape fuzz ``fuzz_fused`` (exit codes, and its reference route against
foveax's float64 goldens: the sampler exactly, the unwarp within 1 LSB),
and ``two_process_demo`` in two processes on the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from foveax.core import golden
from foveax_torch import FoveaxConfig, FoveationPipeline
from foveax_torch.kernels import segreduce as sr
from foveax_torch.scripts import fuzz_fused, stage_bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# (source width, height, reduced width, height)
LOOP_SHAPES = [(96, 64, 48, 32), (256, 128, 128, 64)]
ITERS = 4


def _pipe(shape):
    w, h, wr, hr = shape
    cfg = FoveaxConfig(source_width=w, source_height=h, reduced_width=wr,
                       reduced_height=hr)
    return FoveationPipeline(cfg, device="cpu")


def _frame(shape, seed: int) -> torch.Tensor:
    w, h = shape[:2]
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (3, h, w), np.uint8))


def _loop_outputs(build, pipe, frame, centers) -> list[torch.Tensor]:
    step = build(pipe, frame, centers)
    acc = torch.zeros((), dtype=torch.float32)
    outs = []
    for i in range(len(centers)):
        acc, out = step(i, acc)
        outs.append(out.clone())
    return outs


@pytest.mark.parametrize("shape", LOOP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("stage", stage_bench.STAGES)
def test_stage_loop_matches_pipeline(shape, stage):
    """Each stage loop's output at iteration i equals the pipeline's at
    gaze i (the ``acc * 1e-30`` it adds leaves a float32 gaze as it is):
    the reduced frame of every sampler, the "auto" unwarp of the first
    gaze's reduced frame, and for the SAT build the SAT of the frame with
    the bit flips of the iterations before it."""
    pipe = _pipe(shape)
    frame = _frame(shape, 3)
    centers = stage_bench.gaze_trace(ITERS, "cpu")
    _, build = stage_bench.stage_loops("auto")[stage]
    outs = _loop_outputs(build, pipe, frame, centers)
    if stage == "sat":
        f = frame.clone()
        for out in outs:
            want = pipe.build_sat(f.permute(1, 2, 0))
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
            f[0, 0, 0] ^= int(want.view(torch.int32)[0, 0, 0]) & 1
        return
    red0 = pipe.foveate_chw(frame, centers[0])
    for i, out in enumerate(outs):
        if stage == "unwarp":
            want = pipe.unwarp_auto_chw(red0, centers[i])
        else:
            want = pipe.foveate_chw(frame, centers[i])
        assert out.dtype == torch.uint8 and torch.equal(out, want), i


def test_stage_loops_leave_the_frame_as_it_is():
    pipe = _pipe(LOOP_SHAPES[0])
    frame = _frame(LOOP_SHAPES[0], 4)
    before = frame.clone()
    _loop_outputs(stage_bench.sat_loop, pipe, frame,
                  stage_bench.gaze_trace(ITERS, "cpu"))
    assert torch.equal(frame, before)


def test_stage_bench_prints_the_lines(capsys):
    """The JAX package's line per stage; no device time off the card."""
    rc = stage_bench.main(["--device", "cpu", "--resolutions", "1080p",
                           "--iters", "1", "--stages", "fused", "unwarp"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert [re.sub(r"[0-9.]+ ms", "X ms", line) for line in lines] == [
        "1080p fused_sample: X ms/frame", "1080p unwarp_auto: X ms/frame"]


SMALL = ["0", "3", "--device", "cpu", "--max-width", "600", "--max-height", "300"]


def test_fuzz_passes_on_cpu(capsys):
    assert fuzz_fused.main(SMALL) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "FAILS: 0"
    assert out.count("sampler_eq=True") == 3 * 4 and "bad=none" in out


def test_fuzz_catches_a_flipped_byte(monkeypatch, capsys):
    """A ``segment_reduce_xy_batch`` that gets one byte wrong fails the
    fuzz (exit code 1)."""
    real = sr.segment_reduce_xy_batch

    def flipped(*args):
        out = real(*args).clone()
        out.view(-1)[out.numel() // 2] ^= 1
        return out

    monkeypatch.setattr(sr, "segment_reduce_xy_batch", flipped)
    assert fuzz_fused.main(SMALL) == 1
    out = capsys.readouterr().out
    assert "xy_eq=False" in out and out.splitlines()[-1] != "FAILS: 0"


def test_fuzz_draws_eligible_unaligned_shapes():
    """Widths never a multiple of 16, the first above 8,192 when allowed,
    every shape inside the fused sampler's contract."""
    rng = np.random.default_rng(5)
    for t in range(6):
        pipe = fuzz_fused.eligible_pipeline(rng, 16384, 2200, t == 0, "cpu")
        w, h = pipe.config.source_width, pipe.config.source_height
        assert w % 16 and 96 <= w <= 16384 and 64 <= h <= 2200 and pipe.fused_ok
        assert t or w > 8192


@pytest.mark.parametrize("shape", [(525, 214), (594, 144), (134, 68)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fuzz_reference_route_matches_golden(shape):
    """The fuzz's references against foveax's float64 goldens: the SAT
    route equal to ``golden.sample_rect`` (tolerance 0), the exact unwarp
    within 1 LSB of ``golden.unwarp_rect``, at a random gaze and the edge
    gazes."""
    from foveax_torch.config import reduced_dim

    w, h = shape
    pipe = _pipe((w, h, reduced_dim(w), reduced_dim(h)))
    wr, hr = pipe.config.reduced_width, pipe.config.reduced_height
    frame = _frame(shape, 6)
    frame_hwc = frame.permute(1, 2, 0).numpy()
    sat = golden.build_sat(frame_hwc)
    dense = golden.grid_dense(wr, hr, w, h)
    np.testing.assert_array_equal(pipe.grid.dense(), dense)
    for gaze in [(0.37, 0.61), *fuzz_fused.EDGE_GAZES]:
        c = pipe.center(*gaze)
        red = fuzz_fused.sat_route(frame, pipe.grid, c)
        want = golden.sample_rect(sat, dense, gaze).transpose(2, 0, 1)
        np.testing.assert_array_equal(red.numpy(), want)
        out = fuzz_fused.exact_unwarp(red, w, h, c).numpy().astype(np.int16)
        ref = golden.unwarp_rect(want.transpose(1, 2, 0), w, h, gaze)
        assert np.abs(out - ref.transpose(2, 0, 1).astype(np.int16)).max() <= 1


def _demo(*extra, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "foveax_torch.scripts.two_process_demo",
         "--server-device", "cpu", "--client-device", "cpu", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_two_process_demo_on_cpu():
    out = _demo("--resolution", "160x90", "--frames", "10")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[demo] frames: 10 in" in out.stdout
    assert "[demo] gaze fan-in latency (request -> echoed frame): mean" in out.stdout
    assert re.search(r"\[demo\] wire: \d+ bytes", out.stdout)


def test_two_process_demo_dead_server_exits_1():
    """A server that dies at startup gives exit code 1, not a hang."""
    out = _demo("--resolution", "160x90", "--frames", "10",
                "--server-args=--no-such-flag")
    assert out.returncode == 1
    assert "server died during startup" in out.stderr


def test_smoke_phases_11_to_13_on_cpu(capsys):
    """chip_smoke.py's phases 11-13 at small sizes on the CPU (no launch
    counted, the kernels' plain versions throughout): the ladder's fused
    and SAT paths at 256x128, the fuzz at 2 small shapes, the two-process
    demo at 160x90 and the soak."""
    import chip_smoke

    errs = {}
    report = chip_smoke.ladder_paths(None, errs, 256, 128, "cpu")
    assert report == {"fused": {}, "sat": {}}
    assert errs == {"segreduce_xy": 0, "unwarp_xy": 0, "sat_build": 0,
                    "sat_sample": 0}
    lines = chip_smoke.phase_fuzz(
        "cpu", ["1", "2", "--max-width", "400", "--max-height", "200"])
    assert lines[-1] == "FAILS: 0"
    report = chip_smoke.phase_processes(
        "cpu", ("cpu",), ["--resolution", "160x90", "--frames", "6"], "cpu")
    assert any(line.startswith("[demo] frames: 6 in") for line in report["demo cpu"])
    assert soak_reports_clean(report)
    out = capsys.readouterr().out
    assert "ladder 256x128 -> 144x80: fused path 4 chained frames" in out


def soak_reports_clean(report) -> bool:
    from foveax_torch.scripts import soak

    soaks = [v for k, v in report.items() if k.startswith("soak ")]
    return bool(soaks) and all(soak.residue(r) == [] for r in soaks)


def test_busy_time_is_the_union_of_intervals():
    assert stage_bench.busy_us([]) == 0
    assert stage_bench.busy_us([(5, 7), (0, 2), (1, 3), (6, 9), (9, 10)]) == 8
    assert stage_bench.busy_us([(0, 10), (2, 3)]) == 10
