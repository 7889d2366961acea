"""Per-stage timings of the foveated path (counterpart of the JAX
package's ``scripts/stage_bench.py``).

    python -m foveax_torch.scripts.stage_bench [--resolutions 4k 8k 16k]
        [--iters 20] [--precision auto] [--stages sat sample unwarp]
        [--device cuda]

Each stage runs ``--iters`` times in a Python loop whose iterations depend
on each other through device scalars, as the JAX package's ``fori_loop``
does: the gaze of iteration i is ``centers[i] + acc * 1e-30``, where
``acc`` sums one output value of every iteration before it, and the SAT
build flips the low bit of pixel (0, 0) of channel 0 by the SAT corner's
parity.  Nothing reads the device until the loop's end, one scalar
readback.  Printed per stage: the JAX package's line ``"{res} {name}:
{ms:.2f} ms/frame"``, the median of 3 loops on the host clock, and on the
card beside it the device ms per frame, the sum of the loop's kernel times
(``torch.profiler``, one more loop) over ``--iters``, and the device's busy
ms per frame, the union of those kernels' intervals (the host clock's ms
less the busy ms is the time the device waited on the host).

Stages: ``sat`` the SAT build (K5 on the card), ``sample`` the 4-tap SAT
sampler (its taps, then K7 on the card), ``fused`` the fused sampler's taps then ``segreduce_xy``,
``direct`` the SAT-free direct sampler (plain PyTorch), ``unwarp`` the
unwarp at ``--precision`` (``"auto"``: ``unwarp_xy`` where its contract
holds).  The loop builders take ``(pipeline, frame, centers)`` and return
``step(i, acc) -> (acc, output)``.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable

import numpy as np
import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.core.direct import sample_rect_direct
from foveax_torch.core.sat import build_sat
from foveax_torch.core.unwarp import PRECISIONS, unwarp_rect
from foveax_torch.device import resolve_device
from foveax_torch.kernels.segreduce import sample_rect_fused
from foveax_torch.pipeline.frames import FoveationPipeline

RES = {
    "1080p": (1920, 1080),
    "4k": (3840, 2160),
    "8k": (7680, 4320),
    "16k": (15360, 8640),
}
STAGES = ("sat", "sample", "unwarp", "direct", "fused")

Step = Callable[[int, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def gaze_trace(n: int, device) -> torch.Tensor:
    """The JAX package's per-frame gaze trace, (n, 2) float32."""
    t = np.linspace(0.0, 1.0, n)
    centers = np.stack(
        [0.5 + 0.4 * np.sin(2 * np.pi * t), 0.5 + 0.3 * np.cos(2 * np.pi * t)],
        axis=-1,
    ).astype(np.float32)
    return torch.from_numpy(centers).to(device)


def _first(out: torch.Tensor) -> torch.Tensor:
    """The value at (0, 0, 0) of a (3, H, W) uint8 output, as float32."""
    return out[0, 0, 0].to(torch.float32)


def sat_loop(pipeline: FoveationPipeline, frame: torch.Tensor,
             centers: torch.Tensor) -> Step:
    """The SAT build of a (3, H, W) frame; each iteration's SAT flips the
    low bit of a copy's pixel (0, 0) of channel 0 by its corner's parity,
    so the next build depends on it.  ``centers`` is not read."""
    f = frame.clone()

    def step(i: int, acc: torch.Tensor):
        sat = build_sat(f, in_layout="chw")
        bits = sat.view(torch.int32)
        f[0, :1, :1] ^= (bits[0, :1, :1] & 1).to(torch.uint8)
        return acc + bits[-1, -1, -1].to(torch.float32), sat

    return step


def sample_loop(pipeline: FoveationPipeline, frame: torch.Tensor,
                centers: torch.Tensor) -> Step:
    """The 4-tap SAT sampler on the frame's SAT, built once."""
    sat = build_sat(frame, in_layout="chw")

    def step(i: int, acc: torch.Tensor):
        red = pipeline.sample_chw(sat, centers[i] + acc * 1e-30)
        return acc + _first(red), red

    return step


def fused_loop(pipeline: FoveationPipeline, frame: torch.Tensor,
               centers: torch.Tensor) -> Step:
    """The fused sampler: its taps, then ``segreduce_xy``."""

    def step(i: int, acc: torch.Tensor):
        red = sample_rect_fused(frame, pipeline.grid, centers[i] + acc * 1e-30,
                                wrap_x=pipeline.wrap_x, out_layout="chw")
        return acc + _first(red), red

    return step


def direct_loop(pipeline: FoveationPipeline, frame: torch.Tensor,
                centers: torch.Tensor) -> Step:
    """The SAT-free direct sampler (plain PyTorch, no kernel)."""

    def step(i: int, acc: torch.Tensor):
        red = sample_rect_direct(frame, pipeline.grid, centers[i] + acc * 1e-30,
                                 wrap_x=pipeline.wrap_x, out_layout="chw")
        return acc + _first(red), red

    return step


def unwarp_loop(pipeline: FoveationPipeline, frame: torch.Tensor,
                centers: torch.Tensor, *, precision: str = "auto") -> Step:
    """The unwarp at ``precision`` of the frame's reduced frame at the
    first gaze (the SAT path's), back to the source size."""
    red = pipeline.sample_chw(build_sat(frame, in_layout="chw"), centers[0])
    cfg = pipeline.config

    def step(i: int, acc: torch.Tensor):
        out = unwarp_rect(red, cfg.source_width, cfg.source_height,
                          centers[i] + acc * 1e-30, in_layout="chw",
                          out_layout="chw", precision=precision)
        return acc + _first(out), out

    return step


def run(step: Step, n: int, device) -> float:
    """``n`` chained iterations, then one scalar readback."""
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(n):
        acc, _ = step(i, acc)
    return float(acc)


def host_ms(step: Step, n: int, device) -> float:
    """Median of 3 loops on the host clock, ms per iteration."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(step, n, device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / n * 1e3


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals: the time the
    device ran at least one of them."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_ms(step: Step, n: int, device) -> tuple[float, float, float]:
    """One more loop under ``torch.profiler``, per iteration: the sum of
    its kernels' device ms, the device's busy ms (the union of their
    intervals: less than the sum where kernels overlap, as K5's
    programmatically dependent launches do) and the count of kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(step, n, device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("torch.profiler recorded no device time")
    total = sum(e.time_range.elapsed_us() for e in events)
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events])
    return total / n / 1e3, busy / n / 1e3, len(events) / n


def stage_loops(precision: str) -> dict[str, tuple[str, Callable[..., Step]]]:
    """Stage -> (the JAX package's printed name, loop builder)."""

    def unwarp(pipeline, frame, centers):
        return unwarp_loop(pipeline, frame, centers, precision=precision)

    return {
        "sat": ("sat_build", sat_loop),
        "sample": ("gaze_sample", sample_loop),
        "direct": ("direct_sample", direct_loop),
        "fused": ("fused_sample", fused_loop),
        "unwarp": (f"unwarp_{precision}", unwarp),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolutions", nargs="*", default=["4k", "8k"], choices=RES)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--precision", default="auto", choices=PRECISIONS)
    ap.add_argument(
        "--stages", nargs="*", default=["sat", "sample", "unwarp"],
        choices=STAGES,
        help="subset to time; 'direct', 'fused' (and 'sat' + 'sample') "
        "each take a frame to its reduced frame",
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    loops = stage_loops(args.precision)
    rng = np.random.default_rng(0)
    n = args.iters
    for res in args.resolutions:
        w, h = RES[res]
        pipe = FoveationPipeline(FoveaxConfig().with_source(w, h), device=dev)
        frame = torch.from_numpy(
            rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)).to(dev)
        centers = gaze_trace(n, dev)
        for stage in args.stages:
            name, build = loops[stage]
            step = build(pipe, frame, centers)
            run(step, n, dev)  # warm: kernels built, caches filled
            ms = host_ms(step, n, dev)
            line = f"{res} {name}: {ms:.2f} ms/frame"
            if dev.type == "cuda":
                d_ms, busy, kernels = device_ms(step, n, dev)
                line += (f"  (host {ms:.4f}; device {d_ms:.4f}, busy {busy:.4f} "
                         f"ms/frame; {kernels:g} kernels/frame)")
            print(line, flush=True)
            del step
        del pipe, frame, centers
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
