#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``foveax_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. Build the CUDA kernels of the fused foveate -> unwarp path from
   ``foveax_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. At 1080p (1920x1080 -> 1072x608) and 4K (3840x2160 -> 2144x1200), over
   five gazes and a batch of eight for the sampler, run each kernel and its
   plain PyTorch version on the same inputs on the card: they must be
   bit-equal (tolerance 0).
3. Drive the 4K main path through ``FoveationPipeline`` (``foveate_chw``
   then the fused ``unwarp_auto_chw``) over a 32-frame gaze trace, each
   restored frame fed back as the next input.  Every kernel's launch count
   must rise by exactly 32, the fovea of every roundtrip must equal its
   source, and the first frame must equal the CPU pipeline's result.
4. Time each kernel and its plain version at the 4K main-path shapes
   (CUDA events, median, L2 flushed between launches) and the chained full
   path at 1080p and 4K (host clock, synchronised), beside the card's name
   and power limit.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or away from the
repository's ``foveax_torch`` package, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from foveax_torch import FoveaxConfig, FoveationPipeline
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels import unwarp as uw
from foveax_torch.kernels.build import build

SHAPES = {"1080p": (1920, 1080), "4k": (3840, 2160)}
GAZES = [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0), (0.999, 0.001), (0.03, 0.4)]
BATCH_GAZES = GAZES + [(0.25, 0.75), (0.8, 0.2), (0.6, 0.55)]
N_FRAMES = 32
FOVEA = 8  # half-width of the crop around the gaze that must round-trip
SEED = 0

# H100 SXM data sheet: HBM bandwidth, and the float32 rate outside the
# tensor cores (the kernels' integer and float32 scalar work is counted
# against it).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def gaze_trace(n: int) -> np.ndarray:
    """A smooth scan path, one gaze per frame (the bench's trace)."""
    t = np.linspace(0.0, 1.0, n + 2)[:n]
    return np.stack(
        [0.5 + 0.45 * np.sin(2 * np.pi * t), 0.5 + 0.3 * np.cos(2 * np.pi * t)],
        axis=-1,
    ).astype(np.float32)


def kernel_table():
    seg = "foveax_torch/kernels/csrc/segreduce.cu"
    unw = "foveax_torch/kernels/csrc/unwarp.cu"
    return {
        "segreduce_y": (sr.Y_PASS, seg, "foveax/kernels/segreduce.py:251"),
        "segreduce_x": (sr.X_PASS, seg, "foveax/kernels/segreduce.py:511"),
        "unwarp_x": (uw.X_PASS, unw, "foveax/kernels/unwarp_pl.py:264"),
        "unwarp_y": (uw.Y_PASS, unw, "foveax/kernels/unwarp_pl.py:192"),
    }


def make_pipeline(shape: str, device: str):
    w, h = SHAPES[shape]
    return FoveationPipeline(FoveaxConfig().with_source(w, h), device=device)


def make_frame(pipe, seed: int) -> torch.Tensor:
    h, w, _ = pipe.source_shape
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)
    return torch.from_numpy(frame).to(pipe.device)


def path_cases(pipe, frame, centers):
    """The four kernels' (wrapper, plain version, arguments, ops) at the
    shapes the main path gives them for ``centers`` (N, 2).  Each stage's
    input is the previous stage's kernel output; the unwarp stages use
    the first gaze.  Ops count the integer and float work the inputs
    need: one add per summed element, one divide per box, eight
    operations per blended pixel."""
    cases = {}
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, frame, centers)
    args = (frame, pymc, pyc)
    ops = 3 * frame.shape[2] * int((pyc - pymc).sum())
    cases["segreduce_y"] = (sr.y_segment_reduce_batch,
                            sr.y_segment_reduce_batch_plain, args, ops)
    rows = sr.y_segment_reduce_batch(*args)
    args = (rows, pxmc, pxc, vx, pymc, pyc, vy)
    ops = 3 * pyc.shape[1] * int((pxc - pxmc).sum()) + pxc.numel() * 3 * pyc.shape[1]
    cases["segreduce_x"] = (sr.x_segment_reduce_batch,
                            sr.x_segment_reduce_batch_plain, args, ops)
    reduced = sr.x_segment_reduce_batch(*args)[0]
    h, w, _ = pipe.source_shape
    xv, yv = uw.fused_vectors(reduced.shape[1], reduced.shape[2], w, h, centers[0])
    args = (reduced, *xv)
    cases["unwarp_x"] = (uw.unwarp_x_pass, uw.unwarp_x_pass_plain, args,
                         8 * 3 * reduced.shape[1] * w)
    xb = uw.unwarp_x_pass(*args)
    cases["unwarp_y"] = (uw.unwarp_y_pass, uw.unwarp_y_pass_plain,
                         (xb, *yv), 8 * 3 * h * w)
    return cases


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"kernel gave {got.dtype} {tuple(got.shape)}, plain version "
            f"{want.dtype} {tuple(want.shape)}"
        )
    if not got.numel():
        return 0
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def phase_compare(device: str, shapes=tuple(SHAPES)) -> dict[str, int]:
    """Every kernel against its plain version, bit for bit."""
    errs: dict[str, int] = {}
    for shape in shapes:
        pipe = make_pipeline(shape, device)
        frame = make_frame(pipe, SEED)
        batches = [[g] for g in GAZES] + [BATCH_GAZES]
        for gazes in batches:
            centers = torch.tensor(gazes, dtype=torch.float32, device=device)
            for name, (fn, plain, args, _) in path_cases(pipe, frame, centers).items():
                if len(gazes) > 1 and name.startswith("unwarp"):
                    continue  # the batch exercises the sampler's gaze axis
                err = max_abs_err(fn(*args), plain(*args))
                errs[name] = max(errs.get(name, 0), err)
                if err:
                    raise AssertionError(
                        f"{name} at {shape}, gazes {gazes}: kernel differs "
                        f"from its plain version by {err}"
                    )
        print(f"compare {shape}: {len(batches)} gaze sets, all four kernels "
              "bit-equal to their plain versions", flush=True)
    return errs


def fovea_slices(pipe, gaze) -> tuple[slice, slice]:
    h, w, _ = pipe.source_shape
    cx = int(np.float32(gaze[0]) * np.float32(w))
    cy = int(np.float32(gaze[1]) * np.float32(h))
    return (slice(max(cy - FOVEA, 0), cy + FOVEA + 1),
            slice(max(cx - FOVEA, 0), cx + FOVEA + 1))


def run_main_path(pipe, frame, gazes, centers):
    """The chained main path: returns the last frame and, per frame, a
    device flag that the fovea round-tripped exactly."""
    y = frame
    fovea_ok = []
    for g, c in zip(gazes, centers):
        reduced = pipe.foveate_chw(y, c)
        out = pipe.unwarp_auto_chw(reduced, c)
        ys, xs = fovea_slices(pipe, g)
        fovea_ok.append((out[:, ys, xs] == y[:, ys, xs]).all())
        y = out
    return y, torch.stack(fovea_ok)


def phase_main_path(device: str, kernels, shape: str = "4k") -> dict[str, int]:
    pipe = make_pipeline(shape, device)
    frame = make_frame(pipe, SEED + 1)
    gazes = gaze_trace(N_FRAMES)
    centers = [torch.from_numpy(g).to(device) for g in gazes]
    for kernel, _, _ in kernels.values():
        kernel.launches = 0
    last, fovea_ok = run_main_path(pipe, frame, gazes, centers)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {name: k.launches for name, (k, _, _) in kernels.items()}
    hr, wr, _ = pipe.reduced_shape
    h, w, _ = pipe.source_shape
    if last.shape != (3, h, w) or last.dtype != torch.uint8:
        raise AssertionError(f"main path gave {last.dtype} {tuple(last.shape)}")
    if not bool(fovea_ok.all()):
        bad = (~fovea_ok).nonzero().flatten().tolist()
        raise AssertionError(f"fovea not round-tripped exactly at frames {bad}")

    # The first frame against the CPU pipeline (plain versions throughout).
    cpu = make_pipeline(shape, "cpu")
    c0 = torch.from_numpy(gazes[0])
    want_red = cpu.foveate_chw(frame.cpu(), c0)
    want_out = cpu.unwarp_auto_chw(want_red, c0)
    got_red = pipe.foveate_chw(frame, centers[0])
    got_out = pipe.unwarp_auto_chw(got_red, centers[0])
    if got_red.shape != (3, hr, wr):
        raise AssertionError(f"reduced frame {tuple(got_red.shape)}")
    for what, got, want in (("reduced", got_red, want_red),
                            ("restored", got_out, want_out)):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{shape} {what} frame differs from the CPU path")
    print(f"main path {shape}: {N_FRAMES} chained frames, launches {launches}, "
          "fovea exact on every frame, first frame equal to the CPU path",
          flush=True)
    for name, n in launches.items():
        if n != N_FRAMES:
            raise AssertionError(f"{name} launched {n} times, expected {N_FRAMES}")
    return launches


def time_cuda(fn, args, reps: int, flush: torch.Tensor) -> float:
    """Median ms of ``fn(*args)`` over ``reps`` launches, with the L2
    cache flushed before each (a frame arrives cold)."""
    fn(*args)
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(kernels, shape: str = "4k") -> list[dict]:
    pipe = make_pipeline(shape, "cuda")
    frame = make_frame(pipe, SEED + 2)
    centers = torch.tensor([GAZES[0]], dtype=torch.float32, device="cuda")
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")  # 128 MiB
    rows = []
    for name, (fn, plain, args, ops) in path_cases(pipe, frame, centers).items():
        out = fn(*args)
        nbytes = sum(t.numel() * t.element_size() for t in (*args, out))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        row = {
            "name": name,
            "ms": time_cuda(fn, args, 50, flush),
            "plain_ms": time_cuda(plain, args, 10, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "ops": ops,
        }
        print(f"timing {shape}: {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


def phase_path_fps(shape: str) -> float:
    """Chained full-path frames per second (host clock, synchronised),
    the median of three 32-frame runs after a warm-up."""
    pipe = make_pipeline(shape, "cuda")
    frame = make_frame(pipe, SEED + 3)
    gazes = gaze_trace(N_FRAMES)
    centers = [torch.from_numpy(g).cuda() for g in gazes]

    def chain(n: int) -> float:
        y = frame
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in centers[:n]:
            y = pipe.unwarp_auto_chw(pipe.foveate_chw(y, c), c)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    chain(2)
    dt = statistics.median(chain(N_FRAMES) for _ in range(3))
    fps = N_FRAMES / dt
    print(f"path {shape}: {fps:.3f} fps ({dt / N_FRAMES * 1e3:.4f} ms/frame, "
          f"{N_FRAMES} chained frames)", flush=True)
    return fps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    logs = build(["segreduce", "unwarp"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line:
                print(f"  {name}: {line.strip()}")

    kernels = kernel_table()
    errs = phase_compare("cuda")
    launches = phase_main_path("cuda", kernels)
    timing = {row["name"]: row for row in phase_timing(kernels)}
    for shape in SHAPES:
        phase_path_fps(shape)
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": timing[name]["ms"],
            "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"],
            "bound_by": timing[name]["bound_by"],
            "library_ms": None,
        }
        for name, (_, source, replaces) in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
