#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``foveax_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. Build the CUDA kernels from ``foveax_torch/kernels/csrc`` (one nvcc per
   source, in parallel).
2. Run each kernel and its plain PyTorch version on the same inputs on the
   card: they must be bit-equal (tolerance 0; uint32 SATs compared through
   their int32 view).  The fused path's sampler ``segreduce_xy`` (one
   launch for both sampler passes), the parent pair K1 and K2 it replaces,
   and the fused unwarp ``unwarp_xy`` at 1080p (1920x1080 -> 1072x608) and
   4K (3840x2160 -> 2144x1200), over five gazes and a batch of eight for
   the samplers; ``segreduce_xy`` also on random in-contract taps (output
   widths 1001 and the path's, a frame base one byte off alignment) and at
   1000x500 -> 560x288 (a source width that is not a multiple of 16);
   ``unwarp_xy`` also on random in-contract vectors (a band's rows staged
   in pieces) and at output width 1000; the SAT build K5 in both input
   layouts on random 1080p and 4K frames, all-255 4K and 8K frames (the 8K
   sums wrap past 2^32) and 1000x37, 1x1, 17x1 and 1001x70 frames; the
   SAT row select K6 at 1080p and 4K with each gaze's row taps, a list
   with duplicates and the first and last rows, n = 1, duplicates across a
   band boundary, and a pyc list reaching row H-1 beside a pymc list that
   ends in the first band.
3. Drive two 4K paths through ``FoveationPipeline``, each over a 32-frame
   gaze trace with every restored frame fed back as the next input
   (``foveate_chw`` then the fused ``unwarp_auto_chw``): the fused path
   (``segreduce_xy`` and ``unwarp_xy`` rise by exactly 32, K1, K2, K5 and
   K6 by 0) and the SAT path, ``sampler="sat"`` (K5 and ``unwarp_xy`` by
   32, the others by 0; every reduced frame equal to the fused pipeline's
   on the same input).  In both the
   fovea of every roundtrip must equal its source and the first frame the
   CPU pipeline's result.  Then the serve tick's SAT pair at 4K
   (``batch_pair("sat")``, eight gazes: one K5 launch, the batch equal to
   the fused batch) and the degrade contract (1920x1080 -> 64x36, outside
   the fused sampler's and the fused unwarp's contracts: "auto" runs the
   SAT path and the exact unwarp, one K5 launch and no unwarp kernel, equal
   to the CPU path; "fused" raises).
4. Time each kernel, its plain version and, for K5, the library's two
   ``torch.cumsum`` calls at the 4K main-path shapes (CUDA events, median
   of 50 launches (10 for plain and library), L2 flushed before each), in
   two readings: ``ms`` starts the events right after the flush, so host
   time before the launch counts; ``ms_queued`` first keeps the card busy
   for about 0.2 ms (``torch.cuda._sleep``, its cycle count derived once
   from a timed sleep and printed) while the host enqueues the start
   event, the call and the end event; then the SAT path's plain-torch
   sampler ``sample_rect_from_sat`` alone at 4K (``ms_queued`` and the
   bytes it must move; not a kernel).  Then both chained paths at 1080p
   and 4K (host clock, synchronised), beside the card's name and power
   limit.
5. Serve on the card at 1920x1080 -> 1072x608: the port's ``FoveaxServer``
   and ``FoveaxClient`` through an in-memory connection pair
   (:func:`memory_pair`, asyncio queues), the wire codec resolved as the
   server resolves ``wire_codec="auto"`` (h264 where the port's codec shim
   builds, else jpeg).  One session of 8 frames over a 4-gaze trace
   (``sampler="auto"`` resolves to fused: ``segreduce_xy`` and
   ``unwarp_xy`` +8 each, every other kernel +0), then a 4-client broadcast
   channel of 6 ticks, with ``batch_sampler="fused"`` (one
   ``segreduce_xy`` launch per served tick) and ``"sat"`` (one K5 launch
   per tick, then the plain 4-tap sampler); ``unwarp_xy`` once per frame a
   client restores.  Every reduced frame the server hands an encoder must
   equal the CPU pipeline's ``foveate`` of the same source frame at the
   gaze its ``FrameMeta`` echoes, and every restored frame the CPU
   pipeline's ``unwarp_auto`` of the decoded reduced frame (tolerance 0).
   Prints the clients' receive/decode/unwarp ms, the server's gaze-apply
   median and, timed alone, the client's restore step by step (host copy,
   copy to the card, ``unwarp_auto``, readback), beside the card's name
   and power limit.
6. SVD serving on the card at 1920x1080 -> 1072x608, rank 30, gop 30
   (``sat_compression="svd"``): a session of 4 frames with the client's
   local gaze over the 4-gaze trace (frame 0 a sync sample, frames 1-3
   deltas; K5 +4, ``unwarp_xy`` +4, every other kernel +0), then a
   2-client broadcast channel of 4 ticks (K5 once per tick read,
   ``unwarp_xy`` once per frame restored).  Every SAT the server packed
   must equal the CPU ``build_sat`` of its source frame, every blob the CPU
   ``compress_sat`` and packer of that SAT, every client's reduced frame
   the CPU ``SvdDecoder``'s on the same blob at the same gaze, and every
   restored frame the CPU ``unwarp_auto`` of it (tolerance 0).  Prints the
   server's compress+pack ms and blob bytes and the clients' decode and
   unwarp ms.
7. The math off the main path on the card at 1080p, against the CPU port
   on the same inputs: the logrect point sampler, the 360 SAT sampler, the
   scatter expansion, the log-polar sample, pyramid and pyramid sample
   bit-equal; the log-polar blur and unwarp by the share of pixels more
   than 1 LSB off, gnomonic at 1280x720 by the share of pixels that
   differ, the metrics of a frame against its SAT-path restore by their
   absolute difference, each inside a stated bound.  Host ms of each on
   the card, synchronised.
8. The command-line interface on the card (``foveax_torch.cli.main.main``,
   in this process) at 1920x1080 -> 1072x608 on ``synthetic://`` sources,
   each subcommand run on the card with the launch counts read around it,
   then with ``--device cpu`` on the same input: ``single_frame`` (logrect
   and logrect_point) and ``interpolate_sampled`` write byte-equal PNGs;
   ``foveate_no_encoding`` and ``encode_bitrate`` (OpenCV writer) over 4
   frames of ``--gaze-trace synthetic:1``, then ``decode`` of the card's
   encoded file, give equal decoded frames; ``gaze_eval`` prints the same
   lines.  Then on the card only: ``perf --resolutions 1080p 4k --frames 8
   --clients 8`` with the default sampler and with ``--sampler sat``,
   ``stages`` (``5/5 stages passed``) and ``doctor`` (exit code 0).  Every
   call's launch counts must be :data:`CLI_EXPECTED`'s.  Prints ``perf``'s
   and ``stages``' lines beside the card's name and power limit.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or away from the
repository's ``foveax_torch`` package, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from foveax_torch import FoveaxClient, FoveaxConfig, FoveaxServer, FoveationPipeline
from foveax_torch.cli import main as cli
from foveax_torch.core import gnomonic, logpolar, metrics
from foveax_torch.core import sample as core_sample
from foveax_torch.core.logrect import make_point_grid
from foveax_torch.core.sat import build_sat
from foveax_torch.core.svd_sat import compress_sat, sat_to_numpy
from foveax_torch.io.video import SyntheticReader
from foveax_torch.serve.client import SvdDecoder
from foveax_torch.kernels import fused_select as fs
from foveax_torch.kernels import scan2d
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels import unwarp as uw
from foveax_torch.kernels.build import build

SHAPES = {"1080p": (1920, 1080), "4k": (3840, 2160)}
GAZES = [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0), (0.999, 0.001), (0.03, 0.4)]
BATCH_GAZES = GAZES + [(0.25, 0.75), (0.8, 0.2), (0.6, 0.55)]
N_FRAMES = 32
FOVEA = 8  # half-width of the crop around the gaze that must round-trip
SEED = 0
# K5's comparison frames: (label, width, height, fill or None for random).
SAT_FRAMES = [
    ("1080p", 1920, 1080, None),
    ("4k", 3840, 2160, None),
    ("4k all-255", 3840, 2160, 255),
    ("8k all-255", 7680, 4320, 255),
    ("1000x37", 1000, 37, None),
    ("1x1", 1, 1, None),
    ("17x1", 17, 1, None),
    ("1001x70", 1001, 70, None),
]
# segreduce_xy's third comparison shape: (width, height, reduced width,
# reduced height), a source width that is not a multiple of 16.
ODD_SHAPE = (1000, 500, 560, 288)
# The kernels each path launches once per frame.
PATH_KERNELS = {
    "fused": ("segreduce_xy", "unwarp_xy"),
    "sat": ("sat_build", "unwarp_xy"),
}
# How long the card is kept busy before a queued timing's start event.
SPIN_MS = 0.2

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
    scan = "foveax_torch/kernels/csrc/scan2d.cu"
    return {
        "segreduce_xy": (sr.XY_PASS, seg, "foveax/kernels/segreduce.py:251, "
                         "foveax/kernels/segreduce.py:511"),
        "segreduce_y": (sr.Y_PASS, seg, "foveax/kernels/segreduce.py:251"),
        "segreduce_x": (sr.X_PASS, seg, "foveax/kernels/segreduce.py:511"),
        "unwarp_xy": (uw.UNWARP_XY, unw, "foveax/kernels/unwarp_pl.py:264, "
                      "foveax/kernels/unwarp_pl.py:192"),
        "sat_build": (scan2d.SAT_BUILD, scan, "foveax/kernels/scan2d.py:51"),
        "sat_select_rows": (fs.SELECT_ROWS, scan,
                            "foveax/kernels/fused_select.py:46"),
    }


def make_pipeline(shape: str, device: str, sampler: str = "auto"):
    w, h = SHAPES[shape]
    pipe = FoveationPipeline(
        FoveaxConfig().with_source(w, h), sampler=sampler, device=device
    )
    if sampler != "auto" and pipe.sampler != sampler:
        raise AssertionError(f"asked for {sampler}, got {pipe.sampler}")
    return pipe


def make_frame(pipe, seed: int) -> torch.Tensor:
    h, w, _ = pipe.source_shape
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)
    return torch.from_numpy(frame).to(pipe.device)


def path_cases(pipe, frame, centers):
    """The fused path's kernels and the parent pair K1, K2 as (wrapper,
    plain version, arguments, ops) at the shapes the main path gives them
    for ``centers`` (N, 2).  K2 takes K1's output, the unwarp
    ``segreduce_xy``'s, for the first gaze.  Ops count the integer and
    float work the inputs need: one add per summed element (``segreduce_xy``
    skips invalid rows), one divide per box, eight operations per blended
    byte (the column blend over 3 x hr x W, the row blend over 3 x H x W)."""
    cases = {}
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, frame, centers)
    args = (frame, pxmc, pxc, vx, pymc, pyc, vy)
    ops = (3 * frame.shape[2] * int(((pyc - pymc) * vy).sum())
           + 3 * pyc.shape[1] * pxc.numel())
    cases["segreduce_xy"] = (sr.segment_reduce_xy_batch,
                             sr.segment_reduce_xy_batch_plain, args, ops)
    reduced = sr.segment_reduce_xy_batch(*args)[0]
    args = (frame, pymc, pyc)
    ops = 3 * frame.shape[2] * int((pyc - pymc).sum())
    cases["segreduce_y"] = (sr.y_segment_reduce_batch,
                            sr.y_segment_reduce_batch_plain, args, ops)
    rows = sr.y_segment_reduce_batch(*args)
    args = (rows, pxmc, pxc, vx, pymc, pyc, vy)
    ops = 3 * pyc.shape[1] * int((pxc - pxmc).sum()) + pxc.numel() * 3 * pyc.shape[1]
    cases["segreduce_x"] = (sr.x_segment_reduce_batch,
                            sr.x_segment_reduce_batch_plain, args, ops)
    h, w, _ = pipe.source_shape
    hr = reduced.shape[1]
    xv, yv = uw.fused_vectors(hr, reduced.shape[2], w, h, centers[0])
    cases["unwarp_xy"] = (uw.unwarp_xy, uw.unwarp_xy_plain, (reduced, xv, yv),
                          8 * 3 * (hr + h) * w)
    return cases


def random_vectors(rng, n: int, size: int, device):
    """In-contract unwarp vectors of no particular order: lo/hi anywhere in
    [0, size), den in [1, 255], num in [0, den]."""
    den = rng.integers(1, 256, n)
    vecs = (rng.integers(0, size, n), rng.integers(0, size, n),
            rng.integers(0, den + 1), den)
    return tuple(torch.from_numpy(v.astype(np.int32)).to(device) for v in vecs)


def unwarp_extra_cases(reduced, w: int, h: int, center):
    """``unwarp_xy``'s arguments beyond the main path's: random vectors at
    the path's output shape (each band's rows span far more than
    BAND_ROWS + 1, so the kernel stages them in pieces), and output width
    1000, not a multiple of 16, with the path's y vectors."""
    rng = np.random.default_rng(SEED + w)
    _, hr, wr = reduced.shape
    dev = reduced.device
    _, yv = uw.fused_vectors(hr, wr, w, h, center)
    return {
        "random vectors": (reduced, random_vectors(rng, w, wr, dev),
                           random_vectors(rng, h, hr, dev)),
        "width 1000": (reduced, random_vectors(rng, 1000, wr, dev), yv),
    }


def random_taps(rng, n: int, m: int, dim: int, maxlen: int, device):
    """In-contract sampler taps of no particular order: (pc, pmc, valid),
    each (n, m), intervals of 1..maxlen overlapping, the first touching 0
    and the last dim - 1, about a fifth invalid."""
    pc = rng.integers(1, dim, (n, m))
    pmc = np.maximum(pc - rng.integers(1, maxlen + 1, (n, m)), 0)
    pc[:, 0], pmc[:, 0] = 1, 0
    pc[:, -1], pmc[:, -1] = dim - 1, max(dim - 1 - maxlen, 0)
    valid = rng.random((n, m)) > 0.2
    return (torch.from_numpy(pc.astype(np.int32)).to(device),
            torch.from_numpy(pmc.astype(np.int32)).to(device),
            torch.from_numpy(valid).to(device))


def xy_extra_cases(pipe, frame):
    """``segreduce_xy``'s arguments beyond the main path's: random
    in-contract taps (row intervals up to 257 rows, inside the plain
    version's uint16 bound; column intervals up to the whole row) at output
    width 1001 and at the path's shape for three gazes, the latter also on
    a copy of the frame whose base is one byte past an aligned address."""
    rng = np.random.default_rng(SEED + frame.shape[2])
    _, h, w = frame.shape
    hr, wr, _ = pipe.reduced_shape
    dev = frame.device
    buf = torch.empty(frame.numel() + 1, dtype=torch.uint8, device=dev)
    offset = buf[1:].view(frame.shape).copy_(frame)
    cases = {}
    for what, f, n, mx, my in (("random taps, width 1001", frame, 1, 1001, 77),
                               ("random taps, 3 gazes", frame, 3, wr, hr),
                               ("random taps, base off by 1", offset, 3, wr, hr)):
        pxc, pxmc, vx = random_taps(rng, n, mx, w, w - 1, dev)
        pyc, pymc, vy = random_taps(rng, n, my, h, 257, dev)
        cases[what] = (f, pxmc, pxc, vx, pymc, pyc, vy)
    return cases


def tensors(obj) -> list[torch.Tensor]:
    """The tensors of a kernel's arguments or results, nested tuples
    flattened."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for item in obj for t in tensors(item)]


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """Exact values as int64: a uint32 SAT through its int32 view (no
    signed 32-bit difference, which would wrap past 2^31)."""
    return scan2d.as_int64(t) if t.dtype == torch.uint32 else t.to(torch.int64)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest |kernel - plain| over the elements, in int64; raises
    unless shape and dtype agree."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"kernel gave {got.dtype} {tuple(got.shape)}, plain version "
            f"{want.dtype} {tuple(want.shape)}"
        )
    if not got.numel():
        return 0
    return int((as_int64(got) - as_int64(want)).abs().max())


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> int:
    """Bit equality of a kernel's output and its plain version's (uint32
    through the int32 view); returns the max |error|, raises on any
    mismatch."""
    err = max_abs_err(got, want)
    if got.dtype == torch.uint32:
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        same = torch.equal(got, want)
    if err or not same:
        raise AssertionError(
            f"{name} {what}: kernel differs from its plain version by {err}"
        )
    return err


def compare_extra(errs, name, fn, plain, cases, where: str) -> None:
    for what, args in cases.items():
        err = check_equal(name, fn(*args), plain(*args), f"at {where}, {what}")
        errs[name] = max(errs.get(name, 0), err)


def phase_compare(device: str, shapes=tuple(SHAPES)) -> dict[str, int]:
    """Every kernel of the fused path, and K1 and K2, against its plain
    version, bit for bit."""
    errs: dict[str, int] = {}
    batches = [[g] for g in GAZES] + [BATCH_GAZES]
    for shape in shapes:
        pipe = make_pipeline(shape, device)
        frame = make_frame(pipe, SEED)
        for gazes in batches:
            centers = torch.tensor(gazes, dtype=torch.float32, device=device)
            for name, (fn, plain, args, _) in path_cases(pipe, frame, centers).items():
                if len(gazes) > 1 and name.startswith("unwarp"):
                    continue  # the batch exercises the sampler's gaze axis
                err = check_equal(name, fn(*args), plain(*args),
                                  f"at {shape}, gazes {gazes}")
                errs[name] = max(errs.get(name, 0), err)
        xy_extra = xy_extra_cases(pipe, frame)
        compare_extra(errs, "segreduce_xy", sr.segment_reduce_xy_batch,
                      sr.segment_reduce_xy_batch_plain, xy_extra, shape)
        h, w, _ = pipe.source_shape
        c = torch.tensor(GAZES[0], dtype=torch.float32, device=device)
        reduced = pipe.foveate_chw(frame, c)
        extra = unwarp_extra_cases(reduced, w, h, c)
        compare_extra(errs, "unwarp_xy", uw.unwarp_xy, uw.unwarp_xy_plain,
                      extra, shape)
        print(f"compare {shape}: {len(batches)} gaze sets; segreduce_xy on "
              f"{'; '.join(xy_extra)}; unwarp_xy on {'; '.join(extra)}: all "
              "four kernels bit-equal to their plain versions", flush=True)

    w, h, wr, hr = ODD_SHAPE
    pipe = FoveationPipeline(FoveaxConfig(source_width=w, source_height=h,
                                          reduced_width=wr, reduced_height=hr),
                             device=device)
    if pipe.sampler != "fused":
        raise AssertionError(f"{w}x{h} -> {wr}x{hr} resolved to {pipe.sampler}")
    frame = make_frame(pipe, SEED)
    cases = {}
    for gazes in batches:
        centers = torch.tensor(gazes, dtype=torch.float32, device=device)
        pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, frame, centers)
        cases[f"gazes {gazes}"] = (frame, pxmc, pxc, vx, pymc, pyc, vy)
    compare_extra(errs, "segreduce_xy", sr.segment_reduce_xy_batch,
                  sr.segment_reduce_xy_batch_plain, cases, f"{w}x{h}")
    print(f"compare {w}x{h} -> {wr}x{hr}: segreduce_xy over {len(cases)} gaze "
          "sets, bit-equal to its plain version", flush=True)
    return errs


def sat_frame(w: int, h: int, fill, device: str) -> torch.Tensor:
    """A (3, H, W) uint8 frame: random from the seed, or all ``fill``."""
    if fill is not None:
        return torch.full((3, h, w), fill, dtype=torch.uint8, device=device)
    rng = np.random.default_rng(SEED + w + h)
    return torch.from_numpy(rng.integers(0, 256, (3, h, w), np.uint8)).to(device)


def phase_compare_sat(errs: dict[str, int]) -> None:
    """K5 in both layouts and K6 against their plain versions."""
    for label, w, h, fill in SAT_FRAMES:
        chw = sat_frame(w, h, fill, "cuda")
        want = scan2d.sat_scan_plain(chw)
        for layout in ("chw", "hwc"):
            frame = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
            got = scan2d.sat_scan(frame, in_layout=layout)
            err = check_equal("sat_build", got, want, f"{label} {layout}")
            errs["sat_build"] = max(errs.get("sat_build", 0), err)
        if fill is not None:
            corner = int(as_int64(want[0, -1, -1]))
            if corner != fill * w * h % 2**32:
                raise AssertionError(f"sat_build {label}: corner {corner}")
        del want
    print(f"compare sat_build: {len(SAT_FRAMES)} frames x 2 layouts, "
          "bit-equal to the plain version", flush=True)

    for shape in SHAPES:
        pipe = make_pipeline(shape, "cuda")
        frame = make_frame(pipe, SEED)
        rcw = frame.permute(1, 0, 2).contiguous()
        h = frame.shape[1]
        lists = []
        for g in GAZES:
            centers = torch.tensor([g], dtype=torch.float32, device="cuda")
            *_, pyc, pymc, _ = sr.fused_taps(pipe.grid, frame, centers)
            lists.append((f"gaze {g}", pyc[0], pymc[0]))
        hand = torch.tensor([0, 0, 1, h // 2, h // 2, h // 2, h - 1, h - 1],
                            dtype=torch.int32, device="cuda")
        lists.append(("duplicates and rows 0, H-1", hand, hand))
        r = scan2d.BAND_ROWS
        for what, hi, lo in (
            ("n = 1", [h // 2], [h // 3]),
            ("duplicates across a band boundary", [r - 1, r - 1, r, r, 2 * r],
             [r - 2, r - 1, r - 1, r, r]),
            ("pyc to H-1, pymc in the first band", [1, 2, h - 1], [0, 1, 3]),
        ):
            hi, lo = (torch.tensor(v, dtype=torch.int32, device="cuda")
                      for v in (hi, lo))
            lists.append((what, hi, lo))
        for what, pyc, pymc in lists:
            got = fs.sat_select_rows(rcw, pyc, pymc)
            want = fs.sat_select_rows_plain(rcw, pyc, pymc)
            for part, g_, w_ in zip(("hi", "lo"), got, want):
                err = check_equal("sat_select_rows", g_, w_,
                                  f"{shape} {what} {part}")
                errs["sat_select_rows"] = max(errs.get("sat_select_rows", 0), err)
        print(f"compare sat_select_rows {shape}: {len(lists)} row lists, "
              "bit-equal to the plain version", flush=True)


def fovea_slices(pipe, gaze) -> tuple[slice, slice]:
    h, w, _ = pipe.source_shape
    cx = int(np.float32(gaze[0]) * np.float32(w))
    cy = int(np.float32(gaze[1]) * np.float32(h))
    return (slice(max(cy - FOVEA, 0), cy + FOVEA + 1),
            slice(max(cx - FOVEA, 0), cx + FOVEA + 1))


def run_main_path(pipe, frame, gazes, centers, keep: bool = False):
    """The chained main path: returns the last frame, per frame a device
    flag that the fovea round-tripped exactly, and (with ``keep``) each
    frame's (input, reduced) pair."""
    y = frame
    fovea_ok, kept = [], []
    for g, c in zip(gazes, centers):
        reduced = pipe.foveate_chw(y, c)
        out = pipe.unwarp_auto_chw(reduced, c)
        ys, xs = fovea_slices(pipe, g)
        fovea_ok.append((out[:, ys, xs] == y[:, ys, xs]).all())
        if keep:
            kept.append((y, reduced))
        y = out
    return y, torch.stack(fovea_ok), kept


def zero_counts(kernels) -> None:
    for kernel, _, _ in kernels.values():
        kernel.launches = 0


def read_counts(kernels) -> dict[str, int]:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {name: k.launches for name, (k, _, _) in kernels.items()}


def expect_counts(what: str, launches: dict[str, int], expected: dict[str, int]):
    want = {name: expected.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def phase_main_path(kernels, sampler: str, shape: str = "4k") -> dict[str, int]:
    """One path over the 32-frame trace, its launch counts read around
    it.  For the SAT path every reduced frame is then held to the fused
    pipeline's on the same input."""
    pipe = make_pipeline(shape, "cuda", sampler)
    frame = make_frame(pipe, SEED + 1)
    gazes = gaze_trace(N_FRAMES)
    centers = [torch.from_numpy(g).to("cuda") for g in gazes]
    zero_counts(kernels)
    last, fovea_ok, kept = run_main_path(
        pipe, frame, gazes, centers, keep=sampler == "sat"
    )
    launches = read_counts(kernels)
    hr, wr, _ = pipe.reduced_shape
    h, w, _ = pipe.source_shape
    if last.shape != (3, h, w) or last.dtype != torch.uint8:
        raise AssertionError(f"{sampler} path gave {last.dtype} {tuple(last.shape)}")
    if not bool(fovea_ok.all()):
        bad = (~fovea_ok).nonzero().flatten().tolist()
        raise AssertionError(
            f"{sampler} path: fovea not round-tripped exactly at frames {bad}"
        )
    expect_counts(f"{sampler} path", launches,
                  {name: N_FRAMES for name in PATH_KERNELS[sampler]})

    if kept:
        fused = make_pipeline(shape, "cuda", "fused")
        for i, ((x, reduced), c) in enumerate(zip(kept, centers)):
            if not torch.equal(fused.foveate_chw(x, c), reduced):
                raise AssertionError(f"SAT path frame {i} differs from the fused path")
        del kept

    # The first frame against the CPU pipeline (plain versions throughout).
    cpu = make_pipeline(shape, "cpu", sampler)
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
            raise AssertionError(f"{sampler} {shape} {what} frame differs from the CPU path")
    same = ", each reduced frame equal to the fused path's" if sampler == "sat" else ""
    print(f"main path {sampler} {shape}: {N_FRAMES} chained frames, launches "
          f"{launches}, fovea exact on every frame{same}, first frame equal "
          "to the CPU path", flush=True)
    return launches


def phase_serve_pair(kernels, shape: str = "4k") -> None:
    """The serve tick's SAT pair over a gaze batch: one SAT build, the
    batch equal to the fused batch sampler's."""
    pipe = make_pipeline(shape, "cuda")
    frame = make_frame(pipe, SEED + 4).permute(1, 2, 0).contiguous()
    centers = torch.tensor(BATCH_GAZES, dtype=torch.float32, device="cuda")
    prepare, sample_batch = pipe.batch_pair("sat")
    zero_counts(kernels)
    got = sample_batch(prepare(frame), centers)
    launches = read_counts(kernels)
    expect_counts("serve pair", launches, {"sat_build": 1})
    if not torch.equal(got, pipe.sample_batch_fused(frame, centers)):
        raise AssertionError("SAT serve pair differs from the fused batch")
    print(f"serve pair sat {shape}: {len(BATCH_GAZES)} gazes, launches "
          f"{launches}, equal to the fused batch", flush=True)


def phase_degrade(kernels) -> None:
    """A shape outside the fused sampler's and the fused unwarp's
    contracts: "auto" resolves to the SAT path and runs K5, the unwarp's
    "auto" to the exact unwarp (no kernel); an explicit "fused" raises."""
    cfg = FoveaxConfig(source_width=1920, source_height=1080,
                       reduced_width=64, reduced_height=36)
    pipe = FoveationPipeline(cfg)
    if pipe.sampler != "sat":
        raise AssertionError(f"auto resolved to {pipe.sampler} at 1920x1080 -> 64x36")
    try:
        FoveationPipeline(cfg, sampler="fused")
    except ValueError:
        pass
    else:
        raise AssertionError("sampler='fused' accepted an ineligible shape")
    frame = sat_frame(1920, 1080, None, "cuda")
    c = pipe.center(0.3, 0.6)
    zero_counts(kernels)
    reduced = pipe.foveate_chw(frame, c)
    restored = pipe.unwarp_auto_chw(reduced, c)
    launches = read_counts(kernels)
    expect_counts("degrade", launches, {"sat_build": 1})
    cpu = FoveationPipeline(cfg, device="cpu")
    want_red = cpu.foveate_chw(frame.cpu(), c.cpu())
    want = (want_red, cpu.unwarp_auto_chw(want_red, c.cpu()))
    for g, w_ in zip((reduced, restored), want):
        if not torch.equal(g.cpu(), w_):
            raise AssertionError("degraded path differs from the CPU path")
    print(f"degrade 1920x1080 -> 64x36: auto -> sat and the exact unwarp, "
          f"launches {launches}, equal to the CPU path; fused raises", flush=True)


def spin_cycles(ms: float) -> int:
    """The ``torch.cuda._sleep`` cycle count that keeps the card busy for
    about ``ms``, from the clock rate a timed sleep shows."""
    probe = 1_000_000
    torch.cuda._sleep(probe)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * ms / start.elapsed_time(end))


def time_cuda(fn, args, reps: int, flush: torch.Tensor, spin: int = 0) -> float:
    """Median ms of ``fn(*args)`` over ``reps`` launches, with the L2
    cache flushed before each (a frame arrives cold).  With ``spin``, the
    card sleeps that many cycles after the flush, so that the host has
    enqueued the start event, the call and the end event before the start
    event fires: host time before the launch then falls outside the
    window."""
    fn(*args)
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sat_cases(pipe, frame, centers):
    """K5 and K6 as the SAT path and ``sat_select_rows`` give them work at
    this shape, with their library yardstick (K5: two ``torch.cumsum``
    calls in int64; none selects SAT rows without building the SAT).  Ops
    count one add per element of each scan the data needs."""
    _, h, w = frame.shape
    *_, pyc, pymc, _ = sr.fused_taps(pipe.grid, frame, centers)
    pyc, pymc = pyc[0], pymc[0]
    rows_walked = int(torch.maximum(pyc[-1], pymc[-1])) + 1
    rcw = frame.permute(1, 0, 2).contiguous()
    return {
        "sat_build": (
            lambda f: scan2d.sat_scan(f, in_layout="chw"), scan2d.sat_scan_plain,
            (frame,), 2 * 3 * h * w,
            lambda f: torch.cumsum(torch.cumsum(f, 2, dtype=torch.int64), 1),
        ),
        "sat_select_rows": (
            fs.sat_select_rows, fs.sat_select_rows_plain, (rcw, pyc, pymc),
            3 * w * rows_walked + 2 * pyc.numel() * 3 * w, None,
        ),
    }


def phase_timing(shape: str = "4k") -> list[dict]:
    pipe = make_pipeline(shape, "cuda")
    frame = make_frame(pipe, SEED + 2)
    centers = torch.tensor([GAZES[0]], dtype=torch.float32, device="cuda")
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")  # 128 MiB
    cases = {
        name: (*case, None)
        for name, case in path_cases(pipe, frame, centers).items()
    }
    cases.update(sat_cases(pipe, frame, centers))
    spin = spin_cycles(SPIN_MS)
    print(f"timing {shape}: queued readings spin {spin} cycles (about "
          f"{SPIN_MS} ms) after each flush", flush=True)
    rows = []
    for name, (fn, plain, args, ops, library) in cases.items():
        nbytes = sum(t.numel() * t.element_size() for t in tensors((args, fn(*args))))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        row = {
            "name": name,
            "ms": time_cuda(fn, args, 50, flush),
            "ms_queued": time_cuda(fn, args, 50, flush, spin),
            "plain_ms": time_cuda(plain, args, 10, flush),
            "plain_ms_queued": time_cuda(plain, args, 10, flush, spin),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library_ms_queued": None,
            "bytes": nbytes,
            "ops": ops,
        }
        if library is not None:
            row["library_ms"] = time_cuda(library, args, 10, flush)
            row["library_ms_queued"] = time_cuda(library, args, 10, flush, spin)
        print(f"timing {shape}: {json.dumps(row)}", flush=True)
        rows.append(row)
    time_sat_sampler(pipe, frame, centers[0], flush, spin, shape)
    return rows


def time_sat_sampler(pipe, frame, center, flush, spin: int, shape: str) -> None:
    """The SAT path's plain-torch 4-tap sampler (``sample_rect_from_sat``)
    on its own: ``ms_queued`` as the kernels', and the bytes it must move
    at least (the four uint32 SAT taps of every output value read once,
    the uint8 frame written once).  Not a kernel: not in the kernels
    line."""
    sat = scan2d.sat_scan(frame, in_layout="chw")
    hr, wr, _ = pipe.reduced_shape
    row = {
        "name": "sample_rect_from_sat",
        "ms_queued": time_cuda(pipe.sample_chw, (sat, center), 50, flush, spin),
        "bytes": 4 * 3 * hr * wr * 4 + 3 * hr * wr,
    }
    print(f"timing {shape}: {json.dumps(row)}", flush=True)


def phase_path_fps(shape: str, sampler: str) -> float:
    """Chained full-path frames per second (host clock, synchronised),
    the median of three 32-frame runs after a warm-up."""
    pipe = make_pipeline(shape, "cuda", sampler)
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
    print(f"path {sampler} {shape}: {fps:.3f} fps ({dt / N_FRAMES * 1e3:.4f} "
          f"ms/frame, {N_FRAMES} chained frames)", flush=True)
    return fps


SERVE_FRAMES = 8
SERVE_GAZES = [(0.5, 0.5), (0.3, 0.4), (0.7, 0.6), (0.2, 0.8)]
BROADCAST_CLIENTS = 4
BROADCAST_TICKS = 6
# Seconds a serve run may take before it counts as hung.
SERVE_TIMEOUT_S = 300.0


class MemoryConnection:
    """One end of an in-memory connection: what the server's ``handle`` and
    the client's ``run_on`` need of a websocket (``send``, ``close``, async
    iteration over incoming messages).  ``close`` ends the iteration on both
    ends once the messages sent before it are consumed; sending after
    either end closed raises."""

    _CLOSED = object()

    def __init__(self, inbox: asyncio.Queue, outbox: asyncio.Queue):
        self._inbox, self._outbox = inbox, outbox
        self.peer: MemoryConnection | None = None
        self.closed = False

    async def send(self, message) -> None:
        if self.closed or self.peer.closed:
            raise ConnectionResetError("in-memory connection closed")
        self._outbox.put_nowait(message)

    async def close(self, code: int = 1000, reason: str = "") -> None:
        if not self.closed:
            self.closed = True
            self._outbox.put_nowait(self._CLOSED)
            self._inbox.put_nowait(self._CLOSED)

    def __aiter__(self):
        return self

    async def __anext__(self):
        message = await self._inbox.get()
        if message is self._CLOSED:
            self._inbox.put_nowait(message)  # later reads end too
            raise StopAsyncIteration
        return message


def memory_pair() -> tuple[MemoryConnection, MemoryConnection]:
    """(server end, client end) of one in-memory connection."""
    a, b = asyncio.Queue(), asyncio.Queue()
    server_end, client_end = MemoryConnection(a, b), MemoryConnection(b, a)
    server_end.peer, client_end.peer = client_end, server_end
    return server_end, client_end


class CapturingServer(FoveaxServer):
    """A server that keeps each reduced frame it hands an encoder and, in
    SVD mode, each SAT it packs with the blob and the pack's host ms."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.encoded: list[np.ndarray] = []
        self.svd_packed: list[tuple[np.ndarray, bytes, bool, float]] = []

    def _pack_svd(self, packer, sat):
        t0 = time.perf_counter()
        blob, is_sync = super()._pack_svd(packer, sat)
        ms = (time.perf_counter() - t0) * 1e3
        self.svd_packed.append((sat_to_numpy(sat), blob, is_sync, ms))
        return blob, is_sync

    def _make_encoder(self, cfg, bitrate=None):
        enc = super()._make_encoder(cfg, bitrate)
        encode = enc.encode

        def recording_encode(frame):
            self.encoded.append(np.array(frame))
            return encode(frame)

        enc.encode = recording_encode
        return enc


class CapturingClient(FoveaxClient):
    """A client that keeps each decoded reduced frame and each restored
    frame with its ``FrameMeta``."""

    def __init__(self, *args, **kwargs):
        self.decoded: list[np.ndarray] = []
        self.svd_decoded: list = []  # (blob, gaze, reduced tensor or None)
        self.restored: list = []
        self.unwarp_ms: list[float] = []  # per frame, in arrival order
        super().__init__(*args, frame_sink=lambda f, m: self.restored.append((f, m)),
                         **kwargs)
        record = self.stats.record

        def recording(gaze_idx, recv, dec, unw):
            self.unwarp_ms.append(unw)
            record(gaze_idx, recv, dec, unw)

        self.stats.record = recording

    def _make_decoder(self, *args):
        dec = super()._make_decoder(*args)
        decode = dec.decode

        def recording_decode(sample):
            out = decode(sample)
            if out is not None:
                self.decoded.append(out)
            return out

        dec.decode = recording_decode
        return dec

    def _make_svd_decoder(self, cfg):
        dec = super()._make_svd_decoder(cfg)
        decode = dec.decode

        def recording_decode(sample, gaze):
            out = decode(sample, gaze)
            self.svd_decoded.append((sample, gaze, out))
            return out

        dec.decode = recording_decode
        return dec


async def _serve_one(server, client):
    """One client on its own session; the client stops at its
    ``max_frames``."""
    server_end, client_end = memory_pair()
    handler = asyncio.create_task(server.handle(server_end))
    try:
        return await asyncio.wait_for(client.run_on(client_end), SERVE_TIMEOUT_S)
    finally:
        await client_end.close()
        await asyncio.wait_for(handler, SERVE_TIMEOUT_S)


async def _serve_channel(server, clients, spec: str):
    """Clients on one broadcast channel: run until the channel has served
    its ``max_frames`` ticks, then close every connection."""
    pairs = [memory_pair() for _ in clients]
    handlers = [asyncio.create_task(server.handle(s)) for s, _ in pairs]
    runs = [asyncio.create_task(c.run_on(e)) for c, (_, e) in zip(clients, pairs)]

    async def channel_done():
        while spec not in server.channels:
            await asyncio.sleep(0.005)
        await server.channels[spec].task

    try:
        await asyncio.wait_for(channel_done(), SERVE_TIMEOUT_S)
    finally:
        for s, _ in pairs:
            await s.close()
        stats = await asyncio.wait_for(asyncio.gather(*runs), SERVE_TIMEOUT_S)
        await asyncio.wait_for(asyncio.gather(*handlers), SERVE_TIMEOUT_S)
    return stats


def synthetic_frames(spec: str, n: int) -> list[np.ndarray]:
    reader = SyntheticReader.from_spec(spec)
    return [reader.read() for _ in range(n)]


def check_served(cfg, server, clients, sources, what: str) -> int:
    """Hold what the card served to the CPU pipeline, tolerance 0: every
    reduced frame the server encoded is the CPU ``foveate`` of its source
    frame at the gaze one received frame's ``FrameMeta`` echoes (one to
    one), and every restored frame the CPU ``unwarp_auto`` of the decoded
    reduced frame at that gaze.  Returns the frames checked."""
    cpu = FoveationPipeline(cfg, device="cpu")
    expected = []
    for k, client in enumerate(clients):
        if len(client.decoded) != len(client.restored):
            raise AssertionError(f"{what} client {k}: {len(client.decoded)} "
                                 f"decoded, {len(client.restored)} restored")
        for i, ((full, meta), decoded) in enumerate(zip(client.restored, client.decoded)):
            center = torch.tensor([meta.centerX, meta.centerY], dtype=torch.float32)
            source = torch.from_numpy(sources[meta.frameNum])
            expected.append(cpu.foveate(source, center).numpy().tobytes())
            want = cpu.unwarp_auto(torch.from_numpy(np.ascontiguousarray(decoded)), center)
            if full.shape != want.shape or not np.array_equal(full, want.numpy()):
                raise AssertionError(f"{what} client {k} frame {i}: restored frame "
                                     "differs from the CPU unwarp_auto")
    if sorted(f.tobytes() for f in server.encoded) != sorted(expected):
        raise AssertionError(f"{what}: the {len(server.encoded)} reduced frames "
                             f"encoded differ from the CPU foveate of the "
                             f"{len(expected)} frames received")
    return len(expected)


def serve_session(cfg, device, kernels=None):
    """One session, ``SERVE_FRAMES`` frames over the 4-gaze trace.  Returns
    (server, client, launches read around the run)."""
    w, h = cfg.source_width, cfg.source_height
    spec = f"synthetic://{w}x{h}@30/{SERVE_FRAMES}"
    server = CapturingServer(cfg, max_frames=SERVE_FRAMES, device=device)
    client = CapturingClient(
        "memory", video=spec, config=cfg, max_frames=SERVE_FRAMES, device=device,
        gaze_source=lambda i: SERVE_GAZES[i % len(SERVE_GAZES)],
    )
    if kernels:
        zero_counts(kernels)
    asyncio.run(_serve_one(server, client))
    launches = read_counts(kernels) if kernels else {}
    if client.stats.frames != SERVE_FRAMES:
        raise AssertionError(f"session: client restored {client.stats.frames} "
                             f"of {SERVE_FRAMES} frames")
    check_served(cfg, server, [client], synthetic_frames(spec, SERVE_FRAMES), "session")
    return server, client, launches


def serve_broadcast(cfg, device, batch_sampler: str, kernels=None):
    """``BROADCAST_CLIENTS`` clients, each at its own gaze, on one channel
    of ``BROADCAST_TICKS`` ticks.  Returns (server, clients, launches)."""
    w, h = cfg.source_width, cfg.source_height
    spec = f"synthetic://{w}x{h}@30/{BROADCAST_TICKS}"
    server = CapturingServer(cfg, max_frames=BROADCAST_TICKS, broadcast=True,
                             batch_sampler=batch_sampler, device=device)
    clients = [
        CapturingClient("memory", video=spec, config=cfg, device=device,
                        gaze_source=lambda i, g=g: g)
        for g in SERVE_GAZES[:BROADCAST_CLIENTS]
    ]
    if kernels:
        zero_counts(kernels)
    asyncio.run(_serve_channel(server, clients, spec))
    launches = read_counts(kernels) if kernels else {}
    if server.channels:
        raise AssertionError(f"broadcast {batch_sampler}: channel not torn down")
    if not all(c.stats.frames for c in clients):
        raise AssertionError(f"broadcast {batch_sampler}: frames per client "
                             f"{[c.stats.frames for c in clients]}")
    check_served(cfg, server, clients, synthetic_frames(spec, BROADCAST_TICKS),
                 f"broadcast {batch_sampler}")
    return server, clients, launches


def served_ticks(clients) -> int:
    """Ticks at which at least one client was served (decimation may skip
    a member's tick, never a whole channel's frame read)."""
    return len({m.frameNum for c in clients for _, m in c.restored})


def serve_expected(batch_sampler, clients) -> dict[str, int]:
    """The launches a serve run must show: ``batch_sampler`` None for a
    session (the fused sampler once per frame), else the broadcast
    channel's (one fused launch per served tick, or one K5 launch per tick
    read); ``unwarp_xy`` once per frame the clients restored."""
    frames = sum(c.stats.frames for c in clients)
    if batch_sampler is None:
        return {"segreduce_xy": frames, "unwarp_xy": frames}
    if batch_sampler == "fused":
        return {"segreduce_xy": served_ticks(clients), "unwarp_xy": frames}
    return {"sat_build": BROADCAST_TICKS, "unwarp_xy": frames}


def serve_timings(server, clients) -> str:
    """The clients' ``ClientStats.averages()`` (mean over clients), their
    per-frame unwarp ms (the first frame apart: it loads the kernel's
    library) and the server's gaze-apply median, host clock."""
    avg = {}
    for key in ("avg_receive_ms", "avg_decode_ms", "avg_unwarp_ms"):
        avg[key] = statistics.mean(c.stats.averages()[key] for c in clients)
    later = [ms for c in clients for ms in c.unwarp_ms[1:]]
    avg["unwarp_ms_first"] = statistics.mean(c.unwarp_ms[0] for c in clients)
    avg["unwarp_ms_median_after_first"] = statistics.median(later) if later else None
    gaze = statistics.median(server.gaze_apply_ms) if server.gaze_apply_ms else None
    return json.dumps({**avg, "server_gaze_apply_ms_median": gaze})


def time_client_unwarp(cfg, client, reps: int = 20) -> str:
    """The client's restore of one served frame on its own, no server
    running, in the client's steps: the host copy that makes the decoded
    frame contiguous, its copy to the card with the gaze, ``unwarp_auto``
    (synchronised) and the readback; medians over ``reps`` calls (host
    clock)."""
    pipe = FoveationPipeline(cfg)
    decoded, (_, meta) = client.decoded[-1], client.restored[-1]
    parts = {"host_copy_ms": [], "to_device_ms": [], "unwarp_ms": [],
             "readback_ms": []}
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        host = np.ascontiguousarray(decoded)
        t1 = time.perf_counter()
        reduced = torch.from_numpy(host).to(pipe.device)
        center = torch.tensor([meta.centerX, meta.centerY], dtype=torch.float32)
        center = center.to(pipe.device)
        t2 = time.perf_counter()
        full = pipe.unwarp_auto(reduced, center)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        full.cpu().numpy()
        t4 = time.perf_counter()
        for key, ms in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(ms * 1e3)
    out = {k: statistics.median(v[1:]) for k, v in parts.items()}
    out["decoded_strides"] = list(decoded.strides)
    return json.dumps(out)


def phase_serve(kernels) -> None:
    """The streaming server and client on the card (module docstring,
    phase 5)."""
    cfg = FoveaxConfig()
    server, client, launches = serve_session(cfg, None, kernels)
    print(f"serve wire codec: {server.wire_codec} (wire_codec='auto')", flush=True)
    # Which gazes a frame carries depends on when the client's requests
    # land against the server's 30 fps tick; a paced session on the card
    # applies them within a tick.
    gazes = sorted({(m.centerX, m.centerY) for _, m in client.restored})
    if len(gazes) < 2:
        raise AssertionError(f"serve session: gaze updates never applied, {gazes}")
    expect_counts("serve session", launches, serve_expected(None, [client]))
    print(f"serve session {cfg.source_width}x{cfg.source_height} -> "
          f"{cfg.reduced_width}x{cfg.reduced_height}: {client.stats.frames} frames, "
          f"{len(gazes)} gazes {gazes}, launches {launches}, reduced and restored "
          f"frames equal to the CPU path; timings {serve_timings(server, [client])}",
          flush=True)
    print(f"serve client unwarp alone (no server running): "
          f"{time_client_unwarp(cfg, client)}", flush=True)
    for batch_sampler in ("fused", "sat"):
        server, clients, launches = serve_broadcast(cfg, None, batch_sampler, kernels)
        expect_counts(f"serve broadcast {batch_sampler}", launches,
                      serve_expected(batch_sampler, clients))
        print(f"serve broadcast {batch_sampler}: {len(clients)} clients, "
              f"{BROADCAST_TICKS} ticks ({served_ticks(clients)} served), frames "
              f"per client {[c.stats.frames for c in clients]}, launches "
              f"{launches}, equal to the CPU path; timings "
              f"{serve_timings(server, clients)}", flush=True)
    print(f"serve card: {card_line()}", flush=True)


SVD_FRAMES = 4  # session frames: one sync sample, then deltas
SVD_CLIENTS = 2
SVD_TICKS = 4


def check_svd_served(cfg, server, clients, sources, what: str) -> int:
    """Hold an SVD serve run to the CPU port, tolerance 0: every SAT the
    server packed is the CPU ``build_sat`` of a source frame, in frame
    order; every blob is what the CPU ``compress_sat`` and a fresh packer
    make of those SATs in turn; every blob a client received is one the
    server packed; every client's reduced frame is the CPU
    :class:`SvdDecoder`'s on the same blobs at the same gazes; and every
    restored frame the CPU ``unwarp_auto`` of that reduced frame at that
    gaze.  Returns the frames restored."""
    cpu = FoveationPipeline(cfg, device="cpu")
    cpu_sats = [build_sat(torch.from_numpy(f)) for f in sources]
    packer = server._make_svd_packer()
    blobs, k = set(), 0
    for i, (sat, blob, is_sync, _) in enumerate(server.svd_packed):
        while k < len(cpu_sats) and not np.array_equal(sat, sat_to_numpy(cpu_sats[k])):
            k += 1
        if k == len(cpu_sats):
            raise AssertionError(f"{what}: packed SAT {i} is no source frame's "
                                 "CPU SAT in frame order")
        want = packer.pack(compress_sat(cpu_sats[k], cfg.svd_rank))
        if (blob, is_sync) != want:
            raise AssertionError(f"{what}: blob {i} differs from the CPU "
                                 "compress_sat and packer")
        blobs.add(blob)
        k += 1
    restored = 0
    for c, client in enumerate(clients):
        dec = SvdDecoder(cfg, torch.device("cpu"))
        reduced = []
        for j, (blob, gaze, got) in enumerate(client.svd_decoded):
            if blob not in blobs:
                raise AssertionError(f"{what} client {c}: blob {j} was not packed")
            want = dec.decode(blob, gaze)
            if (got is None) != (want is None) or (
                want is not None and not torch.equal(got.cpu(), want)
            ):
                raise AssertionError(f"{what} client {c} blob {j}: reduced frame "
                                     "differs from the CPU decoder's")
            if want is not None:
                reduced.append((want, gaze))
        if len(reduced) != len(client.restored):
            raise AssertionError(f"{what} client {c}: {len(reduced)} decoded, "
                                 f"{len(client.restored)} restored")
        for (want, gaze), (full, _) in zip(reduced, client.restored):
            center = torch.tensor(gaze, dtype=torch.float32)
            if not np.array_equal(full, cpu.unwarp_auto(want, center).numpy()):
                raise AssertionError(f"{what} client {c}: restored frame differs "
                                     "from the CPU unwarp_auto")
        restored += len(reduced)
    return restored


def serve_svd_session(cfg, device, kernels=None):
    """One SVD session of ``SVD_FRAMES`` frames, the client's local gaze
    over the 4-gaze trace.  Returns (server, client, launches)."""
    w, h = cfg.source_width, cfg.source_height
    spec = f"synthetic://{w}x{h}@30/{SVD_FRAMES}"
    server = CapturingServer(cfg, max_frames=SVD_FRAMES, sat_compression="svd",
                             device=device)
    client = CapturingClient(
        "memory", video=spec, config=cfg, max_frames=SVD_FRAMES, device=device,
        gaze_source=lambda i: SERVE_GAZES[i % len(SERVE_GAZES)],
    )
    if kernels:
        zero_counts(kernels)
    asyncio.run(_serve_one(server, client))
    launches = read_counts(kernels) if kernels else {}
    if client.stats.frames != SVD_FRAMES:
        raise AssertionError(f"svd session: client restored {client.stats.frames} "
                             f"of {SVD_FRAMES} frames")
    syncs = [p[2] for p in server.svd_packed]
    if syncs != [True] + [False] * (SVD_FRAMES - 1):
        raise AssertionError(f"svd session: sync flags {syncs}")
    check_svd_served(cfg, server, [client], synthetic_frames(spec, SVD_FRAMES),
                     "svd session")
    return server, client, launches


def serve_svd_broadcast(cfg, device, kernels=None):
    """``SVD_CLIENTS`` clients, each at its own local gaze, on one SVD
    channel of ``SVD_TICKS`` ticks.  Returns (server, clients, launches)."""
    w, h = cfg.source_width, cfg.source_height
    spec = f"synthetic://{w}x{h}@30/{SVD_TICKS}"
    server = CapturingServer(cfg, max_frames=SVD_TICKS, broadcast=True,
                             sat_compression="svd", device=device)
    clients = [
        CapturingClient("memory", video=spec, config=cfg, device=device,
                        gaze_source=lambda i, g=g: g)
        for g in SERVE_GAZES[1:1 + SVD_CLIENTS]
    ]
    if kernels:
        zero_counts(kernels)
    asyncio.run(_serve_channel(server, clients, spec))
    launches = read_counts(kernels) if kernels else {}
    if server.channels:
        raise AssertionError("svd broadcast: channel not torn down")
    if not all(c.stats.frames for c in clients):
        raise AssertionError(f"svd broadcast: frames per client "
                             f"{[c.stats.frames for c in clients]}")
    check_svd_served(cfg, server, clients, synthetic_frames(spec, SVD_TICKS),
                     "svd broadcast")
    return server, clients, launches


def svd_expected(clients, builds: int) -> dict[str, int]:
    """An SVD run's launches: K5 once per source frame read, ``unwarp_xy``
    once per frame the clients restored, nothing else."""
    return {"sat_build": builds,
            "unwarp_xy": sum(c.stats.frames for c in clients)}


def svd_timings(server, clients) -> str:
    """The server's compress+pack ms per blob (host clock, the SAT's
    readback included), the blob bytes (sync, delta) and the clients'
    ``ClientStats`` decode and unwarp means."""
    packed = server.svd_packed
    out = {
        "compress_pack_ms": [round(p[3], 3) for p in packed],
        "blob_bytes_sync": [len(p[1]) for p in packed if p[2]],
        "blob_bytes_delta": [len(p[1]) for p in packed if not p[2]],
    }
    for key in ("avg_decode_ms", "avg_unwarp_ms"):
        out[key] = statistics.mean(c.stats.averages()[key] for c in clients)
    return json.dumps(out)


def phase_svd(kernels) -> None:
    """SVD serving on the card (module docstring, phase 6)."""
    cfg = FoveaxConfig()
    server, client, launches = serve_svd_session(cfg, None, kernels)
    expect_counts("svd session", launches, svd_expected([client], SVD_FRAMES))
    print(f"svd session {cfg.source_width}x{cfg.source_height} -> "
          f"{cfg.reduced_width}x{cfg.reduced_height}, rank {cfg.svd_rank}, gop "
          f"{cfg.gop_size}: {client.stats.frames} frames, launches {launches}, "
          f"SATs, blobs, reduced and restored frames equal to the CPU port; "
          f"{svd_timings(server, [client])}", flush=True)
    server, clients, launches = serve_svd_broadcast(cfg, None, kernels)
    expect_counts("svd broadcast", launches, svd_expected(clients, SVD_TICKS))
    print(f"svd broadcast: {len(clients)} clients, {SVD_TICKS} ticks, frames per "
          f"client {[c.stats.frames for c in clients]}, launches {launches}, "
          f"equal to the CPU port; {svd_timings(server, clients)}", flush=True)
    print(f"svd card: {card_line()}", flush=True)


MATH_GAZE = (0.3, 0.4)
VIEWPORT = (1280, 720)
PYRAMID_LEVELS = 4
# Bounds of the float math on the card against the CPU port: the share of
# pixels more than 1 LSB off (blur, log-polar unwarp), the share of
# viewport pixels that differ (gnomonic: the card's atan/asin/atan2/sin/cos
# are not the CPU's), and |card - CPU| of the metrics.
MAX_SHARE_OVER_1LSB = 1e-3
MAX_GNOMONIC_SHARE = 1e-2
MAX_PSNR_DB_DIFF = 1e-3
MAX_SSIM_DIFF = 1e-4


def math_exact(cfg, dev, frame, reduced, c):
    """The integer-exact math off the main path at ``cfg``'s shapes on
    ``dev``: name -> zero-argument call."""
    w, h = cfg.source_width, cfg.source_height
    wr, hr = cfg.reduced_width, cfg.reduced_height
    grid = FoveationPipeline(cfg, device=dev).grid
    point = make_point_grid(wr, hr, w, h, dev)
    lpg = logpolar.make_logpolar_grid(wr, hr, w, h, device=dev)
    sat = build_sat(frame)
    pyr = logpolar.build_pyramid(frame, PYRAMID_LEVELS)
    return {
        "sample_rect_point": lambda: core_sample.sample_rect_point(frame, point, c),
        "sample_rect_360_from_sat": lambda: core_sample.sample_rect_360_from_sat(
            sat, grid, c),
        "expand_sampled_rect": lambda: core_sample.expand_sampled_rect(
            reduced, w, h, c),
        "sample_logpolar": lambda: logpolar.sample_logpolar(frame, lpg, c),
        "build_pyramid": lambda: logpolar.build_pyramid(frame, PYRAMID_LEVELS),
        "sample_logpolar_pyramid": lambda: logpolar.sample_logpolar_pyramid(
            pyr, lpg, c, PYRAMID_LEVELS),
    }


def math_float(cfg, viewport, frame, lp, restored, c):
    """The float32 math at ``cfg``'s shapes (gnomonic at ``viewport``):
    name -> zero-argument call; ``lp`` is a log-polar sample and
    ``restored`` the frame's SAT-path restore."""
    w, h = cfg.source_width, cfg.source_height
    calls = {
        "logpolar_gaussian_blur": lambda: logpolar.logpolar_gaussian_blur(lp),
        "unwarp_logpolar": lambda: logpolar.unwarp_logpolar(lp, w, h, c),
        "gnomonic_project": lambda: gnomonic.gnomonic_project(frame, *viewport, c),
    }
    for name in ("mse", "psnr", "ws_psnr", "ssim"):
        calls[name] = lambda f=getattr(metrics, name): f(frame, restored)
    for name in ("foveal_psnr", "eccentricity_weighted_psnr", "foveal_ssim",
                 "eccentricity_weighted_ssim"):
        calls[name] = lambda f=getattr(metrics, name): f(frame, restored, c)
    return calls


def time_host(fn, reps: int = 5) -> float:
    """Median host ms of ``fn``, synchronised with the card where there is
    one, after a warm-up call."""

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_math(device: str = "cuda", cfg=None, viewport=VIEWPORT) -> dict:
    """The math off the main path on ``device`` against the CPU port
    (module docstring, phase 7); returns the report it prints."""
    cfg = cfg or FoveaxConfig()
    frame_np = synthetic_frames(f"synthetic://{cfg.source_width}x"
                                f"{cfg.source_height}@30/1", 1)[0]
    cpu = FoveationPipeline(cfg, sampler="sat", device="cpu")
    frame = torch.from_numpy(frame_np)
    c = torch.tensor(MATH_GAZE, dtype=torch.float32)
    reduced = cpu.foveate(frame, c)
    restored = cpu.unwarp_auto(reduced, c)
    lpg = logpolar.make_logpolar_grid(cfg.reduced_width, cfg.reduced_height,
                                      cfg.source_width, cfg.source_height, device="cpu")
    lp = logpolar.sample_logpolar(frame, lpg, c)
    report = {}
    exact_cpu = math_exact(cfg, "cpu", frame, reduced, c)
    exact_dev = math_exact(cfg, device, frame.to(device), reduced.to(device),
                           c.to(device))
    for name, fn in exact_dev.items():
        got, want = fn().cpu(), exact_cpu[name]()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"math {name}: the card differs from the CPU port")
        report[name] = {"equal": True, "ms": round(time_host(fn), 4)}
    float_cpu = math_float(cfg, viewport, frame, lp, restored, c)
    float_dev = math_float(cfg, viewport, *(t.to(device) for t in
                                            (frame, lp, restored, c)))
    for name, fn in float_dev.items():
        got, want = fn().cpu(), float_cpu[name]()
        entry = {"ms": round(time_host(fn), 4)}
        if got.dtype == torch.uint8:
            d = (got.to(torch.int32) - want.to(torch.int32)).abs()
            if name == "gnomonic_project":
                share, bound = float(d.amax(-1).gt(0).float().mean()), MAX_GNOMONIC_SHARE
                entry["share_differing"] = share
            else:
                share, bound = float(d.gt(1).float().mean()), MAX_SHARE_OVER_1LSB
                entry["share_over_1lsb"] = share
            entry["max_abs_diff"] = int(d.max())
        else:
            share = abs(float(got) - float(want))
            bound = MAX_SSIM_DIFF if "ssim" in name else MAX_PSNR_DB_DIFF
            if name == "mse":
                bound = 1e-5 * float(want)
            entry.update(value=float(got), cpu_value=float(want), abs_diff=share)
        if not share <= bound:
            raise AssertionError(f"math {name}: {share} against the CPU port, "
                                 f"bound {bound}")
        report[name] = entry
    print(f"math {cfg.source_width}x{cfg.source_height} (gnomonic "
          f"{viewport[0]}x{viewport[1]}), gaze {MATH_GAZE}, {device} vs CPU port, "
          f"host ms synchronised (median of 5): {json.dumps(report)}", flush=True)
    return report


# Phase 8: the CLI at the serving shape.  Each call's launches on the card,
# one entry per kernel that must launch (every other kernel: 0).  The
# transcode's restore is the exact unwarp (plain torch, no kernel), as in
# the JAX package; ``perf`` runs 8 + 6 chained steps per resolution and,
# with ``--clients 8``, 8 + 6 batch steps (fused: one segreduce_xy for the
# 8 gazes); ``stages``: stage 1 one foveate, stage 2 one SAT build, stage 3
# 30 served and restored frames, stage 4 26 SAT-path steps, stage 5 61
# one-SAT batches and 8 single foveates; ``doctor`` builds and launches K5
# once.
CLI_SOURCE = "synthetic://1920x1080@30/{}"
CLI_FRAMES = 4
PERF_STEPS = 2 * (8 + 6)  # two resolutions, chain(2) twice and chain(8 + 2)
STAGE_EXPECTED = {
    1: {"segreduce_xy": 1},
    2: {"sat_build": 1},
    3: {"segreduce_xy": 30, "unwarp_xy": 30},
    4: {"sat_build": 26, "unwarp_xy": 26},
    5: {"sat_build": 61, "segreduce_xy": 8},
}
CLI_EXPECTED = {
    "single_frame logrect": {"segreduce_xy": 1},
    "single_frame logrect_point": {},
    "interpolate_sampled": {"segreduce_xy": 1},
    "foveate_no_encoding": {"segreduce_xy": CLI_FRAMES},
    "encode_bitrate": {"segreduce_xy": CLI_FRAMES},
    "decode": {},
    "gaze_eval": {},
    "perf": {"segreduce_xy": 2 * PERF_STEPS, "unwarp_xy": PERF_STEPS},
    "perf --sampler sat": {"sat_build": PERF_STEPS, "unwarp_xy": PERF_STEPS,
                           "segreduce_xy": PERF_STEPS},
    "stages": {name: sum(e.get(name, 0) for e in STAGE_EXPECTED.values())
               for name in ("segreduce_xy", "unwarp_xy", "sat_build")},
    "doctor": {"sat_build": 1},
}


def run_cli(argv: list[str], device: str) -> str:
    """``foveax_torch.cli.main.main(["--device", device, *argv])`` in this
    process; returns what it printed, raises unless it returned 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", device, *argv])
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"{' '.join(argv)} on {device}: exit code {rc}\n{out}")
    return out


def cli_card(kernels, what: str, argv: list[str]) -> str:
    """One subcommand on the card, its launch counts held to
    :data:`CLI_EXPECTED`."""
    zero_counts(kernels)
    out = run_cli(argv, "cuda")
    expect_counts(f"cli {what}", read_counts(kernels), CLI_EXPECTED[what])
    return out


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def video_frames(path: str) -> list[np.ndarray]:
    from foveax_torch.io.video import VideoReader

    with VideoReader(path) as r:
        return [np.ascontiguousarray(f) for f in r]


def same_videos(what: str, a: str, b: str, n: int) -> None:
    fa, fb = video_frames(a), video_frames(b)
    if len(fa) != n or len(fb) != n:
        raise AssertionError(f"cli {what}: {len(fa)} and {len(fb)} frames, expected {n}")
    for i, (x, y) in enumerate(zip(fa, fb)):
        if not np.array_equal(x, y):
            raise AssertionError(f"cli {what}: frame {i} differs between card and CPU")


def phase_cli(kernels) -> dict:
    """The CLI on the card against ``--device cpu`` (module docstring,
    phase 8); returns the printed ``perf`` and ``stages`` lines."""
    t0 = time.perf_counter()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = {dev: f"{tmp}/{dev}" for dev in ("cuda", "cpu")}
        for d in out.values():
            os.makedirs(d)
        src = CLI_SOURCE.format(6)
        for tech in ("logrect", "logrect_point"):
            what = f"single_frame {tech}"
            argv = lambda d: ["single_frame", src, "2", f"{d}/sf_{tech}",
                              "--technique", tech, "--gaze", "0.37,0.61"]
            cli_card(kernels, what, argv(out["cuda"]))
            run_cli(argv(out["cpu"]), "cpu")
            for suffix in ("_source.png", "_foveated.png"):
                if read_bytes(f"{out['cuda']}/sf_{tech}{suffix}") != read_bytes(
                        f"{out['cpu']}/sf_{tech}{suffix}"):
                    raise AssertionError(f"cli {what}: {suffix} differs")
        argv = lambda d: ["interpolate_sampled", src, "1", f"{d}/is", "--gaze", "0.2,0.7"]
        cli_card(kernels, "interpolate_sampled", argv(out["cuda"]))
        run_cli(argv(out["cpu"]), "cpu")
        for suffix in ("_source.png", "_foveated.png", "_restored.png"):
            if read_bytes(f"{out['cuda']}/is{suffix}") != read_bytes(f"{out['cpu']}/is{suffix}"):
                raise AssertionError(f"cli interpolate_sampled: {suffix} differs")

        trace = ["--gaze-trace", "synthetic:1", "--max-frames", str(CLI_FRAMES)]
        for what, name in (("foveate_no_encoding", "rt.mp4"), ("encode_bitrate", "fov.mp4")):
            argv = lambda d: [what, src, f"{d}/{name}", *trace]
            cli_card(kernels, what, argv(out["cuda"]))
            run_cli(argv(out["cpu"]), "cpu")
            same_videos(what, f"{out['cuda']}/{name}", f"{out['cpu']}/{name}", CLI_FRAMES)
        argv = lambda d: ["decode", f"{out['cuda']}/fov.mp4", f"{d}/dec.mp4",
                          "--width", "1920", "--height", "1080", *trace]
        cli_card(kernels, "decode", argv(out["cuda"]))
        run_cli(argv(out["cpu"]), "cpu")
        same_videos("decode", f"{out['cuda']}/dec.mp4", f"{out['cpu']}/dec.mp4", CLI_FRAMES)

        argv = ["gaze_eval", "--frames", "300", "--saccades"]
        if cli_card(kernels, "gaze_eval", argv) != run_cli(argv, "cpu"):
            raise AssertionError("cli gaze_eval: printed lines differ")
    compared_s = time.perf_counter() - t0

    perf = ["perf", "--resolutions", "1080p", "4k", "--frames", "8", "--clients", "8"]
    report["perf"] = cli_card(kernels, "perf", perf).splitlines()
    report["perf --sampler sat"] = cli_card(
        kernels, "perf --sampler sat", perf + ["--sampler", "sat"]).splitlines()
    stages = cli_card(kernels, "stages", ["stages"])
    report["stages"] = stages.splitlines()
    if "5/5 stages passed" not in stages:
        raise AssertionError(f"cli stages:\n{stages}")
    report["doctor"] = [l for l in cli_card(kernels, "doctor", ["doctor"]).splitlines()
                        if l.startswith(("device:", "kernels:"))]
    card = card_line()
    print(f"cli 1920x1080: single_frame (logrect, logrect_point), "
          f"interpolate_sampled, foveate_no_encoding, encode_bitrate, decode and "
          f"gaze_eval equal to --device cpu ({compared_s:.1f} s); launch counts "
          f"as CLI_EXPECTED; card {card}", flush=True)
    for key, lines in report.items():
        for line in lines:
            print(f"cli {key}: {line}  [{card}]", flush=True)
    print(f"cli phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return report


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
    logs = build(["segreduce", "unwarp", "scan2d"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line:
                print(f"  {name}: {line.strip()}")

    kernels = kernel_table()
    errs = phase_compare("cuda")
    phase_compare_sat(errs)
    fused_launches = phase_main_path(kernels, "fused")
    sat_launches = phase_main_path(kernels, "sat")
    phase_serve_pair(kernels)
    phase_degrade(kernels)
    # Each kernel's count from the run of its path; K1, K2 and K6 are on no
    # path (0 in both runs).
    launches = {
        name: (fused_launches if name in PATH_KERNELS["fused"] else sat_launches)[name]
        for name in kernels
    }
    timing = {row["name"]: row for row in phase_timing()}
    for shape in SHAPES:
        for sampler in PATH_KERNELS:
            phase_path_fps(shape, sampler)
    phase_serve(kernels)
    phase_svd(kernels)
    phase_math()
    phase_cli(kernels)
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            **{key: timing[name][key] for key in (
                "ms", "ms_queued", "plain_ms", "plain_ms_queued", "bound_ms",
                "bound_by", "library_ms", "library_ms_queued")},
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
