#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``foveax_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. Build the CUDA kernels from ``foveax_torch/kernels/csrc`` (one nvcc per
   source, four sources, in parallel).
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
   ends in the first band; the SAT path's 4-tap sampler K7 in both output
   layouts on K5's SATs of random 1080p and 4K frames with each gaze's
   taps (N = 1) and the eight gazes of :data:`BATCH_GAZES` (N = 8), on
   random taps (non-monotone seam columns, ``pmc = pc - 1``), on SAT words
   plus random per-row and per-column offsets mod 2^32 (they cancel in
   every box), on the all-255 8K SAT (its words wrap past 2^32)
   at eight gazes, and at 1000x500 -> 560x288 and output width 1001 (8K
   and 16K in phase 11, 36000x18000 in phase 15).
3. Drive two 4K paths through ``FoveationPipeline``, each over a 32-frame
   gaze trace with every restored frame fed back as the next input
   (``foveate_chw`` then the fused ``unwarp_auto_chw``): the fused path
   (``segreduce_xy`` and ``unwarp_xy`` rise by exactly 32, K1, K2, K5, K6
   and K7 by 0) and the SAT path, ``sampler="sat"`` (K5, K7 and
   ``unwarp_xy`` by 32, the others by 0; every reduced frame equal to the
   fused pipeline's on the same input).  In both the
   fovea of every roundtrip must equal its source and the first frame the
   CPU pipeline's result.  Then the serve tick's SAT pair at 4K
   (``batch_pair("sat")``, eight gazes: one K5 and one K7 launch, the
   batch equal to the fused batch) and the degrade contract (1920x1080 ->
   64x36, outside the fused sampler's and the fused unwarp's contracts:
   "auto" runs the SAT path and the exact unwarp, one K5 and one K7 launch
   and no unwarp kernel, equal to the CPU path; "fused" raises).
4. Time each kernel, its plain version and, for K5, the library's two
   ``torch.cumsum`` calls at the 4K main-path shapes (CUDA events, median
   of 50 launches (10 for plain and library), L2 flushed before each), in
   two readings: ``ms`` starts the events right after the flush, so host
   time before the launch counts; ``ms_queued`` first keeps the card busy
   for about 0.2 ms (``torch.cuda._sleep``, its cycle count derived once
   from a timed sleep and printed) while the host enqueues the start
   event, the call and the end event.  K7's bound counts each SAT word
   the run's taps need once (:func:`sat_sample_bytes`).  Then both
   chained paths at 1080p and 4K (host clock, synchronised), beside the
   card's name and power limit.
5. Serve on the card at 1920x1080 -> 1072x608: the port's ``FoveaxServer``
   and ``FoveaxClient`` through an in-memory connection pair
   (:func:`memory_pair`, asyncio queues), the wire codec resolved as the
   server resolves ``wire_codec="auto"`` (h264 where the port's codec shim
   builds, else jpeg).  One session of 8 frames over a 4-gaze trace
   (``sampler="auto"`` resolves to fused: ``segreduce_xy`` and
   ``unwarp_xy`` +8 each, every other kernel +0), then a 4-client broadcast
   channel of 6 ticks, with ``batch_sampler="fused"`` (one
   ``segreduce_xy`` launch per served tick) and ``"sat"`` (one K5 launch
   per tick, then one K7 launch per served tick); ``unwarp_xy`` once per
   frame a client restores.  Every reduced frame the server hands an encoder must
   equal the CPU pipeline's ``foveate`` of the same source frame at the
   gaze its ``FrameMeta`` echoes, and every restored frame the CPU
   pipeline's ``unwarp_auto`` of the decoded reduced frame (tolerance 0).
   The broadcast runs a third time with ``batch_sampler="direct"`` (no
   kernel on the server: ``segreduce_xy`` and K5 +0).
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
   ``perf --resolutions 1080p --frames 8 --clients 8 --sampler direct
   --batch-sampler direct``, ``stages`` (``6/6 stages passed``) and
   ``doctor`` (exit code 0).  Every
   call's launch counts must be :data:`CLI_EXPECTED`'s.  Prints ``perf``'s
   and ``stages``' lines beside the card's name and power limit.
9. Multi-device serving (``foveax_torch.parallel``) on a 2x2 (data x
   space) mesh: four distinct cards where four are visible, else
   ``cuda:0`` for all four entries (printed).  ``dryrun_multichip(4)``
   (``foveax_torch/graft_entry.py``), then at 4K (3840x2160 -> 2144x1200)
   over the 8 gazes of :data:`BATCH_GAZES`: ``sharded_build_sat`` (K5 +2,
   one launch a space block), ``multi_client_step`` (reduced and restored
   frames; K5 +2, K7 +2, one a data shard, no unwarp kernel: the exact
   unwarp), ``frame_parallel_roundtrip`` over 4 frames (K5 +4, K7 +4),
   ``sharded_sample_batch_fused`` (``segreduce_xy`` +2, one launch a data
   shard) and both ``jit_serve_parts`` pairs, each with its launches read
   around it and its outputs equal (tolerance 0) to the single-device path
   on the card and to the same call on a mesh of CPU entries.  Then the
   broadcast ``FoveaxServer(mesh=...)`` at 1920x1080 -> 1072x608 through
   :func:`memory_pair` (4 clients, 6 ticks, ``batch_sampler`` "fused" then
   "sat"; ``segreduce_xy`` twice a served tick, or K5 twice a tick and K7
   twice a served tick, every
   served and restored frame equal to the CPU path as phase 5 checks it),
   ``place_videos="round_robin"``'s ``_next_device()`` (printed) and a
   round-robin broadcast of two videos, two clients each (each channel's
   pipeline on the next card where several are visible; frames equal to
   the CPU path, one ``segreduce_xy`` a served tick a channel), and the
   sharded 4K tick of each pair against the single-device ``batch_pair``
   (host clock, synchronised) with the bytes the SAT gather moves, beside
   the card's name and power limit.
10. The SAT-free direct sampler (``foveax_torch/core/direct.py``, plain
   PyTorch, no kernel of its own): ``FoveationPipeline(sampler="direct")``
   over the 32-frame chained path at 1080p and 4K as in phase 3
   (``unwarp_xy`` +32, every other kernel +0; every reduced frame equal to
   the fused pipeline's on the same input, the fovea exact, the first frame
   equal to the CPU port's); ``batch_pair("direct")`` over the 8 gazes of
   :data:`BATCH_GAZES` at 4K (no launch, equal to the fused batch); at
   1920x1080 -> 64x36 on a random and an all-255 frame, at four gazes,
   equal to the SAT path; a call at a fresh gaze and a batch under
   ``torch.cuda.set_sync_debug_mode("error")``.  Then at 4K ``ms`` and
   ``ms_queued`` of the three samplers of one function (direct, the fused
   sampler with its taps, the SAT pair) beside their least-bytes bound,
   and the direct path's chained fps at 1080p and 4K, beside the card's
   name and power limit.

11. The resolution ladder.  The fused path at 8K (7680x4320 -> 4272x2400)
   and 16K (15360x8640 -> 8544x4800) over 4 chained gazes each, as in
   phase 3 (``segreduce_xy`` and ``unwarp_xy`` +4, every other kernel +0;
   the fovea of every roundtrip equal to its source); then every launch is
   held on the card to its plain version on the same inputs (tolerance 0)
   and each restored frame to the exact unwarp (at most 1 LSB).  The SAT
   path at both sizes for one gaze (K5 +1, K7 +1, the SAT and the reduced
   frame equal to their plain versions', the reduced frame to the fused
   path's).  Then both paths'
   chained fps at both sizes as in phase 4,
   ``foveax_torch.scripts.stage_bench`` over 1080p, 4K, 8K and 16K and the
   five stages (host and device ms per frame) and the CLI's ``perf
   --resolutions 8k 16k`` with its launch counts, beside the card's name
   and power limit.
12. The shape fuzz: ``foveax_torch.scripts.fuzz_fused`` with seed 0 over 8
   random shapes up to 16,384 x 2,200 (widths never a multiple of 16, the
   first above 8,192), with no failure.
13. Serving across processes: ``foveax_torch.scripts.two_process_demo`` at
   1920x1080 over 60 frames, the server (``python -m foveax_torch.cli.main
   --device cuda serve``) in a second process and the client in this one,
   on the card and then on the CPU; every frame must arrive and the gaze
   fan-in percentiles print.  Then the serving soak
   (``foveax_torch.scripts.soak``) on the card for each wire codec: no
   session, channel, native handle, fd or thread left, and the CUDA memory
   allocated after each later cycle no higher than after the second.
14. The sharded fuzz and a hostile stream.
   ``foveax_torch.scripts.fuzz_sharded`` with seed 0 over 6 random shapes
   (widths 128 to 4,096, never a multiple of 16; heights up to 2,160 whose
   space blocks end inside K5's 32-row band; meshes 1x8, 2x4, 4x2, 8x1
   over eight distinct cards where eight are visible, else ``cuda:0``
   eight times), then the all-255 4808x4000 frame on the 1x8 mesh, whose
   sums wrap past 2^32: every sharded output equal to the single-device
   path and to the same call on a mesh of CPU entries, K5 launched once a
   space block (twice a shape) and once alone, ``segreduce_xy`` once a
   data shard, K7 once a gaze alone and once a data shard in each of the
   two sharded samples, with no failure.  Then the port's ``FoveaxClient`` is fed,
   through :func:`memory_pair`, a stream whose init segment declares other
   dimensions than its configuration's, and one whose init segment
   matches but whose sample decodes to other dimensions: each must raise
   ValueError in the client with no kernel launched, and an ``unwarp_xy``
   launch after them must equal ``unwarp_xy_plain`` (tolerance 0).  The
   phase's wall time prints beside the card's name and power limit.
15. Wide frames: past the 32,768 columns one K5 scanning block spans, K5
   and K6 scan in column tiles, and past 35,888 columns (under the
   reduced-size rule) a ``segreduce_xy`` block would need more shared
   memory than the card has, so the fused sampler's contract refuses the
   shape.  K5 on a random and an all-255 70000x256 frame (three tiles, the
   last 4,464 columns; the all-255 sums wrap past 2^32) and at 36000x1024
   (two tiles), in both layouts, against its plain version; the all-255
   SATs at 70000x256 and 34560x512 against 255(y+1)(x+1) mod 2^32; K6 at
   70000x256 with each gaze's row taps and at 36000x1024 with a pyc list
   reaching row H-1, against its plain version (tolerance 0).  Then at
   36000x18000 -> 20000x10000 ``FoveationPipeline`` "auto" must resolve
   "sat": 4 chained gazes of ``foveate_chw`` then ``unwarp_auto_chw`` (K5,
   K7 and ``unwarp_xy`` +4, every other kernel +0; the fovea of every
   roundtrip equal to its source); every ``unwarp_xy`` output equal to
   ``unwarp_xy_plain`` and within 1 LSB of the exact unwarp, a channel at
   a time; the serve tick's SAT pair ``batch_pair("auto")`` on the first
   frame with 3 and with 8 gazes (:data:`WIDE_BATCHES`; K5 +1, K7 +1,
   nothing else), its SAT equal to the plain scan in 1,024-row blocks
   (each carried on from the block above), its first row equal to the
   chained path's first reduced frame and to ``sat_sample_batch_plain``
   (after the batch is freed: the plain version holds about 23 GB a gaze
   here) and every row to the single-gaze sampler's on the same SAT; then
   ``batch_pair("direct")`` with 3 gazes, each row equal to the SAT
   batch's, or its ``torch.OutOfMemoryError`` printed (a finding, not a
   failure); the first reduced frame equal to ``sampler="direct"``'s.  The
   chained fps, a ``torch.profiler`` kernel breakdown of one chained
   frame, K5's and K7's ``ms``/``ms_queued`` beside their bytes bounds and
   the peak tensor bytes of the SAT path, each batch pair and the direct
   sampler print.  At 34560x17280 -> 19200x9600 (223,744 bytes a block)
   "auto" must resolve "fused", ``sampler="sat"`` (K5 +1, in two tiles,
   K7 +1) and the fused sampler
   (``segreduce_xy`` +1) give equal reduced frames at one gaze, and the
   fused one equals ``segment_reduce_xy_batch_plain``.  The phase's wall
   time prints beside the card's name and power limit.

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
from foveax_torch.core import direct as core_direct
from foveax_torch.core import gnomonic, logpolar, metrics
from foveax_torch.core import sample as core_sample
from foveax_torch.config import reduced_dim
from foveax_torch.core.logrect import make_grid, make_point_grid
from foveax_torch.core.sat import build_sat
from foveax_torch.core.svd_sat import compress_sat, sat_to_numpy
from foveax_torch.core.unwarp import unwarp_rect
from foveax_torch.graft_entry import dryrun_mesh_devices, dryrun_multichip
from foveax_torch.io.mux import FragmentWriter
from foveax_torch.io.video import SyntheticReader
from foveax_torch.serve.client import SvdDecoder
from foveax_torch.kernels import fused_select as fs
from foveax_torch.kernels import sat_sample as ss
from foveax_torch.kernels import scan2d
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels import unwarp as uw
from foveax_torch.kernels.build import SOURCES, build
from foveax_torch.parallel import make_mesh
from foveax_torch.parallel import sharded
from foveax_torch.io.wirecodec import JpegWireEncoder, available_wire_codecs
from foveax_torch.scripts import fuzz_fused, fuzz_sharded, soak, stage_bench
from foveax_torch.scripts import two_process_demo

SHAPES = {"1080p": (1920, 1080), "4k": (3840, 2160)}
# Phase 11's sizes (7680x4320 -> 4272x2400, 15360x8640 -> 8544x4800).
LADDER = {"8k": (7680, 4320), "16k": (15360, 8640)}
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
    "sat": ("sat_build", "sat_sample", "unwarp_xy"),
    "direct": ("unwarp_xy",),
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
    sample = "foveax_torch/kernels/csrc/sat_sample.cu"
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
        "sat_sample": (ss.SAT_SAMPLE, sample,
                       "foveax/core/sample.py:155 (plain JAX: no Pallas "
                       "counterpart)"),
    }


def make_pipeline(shape: str, device: str, sampler: str = "auto"):
    w, h = (SHAPES | LADDER)[shape]
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


def keep_max(errs, name: str, err: int) -> None:
    errs[name] = max(errs.get(name, 0), err)


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


def sat_taps(grid, sat, centers):
    """The taps ``sample_rect_from_sat`` hands K7 for ``centers`` (N, 2),
    in the order of ``sat_sample_batch``'s arguments after the SAT."""
    _, hs, ws = sat.shape
    pxc, pxmc, vx, pyc, pymc, vy = core_sample.gaze_taps(grid, hs, ws, centers)
    return pxmc, pxc, vx, pymc, pyc, vy


def sat_sample_bytes(taps, out: torch.Tensor) -> int:
    """The bytes K7 must move for ``taps`` (one gaze): each SAT word that a
    valid cell needs read once (the valid rows' taps times the valid
    columns' taps, three channels), the taps read once, the output written
    once."""
    pxmc, pxc, vx, pymc, pyc, vy = taps
    words = 0
    for g in range(pxc.shape[0]):
        cols = torch.unique(torch.cat([pxc[g][vx[g]], pxmc[g][vx[g]]])).numel()
        rows = torch.unique(torch.cat([pyc[g][vy[g]], pymc[g][vy[g]]])).numel()
        words += 3 * rows * cols
    return 4 * words + sum(t.numel() * t.element_size() for t in taps) + out.numel()


def sat_sample_ops(taps) -> int:
    """K7's operations for ``taps``: three subtractions and one division
    per channel of each valid cell."""
    _, _, vx, _, _, vy = taps
    return 12 * int((vy.sum(1) * vx.sum(1)).sum())


def sat_sample_extra_cases(rng, sat, n: int, wr: int, hr: int):
    """K7's arguments beyond the path's taps: random in-contract taps (no
    order across a row, as at the seam; every third interval one long,
    ``pmc = pc - 1``) over ``sat``, and the same taps over the SAT's words
    plus a random offset per row and per column, mod 2^32: the offsets
    cancel in every box, but nearly every 4-tap difference leaves [0,
    2^32) before the wrap."""
    _, hs, ws = sat.shape
    dev = sat.device
    pxc, pxmc, vx = random_taps(rng, n, wr, ws, ws - 1, dev)
    pyc, pymc, vy = random_taps(rng, n, hr, hs, hs - 1, dev)
    pxmc[:, 1::3], pymc[:, 1::3] = pxc[:, 1::3] - 1, pyc[:, 1::3] - 1
    taps = (pxmc, pxc, vx, pymc, pyc, vy)
    row, col = (torch.from_numpy(rng.integers(0, 2**32, n, np.int64)).to(dev)
                for n in (hs, ws))
    offset = scan2d.low32(scan2d.as_int64(sat) + row[:, None] + col[None, :])
    return {"random taps": (sat, *taps), "random taps, offset words": (offset, *taps)}


def phase_compare_sat_sample(errs: dict[str, int], device: str = "cuda") -> None:
    """K7 against its plain version in both output layouts (module
    docstring, phase 2); on the CPU both are the plain version."""
    cases = {}
    for shape in SHAPES:
        pipe = make_pipeline(shape, device)
        sat = build_sat(make_frame(pipe, SEED), in_layout="chw")
        for gazes in [[g] for g in GAZES] + [BATCH_GAZES]:
            centers = torch.tensor(gazes, dtype=torch.float32, device=device)
            cases[f"{shape}, gazes {gazes}"] = (sat, *sat_taps(pipe.grid, sat, centers))
        hr, wr, _ = pipe.reduced_shape
        rng = np.random.default_rng(SEED + wr)
        for what, args in sat_sample_extra_cases(rng, sat, 3, wr, hr).items():
            cases[f"{shape}, {what}"] = args
    pipe = make_pipeline("8k", device)
    sat = build_sat(sat_frame(*LADDER["8k"], 255, device), in_layout="chw")
    centers = torch.tensor(BATCH_GAZES, dtype=torch.float32, device=device)
    cases["8k all-255, 8 gazes"] = (sat, *sat_taps(pipe.grid, sat, centers))
    w, h, wr, hr = ODD_SHAPE
    sat = build_sat(sat_frame(w, h, None, device), in_layout="chw")
    grid = make_grid(wr, hr, w, h, device)
    centers = torch.tensor(GAZES, dtype=torch.float32, device=device)
    cases[f"{w}x{h}, {len(GAZES)} gazes"] = (sat, *sat_taps(grid, sat, centers))
    rng = np.random.default_rng(SEED + w)
    cases[f"{w}x{h}, random taps, width 1001"] = sat_sample_extra_cases(
        rng, sat, 2, 1001, hr)["random taps"]
    for layout in ss.LAYOUTS:
        compare_extra(errs, "sat_sample",
                      lambda *a: ss.sat_sample_batch(*a, layout),
                      lambda *a: ss.sat_sample_batch_plain(*a, layout),
                      cases, layout)
    print(f"compare sat_sample: {len(cases)} cases x 2 layouts ({', '.join(SHAPES)} "
          f"at {len(GAZES)} single gazes and {len(BATCH_GAZES)} together, random "
          f"taps, offset words; 8k all-255; {w}x{h}; width 1001), bit-equal to "
          "the plain version", flush=True)


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


def sync_all() -> None:
    """Wait for every visible card (a mesh's blocks may lie on several)."""
    for k in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        torch.cuda.synchronize(k)


def read_counts(kernels) -> dict[str, int]:
    sync_all()
    return {name: k.launches for name, (k, _, _) in kernels.items()}


def expect_counts(what: str, launches: dict[str, int], expected: dict[str, int]):
    want = {name: expected.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def phase_main_path(kernels, sampler: str, shape: str = "4k",
                    device: str = "cuda") -> dict[str, int]:
    """One path over the 32-frame trace, its launch counts read around
    it.  For the SAT and direct paths every reduced frame is then held to
    the fused pipeline's on the same input."""
    pipe = make_pipeline(shape, device, sampler)
    frame = make_frame(pipe, SEED + 1)
    gazes = gaze_trace(N_FRAMES)
    centers = [torch.from_numpy(g).to(device) for g in gazes]
    if kernels:
        zero_counts(kernels)
    last, fovea_ok, kept = run_main_path(
        pipe, frame, gazes, centers, keep=sampler != "fused"
    )
    launches = read_counts(kernels) if kernels else {}
    hr, wr, _ = pipe.reduced_shape
    h, w, _ = pipe.source_shape
    if last.shape != (3, h, w) or last.dtype != torch.uint8:
        raise AssertionError(f"{sampler} path gave {last.dtype} {tuple(last.shape)}")
    if not bool(fovea_ok.all()):
        bad = (~fovea_ok).nonzero().flatten().tolist()
        raise AssertionError(
            f"{sampler} path: fovea not round-tripped exactly at frames {bad}"
        )
    if kernels:
        expect_counts(f"{sampler} path", launches,
                      {name: N_FRAMES for name in PATH_KERNELS[sampler]})

    if kept:
        fused = make_pipeline(shape, device, "fused")
        for i, ((x, reduced), c) in enumerate(zip(kept, centers)):
            if not torch.equal(fused.foveate_chw(x, c), reduced):
                raise AssertionError(f"{sampler} path frame {i} differs from the fused path")
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
    same = ", each reduced frame equal to the fused path's" if sampler != "fused" else ""
    print(f"main path {sampler} {shape}: {N_FRAMES} chained frames, launches "
          f"{launches}, fovea exact on every frame{same}, first frame equal "
          "to the CPU path", flush=True)
    return launches


def phase_serve_pair(kernels, shape: str = "4k") -> None:
    """The serve tick's SAT pair over a gaze batch: one SAT build and one
    K7 launch, the batch equal to the fused batch sampler's."""
    pipe = make_pipeline(shape, "cuda")
    frame = make_frame(pipe, SEED + 4).permute(1, 2, 0).contiguous()
    centers = torch.tensor(BATCH_GAZES, dtype=torch.float32, device="cuda")
    prepare, sample_batch = pipe.batch_pair("sat")
    zero_counts(kernels)
    got = sample_batch(prepare(frame), centers)
    launches = read_counts(kernels)
    expect_counts("serve pair", launches, {"sat_build": 1, "sat_sample": 1})
    if not torch.equal(got, pipe.sample_batch_fused(frame, centers)):
        raise AssertionError("SAT serve pair differs from the fused batch")
    print(f"serve pair sat {shape}: {len(BATCH_GAZES)} gazes, launches "
          f"{launches}, equal to the fused batch", flush=True)


def phase_degrade(kernels) -> None:
    """A shape outside the fused sampler's and the fused unwarp's
    contracts: "auto" resolves to the SAT path and runs K5 and K7, the
    unwarp's "auto" to the exact unwarp (no kernel); an explicit "fused"
    raises."""
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
    expect_counts("degrade", launches, {"sat_build": 1, "sat_sample": 1})
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
    """K5, K6 and K7 as the SAT path and ``sat_select_rows`` give them work
    at this shape, with their library yardstick (K5: two ``torch.cumsum``
    calls in int64; none selects SAT rows without building the SAT, nor
    gathers four SAT taps and divides) and, for K7, the bytes its taps
    need (:func:`sat_sample_bytes`).  Ops count one add per element of
    each scan the data needs."""
    _, h, w = frame.shape
    *_, pyc, pymc, _ = sr.fused_taps(pipe.grid, frame, centers)
    pyc, pymc = pyc[0], pymc[0]
    rows_walked = int(torch.maximum(pyc[-1], pymc[-1])) + 1
    rcw = frame.permute(1, 0, 2).contiguous()
    sat = scan2d.sat_scan(frame, in_layout="chw")
    taps = sat_taps(pipe.grid, sat, centers)
    k7 = lambda *a: ss.sat_sample_batch(*a, "chw")  # noqa: E731
    return {
        "sat_build": (
            lambda f: scan2d.sat_scan(f, in_layout="chw"), scan2d.sat_scan_plain,
            (frame,), 2 * 3 * h * w,
            lambda f: torch.cumsum(torch.cumsum(f, 2, dtype=torch.int64), 1), None,
        ),
        "sat_select_rows": (
            fs.sat_select_rows, fs.sat_select_rows_plain, (rcw, pyc, pymc),
            3 * w * rows_walked + 2 * pyc.numel() * 3 * w, None, None,
        ),
        "sat_sample": (
            k7, lambda *a: ss.sat_sample_batch_plain(*a, "chw"), (sat, *taps),
            sat_sample_ops(taps), None, sat_sample_bytes(taps, k7(sat, *taps)),
        ),
    }


def phase_timing(shape: str = "4k") -> list[dict]:
    pipe = make_pipeline(shape, "cuda")
    frame = make_frame(pipe, SEED + 2)
    centers = torch.tensor([GAZES[0]], dtype=torch.float32, device="cuda")
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")  # 128 MiB
    cases = {
        name: (*case, None, None)
        for name, case in path_cases(pipe, frame, centers).items()
    }
    cases.update(sat_cases(pipe, frame, centers))
    spin = spin_cycles(SPIN_MS)
    print(f"timing {shape}: queued readings spin {spin} cycles (about "
          f"{SPIN_MS} ms) after each flush", flush=True)
    rows = []
    for name, (fn, plain, args, ops, library, nbytes) in cases.items():
        if nbytes is None:
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
    return rows


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


async def _serve_channel(server, clients, specs: list[str]):
    """Clients on the broadcast channels of ``specs``: run until every
    channel has served its ``max_frames`` ticks, then close every
    connection."""
    pairs = [memory_pair() for _ in clients]
    handlers = [asyncio.create_task(server.handle(s)) for s, _ in pairs]
    runs = [asyncio.create_task(c.run_on(e)) for c, (_, e) in zip(clients, pairs)]

    async def channel_done(spec):
        while spec not in server.channels:
            await asyncio.sleep(0.005)
        await server.channels[spec].task

    try:
        await asyncio.wait_for(asyncio.gather(*map(channel_done, specs)),
                               SERVE_TIMEOUT_S)
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


def serve_broadcast(cfg, device, batch_sampler: str, kernels=None, mesh=None):
    """``BROADCAST_CLIENTS`` clients, each at its own gaze, on one channel
    of ``BROADCAST_TICKS`` ticks, sharded over ``mesh`` where one is
    given.  Returns (server, clients, launches)."""
    w, h = cfg.source_width, cfg.source_height
    spec = f"synthetic://{w}x{h}@30/{BROADCAST_TICKS}"
    server = CapturingServer(cfg, max_frames=BROADCAST_TICKS, broadcast=True,
                             batch_sampler=batch_sampler, device=device, mesh=mesh)
    clients = [
        CapturingClient("memory", video=spec, config=cfg, device=device,
                        gaze_source=lambda i, g=g: g)
        for g in SERVE_GAZES[:BROADCAST_CLIENTS]
    ]
    if kernels:
        zero_counts(kernels)
    asyncio.run(_serve_channel(server, clients, [spec]))
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


def serve_expected(batch_sampler, clients, mesh=None) -> dict[str, int]:
    """The launches a serve run must show: ``batch_sampler`` None for a
    session (the fused sampler once per frame), else the broadcast
    channel's (one fused launch per served tick, or one K5 launch per tick
    read and one K7 launch per served tick; over a mesh, one per data
    shard, or K5 one per space block; none for the direct sampler);
    ``unwarp_xy`` once per frame the clients restored."""
    frames = sum(c.stats.frames for c in clients)
    n_data, n_space = (mesh.shape["data"], mesh.shape["space"]) if mesh else (1, 1)
    if batch_sampler is None:
        return {"segreduce_xy": frames, "unwarp_xy": frames}
    if batch_sampler == "fused":
        return {"segreduce_xy": n_data * served_ticks(clients), "unwarp_xy": frames}
    if batch_sampler == "direct":
        return {"unwarp_xy": frames}
    return {"sat_build": n_space * BROADCAST_TICKS,
            "sat_sample": n_data * served_ticks(clients), "unwarp_xy": frames}


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
    for batch_sampler in ("fused", "sat", "direct"):
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
    asyncio.run(_serve_channel(server, clients, [spec]))
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

    fn()
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
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
# one-SAT batches and 8 single foveates, stage 6 one SAT build and two
# gazes sampled from it (the direct sampler launches no kernel); K7 once
# per SAT sample; ``doctor`` builds and launches K5 once.
CLI_SOURCE = "synthetic://1920x1080@30/{}"
CLI_FRAMES = 4
PERF_STEPS = 2 * (8 + 6)  # two resolutions, chain(2) twice and chain(8 + 2)
STAGE_EXPECTED = {
    1: {"segreduce_xy": 1},
    2: {"sat_build": 1},
    3: {"segreduce_xy": 30, "unwarp_xy": 30},
    4: {"sat_build": 26, "sat_sample": 26, "unwarp_xy": 26},
    5: {"sat_build": 61, "sat_sample": 61, "segreduce_xy": 8},
    6: {"sat_build": 1, "sat_sample": 2},
}
PERF_DIRECT = ["perf", "--resolutions", "1080p", "--frames", "8", "--clients",
               "8", "--sampler", "direct", "--batch-sampler", "direct"]
# Phase 11's perf: two resolutions, chain(2) twice and chain(20 + 2).
PERF_LADDER = ["perf", "--resolutions", "8k", "16k"]
PERF_LADDER_STEPS = 2 * (2 + 2 + 20 + 2)
CLI_EXPECTED = {
    "single_frame logrect": {"segreduce_xy": 1},
    "single_frame logrect_point": {},
    "interpolate_sampled": {"segreduce_xy": 1},
    "foveate_no_encoding": {"segreduce_xy": CLI_FRAMES},
    "encode_bitrate": {"segreduce_xy": CLI_FRAMES},
    "decode": {},
    "gaze_eval": {},
    "perf": {"segreduce_xy": 2 * PERF_STEPS, "unwarp_xy": PERF_STEPS},
    "perf --sampler sat": {"sat_build": PERF_STEPS, "sat_sample": PERF_STEPS,
                           "unwarp_xy": PERF_STEPS, "segreduce_xy": PERF_STEPS},
    "perf --sampler direct": {"unwarp_xy": PERF_STEPS // 2},
    "stages": {name: sum(e.get(name, 0) for e in STAGE_EXPECTED.values())
               for name in ("segreduce_xy", "unwarp_xy", "sat_build", "sat_sample")},
    "doctor": {"sat_build": 1},
    "perf 8k 16k": {"segreduce_xy": PERF_LADDER_STEPS, "unwarp_xy": PERF_LADDER_STEPS},
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
    report["perf --sampler direct"] = cli_card(
        kernels, "perf --sampler direct", PERF_DIRECT).splitlines()
    stages = cli_card(kernels, "stages", ["stages"])
    report["stages"] = stages.splitlines()
    if "6/6 stages passed" not in stages:
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


# Phase 9: multi-device serving.  A (data, space) = (2, 2) mesh; the
# sharded functions at 4K over the 8 gazes of BATCH_GAZES, the transcode
# over MESH_FRAMES frames, the mesh server at 1080p.
MESH_DATA, MESH_SPACE = 2, 2
MESH_FRAMES = 4


def mesh_devices(device: str = "cuda") -> tuple[list[torch.device], str]:
    """Phase 9's four mesh entries and how they were chosen: four distinct
    cards where four are visible, else ``cuda:0`` four times (the CPU four
    times for ``device="cpu"``)."""
    n = MESH_DATA * MESH_SPACE
    if device == "cpu":
        return [torch.device("cpu")] * n, f"the CPU {n} times"
    count = torch.cuda.device_count()
    if count >= n:
        return ([torch.device("cuda", k) for k in range(n)],
                f"{n} distinct GPUs, cuda:0-{n - 1}")
    return [torch.device("cuda", 0)] * n, f"cuda:0 {n} times ({count} GPU visible)"


def mesh_cases(pipe, mesh, frame, frames, centers, centers_b) -> dict:
    """Phase 9's sharded calls as name -> (sharded call, the single-device
    call it must equal, the launches it must make).  ``frame`` (H, W, 3)
    and ``centers`` (8, 2) feed the serving functions, ``frames`` (B, H,
    W, 3) and ``centers_b`` (B, 2) the transcode."""
    grid = pipe.grid
    n_data, n_space = mesh.shape["data"], mesh.shape["space"]
    build, sample = sharded.jit_serve_parts(grid, mesh)
    prepare, fsample = sharded.jit_serve_parts_fused(grid, mesh)
    sat_pair, fused_pair = pipe.batch_pair("sat"), pipe.batch_pair("fused")

    def restored(reduced, cs):
        return torch.stack([pipe.unwarp(r, c) for r, c in zip(reduced, cs)])

    def single_step():
        reduced = pipe.sample_batch(build_sat(frame), centers)
        return reduced, restored(reduced, centers)

    def single_roundtrip():
        reduced = torch.stack([pipe.sample(build_sat(f), c)
                               for f, c in zip(frames, centers_b)])
        return reduced, restored(reduced, centers_b)

    def single_fused():
        return (fused_pair[1](fused_pair[0](frame), centers),)

    return {
        "sharded_build_sat": (lambda: (sharded.sharded_build_sat(frame, mesh),),
                              lambda: (build_sat(frame),), {"sat_build": n_space}),
        "multi_client_step": (
            lambda: sharded.multi_client_step(frame, centers, grid, mesh),
            single_step, {"sat_build": n_space, "sat_sample": n_data}),
        "frame_parallel_roundtrip": (
            lambda: sharded.frame_parallel_roundtrip(frames, centers_b, grid, mesh),
            single_roundtrip, {"sat_build": len(frames), "sat_sample": len(frames)}),
        "sharded_sample_batch_fused": (
            lambda: (sharded.sharded_sample_batch_fused(frame, centers, grid, mesh),),
            single_fused, {"segreduce_xy": n_data}),
        "jit_serve_parts": (lambda: (sample(build(frame), centers),),
                            lambda: (sat_pair[1](sat_pair[0](frame), centers),),
                            {"sat_build": n_space, "sat_sample": n_data}),
        "jit_serve_parts_fused": (lambda: (fsample(prepare(frame), centers),),
                                  single_fused, {"segreduce_xy": n_data}),
    }


def same_on_host(what: str, got, want) -> None:
    """Equal outputs (tolerance 0; uint32 through the int32 view), each a
    tensor or a ``Sharded``, compared on the host."""
    for k, (g, w_) in enumerate(zip(got, want, strict=True)):
        g, w_ = g.cpu(), w_.cpu()
        if g.dtype == torch.uint32:
            g, w_ = g.view(torch.int32), w_.view(torch.int32)
        if g.shape != w_.shape or g.dtype != w_.dtype or not torch.equal(g, w_):
            raise AssertionError(f"mesh {what}: output {k} differs")


def mesh_dryrun(kernels, device: str) -> None:
    """``dryrun_multichip(4)`` on ``device``, its launches counted: K5 per
    space block (``multi_client_step``, the SAT pair), per frame (the
    transcode) and per distinct device (the placement); K7 per data shard
    (``multi_client_step``, the SAT pair), per frame and per distinct
    device; ``segreduce_xy`` per data shard (the fused sampler and
    pair).  Its outputs must equal the CPU port's, and the sharded step,
    the SAT pair and every placement must agree where they compute the
    same thing."""
    n = MESH_DATA * MESH_SPACE
    if kernels:
        zero_counts(kernels)
    out = dryrun_multichip(n, device)
    if kernels:
        distinct = len(set(dryrun_mesh_devices(n, device)))
        expect_counts("mesh dryrun_multichip", read_counts(kernels), {
            "sat_build": 2 * MESH_SPACE + n + distinct,
            "sat_sample": 2 * MESH_DATA + n + distinct,
            "segreduce_xy": 2 * MESH_DATA})
    cpu = dryrun_multichip(n, "cpu")
    placed = [v for k, v in out.items() if k.startswith("placement.")]
    same_on_host("dryrun placement", placed,
                 [cpu[f"placement.{torch.device('cpu')}"]] * len(placed))
    keys = [k for k in cpu if not k.startswith("placement.")]
    same_on_host("dryrun", [out[k] for k in keys], [cpu[k] for k in keys])
    same_on_host("dryrun serve pair", [out["jit_serve_parts"]],
                 [out["multi_client_step.reduced"]])
    same_on_host("dryrun fused pair", [out["jit_serve_parts_fused"]],
                 [out["sharded_sample_batch_fused"]])
    print(f"mesh dryrun_multichip({n}) on {device}: {len(out)} outputs equal to "
          "the CPU port's", flush=True)


def sat_gather_bytes(mesh, h: int, w: int) -> dict[str, int]:
    """What ``sharded_sample_batch`` copies to gather a (3, H, W) uint32
    SAT: onto each distinct data-shard entry, the blocks that lie on
    another device (``peer_bytes``) and the whole SAT it concatenates
    there (``concat_bytes``)."""
    block = 3 * (h // mesh.shape["space"]) * w * 4
    targets = set(row[0] for row in mesh.devices)
    peer = sum(block for t in targets for d in mesh.devices[0] if d != t)
    return {"sat_bytes": 3 * h * w * 4, "gathers": len(targets),
            "peer_bytes": peer, "concat_bytes": len(targets) * 3 * h * w * 4}


def mesh_calls(kernels, cfg, device: str, mesh):
    """Each sharded call of :func:`mesh_cases` on ``mesh`` at ``cfg``'s
    shape, its launches read around it and its outputs held to the
    single-device path and to the same call on a mesh of CPU entries.
    Returns the (pipeline, frame, centers) it ran on."""
    rng = np.random.default_rng(SEED + 5)
    h, w = cfg.source_height, cfg.source_width
    host_frames = rng.integers(0, 256, (1 + MESH_FRAMES, h, w, 3), np.uint8)
    runs = {}
    for dev, m in ((device, mesh), ("cpu", make_mesh(
            MESH_SPACE, MESH_DATA, devices=mesh_devices("cpu")[0]))):
        pipe = FoveationPipeline(cfg, device=dev)
        frames = torch.from_numpy(host_frames).to(pipe.device)
        centers = torch.tensor(BATCH_GAZES, dtype=torch.float32, device=pipe.device)
        runs[dev] = (pipe, frames[0], centers, mesh_cases(
            pipe, m, frames[0], frames[1:], centers, centers[:MESH_FRAMES]))
    cpu_cases = runs["cpu"][3]
    for name, (call, single, expected) in runs[device][3].items():
        if kernels:
            zero_counts(kernels)
        got = call()
        launches = read_counts(kernels) if kernels else {}
        if kernels:
            expect_counts(f"mesh {name}", launches, expected)
        same_on_host(f"{name} vs the single-device path", got, single())
        same_on_host(f"{name} vs the CPU port", got, cpu_cases[name][0]())
        print(f"mesh {name} {w}x{h}: launches {launches}, equal to the "
              "single-device path and the CPU port", flush=True)
    return runs[device][:3]


def mesh_serve(kernels, cfg, device: str, mesh, batch_sampler: str) -> None:
    """The broadcast ``FoveaxServer(mesh=...)`` through the in-memory
    pair: frames equal to the CPU path (:func:`check_served`), launches
    one per data shard a served tick (fused), or K5 per space block a tick
    and K7 per data shard a served tick (SAT)."""
    _, clients, launches = serve_broadcast(cfg, device, batch_sampler, kernels,
                                           mesh=mesh)
    if kernels:
        expect_counts(f"mesh serve {batch_sampler}", launches,
                      serve_expected(batch_sampler, clients, mesh))
    print(f"mesh serve broadcast {batch_sampler} {cfg.source_width}x"
          f"{cfg.source_height}: {len(clients)} clients, {BROADCAST_TICKS} "
          f"ticks ({served_ticks(clients)} served), frames per client "
          f"{[c.stats.frames for c in clients]}, launches {launches}, equal to "
          "the CPU path", flush=True)


def serve_round_robin(cfg, device: str, kernels=None):
    """Two videos on a ``place_videos="round_robin"`` broadcast server
    (fused), two clients each: each channel's pipeline on the next CUDA
    device where several are visible (the server's own device otherwise).
    Every served and restored frame is held to the CPU path; returns
    (launches, expected launches, the devices the pipelines ran on)."""
    w, h = cfg.source_width, cfg.source_height
    # Synthetic frames depend on the size and the index only: both videos
    # show the same frames.
    specs = [f"synthetic://{w}x{h}@30/{BROADCAST_TICKS + k}" for k in range(2)]
    server = CapturingServer(cfg, max_frames=BROADCAST_TICKS, broadcast=True,
                             batch_sampler="fused", place_videos="round_robin",
                             device=device)
    clients = [
        CapturingClient("memory", video=specs[k // 2], config=cfg, device=device,
                        gaze_source=lambda i, g=g: g)
        for k, g in enumerate(SERVE_GAZES[:4])
    ]
    if kernels:
        zero_counts(kernels)
    asyncio.run(_serve_channel(server, clients, specs))
    launches = read_counts(kernels) if kernels else {}
    if server.channels or not all(c.stats.frames for c in clients):
        raise AssertionError(f"round_robin: frames per client "
                             f"{[c.stats.frames for c in clients]}")
    check_served(cfg, server, clients, synthetic_frames(specs[0], BROADCAST_TICKS),
                 "round_robin")
    expected = {"segreduce_xy": served_ticks(clients[:2]) + served_ticks(clients[2:]),
                "unwarp_xy": sum(c.stats.frames for c in clients)}
    return launches, expected, sorted({str(key[2]) for key in server._pipelines})


def phase_mesh(kernels, cfg=None, serve_cfg=None, device: str = "cuda") -> dict:
    """Multi-device serving on ``device`` (module docstring, phase 9):
    each sharded call's launches and outputs against the single-device
    path and the CPU port, the dry run, the mesh server, round-robin
    placement and the sharded tick's time; returns the timings."""
    t0 = time.perf_counter()
    cfg = cfg or FoveaxConfig().with_source(*SHAPES["4k"])
    serve_cfg = serve_cfg or FoveaxConfig()
    devices, how = mesh_devices(device)
    mesh = make_mesh(MESH_SPACE, MESH_DATA, devices=devices)
    print(f"mesh: {MESH_DATA}x{MESH_SPACE} (data x space) over {how}", flush=True)
    mesh_dryrun(kernels, device)
    pipe, frame, centers = mesh_calls(kernels, cfg, device, mesh)
    for batch_sampler in ("fused", "sat"):
        mesh_serve(kernels, serve_cfg, device, mesh, batch_sampler)
    server = FoveaxServer(serve_cfg, place_videos="round_robin", device=device)
    placed = [str(server._next_device()) for _ in range(4)]
    print(f"mesh round_robin _next_device() x4: {placed}", flush=True)
    launches, expected, placed = serve_round_robin(serve_cfg, device, kernels)
    if kernels:
        expect_counts("mesh round_robin serve", launches, expected)
    print(f"mesh round_robin serve: 2 videos x 2 clients, pipelines on {placed}, "
          f"launches {launches}, equal to the CPU path", flush=True)

    report = {"gather": sat_gather_bytes(mesh, cfg.source_height, cfg.source_width)}
    pairs = {"sat": sharded.jit_serve_parts(pipe.grid, mesh),
             "fused": sharded.jit_serve_parts_fused(pipe.grid, mesh)}
    for name, (prepare, sample) in pairs.items():
        single_prepare, single_sample = pipe.batch_pair(name)
        report[f"tick_{name}_ms"] = time_host(lambda: sample(prepare(frame), centers), 10)
        report[f"single_{name}_ms"] = time_host(
            lambda: single_sample(single_prepare(frame), centers), 10)
    card = card_line() if device == "cuda" else "cpu"
    print(f"mesh timing {cfg.source_width}x{cfg.source_height}, {len(BATCH_GAZES)} "
          f"gazes (host ms, synchronised, median of 10): {json.dumps(report)}  "
          f"[{card}]", flush=True)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return report


# Phase 10: the direct sampler.  F2's shape and gazes: 1920x1080 -> 64x36,
# where the JAX package's direct sampler misses (ROADMAP Queue 3, F2).
F2_CONFIG = dict(source_width=1920, source_height=1080, reduced_width=64,
                 reduced_height=36)
F2_GAZES = [(0.5, 0.5), (0.0, 0.0), (1.0, 1.0), (0.98, 0.03)]
FRESH_GAZE = (0.3141, 0.2718)
# The queued readings' busy wait in phase 10 (longer than the direct
# sampler's host dispatch).
DIRECT_SPIN_MS = 3.0


def direct_batch_pair(kernels, device: str) -> dict[str, int]:
    """``batch_pair("direct")`` at 4K over :data:`BATCH_GAZES`: no kernel
    launched, the batch equal to the fused pair's."""
    pipe = make_pipeline("4k", device, "direct")
    frame = make_frame(pipe, SEED + 4).permute(1, 2, 0).contiguous()
    centers = torch.tensor(BATCH_GAZES, dtype=torch.float32, device=device)
    prepare, sample_batch = pipe.batch_pair("direct")
    if kernels:
        zero_counts(kernels)
    got = sample_batch(prepare(frame), centers)
    launches = read_counts(kernels) if kernels else {}
    if kernels:
        expect_counts("direct batch pair", launches, {})
    if not torch.equal(got, pipe.sample_batch_fused(frame, centers)):
        raise AssertionError("direct batch pair differs from the fused batch")
    return launches


def direct_f2(device: str) -> None:
    """At F2's shape, on a random and an all-255 frame, the direct
    pipeline equals the SAT pipeline on the same device."""
    cfg = FoveaxConfig(**F2_CONFIG)
    direct = FoveationPipeline(cfg, sampler="direct", device=device)
    sat = FoveationPipeline(cfg, sampler="sat", device=device)
    for fill in (None, 255):
        frame = sat_frame(1920, 1080, fill, device)
        for g in F2_GAZES:
            c = direct.center(*g)
            if not torch.equal(direct.foveate_chw(frame, c), sat.foveate_chw(frame, c)):
                raise AssertionError(f"direct at 1920x1080 -> 64x36, gaze {g}, "
                                     f"fill {fill}: differs from the SAT path")


def direct_no_sync() -> None:
    """A direct call, single and batched, at a fresh gaze under
    ``torch.cuda.set_sync_debug_mode("error")``: the gaze never reaches the
    host."""
    pipe = make_pipeline("4k", "cuda", "direct")
    frame = make_frame(pipe, SEED + 5)
    c = torch.tensor(FRESH_GAZE, dtype=torch.float32, device="cuda")
    cs = torch.tensor(BATCH_GAZES, dtype=torch.float32, device="cuda")
    hwc = frame.permute(1, 2, 0)
    pipe.foveate_chw(frame, pipe.center(0.5, 0.5))  # indices built once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.foveate_chw(frame, c)
        pipe.sample_batch_direct(hwc, cs * 0.5 + 0.25)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def direct_timing(shape: str = "4k") -> list[dict]:
    """The three samplers of one function at ``shape``, each from the
    frame to the reduced frame (``ms`` and ``ms_queued`` as phase 4, median
    of 50, L2 flushed, but the card kept busy for ``DIRECT_SPIN_MS``: the
    direct sampler's host dispatch outlasts phase 4's 0.2 ms): the direct
    sampler (plain PyTorch), the fused sampler (its taps, then
    ``segreduce_xy``) and the SAT pair (K5, then the taps and K7).
    The bound is the least bytes: the uint8 frame read once, the uint8
    reduced frame written once."""
    pipe = make_pipeline(shape, "cuda", "direct")
    frame = make_frame(pipe, SEED + 2)
    c = torch.tensor(GAZES[0], dtype=torch.float32, device="cuda")
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")  # 128 MiB
    spin = spin_cycles(DIRECT_SPIN_MS)
    grid = pipe.grid
    samplers = {
        "sample_rect_direct": lambda f, c: core_direct.sample_rect_direct(
            f, grid, c, out_layout="chw"),
        "sample_rect_fused": lambda f, c: sr.sample_rect_fused(
            f, grid, c, out_layout="chw"),
        "sat pair": lambda f, c: core_sample.sample_rect_from_sat(
            build_sat(f, in_layout="chw"), grid, c, out_layout="chw"),
    }
    hr, wr, _ = pipe.reduced_shape
    nbytes = frame.numel() + 3 * hr * wr
    rows = []
    for name, fn in samplers.items():
        row = {
            "name": name,
            "ms": time_cuda(fn, (frame, c), 50, flush),
            "ms_queued": time_cuda(fn, (frame, c), 50, flush, spin),
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "bytes": nbytes,
        }
        print(f"direct timing {shape}: {json.dumps(row)}", flush=True)
        rows.append(row)
    direct_profile(samplers["sample_rect_direct"], frame, c, shape)
    return rows


def direct_profile(fn, frame, c, shape: str, reps: int = 10,
                   what: str = "direct") -> None:
    """``torch.profiler`` over ``reps`` calls of ``fn(frame, c)`` (the
    direct sampler, unless ``what`` names another): its kernels per call,
    their device ms in all, and the six that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(frame, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(frame, c)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    top = [(e.key[:70], e.count // reps, e.self_device_time_total / reps / 1e3)
           for e in kernels[:6]]
    print(f"{what} profile {shape}: {sum(e.count for e in kernels) // reps} "
          f"kernels, {total:.4f} device ms per call; top (name, launches, ms) "
          f"{json.dumps(top)}", flush=True)


def phase_direct(kernels, device: str = "cuda") -> dict:
    """The SAT-free direct sampler (module docstring, phase 10); with
    ``kernels`` None no launch is counted, and off the card nothing is
    timed."""
    t0 = time.perf_counter()
    report = {}
    for shape in SHAPES:
        report[f"path {shape}"] = phase_main_path(kernels, "direct", shape, device)
    report["batch pair"] = direct_batch_pair(kernels, device)
    print(f"direct batch pair 4k: {len(BATCH_GAZES)} gazes, launches "
          f"{report['batch pair']}, equal to the fused batch", flush=True)
    direct_f2(device)
    print(f"direct 1920x1080 -> 64x36: gazes {F2_GAZES}, random and all-255 "
          "frames, equal to the SAT path", flush=True)
    if device == "cuda":
        direct_no_sync()
        print(f"direct at gaze {FRESH_GAZE} and a batch of "
              f"{len(BATCH_GAZES)} under sync debug mode 'error': no sync",
              flush=True)
        card = card_line()
        report["timing"] = direct_timing()
        report["fps"] = {shape: phase_path_fps(shape, "direct") for shape in SHAPES}
        print(f"direct card: {card}", flush=True)
    print(f"direct phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return report


# Phase 11: the resolution ladder.  The fused path over LADDER_FRAMES
# chained gazes and the SAT path for one gaze at each size of LADDER; then
# both paths' chained fps, the stage timings and the CLI's perf at 8K and
# 16K.
LADDER_FRAMES = 4
STAGE_BENCH = ["--resolutions", "1080p", "4k", "8k", "16k", "--stages", "sat",
               "sample", "fused", "direct", "unwarp", "--iters", "10"]


def ladder_pipeline(w: int, h: int, device: str, sampler: str = "auto"):
    pipe = FoveationPipeline(FoveaxConfig().with_source(w, h), sampler=sampler,
                             device=device)
    if pipe.sampler != ("fused" if sampler == "auto" else sampler):
        raise AssertionError(f"{w}x{h}: {sampler} resolved to {pipe.sampler}")
    return pipe


def unwarp_plain_check(errs, reduced, out, c, where: str) -> int:
    """One ``unwarp_xy`` output against its plain version on the card and
    the exact unwarp, a channel at a time (the exact unwarp's float32
    corners of a whole 36000x18000 frame would hold about 31 GB); returns
    the largest |out - exact|."""
    _, h, w = out.shape
    xv, yv = uw.fused_vectors(reduced.shape[1], reduced.shape[2], w, h, c)
    worst = 0
    for ch in range(3):
        red, got = reduced[ch:ch + 1], out[ch:ch + 1]
        keep_max(errs, "unwarp_xy", check_equal(
            "unwarp_xy", got, uw.unwarp_xy_plain(red, xv, yv),
            f"{where}, channel {ch}"))
        exact = unwarp_rect(red, w, h, c, in_layout="chw", out_layout="chw")
        worst = max(worst, max_abs_err(got, exact))
        del exact
    if worst > 1:
        raise AssertionError(f"{where}: the restored frame is {worst} LSB off "
                             "the exact unwarp")
    return worst


def ladder_plain(errs, pipe, kept, restored, centers) -> int:
    """Each chained frame's ``segreduce_xy`` and ``unwarp_xy`` output
    against its plain version on the card, and the restored frame against
    the exact unwarp; returns the largest |restored - exact|."""
    h, w, _ = pipe.source_shape
    worst = 0
    for i, ((x, reduced), out, c) in enumerate(zip(kept, restored, centers)):
        pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(pipe.grid, x, c[None])
        plain = sr.segment_reduce_xy_batch_plain(x, pxmc, pxc, vx, pymc, pyc, vy)
        where = f"at {w}x{h}, frame {i}"
        keep_max(errs, "segreduce_xy", check_equal(
            "segreduce_xy", reduced, plain[0], where))
        del plain
        worst = max(worst, unwarp_plain_check(errs, reduced, out, c, where))
    return worst


def ladder_paths(kernels, errs, w: int, h: int, device: str = "cuda") -> dict:
    """The fused path over :data:`LADDER_FRAMES` chained gazes, then the
    SAT path at the first gaze (module docstring, phase 11); with
    ``kernels`` None no launch is counted."""
    shape = f"{w}x{h}"
    pipe = ladder_pipeline(w, h, device)
    frame = make_frame(pipe, SEED + 6)
    gazes = gaze_trace(LADDER_FRAMES)
    centers = [torch.from_numpy(g).to(device) for g in gazes]
    if kernels:
        zero_counts(kernels)
    last, fovea_ok, kept = run_main_path(pipe, frame, gazes, centers, keep=True)
    fused = read_counts(kernels) if kernels else {}
    if kernels:
        expect_counts(f"ladder fused {shape}", fused,
                      {"segreduce_xy": LADDER_FRAMES, "unwarp_xy": LADDER_FRAMES})
    if not bool(fovea_ok.all()):
        raise AssertionError(f"ladder {shape}: fovea not exact at frames "
                             f"{(~fovea_ok).nonzero().flatten().tolist()}")
    restored = [x for x, _ in kept[1:]] + [last]
    worst = ladder_plain(errs, pipe, kept, restored, centers)
    x0, red0 = kept[0]
    del kept, restored, last

    sat_pipe = ladder_pipeline(w, h, device, "sat")
    if kernels:
        zero_counts(kernels)
    sat = build_sat(x0, in_layout="chw")
    red = sat_pipe.sample_chw(sat, centers[0])
    sat_launches = read_counts(kernels) if kernels else {}
    if kernels:
        expect_counts(f"ladder sat {shape}", sat_launches,
                      {"sat_build": 1, "sat_sample": 1})
    keep_max(errs, "sat_build", check_equal(
        "sat_build", sat, scan2d.sat_scan_plain(x0), f"at {shape}"))
    taps = sat_taps(sat_pipe.grid, sat, centers[0][None])
    keep_max(errs, "sat_sample", check_equal(
        "sat_sample", red, ss.sat_sample_batch_plain(sat, *taps, "chw")[0],
        f"at {shape}"))
    if not torch.equal(red, red0):
        raise AssertionError(f"ladder sat {shape}: differs from the fused path")
    hr, wr, _ = pipe.reduced_shape
    print(f"ladder {w}x{h} -> {wr}x{hr}: fused path {LADDER_FRAMES} chained "
          f"frames, launches {fused}, fovea exact, segreduce_xy and unwarp_xy "
          f"equal to their plain versions, restored within {worst} LSB of the "
          f"exact unwarp; SAT path launches {sat_launches}, K5 and K7 equal "
          "to their plain versions, reduced frame equal to the fused path's",
          flush=True)
    return {"fused": fused, "sat": sat_launches}


def captured(fn, argv) -> tuple[int, list[str]]:
    """``fn(argv)`` with its printed lines captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue().splitlines()


def phase_ladder(kernels, errs) -> dict:
    """The 8K and 16K paths, the stage timings and ``perf`` at 8K and 16K
    (module docstring, phase 11)."""
    t0 = time.perf_counter()
    report = {shape: ladder_paths(kernels, errs, *LADDER[shape]) for shape in LADDER}
    torch.cuda.empty_cache()
    card = card_line()
    report["fps"] = {f"{sampler} {shape}": phase_path_fps(shape, sampler)
                     for shape in LADDER for sampler in ("fused", "sat")}
    print(f"ladder fps card: {card}", flush=True)
    torch.cuda.empty_cache()
    rc, lines = captured(stage_bench.main, STAGE_BENCH)
    if rc != 0 or len(lines) != 4 * 5:
        raise AssertionError(f"stage_bench: exit code {rc}, lines {lines}")
    for line in lines:
        print(f"stage_bench {line}  [{card}]", flush=True)
    torch.cuda.empty_cache()
    perf = cli_card(kernels, "perf 8k 16k", PERF_LADDER).splitlines()
    for line in perf:
        print(f"cli perf 8k 16k: {line}  [{card}]", flush=True)
    print(f"ladder phase: {time.perf_counter() - t0:.1f} s", flush=True)
    report["stage_bench"], report["perf"] = lines, perf
    return report


# Phase 12: the shape fuzz.
FUZZ = ["0", "8"]


def phase_fuzz(device: str = "cuda", fuzz=FUZZ) -> list[str]:
    t0 = time.perf_counter()
    rc, lines = captured(fuzz_fused.main, [*fuzz, "--device", device])
    for line in lines:
        print(f"fuzz {line}", flush=True)
    if rc != 0 or lines[-1] != "FAILS: 0":
        raise AssertionError(f"fuzz_fused {' '.join(fuzz)}: exit code {rc}")
    print(f"fuzz phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return lines


# Phase 13: serving across processes, then the soak.
DEMO_FRAMES = 60
DEMO = ["--resolution", "1920x1080", "--frames", str(DEMO_FRAMES)]


def phase_processes(server_device: str = "cuda", client_devices=("cuda", "cpu"),
                    demo=DEMO, soak_device: str = "cuda") -> dict:
    """Two-process demos, one per client device, then the soak on
    ``soak_device`` for each wire codec (module docstring, phase 13)."""
    t0 = time.perf_counter()
    card = card_line() if "cuda" in (server_device, *client_devices) else "cpu"
    report = {}
    for client in client_devices:
        argv = [*demo, "--server-device", server_device, "--client-device", client]
        rc, lines = captured(two_process_demo.main, argv)
        for line in lines:
            print(f"demo client {client}: {line}  [{card}]", flush=True)
        frames = demo[demo.index("--frames") + 1]
        if rc != 0 or not any(l.startswith(f"[demo] frames: {frames} in")
                              for l in lines):
            raise AssertionError(f"two_process_demo {' '.join(argv)}: exit code {rc}")
        if not any("gaze fan-in latency" in l for l in lines):
            raise AssertionError(f"two_process_demo {' '.join(argv)}: no fan-in line")
        report[f"demo {client}"] = lines
    for wire in ["jpeg"] + (["h264"] if "h264" in available_wire_codecs() else []):
        result = soak.churn(soak_device, wire)
        found = soak.residue(result)
        print(f"soak {soak_device} {wire}: {result}", flush=True)
        if found:
            raise AssertionError(f"soak {wire}: {found}")
        report[f"soak {wire}"] = result
    print(f"processes phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return report


# Phase 14: the sharded fuzz, then hostile streams into the client.
SHARDED_FUZZ = ["0", "6"]


async def _hostile_server(conn, messages: list[bytes]) -> None:
    """A server end that waits for the client's video request, sends
    ``messages`` and then reads until the connection closes."""
    async for _ in conn:
        for message in messages:
            await conn.send(message)
        break
    async for _ in conn:
        pass


async def _feed_client(client, messages: list[bytes]) -> ValueError | None:
    """Run ``client`` against :func:`_hostile_server`; returns what it
    raised (None if it returned)."""
    server_end, client_end = memory_pair()
    server = asyncio.create_task(_hostile_server(server_end, messages))
    try:
        await asyncio.wait_for(client.run_on(client_end), SERVE_TIMEOUT_S)
        return None
    except ValueError as e:
        return e
    finally:
        await client_end.close()
        await asyncio.wait_for(server, SERVE_TIMEOUT_S)


def hostile_streams(cfg) -> dict[str, tuple[list[bytes], str]]:
    """name -> (the messages a hostile server sends, the start of the
    ValueError the client must raise): an init segment whose dimensions
    are not the configuration's reduced frame, and a matching init segment
    whose JPEG sample is 16 columns wider."""
    wr, hr = cfg.reduced_width, cfg.reduced_height
    rng = np.random.default_rng(SEED + 14)
    wide = JpegWireEncoder(wr + 16, hr).encode(
        rng.integers(0, 256, (hr, wr + 16, 3), np.uint8))[0]
    other = FragmentWriter(wr + 16, hr, 30.0, b"jpeg", backend="python")
    same = FragmentWriter(wr, hr, 30.0, b"jpeg", backend="python")
    return {
        "init-dims": ([other.header(), other.frame(wide)],
                      f"stream is {wr + 16}x{hr} but the client pipeline expects"),
        "sample-dims": ([same.header(), same.frame(wide)],
                        f"decoded sample is {wr + 16}x{hr}, expected {wr}x{hr}"),
    }


def phase_hostile(kernels, cfg=None, device: str = "cuda") -> list[str]:
    """Hostile streams into the port's client on ``device``: each must
    raise ValueError with no launch; then one ``unwarp_xy`` launch equal
    to its plain version (module docstring, phase 14)."""
    cfg = cfg or FoveaxConfig()
    report = []
    for name, (messages, want) in hostile_streams(cfg).items():
        client = FoveaxClient("memory", video="hostile", config=cfg, max_frames=1,
                              device=device)
        zero_counts(kernels)
        err = asyncio.run(_feed_client(client, messages))
        launches = read_counts(kernels)
        if err is None or not str(err).startswith(want):
            raise AssertionError(f"hostile {name}: raised {err!r}, expected "
                                 f"ValueError({want!r}...)")
        expect_counts(f"hostile {name}", launches, {})
        tb = err.__traceback__
        while tb.tb_next is not None:
            tb = tb.tb_next
        report.append(f"hostile {name}: ValueError at "
                      f"{os.path.relpath(tb.tb_frame.f_code.co_filename)}:"
                      f"{tb.tb_lineno} ({err}); launches {launches}")
    rng = np.random.default_rng(SEED + 15)
    w, h = cfg.source_width, cfg.source_height
    reduced = torch.from_numpy(rng.integers(
        0, 256, (3, cfg.reduced_height, cfg.reduced_width), np.uint8)).to(device)
    center = torch.tensor(MATH_GAZE, dtype=torch.float32, device=device)
    vectors = uw.fused_vectors(cfg.reduced_height, cfg.reduced_width, w, h, center)
    zero_counts(kernels)
    out = uw.unwarp_xy(reduced, *vectors)
    launches = read_counts(kernels)
    if device == "cuda":
        expect_counts("hostile then unwarp_xy", launches, {"unwarp_xy": 1})
    err = check_equal("unwarp_xy", out, uw.unwarp_xy_plain(reduced, *vectors),
                      "after the hostile streams")
    report.append(f"hostile then unwarp_xy {w}x{h}: launches {launches}, "
                  f"max_abs_err {err} against unwarp_xy_plain")
    return report


def phase_sharded_fuzz(kernels=None, device: str = "cuda", fuzz=SHARDED_FUZZ,
                       wrap: tuple[int, int] | None = None, cfg=None) -> dict:
    """``fuzz_sharded`` on ``device`` with the wrap case (``wrap`` (W, H),
    default the fuzz's 4808x4000), then the hostile streams (module
    docstring, phase 14); returns the printed lines and the launch
    totals."""
    t0 = time.perf_counter()
    kernels = kernels or kernel_table()
    card = card_line() if device == "cuda" else "cpu"
    argv = [*fuzz, "--device", device]
    if wrap is not None:
        argv += ["--wrap", f"{wrap[0]}x{wrap[1]}"]
    rc, lines = captured(fuzz_sharded.main, argv)
    for line in lines:
        print(f"sharded fuzz {line}  [{card}]", flush=True)
    if rc != 0 or lines[-1] != "FAILS: 0" or not any(l.startswith("wrap ") for l in lines):
        raise AssertionError(f"fuzz_sharded {' '.join(argv)}: exit code {rc}")
    totals = {"K5": 0, "segreduce_xy": 0, "K7": 0}
    for line in lines:
        if " launches K5=" in line:
            counts = line.split(" launches ")[1].split()[:3]
            for name, value in (c.split("=") for c in counts):
                totals[name] += int(value)
    print(f"sharded fuzz launches in all: {totals}", flush=True)
    hostile = phase_hostile(kernels, cfg, device)
    for line in hostile:
        print(line, flush=True)
    print(f"sharded fuzz phase: {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    return {"fuzz": lines, "launches": totals, "hostile": hostile}


# Phase 15: frames wider than one K5 scanning block spans (32,768 columns).
# WIDE is past segment_reduce_xy's shared memory too (233,064 bytes a
# block), so "auto" takes the SAT path there; WIDE_FUSED (223,744 bytes)
# stays fused.  The reduced sizes are the configuration's rule.
WIDE = (36000, 18000)        # -> 20000x10000
WIDE_FUSED = (34560, 17280)  # -> 19200x9600
WIDE_FRAMES = 4
WIDE_BLOCK_ROWS = 1024  # rows a block of the plain SAT check scans
WIDE_BATCHES = (3, 8)  # gazes of the SAT batch pairs at WIDE
TILED = (70000, 256)  # three K5 tiles, the last 4,464 columns


def wide_kernels(errs) -> None:
    """K5 and K6 over column tiles against their plain versions, and
    all-255 SATs against their closed form (module docstring, phase
    15)."""

    def sat_check(what: str, chw) -> None:
        want = scan2d.sat_scan_plain(chw)
        for layout in ("chw", "hwc"):
            frame = chw if layout == "chw" else chw.permute(1, 2, 0).contiguous()
            got = scan2d.sat_scan(frame, in_layout=layout)
            keep_max(errs, "sat_build", check_equal("sat_build", got, want,
                                                    f"{what} {layout}"))

    def closed_form(w: int, h: int) -> None:
        sat = scan2d.sat_scan(sat_frame(w, h, 255, "cuda"), in_layout="chw")
        ys = torch.arange(1, h + 1, dtype=torch.int64, device="cuda")
        xs = torch.arange(1, w + 1, dtype=torch.int64, device="cuda")
        closed = (255 * ys[:, None] * xs[None, :]) & scan2d.MASK32
        if not all(torch.equal(scan2d.as_int64(sat[c]), closed) for c in range(3)):
            raise AssertionError(f"sat_build all-255 {w}x{h}: differs from "
                                 "255(y+1)(x+1) mod 2^32")

    def select_check(what: str, rcw, pyc, pymc) -> None:
        got = fs.sat_select_rows(rcw, pyc, pymc)
        for part, g, w_ in zip(("hi", "lo"), got, fs.sat_select_rows_plain(rcw, pyc, pymc)):
            keep_max(errs, "sat_select_rows",
                     check_equal("sat_select_rows", g, w_, f"{what} {part}"))

    w, h = TILED
    tiles = scan2d.sat_plan(h, w).tiles
    sat_check(f"{w}x{h} ({tiles} tiles)", sat_frame(w, h, None, "cuda"))
    sat_check(f"{w}x{h} all-255 ({tiles} tiles)", sat_frame(w, h, 255, "cuda"))
    sat_check("36000x1024", sat_frame(36000, 1024, None, "cuda"))
    for cw, ch in (TILED, (34560, 512)):
        closed_form(cw, ch)
    print(f"wide sat_build: random and all-255 {w}x{h} ({tiles} tiles), "
          "36000x1024 (2 tiles), both layouts, bit-equal to the plain "
          f"version; all-255 {w}x{h} and 34560x512 (255*W*H = "
          f"{255 * w * h} and {255 * 34560 * 512}) equal to 255(y+1)(x+1) "
          "mod 2^32", flush=True)

    grid = make_grid(reduced_dim(w), reduced_dim(h), w, h, "cuda")
    rcw = sat_frame(w, h, None, "cuda").permute(1, 0, 2).contiguous()
    for g in GAZES:
        c = torch.tensor([g], dtype=torch.float32, device="cuda")
        # the sampler's row taps (fused_taps refuses this width)
        pyc, pymc = core_sample.gaze_taps(grid, h, w, c)[3:5]
        select_check(f"{w}x{h} gaze {g}", rcw, pyc[0], pymc[0])
    h = 1024
    rcw = sat_frame(36000, h, None, "cuda").permute(1, 0, 2).contiguous()
    pyc, pymc = (torch.tensor(v, dtype=torch.int32, device="cuda") for v in (
        [1, 2, h // 2, h // 2, h - 1], [0, 1, 3, h // 2 - 1, h - 40]))
    select_check("36000x1024, pyc to H-1", rcw, pyc, pymc)
    print(f"wide sat_select_rows: {w}x{TILED[1]} with {len(GAZES)} gazes' row "
          "taps, 36000x1024 with pyc reaching H-1, bit-equal to the plain "
          "version", flush=True)


def wide_frame(w: int, h: int, device: str, seed: int) -> torch.Tensor:
    """A random (3, H, W) uint8 frame made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (3, h, w), dtype=torch.uint8, device=device,
                         generator=gen)


def wide_sat_check(frame, sat, block_rows: int) -> int:
    """K5's SAT of ``frame`` against the plain scan in row blocks, each
    block's int64 sums carried on from the block above (one int64 scan of
    the whole frame would need about 16 GB more)."""
    _, h, w = frame.shape
    carry = torch.zeros((3, 1, w), dtype=torch.int64, device=frame.device)
    err = 0
    for r0 in range(0, h, block_rows):
        block = frame[:, r0:r0 + block_rows].to(torch.int64).cumsum(2).cumsum(1)
        block += carry
        err = max(err, check_equal("sat_build", sat[:, r0:r0 + block_rows],
                                   scan2d.low32(block), f"at {w}x{h}, rows from {r0}"))
        carry = block[:, -1:]
        del block
    return err


def wide_chain_fps(pipe, frame, centers) -> tuple[float, int]:
    """Chained frames per second over ``centers`` (host clock,
    synchronised; median of three runs) and the peak bytes tensors held
    meanwhile, the frame included."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = frame
        for c in centers:
            y = pipe.unwarp_auto_chw(pipe.foveate_chw(y, c), c)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del y
    return len(centers) / statistics.median(times), torch.cuda.max_memory_allocated()


def wide_timing(name: str, fn, args, nbytes: int, ops: int, **extra) -> dict:
    """``fn(*args)`` on the card: ``ms`` and ``ms_queued`` as phase 4
    (median of 10, L2 flushed) beside the bound of ``nbytes`` and
    ``ops``."""
    flush = torch.empty(2**27, dtype=torch.uint8, device=args[0].device)
    spin = spin_cycles(SPIN_MS)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return {
        "name": name, **extra,
        "ms": time_cuda(fn, args, 10, flush),
        "ms_queued": time_cuda(fn, args, 10, flush, spin),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": ops,
    }


def wide_k5_timing(frame) -> dict:
    """K5 on ``frame`` (chw); its bound: the frame read once and the
    uint32 SAT written once."""
    _, h, w = frame.shape
    plan = scan2d.sat_plan(h, w)
    return wide_timing(
        "sat_build", lambda f: scan2d.sat_scan(f, in_layout="chw"), (frame,),
        5 * frame.numel(), 2 * frame.numel(), shape=f"{w}x{h}",
        tiles=plan.tiles, cuda_launches=plan.launches)


def wide_k7_timing(pipe, frame, center) -> dict:
    """K7 on the SAT of ``frame`` (chw) at one gaze, "chw" as the chained
    path asks; its bound as phase 4's (:func:`sat_sample_bytes`)."""
    _, h, w = frame.shape
    sat = build_sat(frame, in_layout="chw")
    taps = sat_taps(pipe.grid, sat, center[None])
    k7 = lambda *a: ss.sat_sample_batch(*a, "chw")  # noqa: E731
    return wide_timing("sat_sample", k7, (sat, *taps),
                       sat_sample_bytes(taps, k7(sat, *taps)),
                       sat_sample_ops(taps), shape=f"{w}x{h}")


def wide_batch_gazes(first: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` gazes for a batch pair at WIDE: the chained path's first,
    then :data:`BATCH_GAZES` from its second on ((0, 0) and (1, 1), both
    at the seam, first)."""
    rest = torch.tensor(BATCH_GAZES[1:n], dtype=torch.float32, device=first.device)
    return torch.cat([first[None], rest])


def wide_batch_pair(kernels, errs, pipe, frame, cs, reduced0, block_rows: int,
                    keep: bool):
    """The serve tick's SAT pair ``batch_pair("auto")`` on ``frame`` at the
    gazes ``cs``: K5 and K7 once each and nothing else, its SAT equal to
    the row-blocked plain scan, row 0 equal to ``reduced0`` (the chained
    path's first reduced frame) and every row to the single-gaze
    sampler's on the same SAT; then, with the batch freed, row 0 equal to
    ``sat_sample_batch_plain`` (kept in ``errs``).  Returns the launches,
    the peak tensor bytes of the pair (None off the card), the SAT check's
    error and, with ``keep``, the batch itself (else None)."""
    prepare, sample_batch = pipe.batch_pair("auto")
    if prepare != pipe.build_sat:
        raise AssertionError("batch_pair('auto'): not the SAT pair")
    _, h, w = frame.shape
    hwc = frame.permute(1, 2, 0).contiguous()
    if kernels:
        zero_counts(kernels)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sat = prepare(hwc)
    batch = sample_batch(sat, cs)
    launches = read_counts(kernels) if kernels else {}
    peak = torch.cuda.max_memory_allocated() if kernels else None
    if kernels:
        expect_counts(f"wide batch pair, {len(cs)} gazes", launches,
                      {"sat_build": 1, "sat_sample": 1})
    del hwc
    err = wide_sat_check(frame, sat, block_rows)
    if not torch.equal(batch[0], reduced0.permute(1, 2, 0)):
        raise AssertionError(f"wide batch pair, {len(cs)} gazes: row 0 differs "
                             "from the chained path's reduced frame")
    for i, c in enumerate(cs):
        if not torch.equal(batch[i], pipe.sample(sat, c)):
            raise AssertionError(f"wide batch pair, {len(cs)} gazes: row {i} "
                                 "differs from the single-gaze sampler's")
    row0 = batch[0].clone()
    kept = batch if keep else None
    del batch
    plain = ss.sat_sample_batch_plain(sat, *sat_taps(pipe.grid, sat, cs[:1]), "hwc")
    keep_max(errs, "sat_sample", check_equal(
        "sat_sample", row0, plain[0], f"at {w}x{h}, batch of {len(cs)}, row 0"))
    return launches, peak, err, kept


def wide_direct_batch(cfg, frame, cs, sat_batch, device: str) -> str:
    """``batch_pair("direct")`` on ``frame`` at the gazes ``cs``: every
    row equal to the SAT batch's (``sat_batch``), or, on the card, the
    ``torch.cuda.OutOfMemoryError`` it raised, which is a finding, not a
    failure.  Returns what it gave."""
    prepare, sample_batch = FoveationPipeline(
        cfg, sampler="direct", device=device).batch_pair("direct")
    if device != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    try:
        got = sample_batch(prepare(frame.permute(1, 2, 0).contiguous()), cs)
    except torch.cuda.OutOfMemoryError as e:
        return (f"torch.cuda.OutOfMemoryError after a peak of "
                f"{torch.cuda.max_memory_allocated()} tensor bytes: "
                f"{str(e).splitlines()[0]}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    if not torch.equal(got, sat_batch):
        raise AssertionError(f"wide direct batch pair, {len(cs)} gazes: differs "
                             "from the SAT batch")
    return f"ran, peak {peak} tensor bytes, rows equal to the SAT batch's"


def wide_paths(kernels, errs, heights=(WIDE[1], WIDE_FUSED[1]),
               device: str = "cuda", block_rows: int = WIDE_BLOCK_ROWS,
               batches=WIDE_BATCHES) -> dict:
    """The SAT path at WIDE's width over :data:`WIDE_FRAMES` chained gazes
    with every unwarp held to its plain version and the exact unwarp, the
    SAT batch pairs (``batches`` gazes each), the direct batch pair at the
    first batch's gazes, the direct sampler; then WIDE_FUSED's SAT and fused samplers at one gaze
    against each other and the plain fused sampler (module docstring,
    phase 15).  ``heights`` cut the two frames' rows for a rehearsal on the
    CPU, where ``kernels`` is None and nothing is timed."""
    report = {}
    card = device != "cpu"
    w, h = WIDE[0], heights[0]
    cfg = FoveaxConfig().with_source(w, h)
    pipe = FoveationPipeline(cfg, device=device)
    if pipe.sampler != "sat":
        raise AssertionError(f"{w}x{h}: auto resolved to {pipe.sampler}, not sat")
    frame = wide_frame(w, h, device, SEED + 7)
    gazes = gaze_trace(WIDE_FRAMES)
    centers = [torch.from_numpy(g).to(device) for g in gazes]
    if kernels:
        zero_counts(kernels)
    last, fovea_ok, kept = run_main_path(pipe, frame, gazes, centers, keep=True)
    launches = read_counts(kernels) if kernels else {}
    if kernels:
        expect_counts(f"wide sat {w}x{h}", launches,
                      {name: WIDE_FRAMES for name in PATH_KERNELS["sat"]})
    if last.shape != frame.shape or not bool(fovea_ok.all()):
        raise AssertionError(f"wide sat {w}x{h}: restored {tuple(last.shape)}, "
                             f"fovea exact {fovea_ok.tolist()}")
    reduced = [r for _, r in kept]
    restored = [x for x, _ in kept[1:]] + [last]
    del kept, last
    worst = 0
    for i, (red, out, c) in enumerate(zip(reduced, restored, centers)):
        worst = max(worst, unwarp_plain_check(errs, red, out, c,
                                              f"at {w}x{h}, frame {i}"))
    del restored, reduced[1:]
    batch_launches, batch_peaks = {}, {}
    for n in batches:
        if card:
            torch.cuda.empty_cache()
        cs = wide_batch_gazes(centers[0], n)
        batch_launches[n], batch_peaks[n], err, kept = wide_batch_pair(
            kernels, errs, pipe, frame, cs, reduced[0], block_rows,
            keep=n == batches[0])
        keep_max(errs, "sat_build", err)
        if kept is not None:
            direct_batch = wide_direct_batch(cfg, frame, cs, kept, device)
        del kept
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    direct = FoveationPipeline(cfg, sampler="direct", device=device)
    if not torch.equal(direct.foveate_chw(frame, centers[0]), reduced[0]):
        raise AssertionError(f"wide sat {w}x{h}: reduced frame differs from "
                             "the direct sampler's")
    hr, wr, _ = pipe.reduced_shape
    print(f"wide {w}x{h} -> {wr}x{hr}: auto -> sat, {WIDE_FRAMES} chained "
          f"frames, launches {launches}, fovea exact, every unwarp_xy output "
          f"equal to its plain version and within {worst} LSB of the exact "
          "unwarp; batch_pair('auto') launches by gaze count "
          f"{batch_launches}, its SAT equal to the plain scan in "
          f"{block_rows}-row blocks, its rows equal to the chained and "
          "single-gaze reduced frames, row 0 to sat_sample_batch_plain; "
          "first reduced frame equal to the direct sampler's", flush=True)
    print(f"wide {w}x{h} batch_pair('direct') with {batches[0]} gazes: "
          f"{direct_batch}", flush=True)
    report.update(sat=launches, batch=batch_launches, direct_batch=direct_batch)
    if card:
        direct_peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        fps, sat_peak = wide_chain_fps(pipe, frame, centers)
        torch.cuda.empty_cache()
        step = lambda f, c: pipe.unwarp_auto_chw(pipe.foveate_chw(f, c), c)  # noqa: E731
        direct_profile(step, frame, centers[0], f"{w}x{h}", reps=3,
                       what="wide sat path frame")
        torch.cuda.empty_cache()
        k5 = wide_k5_timing(frame)
        torch.cuda.empty_cache()
        k7 = wide_k7_timing(pipe, frame, centers[0])
        line = card_line()
        print(f"wide path sat {w}x{h}: {fps:.3f} fps ({1e3 / fps:.4f} ms/frame, "
              f"{WIDE_FRAMES} chained frames); peak tensor bytes: SAT path "
              f"{sat_peak}, batch pair by gaze count {batch_peaks}, direct "
              f"sampler (one gaze) {direct_peak}  [{line}]", flush=True)
        for row in (k5, k7):
            print(f"wide timing: {json.dumps(row)}  [{line}]", flush=True)
        report.update(fps=fps, sat_peak=sat_peak, batch_peaks=batch_peaks,
                      direct_peak=direct_peak, k5=k5, k7=k7)
    del frame, reduced
    if card:
        torch.cuda.empty_cache()

    w, h = WIDE_FUSED[0], heights[1]
    cfg = FoveaxConfig().with_source(w, h)
    fused = FoveationPipeline(cfg, device=device)
    if fused.sampler != "fused":
        raise AssertionError(f"{w}x{h}: auto resolved to {fused.sampler}, not fused")
    sat_pipe = FoveationPipeline(cfg, sampler="sat", device=device)
    frame = wide_frame(w, h, device, SEED + 8)
    runs = {}
    for name, p in (("sat", sat_pipe), ("fused", fused)):
        if kernels:
            zero_counts(kernels)
        out = p.foveate_chw(frame, centers[0])
        runs[name] = (out, read_counts(kernels) if kernels else {})
        if kernels:
            expect_counts(f"wide {name} {w}x{h}", runs[name][1],
                          {k: 1 for k in PATH_KERNELS[name] if k != "unwarp_xy"})
    if not torch.equal(runs["sat"][0], runs["fused"][0]):
        raise AssertionError(f"wide {w}x{h}: the SAT path differs from the fused path")
    if card:
        torch.cuda.empty_cache()
    pxc, pxmc, vx, pyc, pymc, vy = sr.fused_taps(fused.grid, frame, centers[0][None])
    keep_max(errs, "segreduce_xy", check_equal(
        "segreduce_xy", runs["fused"][0],
        sr.segment_reduce_xy_batch_plain(frame, pxmc, pxc, vx, pymc, pyc, vy)[0],
        f"at {w}x{h}"))
    print(f"wide {w}x{h}: auto -> fused ({sr.xy_shared_bytes(w, cfg.reduced_width)} "
          f"bytes of shared memory a block), sat launches {runs['sat'][1]} "
          f"({scan2d.sat_plan(h, w).tiles} K5 tiles), fused launches "
          f"{runs['fused'][1]}, reduced frames equal, segreduce_xy equal to "
          "its plain version", flush=True)
    report["fused"] = {name: r[1] for name, r in runs.items()}
    return report


def phase_wide(kernels, errs) -> dict:
    """Frames wider than one K5 scanning block spans (module docstring,
    phase 15)."""
    t0 = time.perf_counter()
    wide_kernels(errs)
    torch.cuda.empty_cache()
    report = wide_paths(kernels, errs)
    torch.cuda.empty_cache()
    print(f"wide phase: {time.perf_counter() - t0:.1f} s  [{card_line()}]", flush=True)
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
    logs = build(list(SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line:
                print(f"  {name}: {line.strip()}")

    kernels = kernel_table()
    errs = phase_compare("cuda")
    phase_compare_sat(errs)
    phase_compare_sat_sample(errs)
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
        for sampler in ("fused", "sat"):
            phase_path_fps(shape, sampler)
    phase_serve(kernels)
    phase_svd(kernels)
    phase_math()
    phase_cli(kernels)
    phase_mesh(kernels)
    phase_direct(kernels)
    phase_ladder(kernels, errs)
    phase_fuzz()
    phase_processes()
    phase_sharded_fuzz(kernels)
    phase_wide(kernels, errs)
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
