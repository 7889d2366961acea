"""Differential fuzz of the fused sampler and the fused unwarp at random
eligible shapes and gazes (counterpart of the JAX package's
``scripts/fuzz_fused.py``).

    python -m foveax_torch.scripts.fuzz_fused [seed] [n_shapes]
        [--device cuda] [--max-width 16384] [--max-height 2200]

Fixed shapes hold the kernels at the production sizes; this explores the
rest of the shapes the port admits.  Source widths are drawn from 96 to
``--max-width`` and are never a multiple of 16 (the kernels' 16-column
chunks end ragged), the first above 8,192 where the limit allows (K5's
two-chunk launch plan); heights from 64 to ``--max-height``; each shape's
reduced size is the configuration's rule, and a shape outside the fused
sampler's contract is drawn again (past 35,888 columns every shape is:
``segment_reduce_xy``'s shared memory; K5 scans such rows in column
tiles past 32,768).  Per shape, for a random gaze, (0, 0),
(1, 1) and the edge-clamped (0.997, 0.003):

* ``segreduce_xy`` bit-equal to its plain version and to the SAT route
  (K5, then the 4-tap sampler K7: an independent computation);
* ``unwarp_xy`` on that reduced frame bit-equal to ``unwarp_xy_plain``,
  within 1 LSB of the exact unwarp, and for a gaze whose fovea lies inside
  the frame the fovea of the roundtrip equal to the source (a shape outside
  the fused unwarp's contract prints ``unwarp_maxd=-1`` and is no failure);

then ``sample_rect_fused_batch`` over a batch with a duplicate pair, an
edge-clamped gaze and a random one, each gaze bit-equal to the SAT route
and the pair to each other, and K5 in both input layouts bit-equal to its
plain version.  With ``--device cpu`` every kernel is its plain version,
so only the comparisons with the SAT route and the exact unwarp remain.
Exit code 1 on any failure.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from foveax_torch.config import FoveaxConfig, reduced_dim
from foveax_torch.core.logrect import LogRectGrid
from foveax_torch.core.sample import sample_rect_from_sat
from foveax_torch.core.unwarp import unwarp_rect
from foveax_torch.device import resolve_device
from foveax_torch.kernels import scan2d
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels import unwarp as uw
from foveax_torch.pipeline.frames import FoveationPipeline

FOVEA = 8  # half-width of the crop around the gaze that must round-trip
EDGE_GAZES = [(0.0, 0.0), (1.0, 1.0), (0.997, 0.003)]
MIN_WIDTH, MIN_HEIGHT = 96, 64
TWO_CHUNK_WIDTH = 8192  # above it K5 gives a thread two 16-column chunks


def draw_shape(rng, max_width: int, max_height: int, wide: bool) -> tuple[int, int]:
    """A source (width, height): the width not a multiple of 16, above
    :data:`TWO_CHUNK_WIDTH` when ``wide``."""
    lo = TWO_CHUNK_WIDTH + 1 if wide else MIN_WIDTH
    while True:
        fw = int(rng.integers(lo, max_width + 1))
        if fw % 16:
            return fw, int(rng.integers(MIN_HEIGHT, max_height + 1))


def eligible_pipeline(rng, max_width: int, max_height: int, wide: bool, device):
    """A pipeline at a drawn shape inside the fused sampler's contract."""
    while True:
        fw, fh = draw_shape(rng, max_width, max_height, wide)
        cfg = FoveaxConfig(source_width=fw, source_height=fh,
                           reduced_width=reduced_dim(fw),
                           reduced_height=reduced_dim(fh))
        pipe = FoveationPipeline(cfg, device=device)
        if pipe.fused_ok:
            return pipe


def sat_route(frame: torch.Tensor, grid: LogRectGrid,
              centers: torch.Tensor) -> torch.Tensor:
    """The reference sampler: K5 on the (3, H, W) frame, then the 4-tap
    sampler K7; (N, 3, Hr, Wr) for (N, 2) centres, (3, Hr, Wr) for one."""
    sat = scan2d.sat_scan(frame, in_layout="chw")
    return sample_rect_from_sat(sat, grid, centers, out_layout="chw")


def exact_unwarp(reduced: torch.Tensor, w: int, h: int,
                 center: torch.Tensor) -> torch.Tensor:
    """The reference unwarp of a (3, Hr, Wr) frame to (3, H, W)."""
    return unwarp_rect(reduced, w, h, center, in_layout="chw",
                       out_layout="chw", precision="exact")


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def fovea_slices(w: int, h: int, gaze) -> tuple[slice, slice] | None:
    """The crop around the gaze that must round-trip, or None where it
    reaches row or column 0 or the last one (the clamp rule keeps source
    row and column 0 out of every box)."""
    cx = int(np.float32(gaze[0]) * np.float32(w))
    cy = int(np.float32(gaze[1]) * np.float32(h))
    if not (FOVEA < cx < w - 1 - FOVEA and FOVEA < cy < h - 1 - FOVEA):
        return None
    return slice(cy - FOVEA, cy + FOVEA + 1), slice(cx - FOVEA, cx + FOVEA + 1)


def check_gaze(pipe, frame: torch.Tensor, gaze) -> tuple[bool, str]:
    """One gaze's sampler and unwarp checks; returns (ok, report)."""
    h, w = frame.shape[1:]
    dev = frame.device
    c = torch.tensor(gaze, dtype=torch.float32, device=dev)
    taps = sr.fused_taps(pipe.grid, frame, c[None], wrap_x=pipe.wrap_x)
    pxc, pxmc, vx, pyc, pymc, vy = taps
    args = (frame, pxmc, pxc, vx, pymc, pyc, vy)
    red = sr.segment_reduce_xy_batch(*args)
    xy_eq = _equal(red, sr.segment_reduce_xy_batch_plain(*args))
    red = red[0]
    sampler_eq = _equal(red, sat_route(frame, pipe.grid, c))
    hr, wr = red.shape[1:]
    vectors = uw.fused_vectors(hr, wr, w, h, c, strict=False)
    unwarp_eq, d, fovea = True, -1, "n/a"
    if vectors is not None:
        out = uw.unwarp_xy(red, *vectors)
        unwarp_eq = _equal(out, uw.unwarp_xy_plain(red, *vectors))
        exact = exact_unwarp(red, w, h, c)
        d = int((out.to(torch.int16) - exact.to(torch.int16)).abs().max())
        crop = fovea_slices(w, h, gaze)
        if crop is not None:
            ys, xs = crop
            fovea = str(torch.equal(out[:, ys, xs], frame[:, ys, xs]))
    ok = xy_eq and sampler_eq and unwarp_eq and d <= 1 and fovea != "False"
    return ok, (f"xy_eq={xy_eq} sampler_eq={sampler_eq} unwarp_eq={unwarp_eq} "
                f"unwarp_maxd={d} fovea={fovea}")


def check_batch(pipe, frame: torch.Tensor, batch: np.ndarray) -> list:
    """The batched sampler against the SAT route, gaze by gaze; returns
    the bad entries."""
    cs = torch.from_numpy(batch).to(frame.device)
    reds = sr.sample_rect_fused_batch(frame, pipe.grid, cs, wrap_x=pipe.wrap_x,
                                      out_layout="chw")
    want = sat_route(frame, pipe.grid, cs)
    bad = [k for k in range(len(batch)) if not _equal(reds[k], want[k])]
    if not _equal(reds[0], reds[1]):
        bad.append("dup-mismatch")
    return bad


def check_sat(frame: torch.Tensor) -> bool:
    """K5 in both input layouts against its plain version."""
    want = scan2d.sat_scan_plain(frame)
    hwc = frame.permute(1, 2, 0).contiguous()
    return (_equal(scan2d.sat_scan(frame, in_layout="chw"), want)
            and _equal(scan2d.sat_scan(hwc, in_layout="hwc"), want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("n_shapes", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--max-width", type=int, default=16384)
    ap.add_argument("--max-height", type=int, default=2200)
    args = ap.parse_args(argv)
    if args.max_width < MIN_WIDTH or args.max_height < MIN_HEIGHT:
        ap.error(f"shapes start at {MIN_WIDTH}x{MIN_HEIGHT}")
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    fails = 0
    for t in range(args.n_shapes):
        wide = t == 0 and args.max_width > TWO_CHUNK_WIDTH
        pipe = eligible_pipeline(rng, args.max_width, args.max_height, wide, dev)
        cfg = pipe.config
        fw, fh = cfg.source_width, cfg.source_height
        shape = f"{fw}x{fh} r{cfg.reduced_width}x{cfg.reduced_height}"
        frame = torch.from_numpy(
            rng.integers(0, 256, (3, fh, fw), np.uint8)).to(dev)
        gazes = [tuple(float(v) for v in rng.uniform(0.1, 0.9, 2)), *EDGE_GAZES]
        for gaze in gazes:
            t0 = time.time()
            try:
                ok, report = check_gaze(pipe, frame, gaze)
            except Exception as e:  # noqa: BLE001 - report and count
                print(f"{shape} gaze {gaze}: EXC {e!r}", flush=True)
                fails += 1
                continue
            print(f"{shape} gaze ({gaze[0]:.3f},{gaze[1]:.3f}): {report} "
                  f"({time.time() - t0:.1f}s)", flush=True)
            fails += 0 if ok else 1

        dup = rng.uniform(0.05, 0.95, 2)
        batch = np.stack(
            [dup, dup, np.asarray([1.0, 0.0]), rng.uniform(0, 1, 2)]
        ).astype(np.float32)
        t0 = time.time()
        try:
            bad = check_batch(pipe, frame, batch)
            sat_ok = check_sat(frame)
        except Exception as e:  # noqa: BLE001 - report and count
            print(f"{shape} batch: EXC {e!r}", flush=True)
            fails += 1
            continue
        print(f"{shape} batch x{len(batch)}: bad={bad or 'none'}; "
              f"sat_build_eq={sat_ok} ({time.time() - t0:.1f}s)", flush=True)
        fails += bool(bad) + (not sat_ok)
        del pipe, frame
    print("FAILS:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
