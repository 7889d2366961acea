"""Differential fuzz of the sharded serving functions against the
single-device path at random shapes, gaze batches and mesh shapes
(counterpart of the JAX package's ``scripts/fuzz_sharded.py``).

    python -m foveax_torch.scripts.fuzz_sharded [seed] [n_shapes]
        [--device cuda] [--max-width 4096] [--max-height 2160]
        [--wrap 4808x4000]

The fixed-shape tests (``tests/test_torch_parallel.py``) pin a few shapes;
this explores where sharding faults live: row-block boundaries against the
carry of the blocked SAT, batch splits over ``data``, whole-axis meshes
(1x8, 8x1) and the fused sampler's per-shard frame copies.  Meshes are
(data x space) 1x8, 2x4, 4x2 and 8x1; on the card their entries are eight
distinct GPUs where eight are visible, else ``cuda:0`` eight times.  Per
shape:

* ``sharded_build_sat`` == ``build_sat`` (exact, mod 2^32);
* ``sharded_sample_batch`` == ``sample_rect_from_sat``, gaze by gaze;
* ``multi_client_step`` == that sample, then the exact unwarp;
* inside ``fused_eligible``, ``sharded_sample_batch_fused`` == the SAT path.

On the card each sharded output is also held to the same call on a mesh of
CPU entries, where every kernel is its plain version, and the launches are
counted: K5 once per space block in ``sharded_build_sat`` and again in
``multi_client_step``, once for the single-device ``build_sat``;
``segreduce_xy`` once per data shard where the fused sampler runs; K7 (the
SAT sampler) once per gaze of the single-device reference and once per
data shard in ``sharded_sample_batch`` and again in ``multi_client_step``.
Source widths run from 128 to ``--max-width`` and are never a multiple of
16; heights are ``n_space * k`` up to ``--max-height`` with ``k`` never a
multiple of K5's 32-row band, so every space block ends inside a band.
The first gaze is (0, 1) and the second (0.997, 0.003), the clamp edges.

Then one fixed case: an all-255 frame of ``--wrap`` (4808x4000 by
default, ``none`` to leave it out) on the 1x8 mesh, whose sums pass 2^32
(255 * 4808 * 4000 = 4.90e9): the sharded SAT, its carry added in int64,
must wrap as the single-device SAT does and equal 255 (y+1)(x+1) mod 2^32.

``--device cpu`` runs the plain versions at the JAX package's shape range
(up to 640x200).  Exit code 1 on any failure, 2 without a GPU unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from foveax_torch.config import reduced_dim
from foveax_torch.core.logrect import make_grid
from foveax_torch.core.sample import sample_rect_from_sat
from foveax_torch.core.sat import build_sat
from foveax_torch.core.unwarp import unwarp_rect
from foveax_torch.device import resolve_device
from foveax_torch.kernels import sat_sample as ss
from foveax_torch.kernels import scan2d
from foveax_torch.kernels import segreduce as sr
from foveax_torch.parallel import make_mesh, multi_client_step
from foveax_torch.parallel.sharded import (
    sharded_build_sat,
    sharded_sample_batch,
    sharded_sample_batch_fused,
)

MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]  # (data, space)
MESH_SIZE = 8
MIN_WIDTH = 128
MIN_HEIGHT = 100  # every mesh then has a block height off the band
LIMITS = {"cuda": (4096, 2160), "cpu": (640, 200)}  # default max width, height
WRAP = "4808x4000"
EDGE_GAZES = [(0.0, 1.0), (0.997, 0.003)]


def mesh_devices(device: torch.device) -> list[torch.device]:
    """The eight mesh entries: eight distinct GPUs where eight are visible,
    else ``cuda:0`` eight times (the CPU eight times on the CPU)."""
    if device.type == "cpu":
        return [device] * MESH_SIZE
    if torch.cuda.device_count() >= MESH_SIZE:
        return [torch.device("cuda", k) for k in range(MESH_SIZE)]
    return [torch.device("cuda", 0)] * MESH_SIZE


def draw_shape(rng, n_space: int, max_width: int, max_height: int):
    """A source (width, height): the width not a multiple of 16, the
    height ``n_space * k`` with ``k`` not a multiple of K5's band."""
    while True:
        fw = int(rng.integers(MIN_WIDTH, max_width + 1))
        if fw % 16:
            break
    lo, hi = max(96 // n_space, 2), max_height // n_space
    while True:
        k = int(rng.integers(lo, hi + 1))
        if k % scan2d.BAND_ROWS:
            return fw, n_space * k


def draw_case(rng, max_width: int, max_height: int) -> dict:
    """One shape's mesh, frame and gazes, drawn in the JAX package's
    order."""
    n_data, n_space = MESHES[int(rng.integers(len(MESHES)))]
    fw, fh = draw_shape(rng, n_space, max_width, max_height)
    n_gazes = n_data * int(rng.integers(1, 4))
    frame = rng.integers(0, 256, (fh, fw, 3), np.uint8)
    centers = rng.uniform(0.0, 1.0, (n_gazes, 2)).astype(np.float32)
    for k, gaze in enumerate(EDGE_GAZES[:n_gazes]):
        centers[k] = gaze
    return {"n_data": n_data, "n_space": n_space, "frame": frame,
            "centers": centers}


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def sharded_outputs(frame, centers, grid, mesh, fused: bool) -> dict:
    """Each sharded function's output on ``mesh``, gathered to the host."""
    sat = sharded_build_sat(frame, mesh)
    red_mc, rest_mc = multi_client_step(frame, centers, grid, mesh, unwarp=True)
    out = {"sat": sat.cpu(), "sample": sharded_sample_batch(sat, centers, grid, mesh).cpu(),
           "mc": red_mc.cpu(), "unwarp": rest_mc.cpu()}
    if fused:
        out["fused"] = sharded_sample_batch_fused(frame, centers, grid, mesh).cpu()
    return out


def single_device(frame, centers, grid) -> tuple[torch.Tensor, ...]:
    """The single-device references: the SAT, each gaze sampled from it,
    each reduced frame unwarped (exact)."""
    fh, fw = frame.shape[:2]
    sat = build_sat(frame)
    reduced = torch.stack([sample_rect_from_sat(sat, grid, c) for c in centers])
    restored = torch.stack([unwarp_rect(r, fw, fh, c) for r, c in zip(reduced, centers)])
    return sat, reduced, restored


def read_launches() -> dict[str, int]:
    """The kernels' launch counters (host-side, counted at each launch)."""
    return {"K5": scan2d.SAT_BUILD.launches, "segreduce_xy": sr.XY_PASS.launches,
            "K7": ss.SAT_SAMPLE.launches}


def zero_launches() -> None:
    scan2d.SAT_BUILD.launches = sr.XY_PASS.launches = ss.SAT_SAMPLE.launches = 0


def expected_launches(n_data: int, n_space: int, n_gazes: int, fused: bool,
                      device) -> dict[str, int]:
    """K5: a space block each in ``sharded_build_sat`` and
    ``multi_client_step``, one for the single-device SAT; ``segreduce_xy``
    a data shard each where the fused sampler runs; K7: a gaze each for
    the single-device reference, a data shard each in
    ``sharded_sample_batch`` and ``multi_client_step``; none on the CPU,
    where every kernel is its plain version."""
    if device.type == "cpu":
        return {"K5": 0, "segreduce_xy": 0, "K7": 0}
    return {"K5": 2 * n_space + 1, "segreduce_xy": n_data if fused else 0,
            "K7": n_gazes + 2 * n_data}


def check_shape(case: dict, device: torch.device, devices) -> tuple[bool, str]:
    """One drawn case's invariants; returns (ok, report)."""
    n_data, n_space = case["n_data"], case["n_space"]
    fh, fw, _ = case["frame"].shape
    rw, rh = reduced_dim(fw), reduced_dim(fh)
    mesh = make_mesh(n_space, n_data, devices=devices)
    grid = make_grid(rw, rh, fw, fh, device)
    fused = sr.fused_eligible(grid)
    frame = torch.from_numpy(case["frame"]).to(device)
    centers = torch.from_numpy(case["centers"]).to(device)
    zero_launches()
    sat_ref, red_ref, rest_ref = single_device(frame, centers, grid)
    got = sharded_outputs(frame, centers, grid, mesh, fused)
    launches = read_launches()
    want = {"sat": sat_ref, "sample": red_ref, "mc": red_ref, "unwarp": rest_ref,
            "fused": red_ref}
    eq = {k: _equal(v, want[k]) for k, v in got.items()}
    plain = "n/a"
    if device.type != "cpu":
        cpu = torch.device("cpu")
        ref = sharded_outputs(
            frame.cpu(), centers.cpu(), make_grid(rw, rh, fw, fh, cpu),
            make_mesh(n_space, n_data, devices=mesh_devices(cpu)), fused)
        plain = str(all(_equal(v, ref[k]) for k, v in got.items()))
    launches_ok = launches == expected_launches(n_data, n_space, len(centers),
                                                fused, device)
    ok = all(eq.values()) and plain != "False" and launches_ok
    report = (f"{fw}x{fh} r{rw}x{rh} mesh {n_data}x{n_space} N={len(centers)}: "
              f"sat={eq['sat']} sample={eq['sample']} mc={eq['mc']} "
              f"unwarp={eq['unwarp']} fused={eq.get('fused')} plain={plain} "
              f"launches K5={launches['K5']} segreduce_xy={launches['segreduce_xy']} "
              f"K7={launches['K7']}{'' if launches_ok else ' (unexpected)'}")
    return ok, report


def all255_sat(h: int, w: int, device) -> torch.Tensor:
    """One channel of an all-255 frame's SAT, 255 (y+1)(x+1) mod 2^32, in
    int64."""
    ys = torch.arange(1, h + 1, dtype=torch.int64, device=device)
    xs = torch.arange(1, w + 1, dtype=torch.int64, device=device)
    return (255 * ys[:, None] * xs[None, :]) & scan2d.MASK32


def check_wrap(w: int, h: int, device: torch.device, devices) -> tuple[bool, str]:
    """The all-255 case on the 1x8 mesh: the sharded SAT equal to the
    single-device SAT, to the closed form and, on the card, to K5's plain
    version; K5 launched once a space block and once alone."""
    mesh = make_mesh(MESH_SIZE, 1, devices=devices)
    frame = torch.full((h, w, 3), 255, dtype=torch.uint8, device=device)
    zero_launches()
    sat = sharded_build_sat(frame, mesh).gather(device)
    single = build_sat(frame)
    launches = read_launches()
    sat_eq = _equal(sat, single)
    plain = "n/a"
    if device.type != "cpu":
        plain = str(_equal(sat, scan2d.sat_scan_plain(frame.permute(2, 0, 1))))
    want = all255_sat(h, w, device)
    closed = all(torch.equal(scan2d.as_int64(sat[c]), want) for c in range(3))
    expected = {"K5": 0 if device.type == "cpu" else MESH_SIZE + 1,
                "segreduce_xy": 0, "K7": 0}
    launches_ok = launches == expected
    ok = sat_eq and closed and plain != "False" and launches_ok
    return ok, (f"wrap all-255 {w}x{h} mesh 1x{MESH_SIZE}: 255*W*H = {255 * w * h} "
                f"> 2^32, sat={sat_eq} closed_form={closed} plain={plain} "
                f"launches K5={launches['K5']} segreduce_xy={launches['segreduce_xy']} "
                f"K7={launches['K7']}{'' if launches_ok else ' (unexpected)'}")


def parse_wrap(text: str) -> tuple[int, int] | None:
    """``WxH`` -> (W, H), ``none`` -> None; the sums must pass 2^32 and H
    must split over eight space blocks."""
    if text == "none":
        return None
    try:
        w, h = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"--wrap {text!r}: expected WxH or none")
    if 255 * w * h < 2**32 or h % MESH_SIZE:
        raise argparse.ArgumentTypeError(
            f"--wrap {text}: needs 255*W*H >= 2^32 and H a multiple of "
            f"{MESH_SIZE}")
    return w, h


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("n_shapes", nargs="?", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--max-width", type=int,
                    help="widest source (default 4096 on the card, 640 on the CPU)")
    ap.add_argument("--max-height", type=int,
                    help="tallest source (default 2160 on the card, 200 on the CPU)")
    ap.add_argument("--wrap", type=parse_wrap, default=WRAP,
                    help="the all-255 case's WxH, or none (default %(default)s)")
    args = ap.parse_args(argv)
    max_width = args.max_width or LIMITS[args.device][0]
    max_height = args.max_height or LIMITS[args.device][1]
    if max_width <= MIN_WIDTH or max_height < MIN_HEIGHT:
        ap.error(f"shapes start above {MIN_WIDTH}x{MIN_HEIGHT}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    devices = mesh_devices(device)
    rng = np.random.default_rng(args.seed)
    fails = 0
    for _ in range(args.n_shapes):
        case = draw_case(rng, max_width, max_height)
        fh, fw, _ = case["frame"].shape
        t0 = time.time()
        try:
            ok, report = check_shape(case, device, devices)
        except Exception as e:  # noqa: BLE001 - report and count
            print(f"{fw}x{fh} mesh {case['n_data']}x{case['n_space']} "
                  f"N={len(case['centers'])}: EXC {e!r}", flush=True)
            fails += 1
            continue
        print(f"{report} ({time.time() - t0:.1f}s)", flush=True)
        fails += 0 if ok else 1
    if args.wrap is not None:
        t0 = time.time()
        try:
            ok, report = check_wrap(*args.wrap, device, devices)
        except Exception as e:  # noqa: BLE001 - report and count
            ok, report = False, f"wrap {args.wrap}: EXC {e!r}"
        print(f"{report} ({time.time() - t0:.1f}s)", flush=True)
        fails += 0 if ok else 1
    print("FAILS:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
