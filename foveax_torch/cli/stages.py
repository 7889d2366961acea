"""The staged validation configs (BASELINE.md "Rebuild targets"), on the
port (counterpart of ``foveax/cli/stages.py``).

  1. single 1080p frame log-rectilinear warp at a fixed gaze
  2. SAT encode -> decode round-trip (exact)
  3. 30 fps 1080p streaming with a dynamic gaze trace, nothing rebuilt
     while the gaze moves
  4. 4K full path: SAT -> sample -> unwarp -> gnomonic viewport
     (>= 60 fps target on the card)
  5. 8 concurrent gaze streams sampled from one SAT on 4K frames
  6. the SAT-free direct sampler equal to the SAT path at 4K, on the
     device

Run: ``python -m foveax_torch.cli.main stages`` (``--device cpu`` for the
plain versions).  Prints one PASS/FAIL line per stage plus the measured
numbers.
"""

from __future__ import annotations

import asyncio
import socket
import time

import numpy as np
import torch

from foveax_torch.device import resolve_device

def _result(name: str, ok: bool, detail: str, *, partial: bool = False) -> bool:
    """``partial`` marks a pass whose perf claim could not be measured in
    this environment (parity still verified) — rendered distinctly so a
    PASS line never overstates what was checked."""
    status = "FAIL" if not ok else ("PASS*" if partial else "PASS")
    print(f"[{status}] {name}: {detail}")
    return ok


def _frame(seed: int, shape, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(device)


def stage1_single_frame_warp(device=None) -> bool:
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.pipeline.frames import FoveationPipeline

    dev = resolve_device(device)
    cfg = FoveaxConfig()
    p = FoveationPipeline(cfg, device=dev)
    frame = _frame(1, (1080, 1920, 3), dev)
    t0 = time.perf_counter()
    reduced = p.foveate(frame, p.center(0.37, 0.61)).cpu().numpy()
    dt = time.perf_counter() - t0
    ok = reduced.shape == (608, 1072, 3) and reduced.any()
    return _result(
        "stage1 single-frame warp", ok, f"1080p->1072x608 in {dt:.1f}s (cold)"
    )


def stage2_sat_roundtrip(device=None) -> bool:
    from foveax_torch.core.sat import build_sat, decode_sat

    dev = resolve_device(device)
    frame = _frame(2, (1080, 1920, 3), dev)
    back = decode_sat(build_sat(frame))
    ok = bool(torch.equal(back, frame))
    return _result("stage2 SAT round-trip", ok, "exact uint32 reconstruction")


def stage3_streaming_dynamic_gaze(device=None) -> bool:
    """A 30-frame 1080p session over websockets with a moving gaze.  The
    port compiles nothing per gaze; what could be rebuilt is a kernel
    library, so the stage checks that no library is loaded and no nvcc
    starts between the client's first and last frame.  The server sends
    exactly the frames the client asks for, so that the kernels' launch
    counts are fixed: one sample per frame on the server, one unwarp per
    frame on the client."""
    import websockets

    from foveax_torch.config import FoveaxConfig
    from foveax_torch.kernels import build as kbuild
    from foveax_torch.serve.client import FoveaxClient
    from foveax_torch.serve.server import FoveaxServer

    dev = resolve_device(device)
    cfg = FoveaxConfig()
    # Bind the listening socket ourselves and hand it to websockets.serve:
    # probing a free port and rebinding it is a TOCTOU race.
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    port = lsock.getsockname()[1]

    n_frames = 30
    server = FoveaxServer(cfg, max_frames=n_frames, device=dev)
    gaze_trace = [(0.3 + 0.01 * i, 0.5 + 0.005 * i) for i in range(64)]
    built = []  # (libraries loaded, nvcc runs) as each frame arrives

    def sink(frame, meta):
        built.append((len(kbuild._libs), kbuild.nvcc_runs))

    client = FoveaxClient(
        f"ws://127.0.0.1:{port}",
        video=f"synthetic://1920x1080@30/{n_frames + 5}",
        config=cfg,
        gaze_source=lambda i: gaze_trace[i % len(gaze_trace)],
        frame_sink=sink,
        max_frames=n_frames,
        device=dev,
    )

    async def main():
        async with websockets.serve(
            server.handle, sock=lsock, max_size=64 * 1024 * 1024
        ):
            return await asyncio.wait_for(client.run(), timeout=600)

    stats = asyncio.run(main())
    a = stats.averages()
    rebuilt = len(built) == 0 or built[-1] != built[0]
    libs, runs = built[-1] if built else (0, 0)
    ok = stats.frames == n_frames and server.total_sent == n_frames and not rebuilt
    return _result(
        "stage3 30fps 1080p dynamic-gaze stream",
        ok,
        f"{stats.frames} frames, {libs} kernel librar{'y' if libs == 1 else 'ies'} "
        f"loaded and {runs} nvcc run(s), none while the gaze moved, "
        f"recv {a['avg_receive_ms']:.1f}ms unwarp {a['avg_unwarp_ms']:.1f}ms",
    )


def stage4_4k_full_path(device=None) -> bool:
    from foveax_torch.config import reduced_dim
    from foveax_torch.core.gnomonic import gnomonic_project
    from foveax_torch.core.logrect import make_grid
    from foveax_torch.core.sample import sample_rect_from_sat
    from foveax_torch.core.sat import build_sat
    from foveax_torch.core.unwarp import unwarp_rect

    dev = resolve_device(device)
    w, h = 3840, 2160
    grid = make_grid(reduced_dim(w), reduced_dim(h), w, h, dev)

    def step(f, c):
        sat = build_sat(f, in_layout="chw")
        red = sample_rect_from_sat(sat, grid, c, out_layout="chw")
        restored = unwarp_rect(
            red, w, h, c, in_layout="chw", out_layout="chw", precision="auto"
        )
        # BASELINE config 4 includes the viewport projection stage.
        view = gnomonic_project(restored.permute(1, 2, 0), 1920, 1080, c)
        return restored, view

    frame = _frame(4, (3, h, w), dev)
    centers = [
        torch.tensor([0.3 + 0.01 * i, 0.5], dtype=torch.float32, device=dev)
        for i in range(26)
    ]

    def chain(n):
        y = frame
        view = None
        t0 = time.perf_counter()
        for i in range(n):
            y, view = step(y, centers[i])
        float(view.to(torch.int64).sum())
        return time.perf_counter() - t0

    chain(2)
    base = chain(2)
    total = chain(22)
    fps = 20 / max(total - base, 1e-9)
    # The >= 60 fps target applies on the card; CPU runs just check
    # execution.
    ok = fps >= 60.0 if dev.type == "cuda" else fps > 0
    return _result(
        "stage4 4K full path (incl. viewport projection)",
        ok,
        f"{fps:.1f} fps (target >= 60 on the card)",
    )


def stage5_batched_clients(n_clients: int = 8, device=None) -> bool:
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.pipeline.frames import FoveationPipeline

    dev = resolve_device(device)
    # BASELINE config 5 batches gaze streams over 4K frames.
    cfg = FoveaxConfig().with_source(3840, 2160)
    p = FoveationPipeline(cfg, device=dev)
    rng = np.random.default_rng(5)
    frame = torch.from_numpy(rng.integers(0, 256, (2160, 3840, 3), np.uint8)).to(dev)
    centers = torch.from_numpy(
        rng.uniform(0.1, 0.9, (n_clients, 2)).astype(np.float32)
    ).to(dev)
    batch = p.foveate_batch(frame, centers)
    ok = tuple(batch.shape) == (n_clients, 1200, 2144, 3)
    # Parity with per-client launches.
    for i in range(n_clients):
        if not torch.equal(batch[i], p.foveate(frame, centers[i])):
            ok = False
            break

    def chain(n):
        cs = centers
        t0 = time.perf_counter()
        b = batch
        for _ in range(n):
            b = p.foveate_batch(frame, cs)
            cs = torch.remainder(
                cs + b[0, 0, 0, 0].to(torch.float32) * 1e-9 + 0.003, 1.0
            )
        float(cs.sum())
        return time.perf_counter() - t0

    chain(4)
    base = min(chain(4) for _ in range(2))
    total = min(chain(24) for _ in range(2))
    per = (total - base) / 20 * 1000
    if per > 0.05:
        detail = (
            f"{n_clients} streams from one SAT, {per:.1f} ms/frame "
            f"({1000 / per * n_clients:.0f} client-fps), bitwise == per-client"
        )
        return _result("stage5 8-gaze batched launch", ok, detail)
    # Timing was unmeasurable here: parity alone was verified — a PASS*
    # (partial), never a silent full PASS.
    detail = (
        f"{n_clients} streams from one SAT, bitwise == per-client; "
        "perf claim NOT validated here (timing unstable — see "
        "`perf --clients` on the card)"
    )
    return _result("stage5 8-gaze batched launch", ok, detail, partial=True)


def stage6_direct_sampler(device=None) -> bool:
    """SAT-free direct sampler: bit-equality with the SAT path (K5, then
    the 4-tap sampler) on the device at 4K, two gazes."""
    from foveax_torch.config import reduced_dim
    from foveax_torch.core.direct import sample_rect_direct
    from foveax_torch.core.logrect import make_grid
    from foveax_torch.core.sample import sample_rect_from_sat
    from foveax_torch.core.sat import build_sat

    dev = resolve_device(device)
    w, h = 3840, 2160
    grid = make_grid(reduced_dim(w), reduced_dim(h), w, h, dev)
    frame = _frame(6, (3, h, w), dev)
    sat = build_sat(frame, in_layout="chw")
    ok = True
    for cxy in [(0.5, 0.5), (0.97, 0.06)]:
        c = torch.tensor(cxy, dtype=torch.float32, device=dev)
        a = sample_rect_from_sat(sat, grid, c, out_layout="chw")
        b = sample_rect_direct(frame, grid, c, out_layout="chw")
        if not torch.equal(a, b):
            ok = False
            break
    return _result(
        "stage6 direct sampler == SAT path (4K, on device)",
        ok,
        "bit-identical" if ok else "MISMATCH",
    )


STAGES = (
    stage1_single_frame_warp,
    stage2_sat_roundtrip,
    stage3_streaming_dynamic_gaze,
    stage4_4k_full_path,
    stage5_batched_clients,
    stage6_direct_sampler,
)


def run_all(device=None) -> int:
    dev = resolve_device(device)
    results = [stage(device=dev) for stage in STAGES]
    print(f"{sum(results)}/{len(results)} stages passed")
    return 0 if all(results) else 1
