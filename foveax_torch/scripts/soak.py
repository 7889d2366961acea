"""Serving soak: session churn must leave no residue (counterpart of the
JAX package's ``tests/test_soak.py``).

    python -m foveax_torch.scripts.soak [--device cuda] [--wire jpeg]

A broadcast server on the port's ``FoveaxServer`` and, in each of 10
cycles, three ``FoveaxClient`` streams of three frames each over real
websockets, the cycles alternating between two source shapes so that both
pass through the server's bounded pipeline cache.  After the churn every pool must be back
at its floor: no sessions or channels, at most ``max_pipelines`` cached
pipelines, every native handle released
(:func:`foveax_torch.native.live_native_handles` all 0), file descriptors
and threads within 4 of their count after the first cycle.  On the card,
also the CUDA memory held by tensors (``torch.cuda.memory_allocated``)
after each later cycle must be no higher than after the second cycle,
when both shapes have warmed up (per-shape caches filled).  Exit code 1 on
any residue.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import os
import sys
import threading

import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.device import resolve_device
from foveax_torch.native import live_native_handles
from foveax_torch.scripts.two_process_demo import free_port
from foveax_torch.serve.client import FoveaxClient
from foveax_torch.serve.server import FoveaxServer

BASE = FoveaxConfig(
    source_width=96, source_height=64, reduced_width=48, reduced_height=32
)
VIDEOS = ("synthetic://96x64@30/50", "synthetic://128x96@30/50")
CLIENTS = 3
FRAMES = 3
CYCLES = 10
CYCLE_TIMEOUT_S = 60.0
SLACK = 4  # fds and threads a pool may add after the first cycle


@dataclasses.dataclass
class SoakReport:
    device: str
    wire: str
    sessions: int
    channels: int
    pipelines: int
    max_pipelines: int
    native: dict[str, int]
    fds: tuple[int, int]  # after the first cycle, at the end
    threads: tuple[int, int]
    memory: list[int] | None  # CUDA bytes allocated after each cycle


def fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def churn(device: str = "cuda", wire: str = "jpeg") -> SoakReport:
    """:data:`CYCLES` join/stream/leave cycles against one server; returns
    what is left.  Raises if a client gets fewer frames than it asked for
    or a cycle outlasts :data:`CYCLE_TIMEOUT_S`."""
    dev = resolve_device(device)
    port = free_port()
    server = FoveaxServer(BASE, broadcast=True, max_frames=400, wire_codec=wire,
                          loop_videos=True, device=dev)
    # The server serves its base configuration as it is and derives
    # with_source() for other shapes; the clients mirror that.
    cfgs = {VIDEOS[0]: BASE, VIDEOS[1]: BASE.with_source(128, 96)}
    memory = [] if dev.type == "cuda" else None

    async def one_cycle(cycle: int):
        video = VIDEOS[cycle % len(VIDEOS)]
        clients = [
            FoveaxClient(f"ws://127.0.0.1:{port}", video=video,
                         config=cfgs[video],
                         gaze_source=lambda i, k=k: (0.2 + 0.2 * k, 0.5),
                         max_frames=FRAMES, device=dev)
            for k in range(CLIENTS)
        ]
        stats = await asyncio.wait_for(
            asyncio.gather(*(c.run() for c in clients)), timeout=CYCLE_TIMEOUT_S
        )
        frames = [s.frames for s in stats]
        if frames != [FRAMES] * CLIENTS:
            raise RuntimeError(f"cycle {cycle}: frames per client {frames}")
        # Teardown settles in the channels' finally blocks; yield to it.
        for _ in range(20):
            if not server.sessions and not server.channels:
                break
            await asyncio.sleep(0.05)
        if memory is not None:
            gc.collect()
            torch.cuda.synchronize(dev)
            memory.append(torch.cuda.memory_allocated(dev))

    async def main():
        import websockets

        async with websockets.serve(server.handle, "127.0.0.1", port,
                                    max_size=64 * 1024 * 1024):
            # The first cycle takes the one-time costs (kernel loads, lazy
            # imports, thread pools) before the baseline.
            await one_cycle(0)
            gc.collect()
            base = fd_count(), threading.active_count()
            for cycle in range(1, CYCLES):
                await one_cycle(cycle)
            return base

    (fd0, threads0) = asyncio.run(main())
    gc.collect()
    return SoakReport(
        device=str(dev), wire=wire,
        sessions=len(server.sessions), channels=len(server.channels),
        pipelines=len(server._pipelines), max_pipelines=server.max_pipelines,
        native=live_native_handles(),
        fds=(fd0, fd_count()), threads=(threads0, threading.active_count()),
        memory=memory,
    )


def residue(report: SoakReport) -> list[str]:
    """What the churn left behind, one line each; empty when nothing."""
    found = []
    if report.sessions or report.channels:
        found.append(f"{report.sessions} sessions, {report.channels} channels")
    if report.pipelines > report.max_pipelines:
        found.append(f"{report.pipelines} pipelines > {report.max_pipelines}")
    found += [f"{n} live {name} handles" for name, n in report.native.items() if n]
    for what, (before, after) in (("fds", report.fds), ("threads", report.threads)):
        if after > before + SLACK:
            found.append(f"{what} {before} -> {after}")
    if report.memory is not None:
        warm = report.memory[1]
        grown = [(k, m) for k, m in enumerate(report.memory) if k > 1 and m > warm]
        if grown:
            found.append(f"CUDA memory above the {warm} bytes after cycle 1: {grown}")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--wire", default="jpeg")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    report = churn(args.device, args.wire)
    print(f"soak: {dataclasses.asdict(report)}")
    found = residue(report)
    for line in found:
        print(f"soak residue: {line}", file=sys.stderr)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
