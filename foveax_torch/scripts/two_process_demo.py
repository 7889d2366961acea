"""Two-process serving demo (counterpart of the JAX package's
``scripts/two_process_demo.py``): the server holds its device in one
process, the client runs in this one, over a real socket.

    python -m foveax_torch.scripts.two_process_demo [--frames 60]
        [--resolution 320x180] [--server-device cuda] [--client-device cuda]

The only traffic is JSON gaze messages up and encoded fMP4 fragments
down: no unencoded pixel crosses the process boundary.  The server is
``python -m foveax_torch.cli.main --device D serve --loop ...``; pass
``--client-device cpu`` for a client on a second host without a GPU.

Measures and prints (``[demo]`` lines):
  * frames and end-to-end fps;
  * the client's receive gap, decode and unwarp averages;
  * gaze fan-in latency: a frameRequest sent -> the first frame whose
    echoed centre matches (the gaze's round trip through the server's
    tick), mean, p50, p90, max;
  * wire bytes per second from the client's socket;
  * the server's own gaze-apply percentiles, where its periodic stats line
    came before the end.

Deadlines: 60 s for the server's listen line, 60 s plus one a frame for
the client, then ``terminate``, ``wait(10)`` and ``kill``.  Exit code 1
when the server dies, misses a deadline, or fewer frames arrive than
asked for.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LISTEN_TIMEOUT_S = 60.0
STOP_TIMEOUT_S = 10.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def run_client(port: int, video: str, w: int, h: int, frames: int,
                     unwarp: str, device: str):
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.serve.client import FoveaxClient

    cfg = FoveaxConfig().with_source(w, h)
    client = FoveaxClient(
        f"ws://127.0.0.1:{port}",
        video=video,
        config=cfg,
        gaze_source=lambda i: ((0.3 + 0.01 * i) % 1.0, 0.5),
        max_frames=frames,
        unwarp=unwarp,
        device=device,
    )
    return await client.run()


def _pump(stream, lines: queue.Queue) -> None:
    """Move the server's output lines onto ``lines`` until it closes (the
    pipe never fills, so the server never blocks on its log)."""
    for line in stream:
        lines.put(line)
    lines.put(None)


def wait_listening(server: subprocess.Popen, lines: queue.Queue,
                   seen: list[str]) -> str | None:
    """Wait for the server's listen line; returns None, or why not."""
    deadline = time.monotonic() + LISTEN_TIMEOUT_S
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            return f"server never started listening within {LISTEN_TIMEOUT_S:.0f} s"
        try:
            line = lines.get(timeout=left)
        except queue.Empty:
            continue
        if line is None:
            return f"server died during startup (exit code {server.wait()})"
        seen.append(line)
        if "Listening" in line:
            return None


def stop(server: subprocess.Popen) -> None:
    server.terminate()
    try:
        server.wait(timeout=STOP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        server.kill()
        server.wait()


def report(stats, dt: float) -> None:
    a = stats.averages()
    print(f"[demo] frames: {a['frames']} in {dt:.1f}s "
          f"({a['frames'] / dt:.1f} fps end-to-end)")
    print(f"[demo] avg receive gap: {a['avg_receive_ms']:.1f} ms")
    print(f"[demo] avg decode: {a['avg_decode_ms']:.2f} ms")
    print(f"[demo] avg unwarp: {a['avg_unwarp_ms']:.2f} ms")
    if stats.gaze_apply_ms:
        g = sorted(stats.gaze_apply_ms)

        def p(q):
            return g[min(int(q * len(g)), len(g) - 1)]

        print(f"[demo] gaze fan-in latency (request -> echoed frame): "
              f"mean {a['avg_gaze_apply_ms']:.1f} ms  "
              f"p50 {p(0.5):.1f}  p90 {p(0.9):.1f}  max {g[-1]:.1f} "
              f"(n={len(g)})")
    print(f"[demo] wire: {stats.wire_bytes} bytes in {dt:.1f}s = "
          f"{stats.wire_bytes * 8 / dt / 1e3:.0f} kbit/s "
          f"({stats.wire_bytes * 8 / max(a['frames'], 1) / 1e3:.1f} "
          f"kbit/frame)")
    print("[demo] traffic: JSON gaze messages up, encoded fMP4 down - "
          "no unencoded pixels crossed the process boundary")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    # Small enough by default that a CPU client keeps up with the 30 fps
    # tick: the fan-in measures the server's gaze application only while
    # the client keeps up (a lagging client measures its own backlog).
    ap.add_argument("--resolution", default="320x180")
    ap.add_argument("--server-device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--client-device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--wire-codec", default="auto")
    ap.add_argument(
        "--predict-gaze", default="off", choices=["off", "linear", "kalman"],
        help="server-side gaze prediction (with it on, the echoed centre "
        "is the predicted one, so the matched fan-in reads n/a)",
    )
    ap.add_argument(
        "--client-unwarp", default="auto", choices=["auto", "off"],
        help="off: the client skips the restore, so the fan-in measures "
        "the gaze round trip alone on a client that cannot keep up",
    )
    ap.add_argument("--server-args", default="",
                    help="extra arguments appended to the serve command")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.resolution.split("x"))
    port = free_port()
    video = f"synthetic://{w}x{h}@30/100000"

    if "cuda" in (args.server_device, args.client_device):
        # Built once here, so that neither process runs nvcc (or waits on
        # the other's build) while the stream runs.
        from foveax_torch.kernels.build import SOURCES, build

        build(list(SOURCES))

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    server_cmd = [
        sys.executable, "-m", "foveax_torch.cli.main",
        "--device", args.server_device,
        "serve", "--port", str(port), "--loop",
        "--wire-codec", args.wire_codec,
        "--predict-gaze", args.predict_gaze,
        *args.server_args.split(),
    ]
    print(f"[demo] server on {args.server_device}, client on "
          f"{args.client_device}; starting: {' '.join(server_cmd)}", flush=True)
    server = subprocess.Popen(
        server_cmd, env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: queue.Queue = queue.Queue()
    pump = threading.Thread(target=_pump, args=(server.stdout, lines), daemon=True)
    pump.start()
    seen: list[str] = []
    try:
        why = wait_listening(server, lines, seen)
        if why is not None:
            print("".join(seen), end="")
            print(f"[demo] {why}", file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        try:
            stats = asyncio.run(asyncio.wait_for(
                run_client(port, video, w, h, args.frames, args.client_unwarp,
                           args.client_device),
                timeout=LISTEN_TIMEOUT_S + args.frames,
            ))
        except (asyncio.TimeoutError, OSError) as e:
            print(f"[demo] client failed: {e!r} (server "
                  f"{'alive' if server.poll() is None else 'dead'})",
                  file=sys.stderr)
            return 1
        dt = time.perf_counter() - t0
        report(stats, dt)
    finally:
        stop(server)
        pump.join(timeout=STOP_TIMEOUT_S)
    while True:
        try:
            line = lines.get_nowait()
        except queue.Empty:
            break
        if line is not None:
            seen.append(line)
    for line in seen:
        # The server's gaze-apply percentiles (arrival -> sampling tick),
        # independent of the client and the transport.
        if "gaze_apply" in line:
            print(f"[demo] server {line.strip()}")
    if stats.frames < args.frames:
        print(f"[demo] {stats.frames} of {args.frames} frames arrived",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
