"""Sanitizer lanes for the port's native layer (counterpart of the JAX
package's ``scripts/fuzz_native_{demux,codec}.sh``).

    python -m foveax_torch.scripts.fuzz_native {demux,codec} [seed] [iters]

Builds a fuzzer from ``foveax_torch/native/fuzz/`` against the
port's own source, ``native/fmp4.cc`` (``demux``) or ``native/codec.cc``
(``codec``, linked with FFmpeg), with ``g++ -O1 -g
-fsanitize=address,undefined -std=c++17``, runs it and removes it.  The
binary goes to ``foveax_torch/native/build/`` under a name that carries
the process id, so concurrent lanes (test workers, the JAX package's
lanes) never share a path.  A UBSan report stops the run
(``UBSAN_OPTIONS=halt_on_error=1`` unless set), so any memory error,
undefined behaviour or leaked handle is a non-zero exit code; a clean run
prints ``clean``.  Without FFmpeg's headers the ``codec`` lane prints
``skipped`` and exits 0.  Exit code 2 without ``g++``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD = NATIVE / "build"
FLAGS = ["-O1", "-g", "-fsanitize=address,undefined", "-std=c++17"]
LANES = {  # lane -> (port source, libraries, default iterations)
    "demux": ("fmp4.cc", [], 200),
    "codec": ("codec.cc", ["-lavcodec", "-lavutil", "-lswscale"], 40),
}
BUILD_TIMEOUT_S = 300


def binary_path(lane: str) -> Path:
    """Where this process builds ``lane``'s fuzzer."""
    return BUILD / f"fuzz_native_{lane}.{os.getpid()}"


def have_ffmpeg_headers(cxx: str) -> bool:
    """The native Makefile's probe: does the compiler find libavcodec's
    header?"""
    probe = subprocess.run(
        [cxx, "-E", "-x", "c++", "-include", "libavcodec/avcodec.h", os.devnull],
        capture_output=True, timeout=60,
    )
    return probe.returncode == 0


def build_command(lane: str, cxx: str, out: Path) -> list[str]:
    source, libs, _ = LANES[lane]
    return [cxx, *FLAGS, str(NATIVE / "fuzz" / f"fuzz_native_{lane}.cc"),
            str(NATIVE / source), "-o", str(out), *libs]


def run_lane(lane: str, seed: int, iters: int) -> int:
    """Build, run and remove ``lane``'s fuzzer; returns its exit code."""
    cxx = shutil.which("g++")
    if cxx is None:
        print("fuzz_native: g++ unavailable", file=sys.stderr)
        return 2
    if lane == "codec" and not have_ffmpeg_headers(cxx):
        print("fuzz_native codec: FFmpeg headers unavailable, skipped", flush=True)
        return 0
    BUILD.mkdir(parents=True, exist_ok=True)
    out = binary_path(lane)
    try:
        built = subprocess.run(build_command(lane, cxx, out), capture_output=True,
                               text=True, timeout=BUILD_TIMEOUT_S)
        if built.returncode != 0:
            print(f"fuzz_native {lane}: build failed\n{built.stderr}", file=sys.stderr)
            return built.returncode
        env = dict(os.environ)
        env.setdefault("UBSAN_OPTIONS", "halt_on_error=1:print_stacktrace=1")
        return subprocess.run([str(out), str(seed), str(iters)], env=env).returncode
    finally:
        out.unlink(missing_ok=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lane", choices=sorted(LANES))
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("iters", nargs="?", type=int,
                    help="iterations (default 200 for demux, 40 for codec)")
    args = ap.parse_args(argv)
    iters = LANES[args.lane][2] if args.iters is None else args.iters
    return run_lane(args.lane, args.seed, iters)


if __name__ == "__main__":
    sys.exit(main())
