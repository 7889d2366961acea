"""The benchmark of foveax_torch's served path on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up,
a closed loop of ``--seconds`` seconds, the check against the plain
reference, and a JSON result as the last line of standard output.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch of the window.  Exits non-zero
with no result where no CUDA card (or too few) is visible, where the
port cannot be imported, and where JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock, from
    /proc (to 10 ms); now, where /proc cannot tell."""
    now = time.perf_counter()
    try:
        import os

        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


T_START = _process_start()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card", file=sys.stderr)
        return 2
    from benchmark.harness import load_cell, report, run_cell

    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                      t_start=T_START)
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
