"""The readings the check's limits are set from, on the card at a cell's
own size: the program over many seeds (the lower readings) and the
control over a few (the upper readings), in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 7 8 9 [--seconds 2]

The control is the plain reference put in the program's place and
computed one precision lower (``reference/foveation.py``,
``precision="control"``: float32 box sums, a bfloat16 blend).  Each run
is a short window at the cell's own load that completes at least as many
units as a run checks, judged as a run judges.  The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_patch(config: dict):
    """Put the reference at ``precision="control"`` in the place of the
    pipeline's samplers and unwarp."""
    from benchmark.reference.foveation import BoxFilter, Unwarp

    box = BoxFilter(config["source_width"], config["source_height"], config["reduced_width"],
                    config["reduced_height"], precision="control")
    unwarp = Unwarp(config["source_width"], config["source_height"], precision="control")

    def identity(frame):
        return frame

    def sample_one(frame, center):
        return box(frame, center.tolist())

    def sample_batch(frame, centers):
        return torch.stack([box(frame, c) for c in centers.tolist()])

    def patch(pipeline):
        pipeline.single_pair = lambda: (identity, sample_one)
        pipeline.batch_pair = lambda batch_sampler="auto": (identity, sample_batch)
        pipeline.unwarp_auto = lambda reduced, center: unwarp(reduced, center.tolist())[0]

    return patch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness import load_cell, run_cell

    cell = load_cell(args.workload)
    quiet = lambda s: None  # noqa: E731
    lower: dict[str, int] = {}
    upper: dict[str, int] = {}
    for label, seeds, patch in (("program", args.seeds, None),
                                ("control", args.control_seeds, control_patch(cell.config))):
        for seed in seeds:
            r = run_cell(cell, seed, args.seconds, False, device="cuda:0",
                         t_start=time.perf_counter(), patch=patch, log=quiet)
            nums = {n: c["value"] for n, c in r["checks"].items()}
            print(f"{args.workload} {label} seed {seed}: correct {r['correct']}, units "
                  f"{r['attempted']}, {nums}", flush=True)
            into = lower if patch is None else upper
            for n, v in nums.items():
                into[n] = max(into.get(n, v), v) if patch is None else min(into.get(n, v), v)
    print(f"{args.workload} lower readings (largest over program seeds): {lower}")
    print(f"{args.workload} upper readings (smallest over control seeds): {upper}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
