#!/usr/bin/env python3
"""Band-height sweep of the SAT kernels K5 and K6 on one GPU.

    PYTHONPATH=. python3 scripts/sat_band_sweep.py [R ...]

For each band height R (default 8 16 32 64 128) it sets
``foveax_torch.kernels.scan2d.BAND_ROWS``, holds K5 (both layouts) and K6
bit-equal to their plain versions on a random 4K frame (K6 with the row
taps of gaze (0.5, 0.5), n = 1200), and prints one JSON line per R with
each kernel's ``ms_queued``, timed as ``chip_smoke.py`` times it (L2
flushed, the card kept busy while the host enqueues; median of 50), and
the device time of each CUDA kernel a call launches (``torch.profiler``,
mean over 20 calls, L2 flushed before each), in microseconds.  The last
line is the card's name and power limit.
"""

from __future__ import annotations

import json
import re
import sys

import torch

import chip_smoke
from foveax_torch.kernels import fused_select as fs
from foveax_torch.kernels import scan2d
from foveax_torch.kernels import segreduce as sr
from foveax_torch.kernels.build import build


def phase_us(fn, args, flush: torch.Tensor, reps: int = 20) -> dict[str, float]:
    """Mean device time per call of each CUDA kernel ``fn(*args)``
    launches, by kernel name (the flush's own kernel left out)."""
    fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.zero_()
            fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t and "kernel" in e.key and "fill" not in e.key.lower():
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            out[name.removeprefix("void ")] = round(t / reps, 3)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("sat_band_sweep: no CUDA device", file=sys.stderr)
        return 1
    bands = [int(a) for a in argv] or [8, 16, 32, 64, 128]
    entry = ""
    for line in build(["scan2d"])["scan2d"].splitlines():
        m = re.search(r"Compiling entry function '.*?\d+(\w+?_kernel)(\w*)'", line)
        if m:  # the kernel and its template arguments, from the mangled name
            entry = m.group(1) + str(re.findall(r"Li(\d+)E", m.group(2)))
        elif "spill" in line or "Used" in line:
            print(f"{entry}: {line.strip()}")
    pipe = chip_smoke.make_pipeline("4k", "cuda")
    chw = chip_smoke.make_frame(pipe, chip_smoke.SEED + 2)
    hwc = chw.permute(1, 2, 0).contiguous()
    rcw = chw.permute(1, 0, 2).contiguous()
    centers = torch.tensor([[0.5, 0.5]], dtype=torch.float32, device="cuda")
    *_, pyc, pymc, _ = sr.fused_taps(pipe.grid, chw, centers)
    pyc, pymc = pyc[0], pymc[0]
    want = scan2d.sat_scan_plain(chw)
    want_sel = fs.sat_select_rows_plain(rcw, pyc, pymc)
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")
    spin = chip_smoke.spin_cycles(chip_smoke.SPIN_MS)
    cases = {
        "sat_build chw": (lambda f: scan2d.sat_scan(f, in_layout="chw"), (chw,)),
        "sat_build hwc": (lambda f: scan2d.sat_scan(f, in_layout="hwc"), (hwc,)),
        "sat_select_rows": (fs.sat_select_rows, (rcw, pyc, pymc)),
    }
    for r in bands:
        scan2d.BAND_ROWS = r
        for layout, frame in (("chw", chw), ("hwc", hwc)):
            chip_smoke.check_equal("sat_build", scan2d.sat_scan(frame, in_layout=layout),
                                   want, f"R={r} {layout}")
        for got, w_ in zip(fs.sat_select_rows(rcw, pyc, pymc), want_sel):
            chip_smoke.check_equal("sat_select_rows", got, w_, f"R={r}")
        row = {"band_rows": r}
        for name, (fn, args) in cases.items():
            row[name] = chip_smoke.time_cuda(fn, args, 50, flush, spin)
            row[name + " us by kernel"] = phase_us(fn, args, flush)
        print(json.dumps(row), flush=True)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
