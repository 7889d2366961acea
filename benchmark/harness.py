"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
names the cell's configuration and traffic mix, ``configs/<config>.json``
holds the shapes and the limits of the check, ``traffic/<mix>.json`` the
inputs and the driver, ``drivers/<driver>.py`` how a unit drives the
port, ``end_to_end/<metric>.py`` and ``metrics/<metric>.py`` how each
metric is read, ``roofline/<kernel>.py`` a kernel's least bytes and
operations.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import trace as tracing
from benchmark.inputs import Inputs, Reservoir

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# Top-level module names that must never be loaded with the port.
FORBIDDEN = ("jax", "jaxlib", "flax", "foveax")
# The traced stretch: it starts this share into the window and ends after
# TRACE_SECONDS or TRACE_UNITS units, whichever comes first.
TRACE_FROM = 0.25
TRACE_SECONDS = 2.0
TRACE_UNITS = 1500


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: those
    loaded), each compared whole: ``foveax_torch`` is not ``foveax``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]  # the manifest's entries this cell reports
    per_layer: list[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    manifest = manifest or _load_json(CHECKOUT / "BENCHMARK.json")
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, _load_json(CHECKOUT / conf["file"]),
                _load_json(ROOT / "traffic" / f"{w['traffic']}.json"), int(w["chips"]), e2e, layer)


@dataclasses.dataclass
class Run:
    """What the end-to-end readers read."""

    units: int
    viewers: int
    window_s: float
    latencies: list[float]
    setup_s: float


@dataclasses.dataclass
class Ctx:
    """What a driver's ``make`` is given."""

    pipeline: object
    inputs: Inputs
    config: dict
    traffic: dict


def smi() -> str:
    """The card's name, power limit, SM clock and temperature, as
    ``nvidia-smi`` reads them (empty where it cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


def cpu_probe_ms(reps: int = 5) -> float:
    """Median time of a fixed piece of pure-Python work (about 5 to 12 ms
    on the card's host): the host's speed, which sets the pace of the
    cells whose units are bound by the host."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        s = 0
        for i in range(200_000):
            s += i
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def check(records, config: dict, device, *, log) -> dict[str, int]:
    """Compare every sampled unit's output with the plain reference.
    Returns each number compared (the configuration holds its limit)."""
    from benchmark.reference.foveation import BoxFilter, Unwarp

    nums: dict[str, int] = {}
    w, h = config["source_width"], config["source_height"]
    wr, hr = config["reduced_width"], config["reduced_height"]
    box = unwarp = None
    worst = 0
    for kind, key, gaze, out, frame in sorted(records, key=lambda r: (r[0], r[1])):
        if kind == "reduced":
            box = box or BoxFilter(w, h, wr, hr)
            nums.setdefault("reduced_bytes_off", 0)
            f = torch.from_numpy(frame).to(device)
            for v in range(len(gaze)):
                ref = box(f, gaze[v], key=key)
                got = torch.from_numpy(out[v]).to(device)
                nums["reduced_bytes_off"] += int((ref != got).sum())
            del f
        elif kind == "restored":
            unwarp = unwarp or Unwarp(w, h)
            nums.setdefault("restore_bytes_over_1lsb", 0)
            nums.setdefault("restore_fovea_bytes_off", 0)
            ref, fovea = unwarp(torch.from_numpy(frame).to(device), gaze[0])
            d = (torch.from_numpy(out).to(device).to(torch.int16) - ref.to(torch.int16)).abs()
            nums["restore_bytes_over_1lsb"] += int((d > 1).sum())
            nums["restore_fovea_bytes_off"] += int(((d != 0) & fovea[..., None]).sum())
            worst = max(worst, int(d.max()))
        else:
            raise ValueError(f"unknown output kind {kind!r}")
    if unwarp is not None:
        log(f"restored frames checked: {len(records)}, largest |difference| {worst}")
    return nums


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
             t_start: float, patch=None, log=None) -> dict:
    """One run of ``cell``; returns the result line's object.  ``t_start``
    is the process's start on the ``time.perf_counter`` clock; ``patch``,
    given the pipeline, may put something in the program's place (the
    control, the fault tests)."""
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.kernels import build
    from foveax_torch.pipeline.frames import FoveationPipeline

    log = log or (lambda s: print(s, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.set_num_threads(1)
    config, traffic = cell.config, cell.traffic
    nvcc_before = build.nvcc_runs
    pipeline = FoveationPipeline(FoveaxConfig(
        source_width=config["source_width"], source_height=config["source_height"],
        reduced_width=config["reduced_width"], reduced_height=config["reduced_height"],
        fps=float(config["fps"])), device=dev)
    if patch is not None:
        patch(pipeline)
    inputs = Inputs(seed, config, traffic, dev)
    driver = tracing.load_module("drivers", traffic["driver"])
    unit = driver.make(Ctx(pipeline, inputs, config, traffic))

    for k in range(int(traffic["warm_units"])):
        unit(-1 - k)
    if trace:  # the profiler's first start initialises the device tracer
        prof = tracing.start()
        unit(-1)
        tracing.stop(prof)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded with the port: {', '.join(found)}")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    compiled = build.nvcc_runs - nvcc_before

    sample = Reservoir(int(traffic["check_units"]), inputs.check_rng)
    latencies: list[float] = []
    starts: list[float] = []
    prof, traced, trace_units, trace_k0 = None, None, 0, 0
    k = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        starts.append(now)
        if trace and prof is None and now - t0 >= TRACE_FROM * seconds:
            prof, trace_t0, trace_k0 = tracing.start(), time.perf_counter(), k
        latency, (kind, i, gaze, out) = unit(k)
        latencies.append(latency)
        sample.offer((kind, i, gaze, out, inputs.pool[i]))
        if prof is not None and traced is None:
            trace_units += 1
            if trace_units >= TRACE_UNITS or time.perf_counter() - trace_t0 >= TRACE_SECONDS:
                traced = tracing.stop(prof)
        k += 1
    window_s = time.perf_counter() - t0
    if prof is not None and traced is None:
        traced = tracing.stop(prof)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded with the port: {', '.join(found)}")

    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    log(f"card: {card}, count {torch.cuda.device_count() if cuda else 0}; nvidia-smi: {smi() if cuda else ''}")
    log(f"cell {cell.name}: sampler {pipeline.sampler} (config resolves_to {config['resolves_to']}), "
        f"units {k}, viewers {inputs.viewers}, window {window_s:.6f} s, setup {setup_s:.6f} s, "
        f"set-up compiled {compiled} source(s), window peak {peak} bytes, host pool {inputs.pool_bytes} bytes")
    if k > 1:
        unit_ms = np.diff(np.append(starts, t0 + window_s)) * 1e3
        half = k // 2
        log(f"unit ms: median {np.median(unit_ms):.4f}, p5 {np.percentile(unit_ms, 5):.4f}, "
            f"p95 {np.percentile(unit_ms, 95):.4f}, max {unit_ms.max():.4f}; units/s first half "
            f"{half / (starts[half] - t0):.3f}, second half {(k - half) / (t0 + window_s - starts[half]):.3f}; "
            f"latency ms median {np.median(latencies) * 1e3:.4f}")
        per_s = np.bincount(((np.asarray(starts) - t0)).astype(np.int64), minlength=int(window_s))
        log(f"units started in each second of the window: {per_s.tolist()}")
    log(f"CPU probe after the window: {cpu_probe_ms():.4f} ms")
    if k < int(traffic["check_units"]):
        log(f"only {k} units completed in the window, fewer than the {traffic['check_units']} checked")

    run = Run(k, inputs.viewers, window_s, latencies, setup_s)
    result_metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": card, "count": 1 if cuda else 0,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        cell_shapes = {key: config[key] for key in
                       ("source_width", "source_height", "reduced_width", "reduced_height")}
        cell_shapes["viewers"] = inputs.viewers
        summary = tracing.summarize(traced, driver.SPANS, trace_units, cell_shapes, tracing.card_peak(card))
        summary.latencies = latencies[:trace_k0] + latencies[trace_k0 + trace_units:]
        counts = {n: sorted(set(summary.per_span(n))) for n in driver.SPANS}
        log(f"traced {summary.units} units over {summary.window_s:.6f} s: {len(summary.ops)} device "
            f"operations ({summary.unmatched} with no launch found, {summary.unnamed} unnamed records "
            f"left out), busy {summary.busy_s:.6f} s; kernels a unit by step: {counts}")
        for m in cell.per_layer:
            v = tracing.load_module("metrics", m["name"]).read(summary)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        breakdown = tracing.breakdown(summary)
        del traced, summary
    else:
        for m in cell.end_to_end:
            v = tracing.load_module("end_to_end", m["name"]).read(run)
            result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # The program's state goes before the reference runs beside it.
    records = sample.items
    del unit, pipeline, latencies, sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check(records, config, dev, log=log)
    limits = config["limits"]
    checks = {n: {"value": v, "limit": limits[n]} for n, v in nums.items()}
    correct = bool(records) and all(v <= limits[n] for n, v in nums.items())
    result = {"correct": correct, "attempted": k * inputs.viewers, "failed": 0,
              "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """Print the numbers compared, each beside its limit, as the last
    lines of standard error, then the result as the last line of standard
    output."""
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct: {str(result['correct']).lower()}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
