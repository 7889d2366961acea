"""Entry points of the port (counterpart of ``__graft_entry__.py``):
the flagship single-device step and a multi-device dry run.

    python -m foveax_torch.graft_entry [N] [--device cpu]

runs :func:`dryrun_multichip` over an N-entry mesh (default 8) and prints
``dryrun_multichip(N) OK``.
"""

from __future__ import annotations

import numpy as np
import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.core.logrect import make_grid
from foveax_torch.core.unwarp import unwarp_rect
from foveax_torch.device import resolve_device
from foveax_torch.kernels.segreduce import fused_eligible, sample_rect_fused


def entry(device: str | torch.device | None = None):
    """``(fn, example_args)``: the foveated-streaming device step at the
    reference's flagship 1920x1080 -> 1072x608 — the fused sampler
    (``segreduce_xy`` on the card) on an (H, W, 3) frame, then the exact
    unwarp, as the JAX package's entry restores.  The JAX package's entry
    samples with its direct sampler; this one keeps the fused sampler, the
    kernel the card's hot path runs, whose output is bit-identical to it.
    On ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    cfg = FoveaxConfig()
    grid = make_grid(
        cfg.reduced_width, cfg.reduced_height, cfg.source_width,
        cfg.source_height, dev,
    )

    def step(frame, center):
        reduced = sample_rect_fused(frame, grid, center, in_layout="hwc")
        restored = unwarp_rect(reduced, cfg.source_width, cfg.source_height, center)
        return reduced, restored

    frame = torch.zeros(
        (cfg.source_height, cfg.source_width, 3), dtype=torch.uint8, device=dev
    )
    center = torch.tensor([0.5, 0.5], dtype=torch.float32, device=dev)
    return step, (frame, center)


def dryrun_mesh_devices(n_devices: int, device: str | torch.device | None = None):
    """The ``n_devices`` entries of the dry run's mesh: the visible CUDA
    devices in turn (one card: ``cuda:0`` every time), or the CPU
    ``n_devices`` times with ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    return [torch.device("cuda", k % count) for k in range(n_devices)]


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> dict:
    """Run each sharded serving step once over an ``n_devices`` mesh at
    tiny shapes (``space`` x ``data``, data 2 where ``n_devices`` is even),
    on the card unless ``device="cpu"``.  Returns every output, gathered
    to the host, by name: ``multi_client_step`` (reduced, restored), the
    ``jit_serve_parts`` pair, ``frame_parallel_roundtrip`` (reduced,
    restored), ``sharded_sample_batch_fused``, the
    ``jit_serve_parts_fused`` pair, and per distinct mesh device the
    single-device pipeline's sample (the ``round_robin`` placement)."""
    from foveax_torch.parallel import (
        frame_parallel_roundtrip,
        make_mesh,
        multi_client_step,
        sharded_sample_batch_fused,
    )
    from foveax_torch.parallel.sharded import jit_serve_parts, jit_serve_parts_fused
    from foveax_torch.pipeline.frames import FoveationPipeline

    n_data = 2 if n_devices % 2 == 0 else 1
    n_space = n_devices // n_data
    devices = dryrun_mesh_devices(n_devices, device)
    mesh = make_mesh(n_space, n_data, devices=devices)
    home = mesh.devices[0][0]

    src_w, src_h = 64, 8 * n_space  # rows divide evenly over `space`
    out_w, out_h = 32, 16
    grid = make_grid(out_w, out_h, src_w, src_h, home)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(home)

    frame = put(rng.integers(0, 256, size=(src_h, src_w, 3), dtype=np.uint8))
    centers = put(rng.uniform(0.1, 0.9, size=(2 * n_data, 2)).astype(np.float32))
    out = {}
    reduced, restored = multi_client_step(frame, centers, grid, mesh, unwarp=True)
    out["multi_client_step.reduced"] = reduced.cpu()
    out["multi_client_step.restored"] = restored.cpu()
    assert out["multi_client_step.reduced"].shape == (2 * n_data, out_h, out_w, 3)
    assert out["multi_client_step.restored"].shape == (2 * n_data, src_h, src_w, 3)

    # The broadcast server's split build/sample closures (serve --mesh).
    build, sample = jit_serve_parts(grid, mesh)
    out["jit_serve_parts"] = sample(build(frame), centers).cpu()

    # Frame-parallel offline transcode over every entry.
    frames = put(rng.integers(0, 256, size=(n_devices, src_h, src_w, 3), dtype=np.uint8))
    centers_b = put(rng.uniform(0.1, 0.9, size=(n_devices, 2)).astype(np.float32))
    red_b, rest_b = frame_parallel_roundtrip(frames, centers_b, grid, mesh)
    out["frame_parallel_roundtrip.reduced"] = red_b.cpu()
    out["frame_parallel_roundtrip.restored"] = rest_b.cpu()
    assert out["frame_parallel_roundtrip.restored"].shape == (n_devices, src_h, src_w, 3)

    # The SAT-free fused sampler, data-parallel over the gazes, at a shape
    # inside its contract; then the serve loop's closures for it.
    fsrc_w, fsrc_h, fout_w, fout_h = 256, 64, 128, 32
    fgrid = make_grid(fout_w, fout_h, fsrc_w, fsrc_h, home)
    assert fused_eligible(fgrid)
    fframe = put(rng.integers(0, 256, size=(fsrc_h, fsrc_w, 3), dtype=np.uint8))
    out["sharded_sample_batch_fused"] = sharded_sample_batch_fused(
        fframe, centers, fgrid, mesh
    ).cpu()
    assert out["sharded_sample_batch_fused"].shape == (2 * n_data, fout_h, fout_w, 3)
    prepare, fsample = jit_serve_parts_fused(fgrid, mesh)
    out["jit_serve_parts_fused"] = fsample(prepare(fframe), centers).cpu()

    # Video-set placement (serve --place-videos round_robin): a pipeline
    # bound to each device, its result on that device.
    cfg = FoveaxConfig(
        source_width=src_w, source_height=src_h, reduced_width=out_w,
        reduced_height=out_h,
    )
    for dev in dict.fromkeys(mesh.flat()):
        p = FoveationPipeline(cfg, sampler="sat", device=dev)
        red_d = p.sample(p.build_sat(frame.to(dev)), p.center(0.25, 0.75))
        assert red_d.device == dev, (dev, red_d.device)
        out[f"placement.{dev}"] = red_d.cpu()
    return out


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=8)
    parser.add_argument("--device", default=None, help="cpu, or cuda (default)")
    args = parser.parse_args()
    dryrun_multichip(args.n_devices, args.device)
    print(f"dryrun_multichip({args.n_devices}) OK")
