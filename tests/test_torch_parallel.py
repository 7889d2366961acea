"""foveax_torch.parallel on the CPU against foveax.parallel on the
conftest's 8 virtual CPU devices, and against the port's single-device
functions: meshes of CPU entries (one process drives them all), the
same inputs made from a seed with numpy.  Every comparison is bit-equal
(tolerance 0): the sharded SAT is integer arithmetic mod 2^32, the
samplers are bit-identical, and the port's exact unwarp matches foveax's
jitted one (so foveax's functions run under ``jax.jit``).  The mesh
server is served through real websockets and through chip_smoke.py's
in-memory pair, its frames held to the CPU pipeline."""

import asyncio
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from foveax.core.logrect import make_grid as fx_make_grid
from foveax.parallel import make_mesh as fx_make_mesh
from foveax.parallel import sharded as fx
from foveax_torch import FoveaxConfig, FoveationPipeline
from foveax_torch.core.logrect import make_grid
from foveax_torch.core.sat import build_sat
from foveax_torch.kernels.scan2d import as_int64, low32
from foveax_torch.parallel import make_mesh
from foveax_torch.parallel import sharded as pt

torch.set_num_threads(1)

MESHES = [(1, 8), (8, 1), (2, 4), (4, 2)]  # (n_data, n_space)
GAZES = np.array(
    [[0.5, 0.5], [0.25, 0.75], [0.9, 0.1], [0.02, 0.97],
     [0.0, 0.0], [1.0, 1.0], [0.999, 0.001], [0.6, 0.3]],
    np.float32,
)
FUSED = (256, 64, 128, 32)  # source w, h, reduced w, h inside both fused contracts


def _pt_mesh(n_data, n_space):
    return make_mesh(n_space, n_data, devices=["cpu"] * (n_data * n_space))


def _host(x) -> np.ndarray:
    """A port result (tensor or Sharded) as a numpy array, uint32 kept."""
    t = x.cpu()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _grids(w, h, wr, hr):
    return make_grid(wr, hr, w, h, "cpu"), fx_make_grid(wr, hr, w, h)


def _fused_frame():
    w, h, _, _ = FUSED
    return np.random.default_rng(11).integers(0, 256, (h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def mesh2x4():
    return _pt_mesh(2, 4), fx_make_mesh(n_space=4, n_data=2)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2)], ids=["1x8", "2x4", "4x2"])
def test_sharded_sat_matches_foveax(small_frame, shape):
    n_data, n_space = shape
    got = pt.sharded_build_sat(torch.from_numpy(small_frame), _pt_mesh(n_data, n_space))
    assert got.axis == "space" and len(got.blocks) == n_space
    want = fx.sharded_build_sat(
        jnp.asarray(small_frame), fx_make_mesh(n_space=n_space, n_data=n_data)
    )
    np.testing.assert_array_equal(_host(got), np.asarray(want))


def test_multi_client_step_matches_foveax(small_frame, mesh2x4):
    h, w, _ = small_frame.shape
    grid, fgrid = _grids(w, h, 48, 32)
    mesh, fmesh = mesh2x4
    centers = GAZES[:4]
    reduced, restored = pt.multi_client_step(
        torch.from_numpy(small_frame), torch.from_numpy(centers), grid, mesh
    )
    want = jax.jit(lambda f, c: fx.multi_client_step(f, c, fgrid, fmesh))(
        jnp.asarray(small_frame), jnp.asarray(centers)
    )
    assert reduced.axis == restored.axis == "data"
    np.testing.assert_array_equal(_host(reduced), np.asarray(want[0]))
    np.testing.assert_array_equal(_host(restored), np.asarray(want[1]))
    (alone,) = pt.jit_multi_client_step(grid, mesh, unwarp=False)(
        torch.from_numpy(small_frame), torch.from_numpy(centers)
    )
    np.testing.assert_array_equal(_host(alone), np.asarray(want[0]))


def test_sharded_sample_batch_and_sat_pair_match_foveax(small_frame, mesh2x4):
    h, w, _ = small_frame.shape
    grid, fgrid = _grids(w, h, 48, 32)
    mesh, fmesh = mesh2x4
    frame, centers = torch.from_numpy(small_frame), torch.from_numpy(GAZES[4:])
    fbuild, fsample = fx.jit_serve_parts(fgrid, fmesh)
    want = np.asarray(fsample(fbuild(jnp.asarray(small_frame)), jnp.asarray(GAZES[4:])))
    build, sample = pt.jit_serve_parts(grid, mesh)
    np.testing.assert_array_equal(_host(sample(build(frame), centers)), want)
    sat = pt.sharded_build_sat(frame, mesh)
    np.testing.assert_array_equal(
        _host(pt.sharded_sample_batch(sat, centers, grid, mesh)), want
    )


def test_frame_parallel_roundtrip_matches_foveax(small_frame, mesh2x4):
    h, w, _ = small_frame.shape
    grid, fgrid = _grids(w, h, 48, 32)
    mesh, fmesh = mesh2x4
    frames = np.stack([np.roll(small_frame, i * 5, axis=1) for i in range(8)])
    centers = np.random.default_rng(3).uniform(0.2, 0.8, (8, 2)).astype(np.float32)
    reduced, restored = pt.frame_parallel_roundtrip(
        torch.from_numpy(frames), torch.from_numpy(centers), grid, mesh
    )
    assert reduced.axis == ("data", "space") and len(reduced.blocks) == 8
    want = jax.jit(lambda f, c: fx.frame_parallel_roundtrip(f, c, fgrid, fmesh))(
        jnp.asarray(frames), jnp.asarray(centers)
    )
    np.testing.assert_array_equal(_host(reduced), np.asarray(want[0]))
    np.testing.assert_array_equal(_host(restored), np.asarray(want[1]))


def test_fused_batch_and_pair_match_foveax(mesh2x4):
    """The fused sharded sampler against foveax's in interpret mode, as
    ``tests/test_parallel.py`` runs it."""
    w, h, wr, hr = FUSED
    grid, fgrid = _grids(w, h, wr, hr)
    mesh, fmesh = mesh2x4
    frame_np = _fused_frame()
    centers_np = np.random.default_rng(12).uniform(0.05, 0.95, (4, 2)).astype(np.float32)
    frame, centers = torch.from_numpy(frame_np), torch.from_numpy(centers_np)
    want = np.asarray(jax.jit(
        lambda f, c: fx.sharded_sample_batch_fused(f, c, fgrid, fmesh)
    )(jnp.asarray(frame_np), jnp.asarray(centers_np)))
    assert want.shape == (4, hr, wr, 3)
    got = pt.sharded_sample_batch_fused(frame, centers, grid, mesh)
    np.testing.assert_array_equal(_host(got), want)
    prepare, sample = pt.jit_serve_parts_fused(grid, mesh)
    np.testing.assert_array_equal(_host(sample(prepare(frame), centers)), want)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{s}" for d, s in MESHES])
def test_every_function_matches_single_device(small_frame, shape):
    """Each sharded function at each mesh shape equals the port's
    single-device path on the same inputs."""
    mesh = _pt_mesh(*shape)
    h, w, _ = small_frame.shape
    pipe = FoveationPipeline(
        FoveaxConfig(source_width=w, source_height=h, reduced_width=48,
                     reduced_height=32), device="cpu",
    )
    frame, centers = torch.from_numpy(small_frame), torch.from_numpy(GAZES)
    sat = build_sat(frame)
    np.testing.assert_array_equal(_host(pt.sharded_build_sat(frame, mesh)), _host(sat))
    reduced = pipe.sample_batch(sat, centers)
    restored = torch.stack([pipe.unwarp(r, c) for r, c in zip(reduced, centers)])
    got_red, got_rest = pt.multi_client_step(frame, centers, pipe.grid, mesh)
    np.testing.assert_array_equal(_host(got_red), reduced.numpy())
    np.testing.assert_array_equal(_host(got_rest), restored.numpy())
    build, sample = pt.jit_serve_parts(pipe.grid, mesh)
    np.testing.assert_array_equal(_host(sample(build(frame), centers)), reduced.numpy())

    frames = torch.stack([torch.roll(frame, 7 * i, dims=1) for i in range(8)])
    got_red, got_rest = pt.frame_parallel_roundtrip(frames, centers, pipe.grid, mesh)
    for i in range(8):
        red = pipe.sample(build_sat(frames[i]), centers[i])
        np.testing.assert_array_equal(_host(got_red)[i], red.numpy())
        np.testing.assert_array_equal(_host(got_rest)[i], pipe.unwarp(red, centers[i]).numpy())

    w, h, wr, hr = FUSED
    fpipe = FoveationPipeline(
        FoveaxConfig(source_width=w, source_height=h, reduced_width=wr,
                     reduced_height=hr), device="cpu",
    )
    fframe = torch.from_numpy(_fused_frame())
    want = fpipe.sample_batch_fused(fframe, centers).numpy()
    np.testing.assert_array_equal(
        _host(pt.sharded_sample_batch_fused(fframe, centers, fpipe.grid, mesh)), want
    )
    prepare, fsample = pt.jit_serve_parts_fused(fpipe.grid, mesh)
    np.testing.assert_array_equal(_host(fsample(prepare(fframe), centers)), want)


@pytest.mark.parametrize("n", [2, 8])
def test_sat_carry_wraps_as_uint32(n):
    """The carry and its add on values near 2^32, held to numpy's uint32
    arithmetic (which wraps mod 2^32)."""
    rng = np.random.default_rng(n)
    totals = rng.integers(2**32 - 2**20, 2**32, (3, n, 17), dtype=np.uint64).astype(np.uint32)
    local = rng.integers(2**32 - 2**20, 2**32, (3, 5, 17), dtype=np.uint64).astype(np.uint32)
    want = np.cumsum(totals, axis=1, dtype=np.uint32) - totals
    carry = pt._sat_carry(torch.from_numpy(totals.astype(np.int64)))
    np.testing.assert_array_equal(carry.numpy().astype(np.uint32), want)
    got = low32(as_int64(torch.from_numpy(local.view(np.int32)).view(torch.uint32))
                + carry[:, -1, None, :])
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy().view(np.uint32), local + want[:, -1:, :]
    )


def test_mesh_and_shard_checks():
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(4, 2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(1)
    mesh = _pt_mesh(2, 4)
    assert mesh.axis_names == ("data", "space")
    assert mesh.shape == {"data": 2, "space": 4} and mesh.size == 8
    with pytest.raises(ValueError, match="frame rows"):
        pt.sharded_build_sat(torch.zeros((62, 96, 3), dtype=torch.uint8), mesh)
    sat = pt.sharded_build_sat(torch.zeros((64, 96, 3), dtype=torch.uint8), mesh)
    with pytest.raises(ValueError, match="centers"):
        pt.sharded_sample_batch(sat, torch.zeros((3, 2)),
                                make_grid(48, 32, 96, 64, "cpu"), mesh)
    sat = pt.Sharded(
        (torch.tensor([[2**32 - 1]]).to(torch.int32).view(torch.uint32),
         torch.tensor([[7]], dtype=torch.int32).view(torch.uint32)), "space", 0)
    assert sat.gather().dtype == torch.uint32
    assert as_int64(sat.gather()).flatten().tolist() == [2**32 - 1, 7]


def _loopback(server, cfg, n_clients: int, frames: int):
    import websockets

    from foveax_torch.serve.client import FoveaxClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = f"synthetic://{cfg.source_width}x{cfg.source_height}@30/20"
    clients = [
        FoveaxClient(f"ws://127.0.0.1:{port}", video=spec, config=cfg,
                     gaze_source=lambda i, gx=gx: (gx, 0.5), max_frames=frames,
                     device="cpu")
        for gx in np.linspace(0.3, 0.7, n_clients)
    ]

    async def main():
        async with websockets.serve(server.handle, "127.0.0.1", port,
                                    max_size=64 * 1024 * 1024):
            return await asyncio.wait_for(
                asyncio.gather(*(c.run() for c in clients)), timeout=120)

    return asyncio.run(main())


@pytest.mark.parametrize("batch_sampler", ["sat", "fused"])
def test_broadcast_serve_with_mesh(small_frame, batch_sampler):
    """End-to-end loopback: a broadcast server over a 2x4 mesh serves two
    clients 4 frames each (foveax's ``test_broadcast_serve_with_mesh``
    and ``..._fused``; the fused source inside the fused contract)."""
    from foveax_torch.serve.server import FoveaxServer

    w, h, wr, hr = FUSED if batch_sampler == "fused" else (96, 64, 48, 32)
    cfg = FoveaxConfig(source_width=w, source_height=h, reduced_width=wr,
                       reduced_height=hr)
    server = FoveaxServer(cfg, max_frames=8, broadcast=True, mesh=_pt_mesh(2, 4),
                          batch_sampler=batch_sampler, device="cpu")
    stats = _loopback(server, cfg, 2, 4)
    assert all(s.frames == 4 for s in stats)


@pytest.mark.parametrize("batch_sampler", ["fused", "sat"])
def test_mesh_server_frames_equal_cpu_path(batch_sampler):
    """chip_smoke.py's mesh broadcast (4 clients, 6 ticks) on a 2x4 mesh
    of CPU entries: every served and restored frame equal to the
    single-device CPU pipeline's."""
    cfg = FoveaxConfig(source_width=96, source_height=64, reduced_width=48,
                       reduced_height=32)
    server, clients, _ = chip_smoke.serve_broadcast(
        cfg, "cpu", batch_sampler, mesh=_pt_mesh(2, 4))
    assert server.channels == {} and all(c.stats.frames for c in clients)


def test_sat_mesh_needs_space_to_divide_height():
    from foveax_torch.serve.server import BroadcastChannel, FoveaxServer

    cfg = FoveaxConfig(source_width=96, source_height=60, reduced_width=48,
                       reduced_height=32)
    server = FoveaxServer(cfg, broadcast=True, mesh=_pt_mesh(1, 8),
                          batch_sampler="sat", device="cpu")
    channel = BroadcastChannel(server, "synthetic://96x60@30/4")
    channel.pipeline = server._pipeline_for(96, 60)
    with pytest.raises(ValueError, match="must divide the source height"):
        channel._sharded_pair(cfg)


def test_dryrun_multichip_cpu():
    from foveax_torch.graft_entry import dryrun_multichip

    out = dryrun_multichip(8, device="cpu")
    assert out["multi_client_step.reduced"].shape == (4, 16, 32, 3)
    assert out["frame_parallel_roundtrip.restored"].shape == (8, 32, 64, 3)
    assert torch.equal(out["jit_serve_parts"], out["multi_client_step.reduced"])
    assert torch.equal(out["jit_serve_parts_fused"], out["sharded_sample_batch_fused"])
    assert list(k for k in out if k.startswith("placement.")) == ["placement.cpu"]


def test_entry_matches_foveax():
    """The flagship 1080p step: the port's fused sampler and exact
    unwarp against foveax's ``entry`` (its direct sampler, bit-identical)
    under ``jax.jit``."""
    import __graft_entry__

    from foveax_torch.graft_entry import entry

    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (1080, 1920, 3), np.uint8)
    center = np.array([0.37, 0.61], np.float32)
    step, (f0, c0) = entry("cpu")
    assert f0.shape == frame.shape and c0.shape == (2,)
    got = step(torch.from_numpy(frame), torch.from_numpy(center))
    fstep, _ = __graft_entry__.entry()
    want = jax.jit(fstep)(jnp.asarray(frame), jnp.asarray(center))
    for g, w_ in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_phase_mesh_on_cpu():
    """chip_smoke.py's phase 9 end to end with CPU entries at a small
    size: every sharded call equal to the single-device path, the dry
    run, the mesh server's frames, round-robin placement, the timings."""
    cfg = FoveaxConfig(source_width=256, source_height=64, reduced_width=128,
                       reduced_height=32)
    serve_cfg = FoveaxConfig(source_width=96, source_height=64, reduced_width=48,
                             reduced_height=32)
    report = chip_smoke.phase_mesh(None, cfg, serve_cfg, device="cpu")
    assert report["gather"]["peer_bytes"] == 0
    assert {"tick_sat_ms", "tick_fused_ms", "single_sat_ms", "single_fused_ms"} <= set(report)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_shapes_match_single_device(seed):
    """``scripts/fuzz_sharded.py``'s invariants at random shapes, gaze
    batches and mesh shapes: the sharded SAT, the SAT pair, the sharded
    step and (inside its contract) the fused pair equal the port's
    single-device path."""
    rng = np.random.default_rng(100 + seed)
    n_data, n_space = MESHES[seed]
    mesh = _pt_mesh(n_data, n_space)
    w = int(rng.integers(16, 200))
    h = n_space * int(rng.integers(2, 12))
    wr, hr = int(rng.integers(4, w + 1)), int(rng.integers(2, h + 1))
    pipe = FoveationPipeline(
        FoveaxConfig(source_width=w, source_height=h, reduced_width=wr,
                     reduced_height=hr), device="cpu",
    )
    frame = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
    centers = torch.from_numpy(
        rng.uniform(0, 1, (n_data * int(rng.integers(1, 4)), 2)).astype(np.float32))
    sat = build_sat(frame)
    np.testing.assert_array_equal(_host(pt.sharded_build_sat(frame, mesh)), _host(sat))
    reduced = pipe.sample_batch(sat, centers)
    build, sample = pt.jit_serve_parts(pipe.grid, mesh)
    np.testing.assert_array_equal(_host(sample(build(frame), centers)), reduced.numpy())
    got_red, got_rest = pt.multi_client_step(frame, centers, pipe.grid, mesh)
    np.testing.assert_array_equal(_host(got_red), reduced.numpy())
    np.testing.assert_array_equal(
        _host(got_rest),
        torch.stack([pipe.unwarp(r, c) for r, c in zip(reduced, centers)]).numpy())
    if pipe.fused_ok:
        prepare, fsample = pt.jit_serve_parts_fused(pipe.grid, mesh)
        np.testing.assert_array_equal(_host(fsample(prepare(frame), centers)),
                                      reduced.numpy())
