"""foveax_torch's server and client through real websockets on the CPU,
held against foveax (tolerance 0 unless stated): each reduced frame the
server hands its encoder equals foveax's ``FoveationPipeline.foveate`` of
the same source frame at the gaze the frame's ``FrameMeta`` echoes, and
each frame the client restores equals foveax's fused unwarp
(``unwarp_rect_fused(..., interpret=True)``) of the decoded reduced frame
where foveax's fused unwarp takes the shape (1280x640), or lies within
1 LSB of foveax's exact unwarp with the fovea bit-exact where it does not
(96x64).  In the SVD serve mode the blobs are bit-equal to foveax's and
the restored frames lie within a stated bound of foveax's client path.
The foveax references are jitted with the gaze traced."""

import asyncio
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CapturingClient, CapturingServer, synthetic_frames
from foveax.config import FoveaxConfig as FxConfig
from foveax.core.unwarp import unwarp_rect as fx_unwarp_rect
from foveax.kernels.unwarp_pl import unwarp_rect_fused as fx_unwarp_fused
from foveax.pipeline.frames import FoveationPipeline as FxPipeline
from foveax_torch import FoveaxConfig

torch.set_num_threads(1)

GAZES = [(0.5, 0.5), (0.3, 0.4), (0.7, 0.6), (0.2, 0.8)]
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _configs(w, h, wr, hr):
    kw = dict(source_width=w, source_height=h, reduced_width=wr, reduced_height=hr)
    return FoveaxConfig(**kw), FxConfig(**kw)


def _loopback(server, clients):
    port = _free_port()
    for c in clients:
        c.uri = f"ws://127.0.0.1:{port}"

    async def main():
        import websockets

        async with websockets.serve(
            server.handle, "127.0.0.1", port, max_size=64 * 1024 * 1024
        ):
            return await asyncio.wait_for(
                asyncio.gather(*(c.run() for c in clients)), timeout=TIMEOUT_S
            )

    return asyncio.run(main())


def _center(meta):
    return jnp.asarray([meta.centerX, meta.centerY], jnp.float32)


def _session(cfg, spec, n):
    server = CapturingServer(cfg, max_frames=n, wire_codec="jpeg", device="cpu")
    client = CapturingClient(
        "", video=spec, config=cfg, max_frames=n, device="cpu",
        gaze_source=lambda i: GAZES[i % len(GAZES)],
    )
    _loopback(server, [client])
    assert client.stats.frames == n == len(server.encoded) == len(client.decoded)
    return server, client


def _check_reduced(fx_pipe, spec, n, server, client):
    """A session's i-th encoded frame is the reduced frame of the i-th
    frame the client received."""
    sources = synthetic_frames(spec, n)
    for encoded, (_, meta) in zip(server.encoded, client.restored):
        want = fx_pipe.foveate(jnp.asarray(sources[meta.frameNum]), _center(meta))
        np.testing.assert_array_equal(encoded, np.asarray(want))


def test_session_bit_equal_to_foveax_fused_unwarp():
    cfg, fx_cfg = _configs(1280, 640, 720, 368)
    spec, n = "synthetic://1280x640@30/4", 4
    server, client = _session(cfg, spec, n)
    _check_reduced(FxPipeline(fx_cfg), spec, n, server, client)
    fused = jax.jit(lambda r, c: fx_unwarp_fused(r, 1280, 640, c, interpret=True))
    for (full, meta), decoded in zip(client.restored, client.decoded):
        want = np.asarray(fused(jnp.asarray(decoded), _center(meta)))
        np.testing.assert_array_equal(full, want)


def test_session_off_fused_contract_within_one_lsb_of_exact():
    """96x64: foveax's fused unwarp refuses the width, so the restored
    frame is held to foveax's exact unwarp."""
    cfg, fx_cfg = _configs(96, 64, 48, 32)
    spec, n = "synthetic://96x64@30/6", 6
    server, client = _session(cfg, spec, n)
    _check_reduced(FxPipeline(fx_cfg), spec, n, server, client)
    exact = jax.jit(lambda r, c: fx_unwarp_rect(r, 96, 64, c))
    for (full, meta), decoded in zip(client.restored, client.decoded):
        want = np.asarray(exact(jnp.asarray(decoded), _center(meta)))
        d = np.abs(full.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, (d.max(), (d > 1).sum())
        cx = int(np.float32(meta.centerX) * np.float32(96))
        cy = int(np.float32(meta.centerY) * np.float32(64))
        ys, xs = slice(max(cy - 3, 0), cy + 3), slice(max(cx - 3, 0), cx + 3)
        np.testing.assert_array_equal(full[ys, xs], want[ys, xs])


@pytest.mark.parametrize("batch_sampler", ["fused", "sat"])
def test_broadcast_reduced_frames_bit_equal_to_foveax(batch_sampler):
    """Three clients on one channel: foveax's foveate of every frame the
    clients received, each at its echoed gaze, is one of the reduced
    frames the server encoded (one to one)."""
    cfg, fx_cfg = _configs(96, 64, 48, 32)
    spec, ticks = "synthetic://96x64@30/30", 8
    server = CapturingServer(cfg, max_frames=ticks, broadcast=True, wire_codec="jpeg",
                             batch_sampler=batch_sampler, device="cpu")
    clients = [
        CapturingClient("", video=spec, config=cfg, max_frames=4, device="cpu",
                        gaze_source=lambda i, g=g: g)
        for g in GAZES[1:]
    ]
    _loopback(server, clients)
    fx_pipe = FxPipeline(fx_cfg)
    sources = synthetic_frames(spec, ticks)
    expected = sorted(
        np.asarray(fx_pipe.foveate(jnp.asarray(sources[m.frameNum]), _center(m))).tobytes()
        for c in clients for _, m in c.restored
    )
    assert all(c.stats.frames == 4 for c in clients)
    # Frames encoded for a tick the clients no longer waited for are not
    # received: every received frame must be among the encoded ones.
    encoded = sorted(f.tobytes() for f in server.encoded)
    for frame in expected:
        assert frame in encoded
        encoded.remove(frame)
    assert len(server.encoded) >= len(expected) == 12


# The SVD serve mode against foveax's client path.  The reduced SAT's
# texels differ by float32 ulps at SAT magnitude (the rank contraction
# sums in another order, tests/test_torch_svd.py), which moves a box mean
# by 1 where the box is small: measured worst max 1 on 2.2% of values over
# 6 frames at 96x64 and 256x128 (2 on random frames,
# tests/test_torch_svd.py).  The unwarp then adds its own contract, within
# 1 LSB of foveax's exact unwarp with the fovea exact.
SVD_REDUCED_MAX = 2
SVD_REDUCED_SHARE = 0.05


def test_svd_session_bit_equal_to_foveax_wire():
    """An SVD session through websockets: every SAT the server packed is
    foveax's SAT of the source frame and every blob what foveax's
    ``compress_sat`` and packer make of it (tolerance 0).  At the client,
    each reduced frame lies within ``SVD_REDUCED_MAX`` of foveax's
    (its unpacker and reduced-SAT sampler on the same blob at the client's
    local gaze), each restored frame within 1 LSB of foveax's exact unwarp
    of the client's reduced frame with the fovea exact, and so within
    ``SVD_REDUCED_MAX + 1`` of foveax's whole client path."""
    from foveax.core.logrect import make_grid as fx_make_grid
    from foveax.core.sat import build_sat as fx_build_sat
    from foveax.core.svd_sat import (
        compress_sat as fx_compress,
        create_reduced_sat as fx_reduced_sat,
        sample_from_reduced_sat as fx_box,
    )
    from foveax.io import svdwire as fx_wire

    cfg, fx_cfg = _configs(96, 64, 48, 32)
    spec, n = "synthetic://96x64@30/6", 6
    server = CapturingServer(cfg, max_frames=n, sat_compression="svd", device="cpu")
    client = CapturingClient(
        "", video=spec, config=cfg, max_frames=n, device="cpu",
        gaze_source=lambda i: GAZES[i % len(GAZES)],
    )
    _loopback(server, [client])
    assert client.stats.frames == n == len(server.svd_packed)

    packer = fx_wire.SvdWirePacker(sync_every=fx_cfg.gop_size)
    for (sat, blob, is_sync, _), source in zip(server.svd_packed,
                                               synthetic_frames(spec, n)):
        fx_sat = fx_build_sat(jnp.asarray(source))
        np.testing.assert_array_equal(sat, np.asarray(fx_sat))
        assert (blob, is_sync) == packer.pack(fx_compress(fx_sat, fx_cfg.svd_rank))

    grid = fx_make_grid(48, 32, 96, 64)
    reduce = jax.jit(lambda svd, c: fx_box(fx_reduced_sat(svd, grid, c)))
    exact = jax.jit(lambda r, c: fx_unwarp_rect(r, 96, 64, c))
    unpacker = fx_wire.SvdWireUnpacker()
    assert len(client.svd_decoded) == len(client.restored) == n
    for (blob, gaze, reduced), (full, _) in zip(client.svd_decoded, client.restored):
        c = jnp.asarray(gaze, jnp.float32)
        fx_reduced = np.asarray(reduce(unpacker.unpack(blob), c))
        ours = reduced.numpy()
        d = np.abs(ours.astype(np.int32) - fx_reduced.astype(np.int32))
        assert d.max() <= SVD_REDUCED_MAX, d.max()
        assert (d > 0).mean() <= SVD_REDUCED_SHARE, (d > 0).mean()
        want = np.asarray(exact(jnp.asarray(ours), c))
        d = np.abs(full.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, d.max()
        cx = int(np.float32(gaze[0]) * np.float32(96))
        cy = int(np.float32(gaze[1]) * np.float32(64))
        ys, xs = slice(max(cy - 3, 0), cy + 3), slice(max(cx - 3, 0), cx + 3)
        np.testing.assert_array_equal(full[ys, xs], want[ys, xs])
        whole = np.asarray(exact(jnp.asarray(fx_reduced), c))
        d = np.abs(full.astype(np.int32) - whole.astype(np.int32))
        assert d.max() <= SVD_REDUCED_MAX + 1, d.max()
