"""foveax_torch's streaming server and client on the CPU (``device="cpu"``):
the functional behaviour of the JAX package's serve tests (text replies,
broadcast, malformed input, the gaze trust boundary, path traversal, the
channel lifecycle, resolution checks, the pipeline cache, decimation,
AIMD, the readback guard), the SVD serve mode, the in-memory connection
pair that chip_smoke.py serves through, the direct batch sampler, the
device default, the option checks, the mesh constructor checks and
round-robin placement.  No test
here asserts a time."""

import asyncio
import socket
import threading

import pytest
import torch

import chip_smoke
from foveax_torch import FoveaxConfig
from foveax_torch.io.wirecodec import WIRE_PRESETS, available_wire_codecs
from foveax_torch.serve import protocol
from foveax_torch.serve.client import FoveaxClient, gaze_to_index
from foveax_torch.serve.protocol import VideoRequest
from foveax_torch.serve.server import (
    BroadcastChannel,
    FoveaxServer,
    ReadbackGuard,
    Session,
)

CFG = FoveaxConfig(
    source_width=96, source_height=64, reduced_width=48, reduced_height=32
)
TIMEOUT_S = 90


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _server(**kw) -> FoveaxServer:
    return FoveaxServer(CFG, device="cpu", **kw)


def _client(port, **kw) -> FoveaxClient:
    return FoveaxClient(f"ws://127.0.0.1:{port}", config=CFG, device="cpu", **kw)


def _serve(server, port, body):
    """Run ``body()`` against ``server`` on a websocket at ``port``."""

    async def main():
        import websockets

        async with websockets.serve(
            server.handle, "127.0.0.1", port, max_size=64 * 1024 * 1024
        ):
            return await asyncio.wait_for(body(), timeout=TIMEOUT_S)

    return asyncio.run(main())


def _connect(port):
    import websockets

    return websockets.connect(f"ws://127.0.0.1:{port}")


def test_loopback_text_message():
    port = _free_port()
    server = _server()

    async def body():
        async with _connect(port) as ws:
            await ws.send(protocol.dumps(protocol.TextMessage("hello")))
            reply = protocol.loads(await asyncio.wait_for(ws.recv(), 10))
            assert "hello" in reply.message

    _serve(server, port, body)


@pytest.mark.parametrize("batch_sampler", ["auto", "fused", "sat"])
def test_broadcast_multi_client(batch_sampler):
    """3 concurrent clients of one video: shared frame clock, one batched
    sample per tick, each client unwarps with its own gaze."""
    port = _free_port()
    server = _server(max_frames=8, broadcast=True, batch_sampler=batch_sampler)
    gazes = [(0.2, 0.3), (0.5, 0.5), (0.8, 0.7)]
    clients = [
        _client(port, video="synthetic://96x64@30/30",
                gaze_source=lambda i, g=g: g, max_frames=5)
        for g in gazes
    ]

    async def body():
        return await asyncio.gather(*(c.run() for c in clients))

    stats = _serve(server, port, body)
    assert all(s.frames == 5 for s in stats)
    assert len(server.channels) == 0
    buckets = [set(s.by_gaze) for s in stats]
    assert gaze_to_index(0.2, 0.3) in buckets[0]
    assert gaze_to_index(0.8, 0.7) in buckets[2]


def test_server_ignores_malformed_messages():
    port = _free_port()
    server = _server()

    async def body():
        async with _connect(port) as ws:
            await ws.send("this is not json")
            await ws.send('{"type": "warpDrive"}')
            await ws.send(b"\x00\x01binary nonsense")
            await ws.send(protocol.dumps(protocol.TextMessage("alive?")))
            reply = protocol.loads(await asyncio.wait_for(ws.recv(), 10))
            assert "alive?" in reply.message

    _serve(server, port, body)


def test_structurally_bad_messages_do_not_kill_session():
    port = _free_port()
    server = _server()

    async def body():
        async with _connect(port) as ws:
            await ws.send("[1, 2, 3]")
            await ws.send('{"type": "frameRequest", "centerX": 0.5}')
            await ws.send(
                '{"type": "frameRequest", "centerX": "zzz", '
                '"centerY": 0.5, "packetNumber": 1}'
            )
            await ws.send(
                '{"type": "frameRequest", "centerX": "0.25", '
                '"centerY": 0.75, "packetNumber": 7}'
            )
            reply = protocol.loads(await asyncio.wait_for(ws.recv(), 10))
            assert reply == protocol.Ack(7)

    _serve(server, port, body)


def test_gaze_prediction_and_adaptive_quality():
    server = _server(predict_gaze=True)
    s = Session(ws=None, server=server)
    s.update_gaze(0.5, 0.5)
    s.update_gaze(0.6, 0.55)
    cx, cy = s.effective_center()
    assert abs(cx - 0.7) < 1e-6 and abs(cy - 0.6) < 1e-6
    s.update_gaze(0.95, 0.5)
    s.update_gaze(0.02, 0.5)
    assert abs(s.effective_center()[0] - 0.09) < 1e-6
    q0 = s.quality
    s.on_frame_outcome(dropped=True)
    assert s.quality < q0
    for _ in range(30):
        s.on_frame_outcome(dropped=False)
    assert s.quality > q0 * 0.8


def test_gaze_clamped_at_trust_boundary():
    s = Session(ws=None, server=_server(predict_gaze="kalman"))
    s.update_gaze(1e30, -1e30)
    assert s.center == (1.0, 0.0)
    s.update_gaze(-0.25, 7.5)
    assert s.center == (0.0, 1.0)
    cx, cy = s.effective_center()
    assert 0.0 <= cx <= 1.0 and 0.0 <= cy <= 1.0


def test_path_traversal_rejected_but_session_survives(tmp_path):
    port = _free_port()
    secret = tmp_path / "secret.mp4"
    secret.write_bytes(b"not really a video")
    server = _server(video_dir=tmp_path / "videos")

    async def body():
        async with _connect(port) as ws:
            for name in [str(secret), "../secret", "a/b", ".hidden"]:
                await ws.send(protocol.dumps(VideoRequest(name)))
                reply = protocol.loads(await asyncio.wait_for(ws.recv(), 10))
                assert "videoRequest failed" in reply.message, name
            await ws.send(protocol.dumps(protocol.TextMessage("ping")))
            reply = protocol.loads(await asyncio.wait_for(ws.recv(), 10))
            assert "ping" in reply.message

    _serve(server, port, body)


def test_broadcast_rejoin_after_teardown_gets_fresh_channel():
    port = _free_port()
    server = _server(max_frames=50, broadcast=True)

    async def body():
        out = []
        for _ in range(2):
            c = _client(port, video="synthetic://96x64@30/60", max_frames=3)
            out.append(await c.run())
            await asyncio.sleep(0.2)  # let the teardown callback run
        return out

    s1, s2 = _serve(server, port, body)
    assert s1.frames == 3 and s2.frames == 3
    assert len(server.channels) == 0


def test_broadcast_channel_leave_clears_membership():
    server = _server(broadcast=True)

    class _WS:
        transport = None

    async def main():
        session = Session(_WS(), server)
        channel = BroadcastChannel(server, "synthetic://96x64@30/10")
        channel.join(session)
        session.channel = channel
        channel.leave(session)
        assert session.channel is None
        await asyncio.sleep(0)

    asyncio.run(main())


def test_fused_batch_sampler_refuses_ineligible_source():
    """An explicit fused broadcast sampler fails the join, not the tick,
    on a shape outside the fused sampler's contract (1920x1080 -> 64x36)."""
    server = FoveaxServer(
        FoveaxConfig(reduced_width=64, reduced_height=36), device="cpu",
        broadcast=True, batch_sampler="fused",
    )
    server.max_pipelines = 1
    channel = BroadcastChannel(server, "synthetic://1920x1080@30/2")

    class _WS:
        transport = None

    async def main():
        with pytest.raises(ValueError, match="fused sampler's contract"):
            channel.join(Session(_WS(), server))
        assert channel.reader is None and channel.task is None

    asyncio.run(main())


def test_fused_batch_sampler_refuses_wide_source():
    """The same at 36000x64 (-> 20000x48), inside the row-sum bound but
    wider than a ``segment_reduce_xy`` block's shared memory allows."""
    server = FoveaxServer(FoveaxConfig(), device="cpu", broadcast=True,
                          batch_sampler="fused")
    server.max_pipelines = 1
    channel = BroadcastChannel(server, "synthetic://36000x64@30/2")

    class _WS:
        transport = None

    async def main():
        with pytest.raises(ValueError, match="36000x64 fails"):
            channel.join(Session(_WS(), server))
        assert channel.reader is None and channel.task is None

    asyncio.run(main())


def test_client_rejects_resolution_mismatch():
    port = _free_port()
    server = _server(max_frames=4)
    bad = FoveaxConfig(
        source_width=96, source_height=64, reduced_width=64, reduced_height=48
    )
    client = FoveaxClient(f"ws://127.0.0.1:{port}", video="synthetic://96x64@30/10",
                          config=bad, max_frames=4, device="cpu")

    async def body():
        with pytest.raises(ValueError, match="client pipeline expects"):
            await client.run()

    _serve(server, port, body)


def test_loopback_stream_inter_frame_codec():
    """Inter-frame samples on the wire where the codec shim is built:
    h264 in, h264 out, the restored frames at the source size."""
    if "h264" not in available_wire_codecs():
        pytest.skip("the codec shim needs FFmpeg's headers, absent here")
    port = _free_port()
    server = _server(max_frames=8, wire_codec="h264")
    seen = []
    client = _client(port, video="synthetic://96x64@30/20",
                     gaze_source=lambda i: (0.4, 0.6),
                     frame_sink=lambda f, meta: seen.append(f), max_frames=6)
    stats = _serve(server, port, client.run)
    assert stats.frames == 6 and seen[0].shape == (64, 96, 3)
    assert server.wire_codec == "h264"


def test_synthetic_dimension_clamp():
    server = _server()
    with pytest.raises(ValueError, match="too large"):
        server._resolve("synthetic://50000x50000")
    with pytest.raises(ValueError, match="too small"):
        server._resolve("synthetic://4x4")
    r = server._resolve("synthetic://96x64")
    assert (r.width, r.height) == (96, 64)
    r.close()


def test_pipeline_cache_is_bounded():
    server = _server()
    server.max_pipelines = 2
    server._pipeline_for(96, 64)
    server._pipeline_for(112, 64)
    server._pipeline_for(128, 64)
    assert len(server._pipelines) == 2
    assert (96, 64, server.device) not in server._pipelines
    p = server._pipeline_for(128, 64)
    assert p is server._pipelines[(128, 64, server.device)]
    assert p.device == torch.device("cpu")


def test_decimation_factor_bounds_tick():
    server = _server(encode_workers=1)
    tick = 1.0 / 30.0
    budget = 0.9 * tick
    for workers in (1, 2, 8):
        server.encode_workers = workers
        for ema_ms in (0.5, 2.0, 8.0, 21.0, 60.0):
            for n in (1, 3, 8, 32, 170):
                ch = BroadcastChannel(server, "v")
                ch._enc_ema = ema_ms / 1000.0
                k = ch._update_decimation(n, tick)
                assert k <= 16
                if k < 16:
                    per_tick = (n / k) * ch._enc_ema / workers
                    assert per_tick <= budget + ch._enc_ema / workers
    ch = BroadcastChannel(server, "v")
    server.encode_workers = 1
    ch._enc_ema = 0.021
    assert ch._update_decimation(8, tick) == 6
    ch._enc_ema = 0.017
    for _ in range(14):
        assert ch._update_decimation(8, tick) == 6
    assert ch._update_decimation(8, tick) == 5
    ch._enc_ema = 0.08
    assert ch._update_decimation(8, tick) == 16


def test_aimd_floor_never_exceeds_configured_bitrate():
    server = _server(wire_codec="jpeg")
    server.adapt_rate = True
    server.wire_bitrate = 200_000
    s = Session(ws=None, server=server)
    assert s.rate_bps == 200_000
    s.on_frame_outcome(True)
    assert s.rate_bps < 200_000
    for _ in range(40):
        s.on_frame_outcome(True)
    assert s.rate_bps == 50_000
    for _ in range(400):
        s.on_frame_outcome(False)
    assert s.rate_bps == 200_000
    server.wire_bitrate = 8_000_000
    s2 = Session(ws=None, server=server)
    for _ in range(60):
        s2.on_frame_outcome(True)
    assert s2.rate_bps == 250_000


def test_rate_adaptation_flags():
    with pytest.raises(ValueError, match="wire-bitrate"):
        _server(wire_codec="jpeg", adapt_rate=True)
    with pytest.raises(ValueError, match="inter-frame"):
        _server(wire_codec="jpeg", wire_bitrate=1, adapt_rate=True)


def test_readback_guard_skip_and_recover():
    ev = threading.Event()
    calls = []

    def stalled():
        calls.append("stalled")
        ev.wait(10)
        return "stale"

    def fresh():
        calls.append("fresh")
        return "fresh"

    async def main():
        loop = asyncio.get_running_loop()
        g = ReadbackGuard(0.1)
        assert await g.call(loop, stalled) is None
        assert g.timeouts == 1
        assert await g.call(loop, fresh) is None
        assert g.skips == 1 and calls == ["stalled"]
        ev.set()
        for _ in range(200):
            if g._pending.done():
                break
            await asyncio.sleep(0.01)
        assert await g.call(loop, fresh) == "fresh"
        assert g.recoveries == 1 and calls == ["stalled", "fresh"]

    asyncio.run(main())


def test_preset_pressure_exhausted_ladder_returns_false():
    """The JAX package's _bump_preset_pressure answers True inside its
    one-second rate limit even when the ladder is exhausted; the port
    checks exhaustion first."""
    server = _server(wire_codec="jpeg")
    server.wire_preset = "auto"
    server._preset_cache[("jpeg", 48, 32)] = "superfast"
    assert server._bump_preset_pressure(CFG)  # superfast -> ultrafast
    assert server._resolve_preset(CFG) == WIRE_PRESETS[0]
    # Inside the window, on an exhausted ladder.
    assert server._bump_preset_pressure(CFG) is False
    assert server._preset_pressure == 1
    # A ladder with room left is held inside the window as before.
    server._preset_cache[("jpeg", 48, 32)] = "veryfast"
    assert server._bump_preset_pressure(CFG) is True
    assert server._preset_pressure == 1


@pytest.mark.parametrize("what", ["session", "fused", "sat", "direct"])
def test_memory_pair_loopback(what):
    """chip_smoke.py's serve phase at a CPU size through its in-memory
    connection pair: every reduced and restored frame equal to the CPU
    pipeline's, and no kernel launched on CPU tensors."""
    kernels = chip_smoke.kernel_table()
    if what == "session":
        server, client, launches = chip_smoke.serve_session(CFG, "cpu", kernels)
        clients = [client]
    else:
        server, clients, launches = chip_smoke.serve_broadcast(CFG, "cpu", what, kernels)
        assert 1 <= chip_smoke.served_ticks(clients) <= chip_smoke.BROADCAST_TICKS
    assert set(launches.values()) == {0}
    assert len(server.encoded) == sum(c.stats.frames for c in clients) > 0


def test_direct_broadcast_equals_sat_channel():
    """A broadcast channel with ``batch_sampler="direct"`` (chip_smoke.py's
    in-memory pair, 4 clients) encodes, for every frame a client received,
    the SAT pipeline's reduced frame of that source frame at its gaze."""
    import numpy as np

    from foveax_torch import FoveationPipeline

    server, clients, _ = chip_smoke.serve_broadcast(CFG, "cpu", "direct")
    sat = FoveationPipeline(CFG, sampler="sat", device="cpu")
    spec = f"synthetic://{CFG.source_width}x{CFG.source_height}@30/{chip_smoke.BROADCAST_TICKS}"
    sources = chip_smoke.synthetic_frames(spec, chip_smoke.BROADCAST_TICKS)
    want = sorted(
        sat.foveate(
            torch.from_numpy(sources[meta.frameNum]),
            torch.tensor([meta.centerX, meta.centerY], dtype=torch.float32),
        ).numpy().tobytes()
        for c in clients for _, meta in c.restored
    )
    assert len(want) == sum(c.stats.frames for c in clients) > 0
    assert sorted(np.ascontiguousarray(f).tobytes() for f in server.encoded) == want


def test_device_default_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoveaxServer(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoveaxClient("ws://127.0.0.1:1", config=CFG)


def test_unported_modes_raise():
    # The SVD mode streams the SAT itself: only the SAT batch samplers.
    with pytest.raises(ValueError, match="batch_sampler"):
        _server(sat_compression="svd", batch_sampler="fused")
    with pytest.raises(ValueError, match="batch_sampler"):
        _server(sat_compression="svd", batch_sampler="direct")
    with pytest.raises(ValueError, match="unknown batch_sampler"):
        _server(batch_sampler="mm")
    with pytest.raises(ValueError):
        _server(place_videos="sideways")
    assert _server(place_videos="round_robin").place_videos == "round_robin"


def test_mesh_constructor_checks(caplog):
    """The JAX package's constructor checks of a mesh: its axes, no
    "direct" sampler over it, round_robin placement excluded, ignored
    (with a warning) by the SVD mode."""
    from types import SimpleNamespace

    from foveax_torch.parallel import make_mesh

    mesh = make_mesh(n_space=4, n_data=2, devices=["cpu"] * 8)
    assert _server(broadcast=True, mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="mesh axes"):
        _server(broadcast=True, mesh=SimpleNamespace(axis_names=("x", "y")))
    with pytest.raises(ValueError, match="--mesh has no sharded direct sampler"):
        _server(broadcast=True, mesh=mesh, batch_sampler="direct")
    with pytest.raises(ValueError, match="mutually exclusive"):
        _server(broadcast=True, mesh=mesh, place_videos="round_robin")
    with caplog.at_level("WARNING", logger="foveax_torch.serve"):
        _server(broadcast=True, mesh=mesh, sat_compression="svd")
    assert "--mesh is ignored with --sat-compression svd" in caplog.text


def test_next_device_round_robin(monkeypatch):
    """``place_videos="round_robin"`` hands out the visible CUDA devices
    in turn (two here, patched: nothing is launched); one device, the CPU
    or the default placement give None (the server's own device)."""
    assert _server(place_videos="round_robin")._next_device() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    server = FoveaxServer(CFG, place_videos="round_robin")
    assert [server._next_device() for _ in range(3)] == [
        torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 0)
    ]
    assert FoveaxServer(CFG)._next_device() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert FoveaxServer(CFG, place_videos="round_robin")._next_device() is None


def _stall_first_sample(monkeypatch, pair: str):
    """Make the first sample call of every pipeline the server builds
    block until the returned event is set (an injected readback wedge)."""
    ev = threading.Event()
    state = {"armed": True}
    orig = FoveaxServer._pipeline_for

    def patched(self, *args):
        p = orig(self, *args)
        if getattr(p, "_stall_wrapped", False):
            return p
        make_pair = getattr(p, pair)

        def stalling_pair(*args):
            prepare, sample = make_pair(*args)

            def stalling(prepared, center):
                if state["armed"]:
                    state["armed"] = False
                    ev.wait(10)
                return sample(prepared, center)

            return prepare, stalling

        setattr(p, pair, stalling_pair)
        p._stall_wrapped = True
        return p

    monkeypatch.setattr(FoveaxServer, "_pipeline_for", patched)
    return ev


@pytest.mark.parametrize("broadcast", [False, True], ids=["session", "broadcast"])
def test_readback_deadline_skips_and_recovers(monkeypatch, broadcast):
    """One sample readback stalls past the deadline: the loop skips
    frames instead of hanging, and every client completes its stream once
    the transfer heals."""
    ev = _stall_first_sample(monkeypatch, "batch_pair" if broadcast else "single_pair")
    port = _free_port()
    server = _server(max_frames=3000, broadcast=broadcast, readback_deadline_s=0.25,
                     loop_videos=True)
    clients = [
        _client(port, video="synthetic://96x64@30/200",
                gaze_source=lambda i, k=k: ((k + 1) / 3.0, 0.5), max_frames=4)
        for k in range(2 if broadcast else 1)
    ]

    async def body():
        asyncio.get_running_loop().call_later(1.0, ev.set)
        return await asyncio.gather(*(c.run() for c in clients))

    stats = _serve(server, port, body)
    assert server.total_readback_skips >= 1
    assert all(s.frames == 4 for s in stats)


def _need_h264():
    if "h264" not in available_wire_codecs():
        pytest.skip("the codec shim needs FFmpeg's headers, absent here")


def test_rate_adaptation_aimd_unit():
    _need_h264()
    server = _server(wire_codec="h264", wire_bitrate=800_000, adapt_rate=True)
    s = Session(ws=None, server=server)
    assert s.rate_bps == 800_000 and not s._rate_dirty
    s.on_frame_outcome(dropped=True)
    assert s.rate_bps == 560_000 and s._rate_dirty
    s._rate_dirty = False
    s.on_frame_outcome(dropped=True)
    assert s.rate_bps == 392_000
    for _ in range(20):
        s.on_frame_outcome(dropped=True)
    assert s.rate_bps == 250_000
    s._rate_dirty = False
    for _ in range(30):
        s.on_frame_outcome(dropped=False)
    assert s.rate_bps == 312_500 and s._rate_dirty
    for _ in range(30 * 20):
        s.on_frame_outcome(dropped=False)
    assert s.rate_bps == 800_000


def test_rate_adaptation_renegotiates_midstream(monkeypatch):
    """Backlog drops trigger a live bitrate decrease: the server swaps
    encoder and muxer and re-sends the header mid-stream; the client
    rebuilds its decoder on the new init segment and keeps decoding."""
    _need_h264()
    port = _free_port()
    server = _server(max_frames=20, wire_codec="h264", wire_bitrate=800_000,
                     adapt_rate=True)
    calls = {"n": 0}

    def fake_backlog(ws):  # force drops on the 4th and 5th ticks
        calls["n"] += 1
        return 10**9 if calls["n"] in (4, 5) else 0

    server._backlog = fake_backlog
    rates = []
    orig = Session.renegotiate_wire

    def spy(self, cfg):
        rates.append(self.rate_bps)
        return orig(self, cfg)

    monkeypatch.setattr(Session, "renegotiate_wire", spy)
    seen = []
    client = _client(port, video="synthetic://96x64@30/40",
                     gaze_source=lambda i: (0.5, 0.5),
                     frame_sink=lambda f, meta: seen.append(f), max_frames=10)
    stats = _serve(server, port, client.run)
    assert rates == [392_000], rates
    assert stats.frames == 10
    assert all(f.shape == (64, 96, 3) for f in seen)
    assert seen[-1].std() > 5.0


def test_renegotiation_failure_closes_session(monkeypatch):
    """An encoder-open failure during renegotiation tells the client and
    closes its connection, so the client returns instead of hanging."""
    _need_h264()
    port = _free_port()
    server = _server(max_frames=40, wire_codec="h264", wire_bitrate=800_000,
                     adapt_rate=True)
    calls = {"n": 0}

    def fake_backlog(ws):
        calls["n"] += 1
        return 10**9 if calls["n"] == 3 else 0

    server._backlog = fake_backlog

    def failing(self, cfg):
        raise RuntimeError("fx_enc_open failed")

    monkeypatch.setattr(Session, "renegotiate_wire", failing)
    texts = []
    client = _client(port, video="synthetic://96x64@30/60",
                     gaze_source=lambda i: (0.5, 0.5),
                     frame_sink=lambda f, meta: None, max_frames=40,
                     on_text=texts.append)
    stats = _serve(server, port, client.run)
    assert stats.frames < 40
    assert any("renegotiation failed" in t for t in texts), texts


def _renegotiating_clients(port, server, n, max_frames):
    """``n`` JPEG clients of one video; after the first client's third
    frame the server's preset generation moves on once, which makes every
    member's encoder stale: the next tick renegotiates it.  Each client
    keeps its texts and counts the decoders it builds."""
    bumped = []

    def sink(frame, meta, client):
        client.got += 1
        if client.got == 3 and not bumped:
            bumped.append(True)
            server._preset_gen += 1

    class Counting(FoveaxClient):
        def _make_decoder(self, *args):
            self.decoders += 1
            return super()._make_decoder(*args)

    clients = []
    for k in range(n):
        texts = []
        c = Counting(f"ws://127.0.0.1:{port}", config=CFG, device="cpu",
                     video="synthetic://96x64@30/60", max_frames=max_frames,
                     gaze_source=lambda i, k=k: (0.3 + 0.4 * k, 0.5),
                     frame_sink=lambda f, m, k=k: sink(f, m, clients[k]),
                     on_text=texts.append)
        c.got, c.decoders, c.texts = 0, 0, texts
        clients.append(c)
    return clients


def _stream_infos(client) -> int:
    return sum('"streamInfo"' in t for t in client.texts)


@pytest.mark.parametrize("broadcast", [False, True], ids=["session", "broadcast"])
def test_renegotiation_resends_the_header_on_the_jpeg_wire(broadcast):
    """A mid-stream renegotiation (a preset-pressure change) on the JPEG
    wire: every client gets a second streamInfo and header, rebuilds its
    decoder on the new init segment and keeps decoding to its
    max_frames."""
    port = _free_port()
    server = _server(wire_codec="jpeg", broadcast=broadcast)
    clients = _renegotiating_clients(port, server, 2 if broadcast else 1, 10)

    async def body():
        return await asyncio.gather(*(c.run() for c in clients))

    stats = _serve(server, port, body)
    assert [s.frames for s in stats] == [10] * len(clients)
    assert [_stream_infos(c) for c in clients] == [2] * len(clients)
    assert [c.decoders for c in clients] == [2] * len(clients)


@pytest.mark.parametrize("broadcast", [False, True], ids=["session", "broadcast"])
def test_renegotiation_failure_ends_only_that_stream(monkeypatch, broadcast):
    """The first encoder that cannot reopen mid-stream (JPEG wire): its
    client is told and its connection closed.  A session's stream ends; a
    channel evicts that member from its loop and serves the other to its
    max_frames."""
    port = _free_port()
    server = _server(wire_codec="jpeg", broadcast=broadcast)
    failed, evicted = [], []
    renegotiate, leave = Session.renegotiate_wire, BroadcastChannel.leave

    def flaky(self, cfg):
        if not failed:
            failed.append(self)
            raise RuntimeError("fx_enc_open failed")
        return renegotiate(self, cfg)

    def spy(self, session):
        if asyncio.current_task() is self.task:  # from the channel's loop
            evicted.append(session)
        return leave(self, session)

    monkeypatch.setattr(Session, "renegotiate_wire", flaky)
    monkeypatch.setattr(BroadcastChannel, "leave", spy)
    clients = _renegotiating_clients(port, server, 2 if broadcast else 1, 10)

    async def body():
        return await asyncio.gather(*(c.run() for c in clients))

    stats = _serve(server, port, body)
    told = [any("renegotiation failed" in t for t in c.texts) for c in clients]
    assert told.count(True) == 1 and len(failed) == 1
    frames = [s.frames for s, t in zip(stats, told) if t] + [
        s.frames for s, t in zip(stats, told) if not t]
    assert frames[0] < 10 and frames[1:] == [10] * (len(clients) - 1)
    if broadcast:
        assert failed[0] in evicted


def test_launch_count_is_exact_under_threads(monkeypatch):
    """The server launches kernels from executor threads: a wrapper's
    count must not lose an update when threads launch at once."""
    import sys
    from types import SimpleNamespace

    from foveax_torch.kernels.build import Kernel

    kernel = Kernel("none", "none", [])
    kernel._fn = lambda *args: 0  # a launch that succeeds
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    n_threads, per_thread = 16, 2000
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(per_thread):
            kernel.launch()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == n_threads * per_thread


@pytest.mark.parametrize("mode", ["session", "broadcast"])
def test_svd_memory_pair_loopback(mode):
    """chip_smoke.py's SVD phase at a CPU size: every packed SAT, blob,
    reduced and restored frame equal to the CPU port's, the session's
    first sample a sync sample and the rest deltas, and no kernel launched
    on CPU tensors."""
    kernels = chip_smoke.kernel_table()
    if mode == "session":
        server, client, launches = chip_smoke.serve_svd_session(CFG, "cpu", kernels)
        clients = [client]
    else:
        server, clients, launches = chip_smoke.serve_svd_broadcast(CFG, "cpu", kernels)
        assert len(server.svd_packed) == chip_smoke.SVD_TICKS
    assert set(launches.values()) == {0}
    assert all(c.stats.frames > 0 for c in clients)
    assert server.svd_packed[0][2] is True


def test_svd_options_validated():
    with pytest.raises(ValueError, match="svd_wire_compress"):
        _server(sat_compression="svd", svd_wire_compress="lz4")
    with pytest.raises(ValueError, match="sat_compression"):
        _server(sat_compression="pca")
    server = _server(sat_compression="svd", batch_sampler="sat",
                     svd_wire_compress="none")
    assert server.sat_compression == "svd" and server.svd_wire_compress == "none"


@pytest.mark.parametrize("compress", ["deflate", "none"])
def test_svd_stream_restores_frames(compress):
    """An SVD session through websockets with each other residual coding:
    the client restores full frames at its own gaze, and the stream's
    track advertises the source dimensions."""
    port = _free_port()
    server = _server(max_frames=5, sat_compression="svd", svd_wire_compress=compress)
    frames = []
    client = _client(port, video="synthetic://96x64@30/20", max_frames=4,
                     gaze_source=lambda i: (0.4, 0.6),
                     frame_sink=lambda f, meta: frames.append(f))
    stats = _serve(server, port, client.run)
    assert stats.frames == 4 and len(frames) == 4
    assert all(f.shape == (64, 96, 3) and f.dtype == "uint8" for f in frames)
    assert stats.by_gaze.keys() == {gaze_to_index(0.4, 0.6)}


def test_svd_client_rejects_resolution_mismatch():
    """An fxsv track carries the source dimensions: a client configured
    for another source fails loudly."""
    port = _free_port()
    server = _server(max_frames=4, sat_compression="svd")
    bad = FoveaxConfig(
        source_width=64, source_height=64, reduced_width=48, reduced_height=32
    )
    client = FoveaxClient(f"ws://127.0.0.1:{port}", video="synthetic://96x64@30/10",
                          config=bad, max_frames=4, device="cpu")

    async def body():
        with pytest.raises(ValueError, match="client pipeline expects 64x64"):
            await client.run()

    _serve(server, port, body)
