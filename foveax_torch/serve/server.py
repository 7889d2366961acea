"""Asyncio websocket streaming server (the port's fork of
``foveax/serve/server.py``), driving the port's ``FoveationPipeline`` on
its device: ``cuda`` unless the server is given ``device="cpu"``.

Architecture vs the reference (src/video_server.cc): the reference spawns a
thread per connection, a *detached thread per gaze message*, and a full GPU
context + engine stack per client.  The server runs one asyncio event loop,
one send-loop task per connection, one shared FoveationPipeline per
resolution (the grid is gaze-independent), and per-connection session state
only for the decoder, muxer, and latest gaze.  Gaze updates are a plain
attribute write on the session (single-threaded event loop — no mutexes,
no data races by construction; the reference needed three mutexes per
connection, src/video_server.h:49-53).

Frame loop per tick (reference hot loop src/video_server.cc:287-427):
decode (thread pool) -> device foveate with the latest gaze -> encode
(thread pool) -> mux fragment -> send JSON metadata + binary fragment,
paced to the configured fps.  Per session the device step is the
pipeline's ``single_pair`` (the fused sampler ``segreduce_xy`` where the
shape allows it, else the SAT build K5 and the 4-tap sampler); a broadcast
channel samples all its members' gazes in one ``batch_pair`` call per
tick.  Both loops run their ticks through a :class:`Feed` (read, prepare,
pace, the guarded device calls, the sends), whose device half is a
``serve/tick.py::ServeTick``: inputs are staged from the executor threads
with a synchronous host -> device copy, and every result is read back
into a pinned host block the caller owns (``serve/tick.py::readback``)
inside the executor call that ``ReadbackGuard`` bounds.  Each tick is a
``serve.tick`` unit of the tracer (``pipeline/profiling.py``), its read,
stage, prepare, pace, sample, readback, encodes and sends spans inside
it; they feed the server's ``tally``, of which ``_stats_loop`` logs each
period's p50 and p95.

The connection is any object with ``send``, ``close`` and async iteration
over incoming messages (a ``websockets`` connection, or an in-memory
pair); ``websockets`` is imported only to serve on a port and to name its
connection-closed exception.

SVD mode (``sat_compression="svd"``): the device step is the SAT build
alone (K5 on the card), once per source frame; the SAT is read back,
factored on the host (``core/svd_sat.compress_sat``, NumPy float64) and
packed for the wire (``io/svdwire``) inside the executor call that
``ReadbackGuard`` bounds, and one gaze-independent ``fxsv`` blob per tick
goes to every member: each client foveates at its own gaze.

Multi-device serving: with ``mesh=`` (a ``foveax_torch.parallel`` mesh over
``("data", "space")``) a broadcast channel runs the sharded pair of
``parallel/sharded.py`` in place of ``batch_pair``: the fused pair
(``segreduce_xy`` once per data shard a tick) or the SAT pair (K5 once per
space block a tick, the SAT gathered onto each data shard); the member
batch is padded to a multiple of the data axis with the last gaze.
``place_videos="round_robin"`` gives each channel or session the next
CUDA device, with a pipeline bound to it, where more than one is visible.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import os
import time
from collections import OrderedDict, deque
from pathlib import Path

import numpy as np
import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.core.svd_sat import compress_sat
from foveax_torch.device import resolve_device
from foveax_torch.io import svdwire
from foveax_torch.io.mux import FragmentWriter
from foveax_torch.io.video import open_video, parse_synthetic_spec
from foveax_torch.io.wirecodec import (
    WIRE_PRESETS,
    available_wire_codecs,
    make_wire_encoder,
    pick_wire_preset,
)
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve import protocol
from foveax_torch.serve.gazepred import make_predictor
from foveax_torch.serve.protocol import (
    Ack, FrameMeta, FrameRequest, TextMessage, VideoRequest, connection_closed_errors,
)
from foveax_torch.serve.tick import ServeTick, stager

# The tick's stager, by the name it had in this module.
_input_stager = stager

log = logging.getLogger("foveax_torch.serve")


def _read(reader):
    """One decoded frame from ``reader`` (None at the end), in a
    ``serve.read`` span."""
    with profiling.span("serve.read"):
        return reader.read()


# The spans of the server's ticks that ``_stats_loop`` logs, in order.
_LOGGED_SPANS = ("tick", "read", "stage", "prepare", "pace", "sample", "readback",
                 "encode", "send")


def _span_tails(stats) -> str:
    """p50 and p95 of each ``serve.*`` span in ``stats`` (a period of the
    server's ``tally``), as ``_stats_loop`` logs them."""
    return "".join(
        "%s p50=%.1fms p95=%.1fms " % (name, stats[name].p50_ms, stats[name].p95_ms)
        for name in _LOGGED_SPANS if name in stats
    )


def _encode(wire, frame: np.ndarray, member: int):
    """``wire.encode(frame)`` in a ``serve.encode`` span."""
    with profiling.span("serve.encode", member=member):
        return wire.encode(frame)


class ReadbackGuard:
    """Deadline-bounded device->host readback for a serve loop.

    A device->host transfer can stall for minutes while compute and
    uploads keep working; an unguarded ``await run_in_executor(readback)``
    then stalls the channel indefinitely (the reference's analogous load
    response is its bounded 20x1 ms packet wait before a frame drop,
    src/video_server.cc:365-374).

    Semantics: a readback that misses its deadline is ABANDONED for this
    tick (frame skipped, channel stays alive).  While the stalled call
    is still running no new device readback is launched — a wedged
    transport must not accumulate one blocked pool thread per tick.
    When the stalled call finally completes, its stale result is
    discarded and the next tick resumes normal cadence.

    The deadline must comfortably exceed a legitimate slow first tick
    (the first call of a kernel builds its library with nvcc): a late
    first tick then costs skipped frames, not a false eviction, and
    cadence recovers as soon as it lands.  A deadline <= 0 disables the
    guard: every call runs to its end.
    """

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._pending: asyncio.Future | None = None
        self.timeouts = 0
        self.skips = 0  # cumulative across the guard's lifetime (stats)
        self._wedge_skips = 0  # since the current wedge began
        self.recoveries = 0

    async def call(self, loop: asyncio.AbstractEventLoop, fn):
        """Run ``fn`` in the executor with a deadline.

        Returns ``fn()``'s result, or ``None`` when this tick must be
        skipped (deadline missed now, or a previous miss still stalled).
        """
        if self.deadline_s <= 0:
            return await loop.run_in_executor(None, fn)
        if self._pending is not None:
            if not self._pending.done():
                self.skips += 1
                self._wedge_skips += 1
                return None
            # The stalled readback finally finished: consume its (stale)
            # result/exception and resume normal operation.
            self._pending.exception()
            self._pending = None
            self.recoveries += 1
            log.info(
                "readback recovered after %d skipped ticks",
                self._wedge_skips,
            )
            self._wedge_skips = 0
        fut = loop.run_in_executor(None, fn)
        done, _ = await asyncio.wait({fut}, timeout=self.deadline_s)
        if not done:
            self._pending = fut
            self.timeouts += 1
            log.warning(
                "device readback missed its %.1f s deadline — skipping "
                "frames until the transfer completes (wedged transport?)",
                self.deadline_s,
            )
            return None
        return fut.result()


def _log_task_failure(task: asyncio.Task) -> None:
    """Session supervision: a crashed send loop is logged, never silent
    (the reference's per-connection threads die invisibly)."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is None:
        return
    if isinstance(exc, connection_closed_errors()):
        log.info("session ended: peer closed the connection")
        return
    log.error("session task failed: %r", exc)


class Session:
    """Per-connection state (the analog of the reference's connection_data,
    src/video_server.h:33-54 — minus the per-connection GPU context)."""

    def __init__(self, ws, server: "FoveaxServer"):
        self.ws = ws
        self.server = server
        self.center = (0.5, 0.5)
        # Earliest not-yet-applied gaze update (gaze-apply latency probe).
        self._gaze_rx_ts: float | None = None
        # Per-session gaze predictor (Kalman filters carry state).
        self.predictor = (
            make_predictor(server.predict_gaze)
            if server.predict_gaze != "off"
            else None
        )
        self.feed: Feed | None = None  # the session loop's source
        self.mux: FragmentWriter | None = None
        self.wire = None  # per-session wire encoder (inter-frame state)
        self.send_task: asyncio.Task | None = None
        self.channel = None  # BroadcastChannel membership
        self.frames_sent = 0
        self.frames_dropped = 0
        self.frames_decimated = 0  # skipped by saturation decimation
        # streamInfo + the stream header went out since the stream start,
        # the last join or the last renegotiation.
        self.header_sent = False
        # Adaptive quality (AIMD): backlog-dropped frames cut the JPEG
        # quality multiplicatively; sustained clean delivery restores it.
        # (Inter-frame codecs hold their rate target; their adaptation is
        # drop-before-encode, which keeps encoder state consistent with
        # the bytes actually sent.)
        self.quality = float(server.jpeg_quality)
        self._clean_streak = 0
        # AIMD rate adaptation on the inter-frame wire (--adapt-rate with
        # a rate-targeted encoder): multiplicative decrease on drops,
        # additive-ish increase after sustained clean delivery, applied
        # by swapping in a fresh encoder + muxer (header re-sent; the
        # client rebuilds its decoder on the new init segment).  Extends
        # the reference's fixed dual operating point
        # (src/video_encoder.cc:28-58, :210-342) into live adaptation.
        self.rate_bps = (
            int(server.wire_bitrate)
            if server.adapt_rate and server.wire_bitrate > 0
            else 0
        )
        self._rate_dirty = False

    def update_gaze(self, cx: float, cy: float) -> None:
        # Trust boundary: the protocol rejects non-finite coordinates but
        # not out-of-range ones.  Clamp to the normalized gaze domain so
        # a hostile/buggy client cannot poison the predictor state or
        # push the warp's int32 center conversion outside the [0, dim]
        # range every kernel's window math is designed (and swept) for.
        cx = min(max(cx, 0.0), 1.0)
        cy = min(max(cy, 0.0), 1.0)
        self.center = (cx, cy)
        if self._gaze_rx_ts is None:  # keep the EARLIEST unapplied update
            self._gaze_rx_ts = time.perf_counter()
        if self.predictor is not None:
            self.predictor.update(cx, cy)

    def mark_gaze_applied(self) -> None:
        """Record gaze-apply latency: called on the tick that samples a
        frame with this session's current gaze (apply-at-next-tick, the
        reference's timing, src/video_server.cc:325-328).  Production
        observability for the core UX number the two-process demo
        measures end-to-end (stats loop p50/p90)."""
        ts = self._gaze_rx_ts
        if ts is not None:
            self._gaze_rx_ts = None
            self.server.gaze_apply_ms.append(
                (time.perf_counter() - ts) * 1e3
            )

    def effective_center(self) -> tuple[float, float]:
        """Gaze used for the next frame; with prediction enabled the
        session's predictor extrapolates one tick ahead (the dataset's
        pred_* fields model the same one-frame-ahead idea, reference:
        src/gaze_view_points.cc:25-31).  x wraps on the 360 seam; modes
        and tuning in foveax_torch.serve.gazepred."""
        if self.predictor is None:
            return self.center
        return self.predictor.predict(1.0 / self.server.config.fps)

    def on_frame_outcome(self, dropped: bool) -> None:
        if dropped:
            self.quality = max(40.0, self.quality * 0.8)
            if self.rate_bps:
                # Floor: 250 kbit/s absolute — except when the configured
                # target itself is <= 250k, where that floor would make
                # every decrease a silent no-op and --adapt-rate inert;
                # there it drops to a quarter of the target so adaptation
                # still sheds load.
                target = int(self.server.wire_bitrate)
                floor = 250_000 if target > 250_000 else max(1, target // 4)
                new = max(int(self.rate_bps * 0.7), floor)
                if new != self.rate_bps:
                    self.rate_bps = new
                    self._rate_dirty = True
            self._clean_streak = 0
        else:
            self._clean_streak += 1
            if self._clean_streak >= 30:
                self.quality = min(
                    float(self.server.jpeg_quality), self.quality + 5.0
                )
                if self.rate_bps:
                    new = min(
                        int(self.rate_bps * 1.25),
                        int(self.server.wire_bitrate),
                    )
                    if new != self.rate_bps:
                        self.rate_bps = new
                        self._rate_dirty = True
                self._clean_streak = 0

    def renegotiate_wire(self, cfg: FoveaxConfig) -> FragmentWriter:
        """Swap in a fresh encoder at the current rate target plus a
        fresh muxer.  The caller must re-send streamInfo + the new
        header (a new init segment mid-stream); the new encoder opens on
        an IDR, so inter-frame state stays consistent."""
        old, self.wire = self.wire, self.server._make_encoder(
            cfg, bitrate=self.rate_bps
        )
        if old is not None:
            old.close()
        self._rate_dirty = False
        return self.server._wire_muxer(cfg, self.wire)

    async def refresh_wire(
        self, mux: FragmentWriter, cfg: FoveaxConfig
    ) -> FragmentWriter | None:
        """The muxer for the next frame: ``mux``, or after a rate change
        (AIMD) or a preset-pressure change a fresh encoder's
        (:meth:`renegotiate_wire`), and streamInfo + the new init segment
        go out again before the next frame.  Both loops ask after the
        backlog drop, so a member that is still backlogged does not churn
        a new encoder every tick while its socket drains.

        An encoder-open failure (it fires exactly when the host is
        strained) returns None, after the client is told and its
        connection closed: unlike on the send-failure paths this socket is
        healthy, and a headless client would block forever on a silent
        connection."""
        wire = self.wire
        if wire is None:
            return mux
        gen = self.server._preset_gen
        if not (self._rate_dirty or getattr(wire, "_foveax_preset_gen", gen) != gen):
            return mux
        try:
            mux = self.renegotiate_wire(cfg)
        except Exception as e:
            log.warning("encoder renegotiation failed, ending the stream: %s", e)
            await _notify_stream_error(
                self.ws, f"stream ended: encoder renegotiation failed: {e}"
            )
            return None
        self.header_sent = False
        return mux

    async def close(self) -> None:
        if self.channel is not None:
            self.channel.leave(self)
            self.channel = None
        if self.send_task is not None:
            self.send_task.cancel()
            try:
                await self.send_task
            except (asyncio.CancelledError, Exception):
                pass
        if self.feed is not None:
            await self.feed.close()
        if self.wire is not None:
            self.wire.close()
            self.wire = None


async def _notify_stream_error(ws, text: str) -> None:
    """Tell a still-healthy client its stream is over and close the
    socket.  Used when a server-side failure (e.g. encoder reopen during
    rate renegotiation) ends a stream whose socket is fine — without the
    close, a headless client would block forever on a silent connection.
    Send and close are guarded separately: a send failure must not skip
    the close."""
    try:
        await ws.send(protocol.dumps(TextMessage(text)))
    except Exception:
        pass
    try:
        await ws.close(code=1011, reason="stream error")
    except Exception:
        pass


class Feed:
    """One source's serve ticks, as both serve loops run them: read ->
    prepare -> pace (:meth:`next_frame`), the device calls that
    ``ReadbackGuard`` bounds (:meth:`call`), the SVD tick
    (:meth:`svd_sends`) and each member's frame (:meth:`send`).  It owns
    the source's reader, its :class:`ServeTick`, the pace deadline and
    the in-flight read, which :meth:`close` waits for before it closes
    the reader."""

    def __init__(self, server: "FoveaxServer", reader, tick: ServeTick):
        self.server = server
        self.reader = reader
        self.tick = tick
        self.config = tick.pipeline.config
        self.guard = ReadbackGuard(server.readback_deadline_s)
        # SVD-mode wire packer (sync cadence = gop_size ticks).
        self.packer = (
            server._make_svd_packer() if server.sat_compression == "svd" else None
        )
        self._deadline: float | None = None  # the pace clock starts at the first read
        self._read = None  # in-flight executor read, if any

    async def next_frame(self):
        """The next source frame, read and prepared (the SAT, or the staged
        frame itself for the SAT-free samplers), once the tick's deadline
        has come; None at the end of the source."""
        loop = asyncio.get_running_loop()
        if self._deadline is None:
            self._deadline = time.perf_counter()
        self._read = loop.run_in_executor(None, profiling.bind(_read), self.reader)
        frame = await self._read
        self._read = None
        if frame is None:
            return None
        # The gaze-independent prepare stage runs eagerly; the gaze is read
        # as late as possible (the reference sleeps to the tick *between*
        # SAT build and gaze sampling, src/video_server.cc:302-328).
        # Device calls run in the executor so a slow first call (a kernel's
        # nvcc build) never blocks the event loop's keepalives.
        prepared = await loop.run_in_executor(
            None, profiling.bind(self.tick.prepare), frame
        )
        with profiling.span("serve.pace"):
            now = time.perf_counter()
            if now < self._deadline:
                await asyncio.sleep(self._deadline - now)
        self._deadline = max(
            self._deadline + 1.0 / self.server.config.fps, time.perf_counter()
        )
        return prepared

    async def call(self, fn):
        """``fn()`` in the executor, bound to the tick's unit, under the
        readback guard: None when this tick must be skipped, counted on the
        server's ``total_readback_skips``."""
        out = await self.guard.call(asyncio.get_running_loop(), profiling.bind(fn))
        if out is None:
            self.server.total_readback_skips += 1
        return out

    def dropped(self, session: Session) -> bool:
        """Drop-on-backlog: True, counted and told to the session's AIMD,
        where its socket holds more than ``max_send_backlog``.  A slow
        consumer must not stall the frame clock (the reference's analog is
        its bounded 20x1 ms encoder packet wait before the frame-drop path,
        src/video_server.cc:365-374)."""
        server = self.server
        if server._backlog(session.ws) <= server.max_send_backlog:
            return False
        session.frames_dropped += 1
        server.total_dropped += 1
        session.on_frame_outcome(True)
        return True

    async def svd_sends(self, prepared, members) -> list:
        """The SVD tick's sends to ``members`` ((session, mux) pairs): one
        gaze-independent blob serves every member whose socket keeps up
        (the SVD mode's whole point: no per-gaze sampling, no per-member
        encode).  The backlog drop comes first, and with no member left
        nothing is packed.  The SAT is read back, factored and packed once,
        inside the guarded call; where that misses its deadline the tick is
        skipped (the packer's seq advanced, so receivers go dark until the
        next sync sample — by design)."""
        served = [(s, mux) for s, mux in members if not self.dropped(s)]
        if not served:
            return []
        packed = await self.call(lambda: self.server._pack_svd(self.packer, prepared))
        if packed is None:
            return []
        sends = []
        for i, (session, mux) in enumerate(served):
            sends.append((session, mux, session.effective_center(), i, packed))
            session.mark_gaze_applied()
        return sends

    async def send_header(self, session: Session, mux: FragmentWriter) -> None:
        """streamInfo, then the stream's header (its init segment)."""
        await session.ws.send(self.server._stream_info(self.config, mux.sample_format))
        await session.ws.send(mux.header())
        session.header_sent = True

    async def send(self, frame_num: int, session: Session, mux: FragmentWriter,
                   center, member: int, result) -> None:
        """One member's frame: ``result`` is ``(sample, is_key)``, or the
        exception its encode raised, raised here.  streamInfo and the
        header go first where the member has not had them, then the
        ``FrameMeta`` echoing ``center`` and the fragment, in a
        ``serve.send`` span."""
        if isinstance(result, BaseException):
            raise result
        sample, is_key = result
        if not session.header_sent:
            await self.send_header(session, mux)
        meta = FrameMeta(centerX=center[0], centerY=center[1], frameNum=frame_num % 256)
        with profiling.span("serve.send", member=member):
            await session.ws.send(protocol.dumps(meta))
            await session.ws.send(mux.frame(sample, is_sync=is_key))
        session.frames_sent += 1
        self.server.total_sent += 1
        session.on_frame_outcome(False)

    async def close(self) -> None:
        """Close the reader once the in-flight read, if any, is over (10 s
        at most): a cancelled loop may still have ``reader.read()`` running
        in the executor, and closing the reader concurrently with a native
        read can crash."""
        if self._read is not None:
            try:
                await asyncio.wait([self._read], timeout=10.0)
            except Exception:
                pass
        self.reader.close()


class BroadcastChannel:
    """All viewers of one video share a frame clock and one prepared frame;
    their gazes are sampled in a single batched launch per tick.

    The answer to the reference's per-connection engine stacks (SURVEY
    section 2.3): N clients cost one prepare stage (the SAT build for the
    "sat" batch sampler, nothing for "fused") plus one batched sample, not
    N pipelines.  The batch is the served members' gazes, unpadded: no
    shape is compiled per batch size here.
    """

    def __init__(self, server: "FoveaxServer", video: str):
        self.server = server
        self.video = video
        self.members: dict[Session, FragmentWriter] = {}
        self.task: asyncio.Task | None = None
        self.feed: Feed | None = None
        self.pipeline: FoveationPipeline | None = None
        self.dead = False
        self._closing_task = None  # strong ref: loop holds tasks weakly
        # Encode-saturation degradation state: EMA of one wire encode's
        # wall time and the current cadence decimation factor (1 = serve
        # every member every tick).
        self._enc_ema = 0.0
        self.decimation = 1
        self._relax_ticks = 0  # consecutive ticks below the current k
        # Preset-pressure interplay: ticks to hold a decimation raise
        # after a preset step (the cheaper encoders + EMA need time to
        # land), and consecutive deep-headroom ticks before asking the
        # server to relax the pressure.
        self._preset_hold = 0
        self._preset_relax_ticks = 0

    @property
    def reader(self):
        """The channel's source while it has one."""
        return None if self.feed is None else self.feed.reader

    def join(self, session: Session) -> None:
        if self.dead:
            raise ValueError("channel is shutting down; retry")
        opened = None
        try:
            if self.feed is None:
                reader = opened = self.server._resolve(self.video)
                # Placement is fixed for the channel's lifetime: its
                # pipeline is bound to the device.
                device = self.server._next_device()
                if device is not None:
                    log.info("channel %s placed on %s", self.video, device)
                self.pipeline = self.server._pipeline_for(
                    reader.width, reader.height, device
                )
                if (
                    self.server.batch_sampler == "fused"
                    and not self.pipeline.fused_ok
                ):
                    # Fail the join loudly instead of letting the sampler
                    # raise mid-tick inside _loop (which would kill the
                    # channel with members attached and no error to the
                    # client).  "auto" degrades to sat by itself.
                    raise ValueError(
                        f"--batch-sampler fused: source "
                        f"{reader.width}x{reader.height} fails "
                        "the fused sampler's contract — use "
                        "auto (degrades to sat) or sat"
                    )
                self.feed = Feed(self.server, reader, self._serve_tick())
            self._join_inner(session, self.pipeline.config)
        except Exception:
            # A failed join with no loop task yet has nothing to run
            # _teardown — close what this call opened or the native
            # decoder leaks on every client retry.
            if opened is not None and self.task is None:
                self.feed = self.pipeline = None
                opened.close()
            raise

    def _serve_tick(self) -> ServeTick:
        """The channel's device half.  ``prepared`` is the per-tick device
        state: the SAT for the "sat" batch sampler and for SVD mode, the
        staged frame itself for "fused".  Sharded serving (server.mesh
        set): the (prepare, sample) pair of foveax_torch.parallel.sharded
        — the client batch split over `data` either way, and padded to a
        multiple of the axis size with the last gaze; the SAT pair also
        splits its scan over `space` rows, the fused pair copies the frame
        to each data shard once per tick and samples there."""
        p, server = self.pipeline, self.server
        if server.sat_compression == "svd":
            return ServeTick(p, (p.build_sat, None))
        if server.mesh is not None:
            return ServeTick(p, self._sharded_pair(p.config),
                             pad_to=server.mesh.shape["data"])
        return ServeTick(p, p.batch_pair(server.batch_sampler))

    def _join_inner(self, session: Session, cfg) -> None:
        session.header_sent = False
        if self.server.sat_compression == "svd":
            self.members[session] = self.server._svd_muxer(cfg)
        else:
            if session.wire is not None:
                # Rejoin after an error eviction: release the old encoder
                # and resend header state (fresh FragmentWriter, seq 0).
                session.wire.close()
            # Honor the session's adapted AIMD rate on rejoin (rate_bps
            # equals the configured target for fresh sessions): a member
            # that was struggling before its eviction must not silently
            # come back at full rate while its controller state still
            # reads the decreased value.
            session.wire = self.server._make_encoder(
                cfg, bitrate=session.rate_bps or None
            )
            self.members[session] = self.server._wire_muxer(cfg, session.wire)
        if self.task is None:
            self.task = asyncio.create_task(self._loop())
            self.task.add_done_callback(_log_task_failure)
            self.task.add_done_callback(lambda _t: self._teardown())

    def _sharded_pair(self, cfg):
        """The mesh's (prepare, sample) pair, by the policy of
        ``batch_pair``: "auto" is fused where the pipeline is inside the
        fused sampler's contract, the row-sharded SAT pair otherwise.  An
        explicit "fused" off the contract already failed the join."""
        from foveax_torch.parallel.sharded import (
            jit_serve_parts,
            jit_serve_parts_fused,
        )

        mesh, p = self.server.mesh, self.pipeline
        mode = self.server.batch_sampler
        if mode == "auto":
            mode = "fused" if p.fused_ok else "sat"
        if mode == "fused":
            return jit_serve_parts_fused(p.grid, mesh, wrap_x=p.wrap_x)
        space = mesh.shape["space"]
        if cfg.source_height % space != 0:
            raise ValueError(
                f"mesh space axis ({space}) must divide the source "
                f"height ({cfg.source_height})"
            )
        return jit_serve_parts(p.grid, mesh)

    def _teardown(self) -> None:
        """Remove the channel once its loop ends (video over, crash, or
        cancellation) so later joins get a fresh channel instead of
        attaching to a dead one.  The dead flag + synchronous channel
        removal in leave() close the join-during-teardown window."""
        self.dead = True
        if self.server.channels.get(self.video) is self:
            self.server.channels.pop(self.video, None)
        for member in self.members:
            if member.channel is self:
                member.channel = None
        self.members.clear()
        # The reader's close waits for an in-flight read (Feed.close), and
        # this callback is synchronous: it runs as a task.
        feed, self.feed = self.feed, None
        if feed is None:
            return
        try:
            self._closing_task = asyncio.get_running_loop().create_task(feed.close())
        except RuntimeError:  # no running loop (interpreter teardown)
            feed.reader.close()

    def leave(self, session: Session) -> None:
        self.members.pop(session, None)
        session.header_sent = False
        # Clear the membership pointer here (not only in _teardown) so an
        # error-evicted but still-connected session can re-request a
        # stream instead of being silently ignored by _start_stream_inner.
        if session.channel is self:
            session.channel = None
        if not self.members and self.task is not None:
            # Remove the channel from the registry synchronously so a
            # concurrent join creates a fresh channel.
            self.dead = True
            if self.server.channels.get(self.video) is self:
                self.server.channels.pop(self.video, None)
            task, self.task = self.task, None
            task.cancel()  # done-callback runs _teardown

    def _update_decimation(self, n_members: int, tick: float) -> int:
        """Cadence decimation factor for this tick: ceil of (estimated
        full-membership encode batch time / 90% of the tick), clamped to
        16.  The estimate is the measured per-member share of the batch
        wall time (contention- and pool-sharing-inclusive — see the
        timing note at the gather) times the full membership; it is
        decimation-independent, so the factor relaxes automatically as
        members leave or encodes get cheaper."""
        if self._enc_ema <= 0.0 or n_members == 0:
            self.decimation = 1
            return 1
        budget = 0.9 * tick
        est = self._enc_ema * n_members
        k_target = max(1, min(16, math.ceil(est / budget)))
        # Preset ladder first (software encode's cheapest degradation is
        # quality, not frames): before RAISING k, try stepping the wire
        # preset a rung cheaper and hold the raise ~1.5 s so the
        # renegotiated encoders can pull the EMA back under budget; only
        # an exhausted ladder decimates.  Pressure relaxes (slowly, via
        # the server's rate limit) after sustained deep headroom.
        if k_target > self.decimation and self._preset_hold > 0:
            self._preset_hold -= 1
            return self.decimation
        if (
            k_target > self.decimation
            and self.pipeline is not None
            and self.server._bump_preset_pressure(self.pipeline.config)
        ):
            self._preset_hold = 45
            self._preset_relax_ticks = 0
            return self.decimation
        if self.decimation == 1 and k_target == 1 and est <= 0.5 * budget:
            self._preset_relax_ticks += 1
            if self._preset_relax_ticks >= 150:
                self.server._drop_preset_pressure()
                self._preset_relax_ticks = 0
        else:
            self._preset_relax_ticks = 0
        # Hysteresis: raising is immediate (overload protection), but
        # lowering waits for ~half a second of sustained headroom — a
        # k flap near a boundary would re-phase every member's schedule
        # and destroy the stable-cadence property decimation exists for.
        if k_target > self.decimation:
            self.decimation = k_target
            self._relax_ticks = 0
        elif k_target < self.decimation:
            self._relax_ticks += 1
            if self._relax_ticks >= 15:
                self.decimation = k_target
                self._relax_ticks = 0
        else:
            self._relax_ticks = 0
        return self.decimation

    async def _loop(self) -> None:
        feed, server = self.feed, self.server
        frame_num = 0
        while server.max_frames is None or frame_num < server.max_frames:
            with ServeTick.unit(tally=server.tally, channel=self.video) as unit:
                prepared = await feed.next_frame()
                if prepared is None:
                    break
                members = list(self.members.items())
                if server.sat_compression == "svd":
                    sends = await feed.svd_sends(prepared, members)
                else:
                    sends = await self._encoded(prepared, members, frame_num, unit)
                for session, *send in sends:
                    try:
                        await feed.send(frame_num, session, *send)
                    except Exception:
                        self.leave(session)
            frame_num += 1

    async def _encoded(self, prepared, members, frame_num: int, unit) -> list:
        """The tick's sends outside SVD mode: the gazes of the members
        served this tick sampled in one batch, then each member's frame
        encoded."""
        if not members:
            return []
        # Deterministic degradation under encode saturation: when the
        # measured per-member encode cost times the membership exceeds
        # what the executor can finish inside one tick, serve each
        # member every k-th tick (phase-spread by join ordinal) so
        # every member keeps a STABLE decimated cadence instead of
        # the global clock stretching for everyone.  The reference's
        # analogous load response is its bounded-wait frame drop
        # (reference: src/video_server.cc:365-374); backlog dropping
        # alone cannot catch this case because the bottleneck is the
        # executor, not any one socket.
        k = self._update_decimation(len(members), 1.0 / self.server.config.fps)
        if k > 1:
            # Phase = live position in the insertion-ordered member
            # dict: always densely spread mod k, with no ordinal
            # bookkeeping that could cluster after churn (churn
            # shifts survivors' phases by at most their index delta
            # — one off-stride beat, then stable again).
            served = []
            for idx, (s, m) in enumerate(members):
                if (frame_num + idx) % k == 0:
                    served.append((s, m))
                else:
                    s.frames_decimated += 1
                    self.server.total_decimated += 1
            members = served
            if not members:
                return []

        centers = [s.effective_center() for s, _ in members]
        for s_, _ in members:
            s_.mark_gaze_applied()
        unit.attrs["viewers"] = len(centers)
        feed = self.feed
        batch_np = await feed.call(lambda: feed.tick.sample(prepared, centers))
        if batch_np is None:  # deadline missed: skip, stay alive
            return []

        # Per-member encodes run concurrently (cv2/libx264 release the
        # GIL): the device gives N gazes nearly for free in one
        # batched launch, and serial host encodes must not hand that
        # back at high member counts.  Backlog drops happen *before*
        # the encode so an inter-frame encoder's state never advances
        # past the bytes its client actually received.
        loop = asyncio.get_running_loop()
        encode_jobs = []  # (session, mux, center, member, future)
        for i, (session, mux) in enumerate(members):
            if feed.dropped(session):
                continue
            fresh = await session.refresh_wire(mux, feed.config)
            if fresh is None:
                # The client was told and its socket closed BEFORE
                # leave(): evicting the last member cancels THIS task, and
                # the CancelledError would fire at the next await —
                # aborting the very notify/close that prevents the client
                # hang this path exists to fix.
                self.leave(session)
                continue
            if fresh is not mux:
                self.members[session] = mux = fresh
            wire = session.wire
            if wire is None:
                # The member left between the tick's membership
                # snapshot and this encode fan-out: leave() already
                # released its encoder.  Found by the real-load
                # 32-member churn test — at high fps the window is
                # wide enough to hit every run, and dereferencing
                # the dead wire here killed the whole channel.
                continue
            if hasattr(wire, "quality"):
                wire.quality = session.quality
            encode_jobs.append((session, mux, centers[i], i, loop.run_in_executor(
                None, profiling.bind(_encode), wire, batch_np[i], i,
            )))
        # Saturation measurement: wall time of the whole gathered
        # batch, normalized per member.  Timing individual encodes
        # would double-count parallelism (each encode's wall time
        # already includes contention from its pool-mates, and the
        # pool is shared with read/build/sample jobs) — the batch
        # window is what actually has to fit inside a tick.
        t_batch = time.perf_counter()
        results = await asyncio.gather(
            *(job[4] for job in encode_jobs), return_exceptions=True
        )
        if encode_jobs:
            d = (time.perf_counter() - t_batch) / len(encode_jobs)
            self._enc_ema = (
                d if self._enc_ema == 0.0
                else 0.7 * self._enc_ema + 0.3 * d
            )
        return [(*job[:4], result) for job, result in zip(encode_jobs, results)]


class FoveaxServer:
    def __init__(
        self,
        config: FoveaxConfig | None = None,
        *,
        video_dir: str | Path = "1080p_videos",
        jpeg_quality: int = 90,
        max_frames: int | None = None,
        broadcast: bool = False,
        loop_videos: bool = False,
        predict_gaze: "bool | str" = "off",
        allow_paths: bool = False,
        wire_codec: str = "auto",
        wire_bitrate: int = 0,
        wire_crf: int = 25,
        wire_preset: str = "auto",
        sat_compression: str = "none",
        svd_wire_compress: str = "rle",
        mesh: "object | None" = None,
        encode_workers: int | None = None,
        adapt_rate: bool = False,
        place_videos: str = "default",
        batch_sampler: str = "auto",
        readback_deadline_s: float = 120.0,
        device: str | torch.device | None = None,
    ):
        # The device every pipeline of this server runs on: cuda unless
        # the caller passes device="cpu" (raises without a GPU).
        self.device = resolve_device(device)
        self.config = config or FoveaxConfig()
        self.video_dir = Path(video_dir)
        self.jpeg_quality = jpeg_quality
        self.max_frames = max_frames
        self.broadcast = broadcast
        self.loop_videos = loop_videos
        # Gaze prediction mode: "off" | "linear" | "kalman" (bools accepted
        # for back-compat: True = "linear").
        if predict_gaze is True:
            predict_gaze = "linear"
        elif predict_gaze is False:
            predict_gaze = "off"
        if predict_gaze not in ("off", "linear", "kalman"):
            raise ValueError(f"unknown predict_gaze mode {predict_gaze!r}")
        self.predict_gaze = predict_gaze
        self.allow_paths = allow_paths
        # Wire codec: "auto" prefers inter-frame H.264 (the reference's
        # wire format, src/video_encoder.cc:3-78) and falls back to
        # intra-only JPEG when the native codec shim is unavailable.
        if wire_codec == "auto":
            wire_codec = "h264" if "h264" in available_wire_codecs() else "jpeg"
        elif wire_codec != "jpeg" and wire_codec not in available_wire_codecs():
            raise ValueError(f"wire codec {wire_codec!r} unavailable on this host")
        self.wire_codec = wire_codec
        self.wire_bitrate = wire_bitrate
        self.wire_crf = wire_crf
        # Encoder speed preset: "auto" resolves per operating point by
        # measured cost on this host (pick_wire_preset — the capacity
        # lever BENCHMARKS.md "Composed serving capacity" quantifies);
        # "" keeps the codec default (veryfast).
        if wire_preset not in ("auto", "") and wire_preset not in WIRE_PRESETS:
            raise ValueError(f"unknown wire_preset {wire_preset!r}")
        self.wire_preset = wire_preset
        self._preset_cache: dict[tuple, str] = {}
        # Encode-saturation preset pressure (auto mode only): before a
        # channel decimates member cadence, the server steps the wire
        # preset DOWN the WIRE_PRESETS ladder (toward ultrafast) —
        # software encode's cheapest degradation is quality, not frames
        # (the reference never faces this: NVENC silicon,
        # src/video_encoder.cc:28-58).  Sessions pick the change up
        # lazily through the rate-renegotiation machinery (a preset
        # generation stamp on each encoder).
        self._preset_pressure = 0
        self._preset_gen = 0
        self._preset_changed_at = float("-inf")
        self.total_preset_downgrades = 0
        # Live per-session AIMD on the wire bitrate (requires a
        # rate-targeted inter-frame encoder, i.e. wire_bitrate > 0).
        self.adapt_rate = adapt_rate
        if adapt_rate and wire_bitrate <= 0:
            raise ValueError("--adapt-rate requires --wire-bitrate > 0")
        if adapt_rate and wire_codec == "jpeg":
            raise ValueError(
                "--adapt-rate needs an inter-frame wire codec (JPEG "
                "already adapts via per-frame quality)"
            )
        # "svd": stream rank-r SAT factors + residual instead of foveated
        # frames — foveation moves client-side (zero gaze latency, one
        # stream serves any number of gazes).  Goes beyond the reference,
        # which built the kernels but never wired them into a program
        # (src/sat_decoder.cc:774-885).
        if sat_compression not in ("none", "svd"):
            raise ValueError(f"unknown sat_compression {sat_compression!r}")
        self.sat_compression = sat_compression
        # Residual entropy-coding strategy for the SVD wire (v2):
        # rle = zlib Z_RLE, deflate = zlib level-1, none = raw (every
        # sample self-contained).
        if svd_wire_compress not in ("rle", "deflate", "none"):
            raise ValueError(
                f"unknown svd_wire_compress {svd_wire_compress!r}"
            )
        self.svd_wire_compress = svd_wire_compress
        # Broadcast-tick sampling strategy: "sat" amortizes one SAT build
        # (kernel K5) per tick across the member batch, then samples each
        # gaze with the 4-tap sampler; "fused" skips the SAT and samples
        # the whole batch in one segreduce_xy launch; "direct" skips the
        # SAT and every kernel (core/direct.py, plain PyTorch).  "auto"
        # resolves in FoveationPipeline.batch_pair: fused where the shape
        # is inside the fused sampler's contract, "sat" otherwise.
        if batch_sampler not in ("auto", "sat", "direct", "fused"):
            raise ValueError(f"unknown batch_sampler {batch_sampler!r}")
        if batch_sampler not in ("auto", "sat") and sat_compression == "svd":
            raise ValueError(
                "sat_compression='svd' streams the SAT itself; "
                "batch_sampler must stay 'sat' or 'auto'"
            )
        self.batch_sampler = batch_sampler
        # Optional foveax_torch.parallel Mesh over ("data", "space"):
        # broadcast channels split the SAT scan over `space` rows and the
        # client batch over `data` (foveax_torch/parallel/sharded.py).
        # None = the single-device pipeline.
        self.mesh = mesh
        if mesh is not None:
            names = tuple(mesh.axis_names)
            if names != ("data", "space"):
                raise ValueError(
                    f'mesh axes must be ("data", "space"), got {names}'
                )
            if batch_sampler == "direct":
                # The sharded pairs are SAT and fused; serving unsharded
                # instead would misreport what the loop runs.
                raise ValueError(
                    "--mesh has no sharded direct sampler; use "
                    "auto, sat, or fused"
                )
            if sat_compression == "svd":
                log.warning(
                    "--mesh is ignored with --sat-compression svd (the SVD "
                    "blob is built once per tick on the default pipeline)"
                )
        # Video-set device placement: "round_robin" gives each video
        # (channel or session) the next CUDA device at open time, with a
        # pipeline bound to it — the second multi-device serving axis
        # (shard the CLIENT BATCH over a mesh via --mesh, or the VIDEO
        # SET across devices via this).  Mutually exclusive with --mesh,
        # which shards ONE video's computation over all devices.
        if place_videos not in ("default", "round_robin"):
            raise ValueError(f"unknown place_videos mode {place_videos!r}")
        if place_videos == "round_robin" and mesh is not None:
            raise ValueError(
                "--place-videos round_robin and --mesh are mutually "
                "exclusive (mesh shards one video over all devices)"
            )
        self.place_videos = place_videos
        self._place_count = 0  # videos placed so far (round-robin cursor)
        # Write-buffer bytes beyond which a session's frame is dropped
        # rather than stalling the pacer.
        self.max_send_backlog = 8 * 1024 * 1024
        # Encode-executor parallelism assumed by the saturation detector
        # (asyncio's default executor sizing); tests pass an explicit
        # value to model a constrained host deterministically.
        self.encode_workers = encode_workers or min(
            32, (os.cpu_count() or 1) + 4
        )
        self.pipeline: FoveationPipeline | None = None
        self.sessions: set[Session] = set()
        self.channels: dict[str, BroadcastChannel] = {}
        self.total_sent = 0
        self.total_dropped = 0
        self.total_decimated = 0
        # Gaze-apply latency samples (ms), gaze arrival -> sampling tick;
        # drained each stats period for p50/p90 observability.
        self.gaze_apply_ms: "deque[float]" = deque(maxlen=4096)
        # The ticks' spans (serve.tick and every serve.* span inside it),
        # summarised per stats period.
        self.tally = profiling.StageTimer("serve")
        # Per-tick device->host readbacks get a deadline (ReadbackGuard):
        # a wedged transfer can stall for minutes while compute keeps
        # working; a serve loop must degrade to skipped frames, not hang.
        # Must exceed a slow first tick (a kernel's nvcc build).  <= 0
        # disables the guard.
        self.readback_deadline_s = readback_deadline_s
        self.total_readback_skips = 0
        # LRU-bounded: each entry holds a device grid, and the key space
        # is remote-influenced (per-resolution) — unbounded
        # growth would let a client exhaust memory via novel dimensions.
        # Keyed by (width, height, device): a pipeline is bound to its
        # device, and round_robin places videos on several.
        self._pipelines: "OrderedDict[tuple, FoveationPipeline]" = (
            OrderedDict()
        )
        self.max_pipelines = 4

    # -- video resolution --------------------------------------------------

    def _resolve(self, name: str):
        """Map a videoRequest name to a source (the reference confines
        requests to `1080p_videos/<name>.mp4`, src/video_server.cc:53).

        Remote input is untrusted: names must stay inside video_dir — no
        separators, no traversal.  Synthetic sources are always allowed.
        """
        if name.startswith("synthetic://"):
            # Clamp remote-controlled synthetic dimensions BEFORE the
            # reader constructor allocates full-resolution host arrays
            # (and before each novel (w, h) builds a pipeline) —
            # unbounded specs are a memory/CPU exhaustion vector.  8K
            # area is the largest supported config.
            w, h, _, _, _ = parse_synthetic_spec(name)
            if w * h > 7680 * 4320:
                raise ValueError(f"synthetic source too large: {name!r}")
            if w < 8 or h < 8:
                raise ValueError(f"synthetic source too small: {name!r}")
            return open_video(name, loop=self.loop_videos)
        if self.allow_paths and Path(name).exists():
            # Trusted/local deployments only (--allow-paths).
            return open_video(Path(name), loop=self.loop_videos)
        if "/" in name or "\\" in name or name.startswith("."):
            raise ValueError(f"invalid video name: {name!r}")
        p = (self.video_dir / f"{name}.mp4").resolve()
        if self.video_dir.resolve() not in p.parents:
            raise ValueError(f"video escapes video_dir: {name!r}")
        return open_video(p, loop=self.loop_videos)

    def _pipeline_for(
        self, width: int, height: int, device: torch.device | None = None
    ) -> FoveationPipeline:
        """The pipeline for a source size on ``device`` (default: the
        server's)."""
        device = self.device if device is None else device
        key = (width, height, device)
        if key not in self._pipelines:
            cfg = self.config
            if (width, height) != (cfg.source_width, cfg.source_height):
                cfg = cfg.with_source(width, height)
            self._pipelines[key] = FoveationPipeline(cfg, device=device)
            while len(self._pipelines) > self.max_pipelines:
                self._pipelines.popitem(last=False)
        self._pipelines.move_to_end(key)
        return self._pipelines[key]

    def _next_device(self) -> torch.device | None:
        """Round-robin device for the next video, or None for the server's.

        Placement is assigned per video (channel or session) at open time
        and stays fixed for its lifetime; the cursor only advances when a
        device is actually handed out.  Returns None when placement is
        off, the server runs on the CPU, or a single CUDA device is
        visible — the server's own device then serves every video.
        """
        if self.place_videos != "round_robin" or self.device.type != "cuda":
            return None
        n = torch.cuda.device_count()
        if n <= 1:
            return None
        device = torch.device("cuda", self._place_count % n)
        self._place_count += 1
        return device

    # -- SVD mode ------------------------------------------------------------

    def _svd_muxer(self, cfg: FoveaxConfig) -> FragmentWriter:
        """The ``fxsv`` track: the payload is a full-frame object
        (gaze-independent), so the track advertises the SOURCE
        dimensions."""
        return FragmentWriter(
            cfg.source_width, cfg.source_height, self.config.fps,
            svdwire.SAMPLE_FORMAT,
        )

    def _wire_muxer(self, cfg: FoveaxConfig, wire) -> FragmentWriter:
        """The reduced-frame track of ``wire``'s encoded samples."""
        return FragmentWriter(
            cfg.reduced_width,
            cfg.reduced_height,
            self.config.fps,
            wire.sample_format,
            codec_config=wire.codec_config,
        )

    def _make_svd_packer(self) -> svdwire.SvdWirePacker:
        return svdwire.SvdWirePacker(
            sync_every=self.config.gop_size, compress=self.svd_wire_compress
        )

    def _pack_svd(self, packer: svdwire.SvdWirePacker, sat: torch.Tensor):
        """Read the SAT back, factor it on the host and pack it:
        ``(blob, is_sync)``.  Runs inside the guarded executor call."""
        return packer.pack(
            compress_sat(sat, self.config.svd_rank, device="cpu")
        )

    def _resolve_preset_base(self, cfg: FoveaxConfig) -> str:
        """Resolve --wire-preset auto once per operating point (codec x
        reduced size): the probe costs a few sub-tick encodes, so cache
        the answer for every later session at the same point."""
        if self.wire_preset != "auto":
            return self.wire_preset
        key = (self.wire_codec, cfg.reduced_width, cfg.reduced_height)
        if key not in self._preset_cache:
            self._preset_cache[key] = pick_wire_preset(
                self.wire_codec,
                cfg.reduced_width,
                cfg.reduced_height,
                self.config.fps,
                bitrate=self.wire_bitrate,
                crf=self.wire_crf,
            )
            log.info(
                "wire preset auto -> %r at %dx%d",
                self._preset_cache[key],
                cfg.reduced_width,
                cfg.reduced_height,
            )
        return self._preset_cache[key]

    def _resolve_preset(self, cfg: FoveaxConfig) -> str:
        """Effective preset = the resolved base stepped down the ladder
        by the current encode-saturation pressure (auto mode only)."""
        base = self._resolve_preset_base(cfg)
        if self._preset_pressure and base in WIRE_PRESETS:
            i = WIRE_PRESETS.index(base)
            return WIRE_PRESETS[max(0, i - self._preset_pressure)]
        return base

    # One preset step per second at most: a renegotiation wave must
    # land (and the encode EMA re-converge) before the next verdict.
    _PRESET_STEP_MIN_S = 1.0
    _PRESET_RELAX_MIN_S = 5.0

    def _bump_preset_pressure(self, cfg: FoveaxConfig) -> bool:
        """Step the wire preset one rung cheaper if possible.  True when
        a step happened (or one landed within the last second — callers
        hold their cadence response either way); False when the ladder
        is exhausted, pinned (non-auto), or preset-less (jpeg).

        Exhaustion is checked before the rate limit: the JAX package's
        server (serve/server.py there) answers True inside the one-second
        window even on an exhausted ladder, which holds a decimation
        raise that no preset step can replace."""
        if self.wire_preset != "auto":
            return False
        base = self._resolve_preset_base(cfg)
        if base not in WIRE_PRESETS:
            return False
        if WIRE_PRESETS.index(base) - self._preset_pressure <= 0:
            return False
        now = time.monotonic()
        if now - self._preset_changed_at < self._PRESET_STEP_MIN_S:
            return True
        self._preset_pressure += 1
        self._preset_gen += 1
        self._preset_changed_at = now
        self.total_preset_downgrades += 1
        log.info(
            "encode saturation: wire preset pressure -> %d (%r at the "
            "flagship point)", self._preset_pressure,
            self._resolve_preset(cfg),
        )
        return True

    def _drop_preset_pressure(self) -> bool:
        """Relax one rung after sustained headroom (channel-judged)."""
        if self._preset_pressure <= 0:
            return False
        now = time.monotonic()
        if now - self._preset_changed_at < self._PRESET_RELAX_MIN_S:
            return False
        self._preset_pressure -= 1
        self._preset_gen += 1
        self._preset_changed_at = now
        log.info(
            "encode headroom: wire preset pressure -> %d",
            self._preset_pressure,
        )
        return True

    def _make_encoder(self, cfg: FoveaxConfig, bitrate: int | None = None):
        """Per-session wire encoder (inter-frame state is per-client, like
        the reference's per-connection VideoEncoder, src/video_server.h:41).
        ``bitrate`` overrides the configured target (rate adaptation)."""
        enc = make_wire_encoder(
            self.wire_codec,
            cfg.reduced_width,
            cfg.reduced_height,
            self.config.fps,
            bitrate=self.wire_bitrate if bitrate is None else bitrate,
            crf=self.wire_crf,
            gop_size=self.config.gop_size,
            jpeg_quality=self.jpeg_quality,
            preset=self._resolve_preset(cfg),
        )
        # Preset-generation stamp: a later pressure change makes this
        # encoder stale, and the encode fan-out renegotiates it through
        # the same path rate adaptation uses.
        enc._foveax_preset_gen = self._preset_gen
        return enc

    @staticmethod
    def _backlog(ws) -> int:
        transport = getattr(ws, "transport", None)
        if transport is None:
            return 0
        try:
            return transport.get_write_buffer_size()
        except Exception:
            return 0

    # -- connection handlers -----------------------------------------------

    async def handle(self, ws) -> None:
        """Serve one connection: any object with ``send``, ``close`` and
        async iteration over incoming messages."""
        session = Session(ws, self)
        self.sessions.add(session)
        try:
            await self._serve_session(ws, session)
        except connection_closed_errors():
            pass  # abrupt disconnects are routine, not handler failures
        finally:
            self.sessions.discard(session)
            await session.close()

    async def _serve_session(self, ws, session: "Session") -> None:
        async for raw in ws:
            if isinstance(raw, (bytes, bytearray)):
                continue  # clients do not send binary
            try:
                msg = protocol.loads(raw)
            except ValueError as e:
                log.warning("bad message: %s", e)
                continue
            if isinstance(msg, TextMessage):
                await ws.send(
                    protocol.dumps(
                        TextMessage(f"I got your message: {msg.message}")
                    )
                )
            elif isinstance(msg, FrameRequest):
                session.update_gaze(msg.centerX, msg.centerY)
                await ws.send(protocol.dumps(Ack(msg.packetNumber)))
            elif isinstance(msg, VideoRequest):
                await self._start_stream(session, msg.video)

    async def _start_stream(self, session: Session, video: str) -> None:
        try:
            await self._start_stream_inner(session, video)
        except (ValueError, IOError) as e:
            # Bad/unopenable video names are client errors, not session
            # killers: report and keep the connection alive.
            log.warning("videoRequest %r rejected: %s", video, e)
            await session.ws.send(
                protocol.dumps(TextMessage(f"videoRequest failed: {e}"))
            )

    async def _start_stream_inner(self, session: Session, video: str) -> None:
        if self.broadcast:
            if session.channel is None:
                channel = self.channels.get(video)
                if channel is None or channel.dead:
                    channel = BroadcastChannel(self, video)
                    self.channels[video] = channel
                try:
                    channel.join(session)
                except Exception:
                    if not channel.members:
                        self.channels.pop(video, None)
                    raise
                session.channel = channel
            return
        if session.send_task is not None:
            return
        # Build everything into locals first: a failure after the reader
        # opens must close it, not leave it leaking on the session for a
        # retry to overwrite (videoRequest errors keep the session alive).
        reader = self._resolve(video)
        try:
            device = self._next_device()
            if device is not None:
                log.info("session video %s placed on %s", video, device)
            pipeline = self._pipeline_for(reader.width, reader.height, device)
            cfg = pipeline.config
            if self.sat_compression == "svd":
                # SVD mode streams the SAT itself, so prepare must stay
                # the SAT build.
                mux, wire = self._svd_muxer(cfg), None
                tick = ServeTick(pipeline, (pipeline.build_sat, None))
            else:
                wire = self._make_encoder(cfg)
                mux = self._wire_muxer(cfg, wire)
                # single_pair resolves to the pipeline's sampler: the SAT
                # pair (prepare = the SAT build, gaze-late 4-tap sample)
                # off the fused sampler's contract, else the fused sampler
                # (prepare = staging, all device work gaze-late).
                tick = ServeTick(pipeline, pipeline.single_pair(), single=True)
            feed = Feed(self, reader, tick)
        except Exception:
            reader.close()
            raise
        session.feed = feed
        session.wire = wire
        session.mux = mux
        session.send_task = asyncio.create_task(self._send_frame_loop(session))
        session.send_task.add_done_callback(_log_task_failure)

    def _stream_info(self, cfg: FoveaxConfig, sample_format: bytes) -> str:
        """Stream metadata as a reference-compatible ``text`` message.

        The binary header only advertises the TRANSMITTED (reduced) track
        dimensions; a client that did not share the server's config (e.g.
        the browser viewer) needs the source dimensions to size its
        unwarp.  Riding in a ``text`` message keeps the wire vocabulary
        exactly the reference's (src/video_server.cc:102-117) — clients
        that don't understand it ignore it.
        """
        return protocol.dumps(
            TextMessage(
                json.dumps(
                    {
                        "kind": "streamInfo",
                        "sourceWidth": cfg.source_width,
                        "sourceHeight": cfg.source_height,
                        "reducedWidth": cfg.reduced_width,
                        "reducedHeight": cfg.reduced_height,
                        "fps": self.config.fps,
                        "codec": sample_format.decode("ascii", "replace"),
                    }
                )
            )
        )

    async def _send_frame_loop(self, session: Session) -> None:
        """The 30 fps hot loop (reference: src/video_server.cc:197-427)."""
        feed = session.feed
        # Header-first, as the reference sends the mp4 header as the first
        # binary frame (src/video_server.cc:273-280).
        await feed.send_header(session, session.mux)
        frame_num = 0
        while self.max_frames is None or frame_num < self.max_frames:
            with ServeTick.unit(tally=self.tally, session=id(session), viewers=1):
                prepared = await feed.next_frame()
                if prepared is None:
                    break
                if self.sat_compression == "svd":
                    sends = await feed.svd_sends(prepared, [(session, session.mux)])
                else:
                    sends = await self._single_sends(feed, session, prepared)
                    if sends is None:  # renegotiation failed: the stream is over
                        return
                for send in sends:
                    await feed.send(frame_num, *send)
            frame_num += 1

    async def _single_sends(self, feed: Feed, session: Session, prepared):
        """The session loop's sends outside SVD mode: its frame at the
        current gaze, sampled and encoded; None where the stream is over."""
        center = session.effective_center()
        session.mark_gaze_applied()
        # The backlog drop runs *before* the encode: an inter-frame
        # encoder's state must never advance past the bytes the client
        # actually received, and skipping the device sample + encode
        # entirely is also cheaper.
        if feed.dropped(session):
            return []
        mux = await session.refresh_wire(session.mux, feed.config)
        if mux is None:
            return None
        session.mux = mux
        wire = session.wire
        if hasattr(wire, "quality"):
            wire.quality = session.quality
        # The sample readback is guarded SEPARATELY from the encode: only
        # the device->host transfer can wedge, and an abandoned tick must
        # never have advanced the wire encoder's inter-frame state past
        # bytes the client actually received (same rule as the backlog
        # drop above).
        reduced_np = await feed.call(lambda: feed.tick.sample(prepared, center))
        if reduced_np is None:  # readback deadline missed
            return []
        result = await asyncio.get_running_loop().run_in_executor(
            None, profiling.bind(_encode), wire, reduced_np, 0
        )
        return [(session, mux, center, 0, result)]

    # -- entry -------------------------------------------------------------

    async def _stats_loop(self, period_s: float = 10.0) -> None:
        """Periodic one-line observability: sessions, delivered fps, drops,
        and p50/p95 of the period's ticks and of each step of them, from
        the spans that fed ``tally`` (the reference's closest analog is an
        every-30-frames print, src/run_satlogrectilinear.cc:724-726)."""
        prev_sent = prev_dropped = prev_decimated = prev_rb = 0
        prev_bytes = profiling.counts()
        self.tally.drain()
        while True:
            await asyncio.sleep(period_s)
            spans = self.tally.drain()
            now_bytes = profiling.counts()
            copied = "stage=%.0fMB/s readback=%.0fMB/s " % tuple(
                (now_bytes.get(k, 0) - prev_bytes.get(k, 0)) / period_s / 1e6
                for k in ("serve.stage_bytes", "serve.readback_bytes")
            )
            prev_bytes = now_bytes
            sent = self.total_sent
            dropped = self.total_dropped
            decimated = self.total_decimated
            rb = self.total_readback_skips
            if self.sessions or sent != prev_sent:
                if self.gaze_apply_ms:
                    lat = np.asarray(self.gaze_apply_ms)
                    self.gaze_apply_ms.clear()
                    gaze_s = "gaze_apply p50=%.0fms p90=%.0fms " % (
                        float(np.percentile(lat, 50)),
                        float(np.percentile(lat, 90)),
                    )
                else:
                    gaze_s = ""
                log.info(
                    "sessions=%d channels=%d fps=%.1f dropped=%d "
                    "decimated=%d rb_skipped=%d preset_pressure=%d "
                    "%s%s%sq_avg=%.0f",
                    len(self.sessions),
                    len(self.channels),
                    (sent - prev_sent) / period_s,
                    dropped - prev_dropped,
                    decimated - prev_decimated,
                    rb - prev_rb,
                    self._preset_pressure,
                    gaze_s,
                    _span_tails(spans),
                    copied,
                    np.mean([s.quality for s in self.sessions])
                    if self.sessions
                    else float(self.jpeg_quality),
                )
            prev_sent, prev_dropped, prev_decimated, prev_rb = (
                sent, dropped, decimated, rb,
            )

    async def run(self, port: int | None = None, *, host: str = "0.0.0.0"):
        import websockets

        port = port or self.config.server_port
        stats_task = asyncio.create_task(self._stats_loop())
        try:
            async with websockets.serve(
                self.handle, host, port, max_size=64 * 1024 * 1024
            ):
                log.info("Listening on port %d", port)
                await asyncio.Future()
        finally:
            stats_task.cancel()

    async def serve_ctx(self, port: int, *, host: str = "127.0.0.1"):
        """Context-manager variant for tests."""
        import websockets

        return websockets.serve(self.handle, host, port, max_size=64 * 1024 * 1024)
