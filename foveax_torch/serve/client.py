"""Headless streaming client (the port's fork of
``foveax/serve/client.py``): it unwarps on its device, ``cuda`` unless it
is given ``device="cpu"``.

The reference client (src/video_client.cc) couples websocket receive, FFmpeg
streaming decode, the OpenCL unwarp, and an SDL/OpenGL renderer via CL-GL
interop.  This client demuxes fragments, decodes the reduced frame
(H.264/VP9/JPEG — the codec is read from the stream's sample entry, like
the reference's streaming-probed decode, src/video_client.cc:167-181),
unwarps on the device (``FoveationPipeline.unwarp_auto``: the fused
kernel ``unwarp_xy`` inside its contract, the exact unwarp elsewhere), and
hands full frames to a pluggable sink (PNG dump, callback, or nothing —
for latency measurement).

An ``fxsv`` stream (the server's SVD mode) carries rank-r SAT factors
instead of a reduced frame: :class:`SvdDecoder` unpacks them onto the
device and box-filters the reduced frame there at the client's own gaze,
and the unwarp takes it on the device at that same gaze.

``run()`` connects with ``websockets``; ``run_on(ws)`` streams on a
connection it is given (any object with ``send`` and async iteration over
incoming messages).

Per-phase latency accounting mirrors the reference's receive/decode/unwarp
averages printed at exit (src/video_client.h:68-73, src/video_client.cc:
375-383), including the gaze-bucketed breakdown (GazeToIndex quantizes the
gaze into a 10x10 grid, src/video_client.cc:434-438), with the p50 and
p95 of decode, upload, unwarp and readback beside the means.  Those
phases are the tracer's ``client.*`` spans, which feed the stats as they
exit: ``client.decode`` around the decoder, and the spans of
:class:`ClientRestore`, the restore (upload, ``unwarp_auto``, readback)
as one callable.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import defaultdict

import numpy as np
import torch

from foveax_torch.config import FoveaxConfig
from foveax_torch.core.logrect import make_grid
from foveax_torch.core.svd_sat import create_reduced_sat, sample_from_reduced_sat
from foveax_torch.device import resolve_device
from foveax_torch.io import svdwire
from foveax_torch.io.mux import make_fragment_reader
from foveax_torch.io.wirecodec import make_wire_decoder
from foveax_torch.pipeline import profiling
from foveax_torch.pipeline.frames import FoveationPipeline
from foveax_torch.serve import protocol
from foveax_torch.serve.protocol import (
    Ack, FrameMeta, FrameRequest, TextMessage, VideoRequest, connection_closed_errors,
)
from foveax_torch.serve.tick import readback, upload

log = logging.getLogger(__name__)


def gaze_to_index(cx: float, cy: float) -> int:
    """Quantize a gaze to a 10x10 bucket (reference:
    src/video_client.cc:434-438)."""
    xi = min(int(cx * 10), 9)
    yi = min(int(cy * 10), 9)
    return yi * 10 + xi


# averages()' percentile phases and the client.* spans they are read from.
_PHASE_SPANS = (("decode", "decode"), ("upload", "upload"), ("unwarp", "restore"),
                ("readback", "readback"))


@dataclasses.dataclass
class ClientStats:
    frames: int = 0
    receive_ms: float = 0.0
    decode_ms: float = 0.0
    unwarp_ms: float = 0.0
    # Gaze-application latency: time from sending a frameRequest to
    # receiving the first frame whose echoed center matches it.
    gaze_apply_ms: list = dataclasses.field(default_factory=list)
    # Total binary bytes received (header + fragments) — the wire cost
    # of the session (the reference prints receive averages only,
    # src/video_client.cc:375-383; bytes make the bandwidth explicit).
    wire_bytes: int = 0
    by_gaze: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    )
    # The client.* spans' summaries (decode, restore, upload, readback),
    # for the percentiles.
    spans: profiling.StageTimer = dataclasses.field(
        default_factory=lambda: profiling.StageTimer("client")
    )

    def record(self, gaze_idx: int, recv: float, dec: float, unw: float) -> None:
        self.frames += 1
        self.receive_ms += recv
        self.decode_ms += dec
        self.unwarp_ms += unw
        b = self.by_gaze[gaze_idx]
        b[0] += 1
        b[1] += recv
        b[2] += dec
        b[3] += unw

    def averages(self) -> dict:
        """Means per frame, and the p50 and p95 of decode, upload, unwarp
        (the whole restore) and readback from the spans (0.0 before the
        first)."""
        n = max(self.frames, 1)
        g = self.gaze_apply_ms
        out = {
            "frames": self.frames,
            "avg_receive_ms": self.receive_ms / n,
            "avg_decode_ms": self.decode_ms / n,
            "avg_unwarp_ms": self.unwarp_ms / n,
            "avg_gaze_apply_ms": sum(g) / len(g) if g else None,
        }
        spans = self.spans.stats
        for phase, name in _PHASE_SPANS:
            s = spans.get(name, profiling.StageStat())
            out[f"p50_{phase}_ms"], out[f"p95_{phase}_ms"] = s.p50_ms, s.p95_ms
        return out

    def report(self) -> str:
        a = self.averages()
        lines = [
            f"frames: {a['frames']}",
            f"avg receive: {a['avg_receive_ms']:.2f} ms",
            f"avg decode: {a['avg_decode_ms']:.2f} ms "
            f"(p50 {a['p50_decode_ms']:.2f}, p95 {a['p95_decode_ms']:.2f})",
            f"avg unwarp: {a['avg_unwarp_ms']:.2f} ms "
            f"(p50 {a['p50_unwarp_ms']:.2f}, p95 {a['p95_unwarp_ms']:.2f}; "
            f"upload p50 {a['p50_upload_ms']:.2f}, p95 {a['p95_upload_ms']:.2f}; "
            f"readback p50 {a['p50_readback_ms']:.2f}, p95 {a['p95_readback_ms']:.2f})",
        ]
        if a["avg_gaze_apply_ms"] is not None:
            lines.append(f"avg gaze-apply: {a['avg_gaze_apply_ms']:.2f} ms")
        for idx in sorted(self.by_gaze):
            n, r, d, u = self.by_gaze[idx]
            lines.append(
                f"gaze[{idx:02d}] n={n} recv={r / n:.2f} dec={d / n:.2f} "
                f"unwarp={u / n:.2f} ms"
            )
        return "\n".join(lines)


class ClientRestore:
    """A client's restore as one callable: upload the decoded reduced
    frame and its gaze, ``pipeline.unwarp_auto``, then the restored frame
    back to host memory, in a ``client.restore`` root span with
    ``client.upload`` and ``client.readback`` inside, which feed
    ``tally`` (a client's ``ClientStats.spans``); :attr:`last` is the last
    restore's root span.  Both copies are the serve tick's
    (``serve/tick.py::upload`` and ``readback``): a frame restored on the
    card lands in a pinned block of PyTorch's caching host allocator, which
    the caller owns through the returned array, so a frame sink may keep
    it; a sink that keeps every frame holds pinned memory (128 MiB a frame
    at 8K, 8 MiB at 1080p).  ``client.readback`` carries ``fresh`` and the counter
    ``client.readback_fresh`` counts the readbacks that had to grow the
    pool.  With ``readback`` false (a client with no frame sink) it waits
    for the unwarp with a one-element readback and returns None."""

    def __init__(self, pipeline: FoveationPipeline, *, readback: bool = True,
                 tally: profiling.StageTimer | None = None):
        self.pipeline = pipeline
        self.readback = readback
        self.tally = tally
        self.last: profiling.root | None = None

    def __call__(self, reduced, center) -> np.ndarray | None:
        """``reduced``: the (Hr, Wr, 3) uint8 frame, a host array or a
        tensor (on the device already, from an SVD decoder); ``center``:
        (cx, cy)."""
        with profiling.root("client.restore", tally=self.tally) as self.last:
            reduced, c = upload(reduced, self.pipeline.device,
                                profiling.span("client.upload"), gaze=center)
            full = self.pipeline.unwarp_auto(reduced, c)
            return readback(full, profiling.span("client.readback"), whole=self.readback)


class SvdDecoder:
    """Decoder for ``fxsv`` streams: unpack the rank-r SAT factors onto
    ``device`` and box-filter a reduced frame at the caller's gaze there
    (client-side foveation; reference kernels
    src/sat_decoder_sample_rect_kernel.cl:25-136, never wired upstream).

    Stateful: v2 delta samples reconstruct against the previous residual;
    after any gap (drop, mid-GOP join) :meth:`decode` returns None until
    the next sync sample, and the caller skips the frame.
    """

    def __init__(self, cfg: FoveaxConfig, device: torch.device):
        self.device = device
        self.grid = make_grid(
            cfg.reduced_width, cfg.reduced_height,
            cfg.source_width, cfg.source_height, device,
        )
        self.unpacker = svdwire.SvdWireUnpacker(device)

    def decode(self, sample: bytes, gaze) -> torch.Tensor | None:
        """(Hr, Wr, 3) uint8 reduced frame on the device, or None after a
        gap.  Waits for the device, so a caller's clock around the call
        counts the decode's device work."""
        svd = self.unpacker.unpack(sample)
        if svd is None:
            return None
        center = torch.tensor(gaze, dtype=torch.float32).to(self.device)
        reduced = sample_from_reduced_sat(create_reduced_sat(svd, self.grid, center))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return reduced


class FoveaxClient:
    def __init__(
        self,
        uri: str,
        *,
        video: str = "03_drone_d5d4gnuAJLo",
        config: FoveaxConfig | None = None,
        gaze_source=None,
        frame_sink=None,
        max_frames: int | None = None,
        on_text=None,
        unwarp: str = "auto",
        device: str | torch.device | None = None,
    ):
        # The unwarp's device: cuda unless the caller passes
        # device="cpu" (raises without a GPU).
        self.device = resolve_device(device)
        self.uri = uri
        self.video = video
        self.config = config or FoveaxConfig()
        self.gaze_source = gaze_source  # callable i -> (cx, cy)
        self.frame_sink = frame_sink  # callable (frame_np, meta) -> None
        self.max_frames = max_frames
        # "off" skips the restore entirely (stats/fan-in measurement on a
        # host whose unwarp can't sustain the wire rate — the render half
        # is measured separately; requires no frame_sink).
        if unwarp not in ("auto", "off"):
            raise ValueError(f"unknown unwarp mode {unwarp!r}")
        if unwarp == "off" and frame_sink is not None:
            raise ValueError("unwarp='off' cannot feed a frame_sink")
        self.unwarp = unwarp
        # Server text messages carry stream-level errors (e.g. "stream
        # ended: encoder renegotiation failed") — surface them.
        self.on_text = on_text or (lambda m: log.info("server: %s", m))
        self.stats = ClientStats()
        self._packet_number = 0
        self._last_sent_gaze: tuple[float, float] | None = None
        self._gaze_sent_at: dict[tuple[float, float], float] = {}

    def _make_decoder(self, sample_format, codec_config, size_hint):
        """The wire decoder for a stream's sample entry (one per init
        segment)."""
        return make_wire_decoder(sample_format, codec_config, size_hint)

    def _make_svd_decoder(self, cfg: FoveaxConfig) -> SvdDecoder:
        """The decoder for an ``fxsv`` stream (one per init segment)."""
        return SvdDecoder(cfg, self.device)

    async def run(self) -> ClientStats:
        """Connect to ``self.uri`` with ``websockets`` and stream."""
        import websockets

        async with websockets.connect(
            self.uri, max_size=64 * 1024 * 1024
        ) as ws:
            return await self.run_on(ws)

    async def _request_gaze(self, ws, gaze) -> None:
        self._packet_number += 1
        await ws.send(
            protocol.dumps(
                FrameRequest(
                    centerX=gaze[0],
                    centerY=gaze[1],
                    packetNumber=self._packet_number,
                )
            )
        )
        self._last_sent_gaze = gaze

    async def run_on(self, ws) -> ClientStats:
        """Stream on the connection ``ws`` until ``max_frames`` frames are
        restored or the server ends the stream."""
        try:
            return await self._stream(ws)
        except connection_closed_errors() as e:
            # A server-initiated close (e.g. 1011 after a failed encoder
            # renegotiation) ends the stream; the reason was already
            # surfaced via the text channel.
            log.warning("server closed the stream: %s", e)
            return self.stats

    async def _stream(self, ws) -> ClientStats:
        cfg = self.config
        restore = ClientRestore(
            FoveationPipeline(cfg, device=self.device),
            readback=self.frame_sink is not None,
            tally=self.stats.spans,
        )
        demux = make_fragment_reader()
        decoder = None  # built after the header announces the codec
        built_headers = 0  # init segments consumed (rebuild on each new one)
        svd_mode = False
        pending_meta: FrameMeta | None = None
        last_recv = time.perf_counter()
        # Pacing floor on outgoing gaze requests (the reference enforces
        # >=5 ms per client loop iteration, src/video_client.h:60,
        # src/video_client.cc:352-355).
        floor_s = cfg.client_loop_floor_ms / 1e3
        last_request_at = -float("inf")

        await ws.send(protocol.dumps(VideoRequest(self.video)))
        # Send the initial gaze WITH the handshake: waiting for the
        # first restored frame would let a free-running server emit
        # center-gazed frames first.  The reference's client has the
        # same pattern — its first frameRequest goes out at stream
        # start, not on first render (reference:
        # src/video_client.cc:125-146).
        if self.gaze_source is not None:
            await self._request_gaze(ws, self.gaze_source(0))
            last_request_at = time.perf_counter()
            # Deliberately NOT seeded into _gaze_sent_at: the first
            # echo spans stream startup (the server's first tick, which
            # may build its kernels), which would skew the gaze-apply
            # latency stats that measure steady-state fan-in.
        async for raw in ws:
            if isinstance(raw, str):
                msg = protocol.loads(raw)
                if isinstance(msg, FrameMeta):
                    pending_meta = msg
                    # Gaze-application latency: first frame whose echoed
                    # center matches a gaze we sent.  (With server-side
                    # gaze PREDICTION the echo is the predicted center
                    # and never matches — the metric reads None then.)
                    key = (round(msg.centerX, 5), round(msg.centerY, 5))
                    sent = self._gaze_sent_at.pop(key, None)
                    if sent is not None:
                        self.stats.gaze_apply_ms.append(
                            (time.perf_counter() - sent) * 1e3
                        )
                elif isinstance(msg, TextMessage):
                    self.on_text(msg.message)
                elif isinstance(msg, Ack):
                    pass
                continue

            # Binary: header or fragment.
            recv_ms = (time.perf_counter() - last_recv) * 1e3
            self.stats.wire_bytes += len(raw)
            samples = demux.feed(bytes(raw))
            # Rebuild the decoder on every NEW init segment, not just
            # the first: a rate-adapting server renegotiates its
            # encoder mid-stream and re-sends the header (the new
            # sample entry carries the new codec config; the fresh
            # stream starts on an IDR).
            header_count = getattr(
                demux, "header_count", 1 if demux.header_seen else 0
            )
            if header_count != built_headers and demux.header_seen:
                built_headers = header_count
                if decoder is not None and hasattr(decoder, "close"):
                    decoder.close()
                decoder = None
            if decoder is None and demux.header_seen:
                sample_format = getattr(demux, "sample_format", None)
                svd_mode = sample_format == svdwire.SAMPLE_FORMAT
                # Reconcile the stream's dimensions with the local
                # pipeline before decoding anything: a server/client
                # resolution mismatch must fail loudly, not produce
                # geometrically wrong restored frames.  SVD streams
                # carry a full-frame object, so their track advertises
                # the SOURCE dimensions.
                expect = (
                    (cfg.source_width, cfg.source_height)
                    if svd_mode
                    else (cfg.reduced_width, cfg.reduced_height)
                )
                if (demux.width, demux.height) != expect:
                    raise ValueError(
                        f"stream is {demux.width}x{demux.height} but the "
                        f"client pipeline expects {expect[0]}x{expect[1]}; "
                        f"pass a config matching the server's source"
                    )
                if svd_mode:
                    decoder = self._make_svd_decoder(cfg)
                else:
                    decoder = self._make_decoder(
                        sample_format,
                        getattr(demux, "codec_config", None),
                        (demux.width, demux.height),
                    )
            for sample_i, sample in enumerate(samples):
                meta = pending_meta
                # The inter-message wait belongs to the message, not
                # to each contained sample.
                if sample_i > 0:
                    recv_ms = 0.0
                with profiling.span("client.decode", tally=self.stats.spans,
                                    bytes=len(sample)) as decode:
                    if svd_mode:
                        # Client-side foveation: the blob is gaze-
                        # independent; apply OUR current gaze locally
                        # (zero gaze-to-photon network latency).
                        local_gaze = (
                            self.gaze_source(self.stats.frames)
                            if self.gaze_source is not None
                            else (0.5, 0.5)
                        )
                        reduced = decoder.decode(sample, local_gaze)
                    else:
                        reduced = decoder.decode(sample)
                dec_ms = decode.ms
                if reduced is None:
                    continue  # decoder delay (not foveax streams)
                if reduced.shape[:2] != (cfg.reduced_height, cfg.reduced_width):
                    raise ValueError(
                        f"decoded sample is {reduced.shape[1]}x"
                        f"{reduced.shape[0]}, expected "
                        f"{cfg.reduced_width}x{cfg.reduced_height}"
                    )

                if svd_mode:
                    # Unwarp with the SAME gaze the local foveation
                    # used, not the server echo.
                    center = local_gaze
                else:
                    # The paired metadata carries the gaze the server
                    # sampled this frame with (the image echo,
                    # reference: src/video_server.cc:396-401).
                    center = (
                        (meta.centerX, meta.centerY) if meta else (0.5, 0.5)
                    )
                if self.unwarp == "off":
                    unw_ms = 0.0
                    full_np = None
                else:
                    # Within 1 LSB of the exact unwarp, fovea bit-exact:
                    # the client is latency-critical, like the
                    # reference's GPU unwarp (src/video_client.cc:313-322).
                    # An SVD decoder's reduced frame is already on the
                    # device; a wire decoder's is a host array.  A
                    # stats-only client waits for the unwarp with a
                    # one-element readback instead of the full-frame
                    # transfer.
                    full_np = restore(reduced, center)
                    unw_ms = restore.last.ms

                self.stats.record(
                    gaze_to_index(*center), recv_ms, dec_ms, unw_ms
                )
                if self.frame_sink is not None:
                    self.frame_sink(full_np, meta)

                # Gaze update (the mouse-move path, reference:
                # src/video_client.cc:125-146): dedupe by epsilon.
                if self.gaze_source is not None:
                    gaze = self.gaze_source(self.stats.frames)
                    if (
                        time.perf_counter() - last_request_at >= floor_s
                    ) and (
                        self._last_sent_gaze is None
                        or abs(gaze[0] - self._last_sent_gaze[0]) > 1e-5
                        or abs(gaze[1] - self._last_sent_gaze[1]) > 1e-5
                    ):
                        await self._request_gaze(ws, gaze)
                        last_request_at = time.perf_counter()
                        self._gaze_sent_at.setdefault(
                            (round(gaze[0], 5), round(gaze[1], 5)),
                            time.perf_counter(),
                        )
                        # Entries whose echo never arrives (superseded
                        # gazes; any server-side prediction) would
                        # otherwise accumulate forever.
                        while len(self._gaze_sent_at) > 256:
                            self._gaze_sent_at.pop(
                                next(iter(self._gaze_sent_at))
                            )

                if (
                    self.max_frames is not None
                    and self.stats.frames >= self.max_frames
                ):
                    return self.stats
            last_recv = time.perf_counter()
        return self.stats
