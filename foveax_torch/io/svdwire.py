"""Wire serialization for SVD-compressed SATs (the port's copy of
``foveax/io/svdwire.py``: the bytes are the same; the packer reads the
factors back with ``.cpu().numpy()`` and the unpacker builds the
:class:`~foveax_torch.core.svd_sat.SVDSat` on a given device).

The reference's experimental path compresses a SAT as rank-r factors plus
a quantized residual (reference: src/sat_decoder_sample_rect_kernel.cl:1-136,
src/sat_decoder.cc:774-885) but never wires it into a serving program; foveax turns
it into a serving mode: the server streams ONE ``fxsv`` sample per source
frame (gaze-independent), and each client builds its own gaze-aligned
reduced SAT locally (foveax_torch.core.svd_sat.create_reduced_sat) — foveation
moves client-side, so gaze latency is zero and one stream serves any
number of gazes.

92% of a v1 blob is the 8-bit residual plane, which is exactly the wire
the reference links zlib for (vestigially — src/video_server.h:3-4).
Version 2 entropy-codes it: zlib level-1 on the raw plane for sync
samples, zlib on the mod-256 delta against the previous frame's residual
for intermediate ones.  Delta frames are sequence-guarded: a receiver
that missed any frame (drop-on-backlog, mid-GOP join) decodes None until
the next sync sample — the same recovery contract as video IDRs.

v1 layout (little-endian), still parsed:
    magic  b"FXSV"  | u16 version=1 | u16 rank | u32 height | u32 width
    f32 ranges[3]
    u (3, H, r) float16 | s (3, r) float32 | v (3, r, W) float16
    residual_q (H, W, 3) uint8

v2 layout: header/factors identical (version=2), then the residual
section becomes
    u8 res_mode (0=raw, 1=zlib, 2=zlib-delta) | u32 seq | u32 comp_len
    | comp_len bytes
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from foveax_torch.core.svd_sat import svd_sat_from_numpy
from foveax_torch.device import resolve_device

MAGIC = b"FXSV"
VERSION = 2

SAMPLE_FORMAT = b"fxsv"  # stsd sample entry fourcc for this payload

RES_RAW = 0
RES_ZLIB = 1
RES_ZLIB_DELTA = 2


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=dtype)


def _pack_header_and_factors(svd) -> tuple[bytes, np.ndarray]:
    u = _host(svd.u, np.float16)
    s = _host(svd.s, np.float32)
    v = _host(svd.v, np.float16)
    res = _host(svd.residual_q, np.uint8)
    ranges = _host(svd.ranges, np.float32)
    _, h, r = u.shape
    w = v.shape[2]
    header = MAGIC + struct.pack("<HHII", VERSION, r, h, w)
    return (
        b"".join([header, ranges.tobytes(), u.tobytes(), s.tobytes(), v.tobytes()]),
        res,
    )


# Encoder-side compression strategies (the wire is plain DEFLATE either
# way — receivers are agnostic).  Measured on the 1080p photo residual
# (BENCHMARKS.md, "SVD wire v2"): Z_RLE delivers ~98% of full deflate's
# ratio at 2.3x less CPU, and crushes near-static deltas (6.2 MB ->
# 6 KB in 11 ms); "deflate" is zlib level-1; "none" skips coding for
# CPU-starved hosts.
_STRATEGIES = ("rle", "deflate", "none")


def _compress(payload: bytes, strategy: str) -> bytes:
    if strategy == "deflate":
        return zlib.compress(payload, 1)
    c = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    return c.compress(payload) + c.flush()


def pack_svd(svd) -> bytes:
    """SVDSat -> stateless wire bytes (v2, compressed residual, always a
    sync sample).  Factors travel as float16 (the rank-r approximation
    tolerates it; the residual absorbs the quantization at
    reconstruction scale).  For the streaming delta mode use
    SvdWirePacker."""
    head, res = _pack_header_and_factors(svd)
    comp = _compress(res.tobytes(), "rle")
    return b"".join(
        [head, struct.pack("<BII", RES_ZLIB, 0, len(comp)), comp]
    )


class SvdWirePacker:
    """Stateful packer for the serving loop: sync samples every
    ``sync_every`` frames carry the zlib'd raw residual; the frames
    between carry the zlib'd mod-256 delta against the previous residual
    (mostly zeros on typical content — the big wire win).  pack() returns
    (payload, is_sync) so the muxer can mark sample dependencies
    honestly."""

    def __init__(self, sync_every: int = 30, compress: str = "rle"):
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if compress not in _STRATEGIES:
            raise ValueError(f"unknown compress strategy {compress!r}")
        self.sync_every = sync_every
        self.compress = compress
        self._prev: np.ndarray | None = None
        self._seq = 0
        self._since_sync = 0

    def pack(self, svd) -> tuple[bytes, bool]:
        head, res = _pack_header_and_factors(svd)
        self._seq += 1
        is_sync = (
            self.compress == "none"  # raw samples are self-contained
            or self._prev is None
            or self._prev.shape != res.shape
            or self._since_sync >= self.sync_every - 1
        )
        if is_sync:
            mode, plane = RES_ZLIB, res
            self._since_sync = 0
        else:
            # mod-256 delta: exact reconstruction via uint8 wraparound.
            mode, plane = RES_ZLIB_DELTA, res - self._prev
            self._since_sync += 1
        if self.compress == "none":
            body, mode = plane.tobytes(), RES_RAW
        else:
            body = _compress(plane.tobytes(), self.compress)
        self._prev = res
        return (
            b"".join([head, struct.pack("<BII", mode, self._seq, len(body)), body]),
            is_sync,
        )


class SvdWireUnpacker:
    """Stateful receiver: decodes sync samples always; decodes delta
    samples only when the previous residual is present AND contiguous
    (seq == prev_seq + 1), returning None otherwise — a member that
    missed a frame (backlog drop, mid-GOP join) stays dark until the
    next sync sample instead of silently decoding a corrupt plane.  The
    factors go to ``device``: ``cuda`` unless told otherwise."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self._prev: np.ndarray | None = None
        self._prev_seq: int | None = None

    def unpack(self, data: bytes):
        got = _unpack(
            data, prev=self._prev, prev_seq=self._prev_seq, device=self.device
        )
        if got is None:
            return None
        svd, res, seq = got
        self._prev = res
        self._prev_seq = seq
        return svd


def unpack_svd(data: bytes, device: str | torch.device | None = None):
    """Stateless wire bytes -> SVDSat on ``device`` (``cuda`` unless told
    otherwise; v1 or v2 sync samples; v2 delta samples need
    SvdWireUnpacker and raise here)."""
    got = _unpack(
        data, prev=None, prev_seq=None, stateless=True,
        device=resolve_device(device),
    )
    assert got is not None  # stateless path raises instead of skipping
    return got[0]


def _unpack(
    data: bytes,
    *,
    prev: np.ndarray | None,
    prev_seq: int | None,
    device: torch.device,
    stateless: bool = False,
):
    if data[:4] != MAGIC:
        raise ValueError("not an FXSV payload")
    if len(data) < 16 + 12:
        # Normalize truncation to the caller contract (ValueError, as
        # np.frombuffer already raises for short factor sections) —
        # struct.unpack_from would raise struct.error instead.
        raise ValueError("truncated FXSV payload")
    version, r, h, w = struct.unpack_from("<HHII", data, 4)
    if version not in (1, 2):
        raise ValueError(f"unsupported FXSV version {version}")
    off = 4 + 12
    ranges = np.frombuffer(data, np.float32, 3, off)
    off += 12
    u = np.frombuffer(data, np.float16, 3 * h * r, off).reshape(3, h, r)
    off += 2 * 3 * h * r
    s = np.frombuffer(data, np.float32, 3 * r, off).reshape(3, r)
    off += 4 * 3 * r
    v = np.frombuffer(data, np.float16, 3 * r * w, off).reshape(3, r, w)
    off += 2 * 3 * r * w

    seq = 0
    if version == 1:
        res = np.frombuffer(data, np.uint8, h * w * 3, off).reshape(h, w, 3)
    else:
        if len(data) < off + 9:
            raise ValueError("truncated FXSV payload")
        mode, seq, clen = struct.unpack_from("<BII", data, off)
        off += 9
        if mode not in (RES_RAW, RES_ZLIB, RES_ZLIB_DELTA):
            raise ValueError(f"unknown FXSV residual mode {mode}")
        if len(data) < off + clen:
            raise ValueError("truncated FXSV payload")
        raw = data[off : off + clen]
        if mode == RES_RAW:
            plane_bytes = raw
        else:
            try:
                plane_bytes = zlib.decompress(raw)
            except zlib.error as e:
                raise ValueError(f"corrupt FXSV residual: {e}") from None
        if len(plane_bytes) != h * w * 3:
            raise ValueError("FXSV residual size mismatch")
        plane = np.frombuffer(plane_bytes, np.uint8).reshape(h, w, 3)
        if mode == RES_ZLIB_DELTA:
            if stateless:
                raise ValueError(
                    "FXSV delta sample needs SvdWireUnpacker state"
                )
            if (
                prev is None
                or prev.shape != plane.shape
                or prev_seq is None
                or seq != prev_seq + 1
            ):
                return None  # missed a frame: dark until the next sync
            res = plane + prev
        else:
            res = plane

    return svd_sat_from_numpy(u, s, v, res, ranges, device), res, seq


def payload_size(height: int, width: int, rank: int) -> int:
    """Wire bytes for given dimensions BEFORE residual entropy coding
    (the v1 size; v2 sync/delta samples are smaller by the residual's
    compression ratio — measured per content in BENCHMARKS.md)."""
    return (
        16
        + 12
        + 2 * 3 * height * rank
        + 4 * 3 * rank
        + 2 * 3 * rank * width
        + height * width * 3
    )
