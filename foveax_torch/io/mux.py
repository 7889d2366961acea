"""Fragmented-MP4 (ISO-BMFF) muxing/demuxing for the streaming wire format.

The reference streams fragmented MP4 assembled in memory by FFmpeg's movenc
with ``frag_keyframe+empty_moov+default_base_moof`` and sends the header as
the first binary websocket frame, then one fragment per video frame
(reference: src/video_server.cc:241-280,386-405).  It vendors two full
FFmpeg source trees to do so.  foveax instead implements the ISO-BMFF box
format directly: an init segment (ftyp+moov with an mvex/trex so the file
is fragment-structured) and per-frame moof+mdat fragments.

Two interchangeable implementations exist:
  * this pure-Python one (always available), and
  * the C++ native one in ``foveax_torch/native`` (preferred when built),
which must produce byte-identical output — enforced by tests.

The sample codec inside the fragments is an implementation detail of the
session (JPEG samples by default — a valid MP4 'jpeg' visual sample entry
— chosen because intra-only frames give the same low-latency properties
the reference tunes NVENC for, with no GPU codec dependency).
"""

from __future__ import annotations

import struct

TIMESCALE = 90_000


def _box(fourcc: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + fourcc + body


def _full(fourcc: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags), *payload)


def _matrix_identity() -> bytes:
    return struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def init_segment(
    width: int,
    height: int,
    sample_format: bytes = b"jpeg",
    codec_config: tuple[bytes, bytes] | None = None,
) -> bytes:
    """ftyp + moov(mvhd, trak, mvex) — the stream header sent first.

    ``codec_config``: optional (fourcc, payload) appended inside the visual
    sample entry — e.g. (b"avcC", <AVCDecoderConfigurationRecord>) for
    avc1 samples once an H.264 encoder is available.  JPEG samples need
    no configuration box.
    """
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso5dash")

    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">II", 0, 0),            # creation/modification time
        struct.pack(">I", TIMESCALE),
        struct.pack(">I", 0),                # duration unknown (fragmented)
        struct.pack(">i", 0x00010000),       # rate 1.0
        struct.pack(">h", 0x0100),           # volume
        b"\x00" * 10,                        # reserved
        _matrix_identity(),
        b"\x00" * 24,                        # predefined
        struct.pack(">I", 2),                # next track id
    )

    tkhd = _full(
        b"tkhd", 0, 7,                       # enabled | in-movie | in-preview
        struct.pack(">II", 0, 0),
        struct.pack(">I", 1),                # track id
        struct.pack(">I", 0),                # reserved
        struct.pack(">I", 0),                # duration
        b"\x00" * 8,
        struct.pack(">hhhh", 0, 0, 0, 0),    # layer, group, volume, reserved
        _matrix_identity(),
        struct.pack(">II", width << 16, height << 16),
    )

    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">II", 0, 0),
        struct.pack(">I", TIMESCALE),
        struct.pack(">I", 0),
        struct.pack(">HH", 0x55C4, 0),       # language 'und'
    )
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0),
        b"vide",
        b"\x00" * 12,
        b"foveax\x00",
    )

    entry_parts = [
        b"\x00" * 6,                          # reserved
        struct.pack(">H", 1),                 # data reference index
        b"\x00" * 16,                         # predefined/reserved
        struct.pack(">HH", width, height),
        struct.pack(">II", 0x480000, 0x480000),  # 72 dpi
        struct.pack(">I", 0),
        struct.pack(">H", 1),                 # frame count
        b"\x00" * 32,                         # compressor name
        struct.pack(">H", 24),                # depth
        struct.pack(">h", -1),                # predefined
    ]
    if codec_config is not None:
        entry_parts.append(_box(codec_config[0], codec_config[1]))
    sample_entry = _box(sample_format, *entry_parts)
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), sample_entry)
    stts = _full(b"stts", 0, 0, struct.pack(">I", 0))
    stsc = _full(b"stsc", 0, 0, struct.pack(">I", 0))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, 0))
    stco = _full(b"stco", 0, 0, struct.pack(">I", 0))
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)

    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd, dinf, stbl)
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    trak = _box(b"trak", tkhd, mdia)

    trex = _full(
        b"trex", 0, 0,
        struct.pack(">IIIII", 1, 1, 0, 0, 0x01010000),
    )
    mvex = _box(b"mvex", trex)
    moov = _box(b"moov", mvhd, trak, mvex)
    return ftyp + moov


def fragment(
    seq: int,
    decode_time: int,
    sample: bytes,
    duration: int,
    *,
    is_sync: bool = True,
) -> bytes:
    """moof + mdat for one sample (one video frame per fragment, mirroring
    the reference's frag-per-frame flush, src/video_server.cc:386-387)."""
    mfhd = _full(b"mfhd", 0, 0, struct.pack(">I", seq))
    # default-base-is-moof (0x020000) like the reference's movflags.
    tfhd = _full(b"tfhd", 0, 0x020000, struct.pack(">I", 1))
    tfdt = _full(b"tfdt", 1, 0, struct.pack(">Q", decode_time))

    trun_flags = 0x000001 | 0x000100 | 0x000200 | 0x000400  # offset|dur|size|flags
    sample_flags = 0x02000000 if is_sync else 0x01010000
    trun_wo_offset = _full(
        b"trun", 0, trun_flags,
        struct.pack(">I", 1),                 # sample count
        struct.pack(">i", 0),                 # data offset placeholder
        struct.pack(">III", duration, len(sample), sample_flags),
    )
    traf = _box(b"traf", tfhd, tfdt, trun_wo_offset)
    moof = _box(b"moof", mfhd, traf)
    # Patch the trun data offset: first sample byte relative to moof start.
    data_offset = len(moof) + 8  # moof + mdat header
    moof = bytearray(moof)
    # trun payload sits at: moof hdr(8) + mfhd + traf hdr(8) + tfhd + tfdt +
    # trun hdr(8) + version/flags(4) + count(4) -> offset field.
    pos = 8 + len(mfhd) + 8 + len(tfhd) + len(tfdt) + 8 + 4 + 4
    struct.pack_into(">i", moof, pos, data_offset)
    mdat = _box(b"mdat", sample)
    return bytes(moof) + mdat


class FragmentWriter:
    """Stateful per-connection muxer: header first, then per-frame
    fragments with running sequence numbers and decode times.

    Uses the C++ muxer (foveax_torch/native) when built; falls back to the pure
    -Python boxes above.  Both produce byte-identical streams (tested).
    """

    def __init__(
        self,
        width: int,
        height: int,
        fps: float,
        sample_format: bytes = b"jpeg",
        *,
        codec_config: tuple[bytes, bytes] | None = None,
        backend: str = "auto",
    ):
        self.width, self.height, self.fps = width, height, fps
        self.sample_format = sample_format
        self.codec_config = codec_config
        self.duration = int(round(TIMESCALE / fps))
        self.seq = 0
        self._native = None
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown mux backend {backend!r}")
        if backend in ("auto", "native"):
            try:
                from foveax_torch import native

                if native.available():
                    self._native = native
                elif backend == "native":
                    raise RuntimeError("native muxer requested but unavailable")
            except ImportError:
                if backend == "native":
                    raise

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def header(self) -> bytes:
        if self._native is not None:
            return self._native.init_segment(
                self.width, self.height, self.sample_format, self.codec_config
            )
        return init_segment(
            self.width, self.height, self.sample_format, self.codec_config
        )

    def frame(self, sample: bytes, *, is_sync: bool = True) -> bytes:
        if self._native is not None:
            out = self._native.fragment(
                self.seq + 1,
                self.seq * self.duration,
                sample,
                self.duration,
                is_sync=is_sync,
            )
        else:
            out = fragment(
                self.seq + 1,
                self.seq * self.duration,
                sample,
                self.duration,
                is_sync=is_sync,
            )
        self.seq += 1
        return out


# --- demux ---------------------------------------------------------------


def iter_boxes(data: bytes, start: int = 0, end: int | None = None):
    """Yield (fourcc, payload_start, payload_end) for top-level boxes."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size = struct.unpack_from(">I", data, pos)[0]
        fourcc = data[pos + 4 : pos + 8]
        if size < 8 or pos + size > end:
            break
        yield fourcc, pos + 8, pos + size
        pos += size


class FragmentReader:
    """Incremental demuxer: feed arbitrary byte chunks, yields samples.

    Understands exactly the structure FragmentWriter emits (and the subset
    any fMP4 stream shares): skips ftyp/moov, extracts mdat payloads,
    reading the fragment sequence from mfhd.
    """

    def __init__(self):
        self._buf = bytearray()
        # 0 = "tkhd not (yet) parsed", exactly as the native demuxer's
        # zero-initialized struct: a corrupt moov whose trak/tkhd cannot
        # be walked still counts as a seen header, and both backends must
        # then report the same (0, 0) — dims persist across renegotiation
        # headers unless a new tkhd parses, also as the native side.
        self._width = self._height = 0
        self.header_seen = False
        # Init segments seen: >1 means the stream was renegotiated
        # mid-flight (rate adaptation) and downstream decoders must be
        # rebuilt from the new sample entry.
        self.header_count = 0
        self.last_seq = 0
        self.sample_format: bytes | None = None
        self.codec_config: tuple[bytes, bytes] | None = None

    @property
    def width(self):
        """None before any init segment, as the native binding."""
        return self._width if self.header_seen else None

    @property
    def height(self):
        return self._height if self.header_seen else None

    def feed(self, chunk: bytes) -> list[bytes]:
        self._buf.extend(chunk)
        samples: list[bytes] = []
        while True:
            if len(self._buf) < 8:
                break
            size = struct.unpack_from(">I", self._buf, 0)[0]
            if size < 8:
                # Corrupt box header: waiting for more bytes would stall
                # this stream forever while the buffer grows unboundedly.
                # The transport (websocket/TCP) is reliable, so this means
                # a framing bug — fail loudly.
                raise ValueError(f"corrupt fMP4 box header (size={size})")
            if len(self._buf) < size:
                break
            fourcc = bytes(self._buf[4:8])
            payload = bytes(self._buf[8:size])
            if fourcc == b"moov":
                self.header_seen = True
                self.header_count += 1
                self._parse_dims(payload)
            elif fourcc == b"moof":
                for fc, s, e in iter_boxes(payload):
                    # Minimum-size guard (version/flags + seq) matching the
                    # native demuxer: a corrupt short mfhd must not read
                    # the next box's bytes or raise struct.error.
                    if fc == b"mfhd" and e - s >= 8:
                        self.last_seq = struct.unpack_from(">I", payload, s + 4)[0]
            elif fourcc == b"mdat":
                samples.append(payload)
            del self._buf[:size]
        return samples

    # Visual sample entry: 78 fixed bytes after the entry header, then
    # optional codec configuration child boxes (ISO 14496-12 s12.1.3).
    _VISUAL_ENTRY_FIXED = 78

    def _parse_stsd(self, buf: bytes, start: int, end: int) -> None:
        if end - start < 16:  # version/flags + count + one entry header
            return
        entry_at = start + 8
        esize = struct.unpack_from(">I", buf, entry_at)[0]
        if esize < 8 or entry_at + esize > end:
            return
        self.sample_format = buf[entry_at + 4 : entry_at + 8]
        pos = entry_at + 8 + self._VISUAL_ENTRY_FIXED
        if pos + 8 <= entry_at + esize:
            csize = struct.unpack_from(">I", buf, pos)[0]
            if csize >= 8 and pos + csize <= entry_at + esize:
                self.codec_config = (
                    buf[pos + 4 : pos + 8],
                    buf[pos + 8 : pos + csize],
                )

    def _parse_dims(self, moov_payload: bytes) -> None:
        for fc, s, e in iter_boxes(moov_payload):
            if fc != b"trak":
                continue
            for fc2, s2, e2 in iter_boxes(moov_payload, s, e):
                if fc2 == b"tkhd" and e2 - s2 >= 8:
                    w, h = struct.unpack_from(">II", moov_payload, e2 - 8)
                    self._width, self._height = w >> 16, h >> 16
                elif fc2 == b"mdia":
                    for fc3, s3, e3 in iter_boxes(moov_payload, s2, e2):
                        if fc3 != b"minf":
                            continue
                        for fc4, s4, e4 in iter_boxes(moov_payload, s3, e3):
                            if fc4 != b"stbl":
                                continue
                            for fc5, s5, e5 in iter_boxes(moov_payload, s4, e4):
                                if fc5 == b"stsd":
                                    self._parse_stsd(moov_payload, s5, e5)


def make_fragment_reader(backend: str = "auto"):
    """Demuxer factory: the C++ parser when built, the Python one
    otherwise.  Both expose feed()/width/height/last_seq/header_seen."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown demux backend {backend!r}")
    if backend in ("auto", "native"):
        try:
            from foveax_torch import native

            if native.available():
                return native.NativeDemuxer()
        except ImportError:
            pass
        if backend == "native":
            raise RuntimeError("native demuxer requested but unavailable")
    return FragmentReader()
