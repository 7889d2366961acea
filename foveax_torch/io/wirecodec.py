"""Inter-frame wire codecs for the streaming path.

The reference streams hardware H.264: NVENC encode on the server with
low-latency tuning (reference: src/video_encoder.cc:3-78) and a streaming
FFmpeg decode on the client (reference: src/video_decoder.cc:58-95).
foveax's equivalent is the native shim in foveax_torch/native/codec.cc (libx264 /
libvpx / mpeg4 over the system FFmpeg libraries) wrapped here behind a
two-method interface:

    encoder.encode(rgb) -> (sample_bytes, is_keyframe)
    decoder.decode(sample) -> rgb | None

Each codec maps to an ISO-BMFF sample entry so the fragments remain a
standard fMP4 stream (the reference gets this from movenc; foveax owns its
muxer, foveax_torch/io/mux.py, so it assembles the codec configuration records —
avcC / esds / vpcC — here).  JPEG implementations of the same interface
keep a fallback with no native dependency.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from foveax_torch.io.video import decode_jpeg, encode_jpeg

# codec name -> (ffmpeg encoder, sample entry fourcc)
_ENCODERS = {
    "h264": ("libx264", b"avc1"),
    "vp9": ("libvpx-vp9", b"vp09"),
    "mpeg4": ("mpeg4", b"mp4v"),
}

# sample entry fourcc -> candidate ffmpeg decoders (first available wins)
_DECODERS = {
    b"avc1": ("h264",),
    b"vp09": ("vp9", "libvpx-vp9"),
    b"mp4v": ("mpeg4",),
}

WIRE_CODECS = ("jpeg",) + tuple(_ENCODERS)

# Speed ladder for the software encoders, fastest first (x264 preset
# names; libvpx maps them onto cpu-used in the native shim).  The
# reference's analog is NVENC's PRESET_FAST (src/video_encoder.cc:28) —
# hardware encode made its speed/quality point nearly free, software
# encode makes it THE serving capacity lever (BENCHMARKS.md, "Composed
# serving capacity").
WIRE_PRESETS = ("ultrafast", "superfast", "veryfast", "faster", "fast", "medium")


def _lib():
    from foveax_torch import native

    return native.load_codec()


def available_wire_codecs() -> list[str]:
    """Wire codecs usable on this host (both encode and decode sides)."""
    out = ["jpeg"]
    lib = _lib()
    if lib is None:
        return out
    for name, (enc, fourcc) in _ENCODERS.items():
        if lib.fx_codec_probe(enc.encode(), 1) and any(
            lib.fx_codec_probe(d.encode(), 0) for d in _DECODERS[fourcc]
        ):
            out.append(name)
    return out


# --- codec configuration records ------------------------------------------


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B byte stream (00 00 [00] 01 start codes) into NALUs."""
    nals = []
    i = 0
    n = len(data)
    start = None
    while i + 3 <= n:
        if data[i] == 0 and data[i + 1] == 0:
            sc = 0
            if data[i + 2] == 1:
                sc = 3
            elif i + 4 <= n and data[i + 2] == 0 and data[i + 3] == 1:
                sc = 4
            if sc:
                if start is not None:
                    nals.append(data[start:i])
                i += sc
                start = i
                continue
        i += 1
    if start is not None:
        nals.append(data[start:])
    return nals


def build_avcc(annexb_extradata: bytes) -> bytes:
    """AVCDecoderConfigurationRecord from libx264's Annex-B SPS/PPS
    extradata (ISO 14496-15 s5.3.3.1; the reference leaves this to
    FFmpeg's movenc)."""
    sps = []
    pps = []
    for nal in split_annexb(annexb_extradata):
        if not nal:
            continue
        t = nal[0] & 0x1F
        if t == 7:
            sps.append(nal)
        elif t == 8:
            pps.append(nal)
    if not sps or not pps:
        raise ValueError("extradata lacks SPS/PPS")
    rec = bytearray()
    rec += bytes([1, sps[0][1], sps[0][2], sps[0][3]])  # ver, profile, compat, level
    rec += bytes([0xFF])  # reserved(6) + lengthSizeMinusOne=3 (4-byte NALU lengths)
    rec += bytes([0xE0 | len(sps)])
    for s in sps:
        rec += len(s).to_bytes(2, "big") + s
    rec += bytes([len(pps)])
    for p in pps:
        rec += len(p).to_bytes(2, "big") + p
    return bytes(rec)


def _mp4_descriptor(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with 4-byte expandable length (ISO 14496-1 s8.3.3)."""
    n = len(payload)
    size = bytes(
        [0x80 | ((n >> s) & 0x7F) for s in (21, 14, 7)] + [n & 0x7F]
    )
    return bytes([tag]) + size + payload


def build_esds(decoder_specific_info: bytes, avg_bitrate: int = 0) -> bytes:
    """esds box payload (full-box header + ES_Descriptor) for MPEG-4 Part 2
    visual samples; decoder_specific_info is the VOL header the encoder put
    in its extradata."""
    dsi = _mp4_descriptor(0x05, decoder_specific_info)
    dcd = _mp4_descriptor(
        0x04,
        bytes([0x20, 0x11])  # objectType=MPEG-4 Visual, streamType=visual
        + b"\x00\x00\x00"  # bufferSizeDB
        + (avg_bitrate or 0).to_bytes(4, "big") * 2  # max/avg bitrate
        + dsi,
    )
    slc = _mp4_descriptor(0x06, b"\x02")
    es = _mp4_descriptor(0x03, b"\x00\x01\x00" + dcd + slc)
    return b"\x00\x00\x00\x00" + es  # full-box version/flags


def parse_esds_dsi(esds_payload: bytes) -> bytes | None:
    """Extract the DecoderSpecificInfo (tag 0x05) payload back out of an
    esds box payload — what the decoder needs as extradata."""
    data = esds_payload[4:]  # skip full-box version/flags

    def read_desc(buf: bytes, pos: int) -> tuple[int, int, int]:
        tag = buf[pos]
        pos += 1
        size = 0
        for _ in range(4):
            b = buf[pos]
            pos += 1
            size = (size << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        return tag, pos, size

    pos = 0
    while pos < len(data):
        tag, body, size = read_desc(data, pos)
        if tag == 0x03:  # ES_Descriptor: ES_ID(2) + flags(1), then
            # optional fields the flags gate (ISO 14496-1 s7.2.6.5):
            # streamDependenceFlag -> dependsOn_ES_ID(2), URL_Flag ->
            # URLlength(1)+URLstring, OCRstreamFlag -> OCR_ES_Id(2).
            if body + 3 > len(data):
                return None
            flags = data[body + 2]
            skip = 3
            if flags & 0x80:
                skip += 2
            if flags & 0x40:
                if body + skip >= len(data):
                    return None
                skip += 1 + data[body + skip]
            if flags & 0x20:
                skip += 2
            pos = body + skip
        elif tag == 0x04:  # DecoderConfigDescriptor: skip 13 fixed bytes
            pos = body + 13
        elif tag == 0x05:
            return data[body : body + size]
        else:
            pos = body + size
    return None


def build_vpcc() -> bytes:
    """vpcC box payload (VP codec configuration, version 1) with 8-bit
    4:2:0 defaults — VP9 streams are self-describing so the decoder side
    never reads this; it exists to make the fMP4 spec-complete."""
    return bytes(
        [
            1, 0, 0, 0,  # version 1, flags 0
            0,  # profile
            10,  # level 1.0
            (8 << 4) | (1 << 1),  # bitDepth=8, chromaSubsampling=4:2:0
            2, 2, 2,  # colour primaries/transfer/matrix: unspecified
        ]
    ) + (0).to_bytes(2, "big")  # codecInitializationDataSize


# --- encoder / decoder wrappers --------------------------------------------


class WireEncoder:
    """Stateful per-session inter-frame encoder (one per client, like the
    reference's per-connection VideoEncoder, src/video_server.h:41).

    ``bitrate`` > 0 selects rate-targeted mode; otherwise ``crf`` selects
    quality-targeted mode (the reference runs both: bitrate 1e8 + cq 25,
    src/video_encoder.cc:28-58).
    """

    def __init__(
        self,
        codec: str,
        width: int,
        height: int,
        fps: float = 30.0,
        *,
        bitrate: int = 0,
        crf: int = 25,
        gop_size: int = 30,
        preset: str = "",
    ):
        if codec not in _ENCODERS:
            raise ValueError(f"unknown wire codec: {codec!r}")
        if preset and preset not in WIRE_PRESETS:
            raise ValueError(f"unknown wire preset: {preset!r}")
        lib = _lib()
        if lib is None:
            raise RuntimeError("native codec shim unavailable")
        enc_name, self.sample_format = _ENCODERS[codec]
        self.codec = codec
        self.preset = preset
        self.width, self.height = width, height
        err = ctypes.create_string_buffer(256)
        self._lib = lib
        # Created before fx_enc_open so close() (via __del__) can always
        # release the native handle, even if _build_config below raises.
        # encode() runs in executor threads while close() may run on the
        # event loop (session teardown during an in-flight broadcast
        # tick): serialize access to the native handle — closing it under
        # a running fx_enc_encode is a use-after-free.
        self._hlock = threading.Lock()
        self._h = lib.fx_enc_open(
            enc_name.encode(),
            width,
            height,
            float(fps),
            int(bitrate),
            int(crf),
            int(gop_size),
            preset.encode(),
            err,
            len(err),
        )
        if not self._h:
            raise RuntimeError(f"encoder open failed: {err.value.decode()}")
        self._out_cap = max(width * height * 3, 1 << 20)
        self._out = ctypes.create_string_buffer(self._out_cap)
        self.codec_config = self._build_config(bitrate)

    def _extradata(self) -> bytes:
        cap = 4096
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.fx_enc_extradata(self._h, buf, cap)
        if n < 0:
            cap = -n
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.fx_enc_extradata(self._h, buf, cap)
        return bytes(buf[:n]) if n > 0 else b""

    def _build_config(self, bitrate: int) -> tuple[bytes, bytes] | None:
        extra = self._extradata()
        if self.codec == "h264":
            return (b"avcC", build_avcc(extra))
        if self.codec == "mpeg4":
            return (b"esds", build_esds(extra, bitrate))
        if self.codec == "vp9":
            return (b"vpcC", build_vpcc())
        return None

    def encode(self, frame_rgb: np.ndarray) -> tuple[bytes, bool]:
        frame_rgb = np.ascontiguousarray(frame_rgb, dtype=np.uint8)
        if frame_rgb.shape != (self.height, self.width, 3):
            raise ValueError(
                f"frame {frame_rgb.shape} != encoder "
                f"{(self.height, self.width, 3)}"
            )
        is_key = ctypes.c_int(0)
        with self._hlock:
            if not self._h:
                raise IOError("encoder closed")
            n = self._lib.fx_enc_encode(
                self._h,
                frame_rgb.ctypes.data_as(ctypes.c_char_p),
                self._out,
                self._out_cap,
                ctypes.byref(is_key),
            )
        if n <= -1000000:
            raise IOError(f"encode failed ({n})")
        if n < 0:  # buffer too small — grow and retry would re-encode;
            raise IOError(f"encoded sample exceeds buffer ({-n} bytes)")
        if n == 0:
            # Zero-latency settings make this unreachable for the codecs
            # above; surface loudly rather than desync the fragment clock.
            raise IOError("encoder buffered the frame (latency contract broken)")
        return bytes(self._out[:n]), bool(is_key.value)

    def close(self) -> None:
        lock = getattr(self, "_hlock", None)
        if lock is None:
            return
        with lock:  # waits out an in-flight executor encode (~ms)
            if self._h:
                self._lib.fx_enc_close(self._h)
                self._h = None

    def __del__(self):
        self.close()


class WireDecoder:
    """Streaming decoder fed demuxed samples (the analog of the reference
    client's custom-AVIO streaming decode, src/video_client.cc:167-181,
    minus the container layer — foveax's demuxer already stripped it)."""

    def __init__(
        self,
        sample_format: bytes,
        codec_config: tuple[bytes, bytes] | None = None,
        *,
        size_hint: tuple[int, int] | None = None,
    ):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native codec shim unavailable")
        self._lib = lib
        candidates = _DECODERS.get(bytes(sample_format))
        if candidates is None:
            raise ValueError(f"no decoder for sample format {sample_format!r}")
        name = next(
            (c for c in candidates if lib.fx_codec_probe(c.encode(), 0)), None
        )
        if name is None:
            raise RuntimeError(f"no decoder available for {sample_format!r}")
        extradata = b""
        if codec_config is not None:
            cfg_fourcc, payload = codec_config
            if cfg_fourcc == b"avcC":
                # The record itself is the extradata; its presence switches
                # FFmpeg's h264 parser to length-prefixed NALU input.
                extradata = payload
            elif cfg_fourcc == b"esds":
                extradata = parse_esds_dsi(payload) or b""
            # vpcC carries no decoder-required bytes (VP9 self-describes).
        err = ctypes.create_string_buffer(256)
        self._h = lib.fx_dec_open(
            name.encode(), extradata, len(extradata), err, len(err)
        )
        if not self._h:
            raise RuntimeError(f"decoder open failed: {err.value.decode()}")
        self._cap = 0
        self._buf = None
        # Pre-size from the stream dimensions when known (the demuxer's
        # track header) so the grow-and-take retry never runs in steady
        # state.
        if size_hint is not None:
            self._ensure(size_hint[0] * size_hint[1] * 3)
        else:
            self._ensure(1 << 22)

    def _ensure(self, cap: int) -> None:
        if cap > self._cap:
            self._cap = cap
            self._buf = ctypes.create_string_buffer(cap)

    def _to_frame(self, w: int, h: int) -> np.ndarray:
        # ctypes array slicing copies only w*h*3 bytes (.raw would first
        # materialize the whole capacity-sized buffer); .copy() keeps the
        # returned array writable and independent of the reused buffer.
        return (
            np.frombuffer(self._buf[: w * h * 3], dtype=np.uint8)
            .reshape(h, w, 3)
            .copy()
        )

    def _finish(self, n: int, w, h, what: str) -> np.ndarray | None:
        """Resolve a decode/flush return: 1 = frame, 0 = none, -(needed)
        with w set = grow the buffer and take the HELD frame (re-sending
        the packet would corrupt inter-frame state; the shim retains the
        decoded frame instead), anything else = hard error.  The
        -(needed) space overlaps numerically with error codes for frames
        >= ~0.6 MP — w > 0 disambiguates (errors leave it 0)."""
        if n < 0 and w.value > 0 and n == -(w.value * h.value * 3):
            self._ensure(-n)
            n = self._lib.fx_dec_take(
                self._h, self._buf, self._cap, ctypes.byref(w), ctypes.byref(h)
            )
        if n < 0:
            raise IOError(f"{what} failed ({n})")
        if n == 0:
            return None
        return self._to_frame(w.value, h.value)

    def decode(self, sample: bytes) -> np.ndarray | None:
        """Feed one sample; returns an RGB frame or None (decoder delay —
        does not occur with foveax's own zero-latency streams)."""
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        n = self._lib.fx_dec_decode(
            self._h, sample, len(sample), self._buf, self._cap,
            ctypes.byref(w), ctypes.byref(h),
        )
        return self._finish(n, w, h, "decode")

    def flush(self) -> np.ndarray | None:
        """Drain a buffered frame at end of stream (raises on decoder
        errors rather than masking them as end-of-stream)."""
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        n = self._lib.fx_dec_flush(
            self._h, self._buf, self._cap, ctypes.byref(w), ctypes.byref(h)
        )
        return self._finish(n, w, h, "flush")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.fx_dec_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# --- JPEG fallback (intra-only), same interface -----------------------------


class JpegWireEncoder:
    """Intra-only fallback: every sample is a sync sample.  ``quality`` is
    mutable — the server's AIMD loop adjusts it per-frame."""

    sample_format = b"jpeg"
    codec_config = None
    codec = "jpeg"

    def __init__(self, width: int, height: int, quality: int = 90):
        self.width, self.height = width, height
        self.quality = float(quality)

    def encode(self, frame_rgb: np.ndarray) -> tuple[bytes, bool]:
        return encode_jpeg(np.asarray(frame_rgb), int(self.quality)), True

    def close(self) -> None:
        pass


class JpegWireDecoder:
    def decode(self, sample: bytes) -> np.ndarray:
        return decode_jpeg(sample)

    def flush(self) -> None:
        return None

    def close(self) -> None:
        pass


def make_wire_encoder(
    codec: str,
    width: int,
    height: int,
    fps: float = 30.0,
    *,
    bitrate: int = 0,
    crf: int = 25,
    gop_size: int = 30,
    jpeg_quality: int = 90,
    preset: str = "",
):
    if codec == "jpeg":
        return JpegWireEncoder(width, height, jpeg_quality)
    return WireEncoder(
        codec, width, height, fps, bitrate=bitrate, crf=crf,
        gop_size=gop_size, preset=preset,
    )


def probe_frame(width: int, height: int, i: int) -> np.ndarray:
    """Moving synthetic probe content for encode-cost measurement: a
    shifting gradient + texture — all-static frames flatter inter-frame
    codecs; pure noise punishes them unrealistically."""
    ys = np.arange(height, dtype=np.uint32)[:, None]
    xs = np.arange(width, dtype=np.uint32)[None, :]
    plane = ((xs * 3 + ys * 7 + i * 11) ^ (xs >> 2)) & 0xFF
    return np.stack(
        [plane, (plane + 85) & 0xFF, (plane + 170) & 0xFF], axis=-1
    ).astype(np.uint8)


def measure_encode(
    codec: str,
    width: int,
    height: int,
    fps: float = 30.0,
    *,
    preset: str = "",
    bitrate: int = 0,
    crf: int = 25,
    frames: int = 4,
    jpeg_quality: int = 90,
) -> tuple[float, float]:
    """(median per-frame encode wall ms, kbit/s at ``fps``) at this exact
    operating point, measured on THIS host (probe_frame content)."""
    import time

    enc = make_wire_encoder(
        codec, width, height, fps,
        bitrate=bitrate, crf=crf, preset=preset, jpeg_quality=jpeg_quality,
    )
    try:
        times = []
        nbytes = 0
        for i in range(frames + 1):
            frame = probe_frame(width, height, i)
            t0 = time.perf_counter()
            sample, _ = enc.encode(frame)
            if i:  # first frame pays keyframe + lazy-init costs
                times.append(time.perf_counter() - t0)
                nbytes += len(sample)
        ms = sorted(times)[len(times) // 2] * 1e3
        kbitps = nbytes * 8 / max(frames, 1) * fps / 1e3
        return ms, kbitps
    finally:
        enc.close()


def measure_encode_cost(codec, width, height, fps=30.0, **kw) -> float:
    """Median per-frame encode wall time (ms); see measure_encode."""
    return measure_encode(codec, width, height, fps, **kw)[0]


def pick_wire_preset(
    codec: str,
    width: int,
    height: int,
    fps: float = 30.0,
    *,
    bitrate: int = 0,
    crf: int = 25,
    budget_ms: float | None = None,
    measure=measure_encode_cost,
) -> str:
    """Resolve preset="auto": the slowest (best-quality) preset whose
    measured per-frame encode cost on this host fits ``budget_ms``
    (default 40% of the frame tick — leaves the executor able to sustain
    >= 2 members/core before decimation engages).  Walks the ladder
    fastest-first and stops at the first miss, so the probe cost is a
    handful of sub-tick encodes at session setup.  The reference never
    needs this: NVENC silicon makes every preset nearly free to the CPU
    (src/video_encoder.cc:28-58); software encode makes the preset THE
    serving-capacity lever (BENCHMARKS.md, "Composed serving capacity").
    """
    if codec == "jpeg":
        return ""
    if budget_ms is None:
        budget_ms = 0.4 * 1e3 / (fps if fps > 0 else 30.0)
    best = WIRE_PRESETS[0]
    for preset in WIRE_PRESETS:
        cost = measure(
            codec, width, height, fps, preset=preset, bitrate=bitrate, crf=crf
        )
        if cost > budget_ms:
            break
        best = preset
    return best


def make_wire_decoder(
    sample_format: bytes | None,
    codec_config: tuple[bytes, bytes] | None = None,
    size_hint: tuple[int, int] | None = None,
):
    """Decoder from the demuxed stream's sample entry (the client learns
    the codec from the stream, like any fMP4 player).  ``size_hint`` =
    (width, height) from the track header pre-sizes the output buffer."""
    if sample_format is None or bytes(sample_format) == b"jpeg":
        return JpegWireDecoder()
    return WireDecoder(sample_format, codec_config, size_hint=size_hint)
