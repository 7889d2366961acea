"""Video decode/encode behind small interfaces.

The reference binds FFmpeg directly (demux/decode/swscale, reference:
src/video_decoder.cc:32-238) and NVENC for H.264 encode (reference:
src/video_encoder.cc:3-342) — both CUDA-locked choices.  foveax keeps the
codec behind ``VideoReader`` / ``VideoWriter`` interfaces with OpenCV's
FFmpeg backend for files, a procedural synthetic source for tests and
benches, and in-memory JPEG for the low-latency streaming path (see
foveax_torch.io.mux for the fragmented-MP4 wire format).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

try:
    import cv2

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


class VideoReader:
    """File-backed reader (OpenCV/FFmpeg).  Yields RGB uint8 frames."""

    def __init__(self, path: str | Path):
        if not _HAVE_CV2:  # pragma: no cover
            raise RuntimeError("OpenCV not available for file video decode")
        self._cap = cv2.VideoCapture(str(path))
        if not self._cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.n_frames = n if n > 0 else None

    def read(self) -> np.ndarray | None:
        ok, bgr = self._cap.read()
        if not ok:
            return None
        return bgr[:, :, ::-1]

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        while (f := self.read()) is not None:
            yield f


_SYNTH_RE = re.compile(
    r"synthetic://(\d+)x(\d+)(?:@(\d+))?(?:/(\d+))?(?:#(\w+))?\Z"
)


def parse_synthetic_spec(spec: str) -> tuple[int, int, float, int, str]:
    """(width, height, fps, n_frames, pattern) from a synthetic:// spec —
    lets callers validate dimensions before any allocation happens.
    Patterns: ``hostile`` (default — high-frequency stripes, the
    aliasing stress content), ``natural`` (band-limited gradients and
    soft shapes, paper-style PSNR magnitudes), ``natural1f``
    (calibrated 1/f amplitude spectrum — the natural-image statistics
    regime between the two, with detail above the peripheral Nyquist),
    or ``photo`` (a mosaic of the real photograph bundled with
    matplotlib, native pixel scale — genuine photographic
    statistics rather than a model of them)."""
    m = _SYNTH_RE.match(spec)
    if not m:
        raise ValueError(f"bad synthetic spec: {spec}")
    pattern = m.group(5) or "hostile"
    if pattern not in ("hostile", "natural", "natural1f", "photo"):
        raise ValueError(f"unknown synthetic pattern {pattern!r}")
    if int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise ValueError(f"bad synthetic dimensions: {spec}")
    return (
        int(m.group(1)),
        int(m.group(2)),
        float(m.group(3)) if m.group(3) else 30.0,
        int(m.group(4)) if m.group(4) else 300,
        pattern,
    )


def _bundled_photo() -> np.ndarray:
    """A real photograph shipped with the installed packages:
    matplotlib's sample photo (600x512 RGB,
    a JPEG of a person at a workstation).  Used by the ``photo``
    synthetic pattern so quality studies can include genuine
    photographic statistics (sensor noise, real edge/texture spectra)
    alongside the calibrated synthetic regimes."""
    import os

    try:
        import matplotlib
        from PIL import Image
    except Exception as e:  # pragma: no cover
        raise ValueError(
            "synthetic pattern 'photo' needs matplotlib+PIL sample data"
        ) from e
    p = os.path.join(
        os.path.dirname(matplotlib.__file__),
        "mpl-data",
        "sample_data",
        "grace_hopper.jpg",
    )
    if not os.path.exists(p):  # pragma: no cover
        raise ValueError(f"synthetic pattern 'photo': missing {p}")
    return np.asarray(Image.open(p).convert("RGB"))


def _photo_mosaic(width: int, height: int) -> np.ndarray:
    """Tile (height, width, 3) with seeded random crops/flips of the
    bundled photograph at NATIVE pixel scale — no resampling, so the
    local amplitude spectrum is the photograph's own (upsampling would
    band-limit it; the whole point is real detail above the reduced
    stream's peripheral Nyquist).  Random crop offsets + flips break
    the periodicity a plain tiling would add; tile seams contribute a
    small, acknowledged artificial-edge population."""
    photo = _bundled_photo()
    ph, pw = photo.shape[:2]
    th, tw = ph // 2, pw // 2  # 300x256 crops: 4x the distinct offsets
    rng = np.random.default_rng(width * 7919 + height + 1)
    base = np.empty((height, width, 3), np.uint8)
    for y0 in range(0, height, th):
        for x0 in range(0, width, tw):
            cy = int(rng.integers(0, ph - th + 1))
            cx = int(rng.integers(0, pw - tw + 1))
            tile = photo[cy : cy + th, cx : cx + tw]
            if rng.integers(0, 2):
                tile = tile[:, ::-1]
            if rng.integers(0, 2):
                tile = tile[::-1, :]
            h = min(th, height - y0)
            w = min(tw, width - x0)
            base[y0 : y0 + h, x0 : x0 + w] = tile[:h, :w]
    return base


class SyntheticReader:
    """Procedural equirect-like source: a panning scene with high-frequency
    detail so foveation artifacts are visible.  Spec string:
    ``synthetic://WxH@FPS/NFRAMES`` (fps and frame count optional)."""

    def __init__(self, width: int, height: int, fps: float = 30.0,
                 n_frames: int = 300, pattern: str = "hostile"):
        self.width, self.height = width, height
        self.fps, self.n_frames = fps, n_frames
        self.pattern = pattern
        self._i = 0
        yy, xx = np.mgrid[0:height, 0:width]
        self._xx, self._yy = xx, yy
        if pattern == "photo":
            self._base = _photo_mosaic(width, height)
        elif pattern == "natural1f":
            # Natural-image statistics: amplitude spectrum A(f) = 1/f
            # (Field 1987; slope verified by tests/test_io.py).  Unlike
            # the band-limited "natural" pattern, spectral energy
            # continues all the way to Nyquist — so the periphery of a
            # foveated transform MUST low-pass (SAT box filter) or alias
            # (point sampling), which is exactly the regime the paper's
            # claim lives in — while unlike "hostile" the energy is not
            # concentrated at Nyquist.  Channels share a 1/f luminance
            # field plus low-amplitude independent 1/f chroma, matching
            # the strong inter-channel correlation of natural images.
            rng = np.random.default_rng(width * 7919 + height)
            fy = np.fft.fftfreq(height)[:, None]
            fx = np.fft.fftfreq(width)[None, :]
            freq = np.hypot(fy, fx)
            freq[0, 0] = 1.0  # DC handled by zeroing the coefficient

            def field_1f():
                spec = (
                    rng.standard_normal((height, width))
                    + 1j * rng.standard_normal((height, width))
                ) / freq
                spec[0, 0] = 0.0
                x = np.fft.ifft2(spec).real
                return (x - x.mean()) / (x.std() + 1e-12)

            luma = field_1f()
            ca, cb = field_1f(), field_1f()
            # RMS contrast ~0.18 around mid-gray: <1% of pixels clip, so
            # clipping barely perturbs the calibrated spectrum.
            r = 0.5 + 0.18 * luma + 0.06 * ca
            g = 0.5 + 0.18 * luma - 0.03 * ca + 0.03 * cb
            b = 0.5 + 0.18 * luma - 0.06 * cb
            self._base = (
                np.clip(np.stack([r, g, b], axis=-1), 0, 1) * 255
            ).astype(np.uint8)
        elif pattern == "natural":
            # Band-limited content (smooth gradients + a few soft shapes):
            # the regime where the paper reports 30-40 dB PSNRs, vs the
            # deliberately aliasing-hostile default stripes.
            u = xx / max(width, 1)
            v = yy / max(height, 1)
            r = 0.55 + 0.25 * np.sin(2 * np.pi * (1.5 * u + 0.3)) * np.cos(
                2 * np.pi * (0.8 * v)
            )
            g = 0.45 + 0.3 * np.sin(2 * np.pi * (0.9 * u - 0.6 * v + 0.1))
            b = 0.5 + 0.3 * np.cos(2 * np.pi * (0.5 * u + 1.1 * v))
            for scx, scy, rad, amp in (
                (0.3, 0.4, 0.18, 0.35),
                (0.7, 0.6, 0.12, -0.3),
                (0.5, 0.25, 0.08, 0.25),
            ):
                d2 = ((u - scx) ** 2 + (v - scy) ** 2) / rad**2
                blob = amp * np.exp(-d2)
                r = r + blob
                g = g + 0.6 * blob
            self._base = (
                np.clip(np.stack([r, g, b], axis=-1), 0, 1) * 255
            ).astype(np.uint8)
        else:
            self._base = np.stack(
                [
                    (255 * (0.5 + 0.5 * np.sin(xx / 23.0))),
                    (yy * 255 // max(height, 1)),
                    ((xx // 6 % 2) * 255),
                ],
                axis=-1,
            ).astype(np.uint8)

    @classmethod
    def from_spec(cls, spec: str) -> "SyntheticReader":
        return cls(*parse_synthetic_spec(spec))

    def read(self) -> np.ndarray | None:
        if self._i >= self.n_frames:
            return None
        shift = (self._i * 3) % self.width
        frame = np.roll(self._base, shift, axis=1)  # already a fresh array
        cx = int((0.5 + 0.4 * np.sin(self._i / 20.0)) * self.width)
        cy = int((0.5 + 0.3 * np.cos(self._i / 17.0)) * self.height)
        r = max(4, self.height // 24)
        y0, y1 = max(cy - r, 0), min(cy + r, self.height)
        x0, x1 = max(cx - r, 0), min(cx + r, self.width)
        if self.pattern in ("natural", "natural1f", "photo"):
            # Soft moving highlight instead of a hard inverted block.
            yy = self._yy[y0:y1, x0:x1]
            xx = self._xx[y0:y1, x0:x1]
            d2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / max(r * r, 1)
            glow = (80 * np.exp(-d2))[..., None]
            frame[y0:y1, x0:x1] = np.clip(
                frame[y0:y1, x0:x1].astype(np.int32) + glow, 0, 255
            ).astype(np.uint8)
        else:
            # A moving bright blob (object motion on top of the pan).
            frame[y0:y1, x0:x1] = 255 - frame[y0:y1, x0:x1]
        self._i += 1
        return frame

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        while (f := self.read()) is not None:
            yield f


class LoopingReader:
    """Endlessly repeat an underlying source (server ``--loop`` mode —
    sessions outlive the clip length)."""

    def __init__(self, factory):
        self._factory = factory
        self._reader = factory()
        self.width = self._reader.width
        self.height = self._reader.height
        self.fps = self._reader.fps
        self.n_frames = None

    def read(self) -> np.ndarray | None:
        frame = self._reader.read()
        if frame is None:
            self._reader.close()
            self._reader = self._factory()
            frame = self._reader.read()
        return frame

    def close(self) -> None:
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        while (f := self.read()) is not None:
            yield f


def open_video(source: str | Path, *, loop: bool = False):
    """Open a file path or a ``synthetic://WxH@FPS/N`` spec."""
    s = str(source)
    if loop:
        return LoopingReader(lambda: open_video(s))
    if s.startswith("synthetic://"):
        return SyntheticReader.from_spec(s)
    return VideoReader(s)


class VideoWriter:
    """File writer (OpenCV/FFmpeg, MPEG-4 in .mp4).

    ``quality`` maps the reference's bitrate knob (reference encoder
    configs: src/video_encoder.cc:22-58) onto the codec's quality scale;
    H.264/NVENC has no portable equivalent in this toolchain so the codec
    stays an implementation detail behind this interface.
    """

    def __init__(
        self,
        path: str | Path,
        width: int,
        height: int,
        fps: float = 30.0,
        *,
        fourcc: str = "mp4v",
        quality: float | None = None,
    ):
        if not _HAVE_CV2:  # pragma: no cover
            raise RuntimeError("OpenCV not available for video encode")
        self._w = cv2.VideoWriter(
            str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (width, height)
        )
        if not self._w.isOpened():
            raise IOError(f"cannot open video writer: {path}")
        if quality is not None:
            self._w.set(cv2.VIDEOWRITER_PROP_QUALITY, float(quality))
        self.width, self.height = width, height
        self.n_written = 0

    def write(self, frame_rgb: np.ndarray) -> None:
        frame_rgb = np.asarray(frame_rgb)
        if frame_rgb.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"frame {frame_rgb.shape[:2]} != writer {(self.height, self.width)}"
            )
        self._w.write(frame_rgb[:, :, ::-1])
        self.n_written += 1

    def close(self) -> None:
        self._w.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeVideoWriter:
    """File writer through foveax's own stack: native wire encoder
    (H.264/VP9/MPEG-4 with real rate control) + in-house fMP4 muxer.

    This is the analog of the reference's file-mux-with-explicit-bitrate
    encoder (reference: src/video_encoder.cc:210-342) — the OpenCV
    ``VideoWriter`` above cannot target a bitrate (its quality property is
    silently ignored by many codecs)."""

    def __init__(
        self,
        path: str | Path,
        width: int,
        height: int,
        fps: float = 30.0,
        *,
        codec: str = "h264",
        bitrate: int = 0,
        crf: int = 25,
        gop_size: int = 30,
    ):
        from foveax_torch.io.mux import FragmentWriter
        from foveax_torch.io.wirecodec import make_wire_encoder

        self._enc = make_wire_encoder(
            codec, width, height, fps, bitrate=bitrate, crf=crf, gop_size=gop_size
        )
        self._mux = FragmentWriter(
            width,
            height,
            fps,
            self._enc.sample_format,
            codec_config=self._enc.codec_config,
        )
        self._f = open(path, "wb")
        self._f.write(self._mux.header())
        self.width, self.height = width, height
        self.n_written = 0
        self.bytes_written = 0  # sample payload bytes (rate-control signal)

    def write(self, frame_rgb: np.ndarray) -> None:
        frame_rgb = np.asarray(frame_rgb)
        if frame_rgb.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"frame {frame_rgb.shape[:2]} != writer {(self.height, self.width)}"
            )
        sample, is_key = self._enc.encode(frame_rgb)
        self._f.write(self._mux.frame(sample, is_sync=is_key))
        self.n_written += 1
        self.bytes_written += len(sample)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
        self._enc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_video_writer(
    path: str | Path,
    width: int,
    height: int,
    fps: float = 30.0,
    *,
    bitrate: int | None = None,
    quality: float | None = None,
    codec: str | None = None,
):
    """Pick the writer: explicit bitrate (or an inter-frame codec request)
    needs the native stack; otherwise the OpenCV writer."""
    from foveax_torch.io.wirecodec import available_wire_codecs

    want_native = bitrate is not None or (codec not in (None, "mp4v"))
    if want_native:
        chosen = codec or "h264"
        if chosen not in available_wire_codecs():
            raise RuntimeError(
                f"codec {chosen!r} needs the native shim (unavailable); "
                "omit --bitrate to use the OpenCV writer"
            )
        return NativeVideoWriter(
            path, width, height, fps, codec=chosen, bitrate=bitrate or 0,
            crf=-1 if bitrate else 25,
        )
    return VideoWriter(path, width, height, fps, quality=quality)


# --- in-memory intra-frame codec for the low-latency streaming path -------


def encode_jpeg(frame_rgb: np.ndarray, quality: int = 90) -> bytes:
    if not _HAVE_CV2:
        raise RuntimeError("OpenCV not available for JPEG encode")
    ok, buf = cv2.imencode(
        ".jpg", np.asarray(frame_rgb)[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality]
    )
    if not ok:
        raise IOError("jpeg encode failed")
    return bytes(buf.tobytes())


def decode_jpeg(data: bytes) -> np.ndarray:
    if not _HAVE_CV2:
        raise RuntimeError("OpenCV not available for JPEG decode")
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise IOError("jpeg decode failed")
    return bgr[:, :, ::-1]
