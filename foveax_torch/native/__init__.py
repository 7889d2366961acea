"""ctypes loader for the native library, with on-demand build (the
port's own copy of the JAX package's native shim).

``load()`` returns the loaded CDLL or None.  The library is built with the
in-tree Makefile on first use (g++, no external deps) and cached under
``foveax_torch/native/build/``.  Builds take an exclusive file lock, and
the Makefile renames each library into place, so processes that build at
once (test workers) neither race nor load a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import subprocess
import threading
from pathlib import Path

log = logging.getLogger("foveax_torch.native")

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR / "build"
_SO = _BUILD / "libfoveax_native.so"
_CODEC_SO = _BUILD / "libfoveax_codec.so"
_load_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_codec_lib: ctypes.CDLL | None = None
_codec_tried = False


def build() -> bool:
    """Run the Makefile under an exclusive lock on ``build/.lock``: a
    second process waits, then finds the libraries up to date."""
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        with open(_BUILD / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-C", str(_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        return _SO.exists()
    except (OSError, subprocess.SubprocessError) as e:  # toolchain missing
        log.warning("native build failed: %s", e)
        return False


def _stale(so: Path) -> bool:
    """True when the .so is missing or older than any native source —
    a prebuilt library from an older checkout must be rebuilt, not
    loaded (new mandatory symbols would raise AttributeError)."""
    if not so.exists():
        return True
    so_m = so.stat().st_mtime
    srcs = list(_DIR.glob("*.cc")) + [_DIR / "Makefile"]
    return any(p.exists() and p.stat().st_mtime > so_m for p in srcs)


def load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale(_SO) and not build() and not _SO.exists():
            return None
        try:
            lib = _configure_native(ctypes.CDLL(str(_SO)))
        except (OSError, AttributeError) as e:  # pragma: no cover
            log.warning(
                "native library unusable (stale build? run "
                "`make -C foveax_torch/native`): %s",
                e,
            )
            return None
        _lib = lib
        return _lib


def _configure_native(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fvx_init_segment.restype = ctypes.c_int
    lib.fvx_init_segment.argtypes = [
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fvx_init_segment_cfg.restype = ctypes.c_int
    lib.fvx_init_segment_cfg.argtypes = [
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fvx_fragment.restype = ctypes.c_int
    lib.fvx_fragment.argtypes = [
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_uint32,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fvx_demux_new.restype = ctypes.c_void_p
    lib.fvx_demux_free.argtypes = [ctypes.c_void_p]
    lib.fvx_demux_feed.restype = ctypes.c_int
    lib.fvx_demux_feed.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fvx_demux_next.restype = ctypes.c_int
    lib.fvx_demux_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fvx_demux_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fvx_demux_header_count.restype = ctypes.c_uint32
    lib.fvx_demux_header_count.argtypes = [ctypes.c_void_p]
    lib.fvx_demux_codec.restype = ctypes.c_int
    lib.fvx_demux_codec.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fvx_demux_live_handles.restype = ctypes.c_int
    lib.fvx_demux_live_handles.argtypes = []
    return lib


def init_segment(
    width: int,
    height: int,
    sample_format: bytes = b"jpeg",
    codec_config: tuple[bytes, bytes] | None = None,
) -> bytes:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    cap = 4096 + (len(codec_config[1]) if codec_config else 0)
    buf = ctypes.create_string_buffer(cap)
    if codec_config is None:
        n = lib.fvx_init_segment(width, height, sample_format, buf, cap)
    else:
        n = lib.fvx_init_segment_cfg(
            width,
            height,
            sample_format,
            codec_config[0],
            codec_config[1],
            len(codec_config[1]),
            buf,
            cap,
        )
    if n < 0:
        raise RuntimeError("fvx_init_segment: buffer too small")
    return buf.raw[:n]


def fragment(
    seq: int, decode_time: int, sample: bytes, duration: int, *, is_sync: bool = True
) -> bytes:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    cap = len(sample) + 512
    buf = ctypes.create_string_buffer(cap)
    n = lib.fvx_fragment(
        seq, decode_time, sample, len(sample), duration, int(is_sync), buf, cap
    )
    if n < 0:
        raise RuntimeError("fvx_fragment: buffer too small")
    return buf.raw[:n]


def available() -> bool:
    return load() is not None


def load_codec() -> ctypes.CDLL | None:
    """The FFmpeg-backed wire-codec shim (libfoveax_codec.so) — optional;
    None when the system lacks FFmpeg dev libraries."""
    global _codec_lib, _codec_tried
    with _load_lock:
        if _codec_lib is not None or _codec_tried:
            return _codec_lib
        _codec_tried = True
        if _stale(_CODEC_SO):
            build()
            if not _CODEC_SO.exists():
                return None
        try:
            lib = _configure_codec(ctypes.CDLL(str(_CODEC_SO)))
        except (OSError, AttributeError) as e:  # pragma: no cover
            log.warning(
                "codec shim unusable (stale build? run "
                "`make -C foveax_torch/native`): %s",
                e,
            )
            return None
        _codec_lib = lib
        return _codec_lib


def _configure_codec(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fx_codec_probe.restype = ctypes.c_int
    lib.fx_codec_probe.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fx_enc_open.restype = ctypes.c_void_p
    lib.fx_enc_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,  # preset ("" = codec default)
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fx_enc_extradata.restype = ctypes.c_int
    lib.fx_enc_extradata.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.fx_enc_encode.restype = ctypes.c_int
    lib.fx_enc_encode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fx_enc_close.argtypes = [ctypes.c_void_p]
    lib.fx_dec_open.restype = ctypes.c_void_p
    lib.fx_dec_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fx_dec_decode.restype = ctypes.c_int
    lib.fx_dec_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fx_dec_take.restype = ctypes.c_int
    lib.fx_dec_take.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fx_dec_flush.restype = ctypes.c_int
    lib.fx_dec_flush.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fx_dec_close.argtypes = [ctypes.c_void_p]
    lib.fx_codec_live_handles.restype = ctypes.c_int
    lib.fx_codec_live_handles.argtypes = []
    return lib


def codec_available() -> bool:
    return load_codec() is not None


def live_native_handles() -> dict:
    """Native handles currently alive in this process, per library — a
    leak probe for soak tests: after all sessions close, every count
    must be zero (the reference leaked detached encoder threads on
    disconnect, src/video_server.cc:213-239)."""
    counts = {}
    clib = load_codec()
    if clib is not None:
        counts["codec"] = int(clib.fx_codec_live_handles())
    nlib = load()
    if nlib is not None:
        counts["demux"] = int(nlib.fvx_demux_live_handles())
    return counts


class NativeDemuxer:
    """Incremental fMP4 demuxer backed by the C++ parser — the native twin
    of foveax_torch.io.mux.FragmentReader."""

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib  # demux symbols configured in _configure_native
        self._h = lib.fvx_demux_new()
        self._cap = 1 << 20
        self._buf = ctypes.create_string_buffer(self._cap)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fvx_demux_free(h)
            self._h = None

    def feed(self, chunk: bytes) -> list[bytes]:
        n = self._lib.fvx_demux_feed(self._h, bytes(chunk), len(chunk))
        if n < 0:
            raise ValueError("corrupt fMP4 box header")
        out = []
        for _ in range(n):
            r = self._lib.fvx_demux_next(self._h, self._buf, self._cap)
            if r == -1:  # none queued (0 is a valid EMPTY sample)
                break
            if r < 0:
                self._cap = -r
                self._buf = ctypes.create_string_buffer(self._cap)
                r = self._lib.fvx_demux_next(self._h, self._buf, self._cap)
            out.append(self._buf[:r])
        return out

    def _info(self):
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        seq = ctypes.c_uint32()
        hdr = ctypes.c_int()
        self._lib.fvx_demux_info(
            self._h,
            ctypes.byref(w),
            ctypes.byref(h),
            ctypes.byref(seq),
            ctypes.byref(hdr),
        )
        return w.value, h.value, seq.value, bool(hdr.value)

    @property
    def width(self):
        w, _, _, hdr = self._info()
        return w if hdr else None

    @property
    def height(self):
        _, h, _, hdr = self._info()
        return h if hdr else None

    @property
    def last_seq(self):
        return self._info()[2]

    @property
    def header_seen(self):
        return self._info()[3]

    @property
    def header_count(self):
        """Init segments seen (>1 = mid-stream renegotiation)."""
        return int(self._lib.fvx_demux_header_count(self._h))

    def _codec(self):
        fourcc = ctypes.create_string_buffer(4)
        cfg_fourcc = ctypes.create_string_buffer(4)
        cap = 4096
        cfg = ctypes.create_string_buffer(cap)
        n = self._lib.fvx_demux_codec(self._h, fourcc, cfg_fourcc, cfg, cap)
        if n < 0:  # pragma: no cover - configs are far below 4 KB
            cap = -n
            cfg = ctypes.create_string_buffer(cap)
            n = self._lib.fvx_demux_codec(self._h, fourcc, cfg_fourcc, cfg, cap)
        sf = fourcc.raw[:4]
        cf = cfg_fourcc.raw[:4]
        return (
            sf if sf != b"\x00" * 4 else None,
            (cf, cfg.raw[:n]) if n > 0 and cf != b"\x00" * 4 else None,
        )

    @property
    def sample_format(self):
        """stsd sample entry fourcc (e.g. b'avc1', b'jpeg'); None pre-header."""
        return self._codec()[0]

    @property
    def codec_config(self):
        """(config box fourcc, payload) — e.g. (b'avcC', record) — or None."""
        return self._codec()[1]
