"""foveax_torch's copies of the jax-free serving modules against foveax's:
the wire protocol, the gaze predictors, the fMP4 muxer (both backends),
the wire codecs and the synthetic source give the same messages, numbers,
bytes and frames (tolerance 0); and the port's native library builds safely
when several processes build it at once."""

import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from foveax.io import mux as fx_mux
from foveax.io import video as fx_video
from foveax.io import wirecodec as fx_wire
from foveax.serve import gazepred as fx_gazepred
from foveax.serve import protocol as fx_protocol
from foveax_torch import native
from foveax_torch.io import mux, video, wirecodec
from foveax_torch.serve import gazepred, protocol

MESSAGES = [
    ("TextMessage", ("hello",)),
    ("VideoRequest", ("synthetic://96x64@30/10",)),
    ("FrameRequest", (0.25, 0.75, 7)),
    ("Ack", (7,)),
    ("FrameMeta", (0.1, 0.2, 3)),
]

MALFORMED = [
    "this is not json",
    "[1, 2, 3]",
    '{"type": "warpDrive"}',
    '{"type": "frameRequest", "centerX": 0.5}',
    '{"type": "frameRequest", "centerX": "zzz", "centerY": 0.5, "packetNumber": 1}',
    '{"type": "frameRequest", "centerX": NaN, "centerY": 0.5, "packetNumber": 1}',
    '{"type": "image", "centerX": 0.5, "centerY": Infinity, "frameNum": 1}',
]


@pytest.mark.parametrize("name,args", MESSAGES, ids=[m[0] for m in MESSAGES])
def test_protocol_matches_foveax(name, args):
    ours = getattr(protocol, name)(*args)
    theirs = getattr(fx_protocol, name)(*args)
    assert protocol.dumps(ours) == fx_protocol.dumps(theirs)
    wire = protocol.dumps(ours)
    assert protocol.loads(wire) == ours
    assert protocol.dumps(protocol.loads(wire)) == fx_protocol.dumps(fx_protocol.loads(wire))


def test_protocol_coerces_string_numerics_as_foveax():
    wire = '{"type": "frameRequest", "centerX": "0.25", "centerY": 0.75, "packetNumber": "7"}'
    assert protocol.dumps(protocol.loads(wire)) == fx_protocol.dumps(fx_protocol.loads(wire))


@pytest.mark.parametrize("payload", MALFORMED)
def test_protocol_rejects_malformed_as_foveax(payload):
    with pytest.raises(ValueError) as ours:
        protocol.loads(payload)
    with pytest.raises(ValueError) as theirs:
        fx_protocol.loads(payload)
    assert str(ours.value) == str(theirs.value)


def _gaze_trace(n: int = 120) -> np.ndarray:
    """Smooth pursuit with two saccades and a crossing of the 360 seam."""
    rng = np.random.default_rng(5)
    t = np.arange(n) / 30.0
    x = (0.9 + 0.2 * t + 0.002 * rng.standard_normal(n)) % 1.0
    y = 0.5 + 0.1 * np.sin(2 * t) + 0.002 * rng.standard_normal(n)
    x[40:] = (x[40:] + 0.3) % 1.0
    y[80:] -= 0.25
    return np.stack([x, y], axis=-1)


@pytest.mark.parametrize("mode", ["zero", "linear", "kalman"])
def test_gazepred_matches_foveax(mode):
    ours, theirs = gazepred.make_predictor(mode), fx_gazepred.make_predictor(mode)
    for i, (cx, cy) in enumerate(_gaze_trace()):
        ours.update(float(cx), float(cy), t=i / 30.0)
        theirs.update(float(cx), float(cy), t=i / 30.0)
        assert ours.predict(1 / 30) == theirs.predict(1 / 30)
    trace = _gaze_trace()
    assert gazepred.evaluate_predictors(trace) == fx_gazepred.evaluate_predictors(trace)


_AVCC = (b"avcC", bytes(range(37)))


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("config", [None, _AVCC], ids=["jpeg", "avc1"])
def test_mux_bytes_match_foveax(backend, config):
    if backend == "native" and not (native.available() and fx_native_available()):
        pytest.fail("native muxer did not build")
    fourcc = b"jpeg" if config is None else b"avc1"
    ours = mux.FragmentWriter(1072, 608, 30.0, fourcc, codec_config=config, backend=backend)
    theirs = fx_mux.FragmentWriter(
        1072, 608, 30.0, fourcc, codec_config=config, backend=backend
    )
    assert ours.backend == theirs.backend == backend
    rng = np.random.default_rng(3)
    header = ours.header()
    assert header == theirs.header()
    samples, stream = [], [theirs.header()]
    for i in range(5):
        sample = rng.integers(0, 256, 100 + 37 * i, np.uint8).tobytes()
        frag = ours.frame(sample, is_sync=i % 2 == 0)
        assert frag == theirs.frame(sample, is_sync=i % 2 == 0)
        samples.append(sample)
        stream.append(frag)
    # The port's readers, both backends, read foveax's stream back.
    blob = b"".join(stream)
    for reader_backend in ("python", "native"):
        reader = mux.make_fragment_reader(reader_backend)
        assert reader.feed(blob[:50]) + reader.feed(blob[50:]) == samples
        assert (reader.width, reader.height) == (1072, 608)
        assert reader.last_seq == 5 and reader.header_count == 1
        assert reader.sample_format == fourcc
        assert reader.codec_config == config


def fx_native_available() -> bool:
    from foveax import native as fx_native

    return fx_native.available()


def _frames(n: int, w: int = 96, h: int = 64) -> list[np.ndarray]:
    return [wirecodec.probe_frame(w, h, i) for i in range(n)]


def test_wirecodec_jpeg_matches_foveax():
    ours = wirecodec.make_wire_encoder("jpeg", 96, 64, jpeg_quality=85)
    theirs = fx_wire.make_wire_encoder("jpeg", 96, 64, jpeg_quality=85)
    dec, fx_dec = wirecodec.make_wire_decoder(b"jpeg"), fx_wire.make_wire_decoder(b"jpeg")
    for frame in _frames(3):
        sample, key = ours.encode(frame)
        assert (sample, key) == theirs.encode(frame)
        np.testing.assert_array_equal(dec.decode(sample), fx_dec.decode(sample))


def test_wirecodec_h264_matches_foveax():
    if "h264" not in wirecodec.available_wire_codecs():
        pytest.skip("the codec shim needs FFmpeg's headers, absent here")
    assert wirecodec.available_wire_codecs() == fx_wire.available_wire_codecs()
    ours = wirecodec.make_wire_encoder("h264", 96, 64, preset="ultrafast")
    theirs = fx_wire.make_wire_encoder("h264", 96, 64, preset="ultrafast")
    assert ours.codec_config == theirs.codec_config
    dec = wirecodec.make_wire_decoder(b"avc1", ours.codec_config, size_hint=(96, 64))
    fx_dec = fx_wire.make_wire_decoder(b"avc1", theirs.codec_config, size_hint=(96, 64))
    try:
        for frame in _frames(4):
            sample, key = ours.encode(frame)
            assert (sample, key) == theirs.encode(frame)
            np.testing.assert_array_equal(dec.decode(sample), fx_dec.decode(sample))
    finally:
        for codec in (ours, theirs, dec, fx_dec):
            codec.close()


def test_wire_preset_pick_matches_foveax():
    costs = {"ultrafast": 1.0, "superfast": 2.0, "veryfast": 9.0, "faster": 20.0}

    def measure(codec, w, h, fps, *, preset, bitrate, crf):
        return costs.get(preset, 99.0)

    for budget in (0.5, 1.5, 10.0, 50.0):
        args = ("h264", 96, 64, 30.0)
        assert wirecodec.pick_wire_preset(
            *args, budget_ms=budget, measure=measure
        ) == fx_wire.pick_wire_preset(*args, budget_ms=budget, measure=measure)
    assert wirecodec.WIRE_PRESETS == fx_wire.WIRE_PRESETS


@pytest.mark.parametrize("pattern", ["hostile", "natural", "natural1f"])
def test_synthetic_reader_matches_foveax(pattern):
    spec = f"synthetic://96x64@24/5#{pattern}"
    assert video.parse_synthetic_spec(spec) == fx_video.parse_synthetic_spec(spec)
    ours = list(video.open_video(spec))
    theirs = list(fx_video.open_video(spec))
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    looped = video.open_video("synthetic://96x64/3", loop=True)
    got = [looped.read() for _ in range(4)]
    np.testing.assert_array_equal(got[3], got[0])


@pytest.mark.parametrize("spec", ["synthetic://0x64", "synthetic://96x64#plaid", "file.mp4"])
def test_synthetic_spec_errors_match_foveax(spec):
    if not spec.startswith("synthetic://"):
        with pytest.raises(ValueError):
            video.parse_synthetic_spec(spec)
        return
    with pytest.raises(ValueError) as ours:
        video.parse_synthetic_spec(spec)
    with pytest.raises(ValueError) as theirs:
        fx_video.parse_synthetic_spec(spec)
    assert str(ours.value) == str(theirs.value)


_BUILD_PROBE = textwrap.dedent("""
    import importlib.util, sys
    spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.load()
    assert lib is not None, "muxer did not build"
    print(len(mod.init_segment(1072, 608)))
""")


def test_native_builds_concurrently(tmp_path):
    """Processes that build the native library at once (test workers)
    serialize on the build lock and load a whole library each."""
    pkg = tmp_path / "native"
    pkg.mkdir()
    for name in ("__init__.py", "Makefile", "fmp4.cc", "codec.cc"):
        shutil.copy(native._DIR / name, pkg / name)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_PROBE, str(pkg / "__init__.py")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(3)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert int(out.strip()) == len(mux.init_segment(1072, 608))
    assert (pkg / "build" / "libfoveax_native.so").exists()
    assert not list((pkg / "build").glob("*.tmp"))


def _make_dry_run(tmp_path, cxx: str) -> str:
    out = subprocess.run(
        ["make", "-n", "-B", "-C", str(native._DIR), f"BUILD={tmp_path}", f"CXX={cxx}"],
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout


def test_native_makefile_skips_codec_without_ffmpeg_headers(tmp_path):
    """Without FFmpeg's headers the Makefile plans the muxer only (the
    JAX package's probe, echo '\\#include ...' through $(shell), says yes
    under GNU make 4.3 whatever the headers, and make then fails on
    codec.cc)."""
    planned = _make_dry_run(tmp_path, "g++ -nostdinc")
    assert "fmp4.cc" in planned and "codec.cc" not in planned
    if "h264" in wirecodec.available_wire_codecs():
        assert "codec.cc" in _make_dry_run(tmp_path, "g++")
