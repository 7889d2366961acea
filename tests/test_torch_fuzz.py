"""Seeded fuzz of the port's trust boundaries (counterpart of
``tests/test_fuzz.py``, with its seeds, corpora and invariants): the wire
protocol, the incremental fMP4 demuxers (Python ``FragmentReader`` and the
C++ ``NativeDemuxer``), the h264 wire decoder and the FXSV unpacker, each
the port's own copy.  Invariants:

* ``protocol.loads`` raises nothing but ValueError and round-trips what it
  accepts;
* both demuxers give identical observable state (samples, dims, codec
  information, sequence, error or not) however the bytes are split, and
  truncated, corrupt or garbage boxes give a clean stall or a ValueError,
  never a different sample;
* the h264 decoder survives hostile samples; ``unpack_svd`` raises only
  ValueError.

Then the same corpora against the JAX package's copies: the port's
``FragmentReader`` observes what foveax's does, both ``protocol.loads``
accept and reject alike and parse to equal fields, and both
``unpack_svd`` raise ValueError at the same inputs and agree elsewhere.
Tests that need the native library or the codec shim skip without them, as
foveax's do.  ``FOVEAX_FUZZ_SEED_BASE`` shifts every seed, as there.
"""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from foveax.io import mux as fx_mux
from foveax.io import svdwire as fx_svdwire
from foveax.serve import protocol as fx_protocol
from foveax_torch import native
from foveax_torch.core.svd_sat import SVDSat
from foveax_torch.io import svdwire
from foveax_torch.io.mux import FragmentReader, FragmentWriter
from foveax_torch.native import NativeDemuxer
from foveax_torch.serve import protocol

torch.set_num_threads(1)

_SEED = int(os.environ.get("FOVEAX_FUZZ_SEED_BASE", "0"))


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed + _SEED)


def _need_native() -> None:
    """Skip, as foveax's tests do, where the native library did not build
    (decided when the test runs, never at import)."""
    if not native.available():
        pytest.skip("native lib unavailable")


# --- protocol ---------------------------------------------------------------


def _protocol_corpus() -> list[str]:
    rng = _rng(42)
    corpus = [
        "",
        "{",
        "[]",
        "null",
        "123",
        '"str"',
        '{"type": "nope"}',
        '{"type": "frameRequest"}',
        '{"type": "frameRequest", "centerX": "a", "centerY": 0, "packetNumber": 0}',
        '{"type": "frameRequest", "centerX": NaN, "centerY": 0.5, "packetNumber": 1}',
        '{"type": "frameRequest", "centerX": Infinity, "centerY": 0.5, "packetNumber": 1}',
        '{"type": "ack", "packetNumber": [1]}',
        '{"type": "image", "centerX": 0.5, "centerY": 0.5, "frameNum": "x"}',
        '{"type": null}',
        '{"type": 5}',
        '{"type": "text"}',
    ]
    for _ in range(200):  # random printable soup
        n = int(rng.integers(0, 64))
        corpus.append(bytes(rng.integers(32, 127, n)).decode("ascii"))
    for _ in range(200):  # random JSON-ish objects
        obj = {"type": str(rng.choice(["text", "ack", "image", "frameRequest", "zzz"]))}
        for k in rng.choice(
            ["message", "centerX", "centerY", "packetNumber", "frameNum", "junk"],
            size=int(rng.integers(0, 4)),
            replace=False,
        ):
            obj[str(k)] = [None, 1.5, "s", [1], {"a": 1}][int(rng.integers(0, 5))]
        corpus.append(json.dumps(obj))
    return corpus


def _random_messages(module) -> list:
    rng = _rng(43)
    out = []
    for _ in range(200):
        out.append([
            module.TextMessage(str(rng.integers(0, 1 << 30))),
            module.VideoRequest("v" * int(rng.integers(1, 40))),
            module.FrameRequest(
                float(rng.random()), float(rng.random()), int(rng.integers(0, 1 << 31))
            ),
            module.Ack(int(rng.integers(0, 1 << 31))),
            module.FrameMeta(
                float(rng.random()), float(rng.random()), int(rng.integers(0, 256))
            ),
        ][int(rng.integers(0, 5))])
    return out


def test_protocol_fuzz_only_valueerror():
    for payload in _protocol_corpus():
        try:
            msg = protocol.loads(payload)
        except ValueError:
            continue
        assert protocol.loads(protocol.dumps(msg)) == msg


def test_protocol_roundtrip_random_valid():
    for msg in _random_messages(protocol):
        assert protocol.loads(protocol.dumps(msg)) == msg


def _parsed(module, payload: str):
    """``module.loads(payload)`` as (type name, fields), or "ValueError"."""
    try:
        msg = module.loads(payload)
    except ValueError:
        return "ValueError"
    return type(msg).__name__, dataclasses.asdict(msg)


def test_protocol_fuzz_agrees_with_foveax():
    """Every fuzz input and every random valid message: accepted or
    rejected alike, accepted ones parsed to the same type and fields."""
    payloads = _protocol_corpus() + [
        fx_protocol.dumps(m) for m in _random_messages(fx_protocol)
    ]
    accepted = 0
    for payload in payloads:
        ours, theirs = _parsed(protocol, payload), _parsed(fx_protocol, payload)
        assert ours == theirs, payload
        accepted += ours != "ValueError"
    assert accepted >= 200  # the valid messages at least


# --- demuxers ---------------------------------------------------------------


def _observe(demux, chunks):
    """Feed chunks; return comparable observable state."""
    samples = []
    err = None
    for c in chunks:
        try:
            samples.extend(bytes(s) for s in demux.feed(c))
        except ValueError:
            err = "corrupt"
            break
    return {
        "samples": samples,
        "err": err,
        "header": bool(demux.header_seen),
        "headers": int(demux.header_count),
        "dims": (demux.width, demux.height) if demux.header_seen else None,
        "seq": demux.last_seq,
        "fmt": getattr(demux, "sample_format", None),
        "cfg": getattr(demux, "codec_config", None),
    }


def _random_splits(rng, data: bytes, n_cases: int):
    for _ in range(n_cases):
        k = int(rng.integers(1, 12))
        cuts = sorted(rng.integers(0, len(data) + 1, k).tolist())
        points = [0] + cuts + [len(data)]
        yield [data[a:b] for a, b in zip(points[:-1], points[1:]) if b > a]


def _valid_stream(rng, codec_config=None) -> bytes:
    mux = FragmentWriter(
        48, 32, 30.0,
        b"avc1" if codec_config else b"jpeg",
        codec_config=codec_config,
        backend="python",
    )
    out = mux.header()
    for i in range(int(rng.integers(1, 6))):
        payload = bytes(rng.integers(0, 256, int(rng.integers(0, 400))))
        out += mux.frame(payload, is_sync=(i == 0))
    return out


def _split_cases():
    """test_demuxers_agree_on_random_splits' chunkings."""
    rng = _rng(44)
    for cfg in (None, (b"avcC", bytes(range(20)))):
        stream = _valid_stream(rng, cfg)
        yield from _random_splits(rng, stream, 30)


def _corruption_cases():
    """test_demuxers_agree_on_corruption's chunkings: byte flips,
    truncations, garbage around a valid stream, tiny boxes."""
    rng = _rng(45)
    base = _valid_stream(rng, (b"avcC", b"\x01\x64\x00\x1e\xff"))
    cases = []
    for _ in range(60):
        b = bytearray(base)
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        cases.append(bytes(b))
    for _ in range(20):
        cases.append(base[: int(rng.integers(0, len(base)))])
    for _ in range(20):
        g = bytes(rng.integers(0, 256, int(rng.integers(1, 32))))
        cases.append(g + base if rng.random() < 0.5 else base + g)
    cases.append(struct.pack(">I", 3) + b"mdat")  # size < 8
    cases.append(b"\x00" * 7)  # less than one header
    for data in cases:
        yield from _random_splits(rng, data, 3)


def _garbage_cases():
    rng = _rng(46)
    for _ in range(100):
        data = bytes(rng.integers(0, 256, int(rng.integers(0, 300))))
        yield from _random_splits(rng, data, 2)


def _renegotiated_cases():
    """(first dims, second dims, chunks) of streams that re-send their
    init segment with new dims and codec configuration."""
    rng = _rng(48)
    for _ in range(12):
        d1 = (int(rng.integers(2, 40)) * 16, int(rng.integers(2, 24)) * 16)
        d2 = (int(rng.integers(2, 40)) * 16, int(rng.integers(2, 24)) * 16)
        m1 = FragmentWriter(
            *d1, 30.0, b"avc1",
            codec_config=(b"avcC", bytes(rng.integers(0, 256, 12))),
            backend="python",
        )
        m2 = FragmentWriter(
            *d2, 30.0, b"jpeg" if rng.random() < 0.5 else b"avc1",
            codec_config=(b"avcC", bytes(rng.integers(0, 256, 9)))
            if rng.random() < 0.7
            else None,
            backend="python",
        )
        stream = m1.header()
        for i in range(int(rng.integers(1, 4))):
            stream += m1.frame(
                bytes(rng.integers(0, 256, int(rng.integers(0, 200)))),
                is_sync=(i == 0),
            )
        stream += m2.header()
        for i in range(int(rng.integers(1, 4))):
            stream += m2.frame(
                bytes(rng.integers(0, 256, int(rng.integers(0, 200)))),
                is_sync=(i == 0),
            )
        for chunks in _random_splits(rng, stream, 6):
            yield d1, d2, chunks


def test_demuxers_agree_on_random_splits():
    """Both demuxer backends expose identical state for every split of a
    valid stream, mid-box-header splits included."""
    _need_native()
    for chunks in _split_cases():
        a = _observe(FragmentReader(), chunks)
        b = _observe(NativeDemuxer(), chunks)
        assert a == b, f"split disagreement: {[len(c) for c in chunks]}"


def test_demuxers_agree_on_corruption():
    """Bit flips in box headers, truncations, garbage prefixes: both
    backends fail (or stall) identically and never emit different
    samples."""
    _need_native()
    for chunks in _corruption_cases():
        assert _observe(FragmentReader(), chunks) == _observe(NativeDemuxer(), chunks)


def test_demuxers_agree_on_pure_garbage():
    _need_native()
    for chunks in _garbage_cases():
        assert _observe(FragmentReader(), chunks) == _observe(NativeDemuxer(), chunks)


def test_wire_decoder_survives_hostile_samples():
    """Corrupt or garbage h264 samples yield a frame (libavcodec's error
    concealment), None or an IOError: never another exception type or a
    crash of the process."""
    from foveax_torch.io.wirecodec import (
        WireEncoder,
        available_wire_codecs,
        make_wire_decoder,
    )

    if "h264" not in available_wire_codecs():
        pytest.skip("h264 shim unavailable")
    enc = WireEncoder("h264", 96, 64, 30.0, crf=30)
    rng = _rng(50)
    samples = [
        enc.encode(rng.integers(0, 256, (64, 96, 3), np.uint8))[0]
        for _ in range(3)
    ]
    cfg = enc.codec_config
    enc.close()
    cases = []
    for i in range(30):  # random multi-byte corruption of real samples
        s = bytearray(samples[i % 3])
        for _ in range(int(rng.integers(1, 6))):
            s[int(rng.integers(0, len(s)))] = int(rng.integers(0, 256))
        cases.append(bytes(s))
    for _ in range(15):  # pure garbage
        cases.append(bytes(rng.integers(0, 256, int(rng.integers(0, 400)))))
    for data in cases:
        dec = make_wire_decoder(b"avc1", cfg, size_hint=(96, 64))
        try:
            out = dec.decode(data)
            assert out is None or out.shape == (64, 96, 3)
        except IOError:
            pass
        finally:
            dec.close()


def _svd_corpus() -> tuple[bytes, list[bytes]]:
    """test_svdwire_unpack_only_valueerror's blob (random factors and
    residual, packed) and its hostile inputs: every stride-97 truncation,
    then 60 random header corruptions, drawn from one generator as there."""
    rng = _rng(49)
    h, w, r = 16, 24, 4
    svd = SVDSat(
        u=torch.from_numpy(rng.normal(size=(3, h, r)).astype(np.float32)),
        s=torch.from_numpy(rng.normal(size=(3, r)).astype(np.float32)),
        v=torch.from_numpy(rng.normal(size=(3, r, w)).astype(np.float32)),
        residual_q=torch.from_numpy(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)),
        ranges=torch.from_numpy(rng.uniform(1, 9, 3).astype(np.float32)),
    )
    data = svdwire.pack_svd(svd)
    cases = [data[:n] for n in range(0, len(data), 97)]
    for _ in range(60):
        b = bytearray(data)
        b[int(rng.integers(4, 16))] = int(rng.integers(0, 256))
        cases.append(bytes(b))
    return data, cases


def test_svdwire_unpack_only_valueerror():
    """The FXSV parser raises ValueError, never struct.error or a shape
    error, on every truncation and on random header corruption (the
    client treats ValueError as a corrupt stream; anything else ends its
    receive loop)."""
    data, cases = _svd_corpus()
    svdwire.unpack_svd(data, device="cpu")  # the full payload parses
    for case in cases:
        try:
            svdwire.unpack_svd(case, device="cpu")
        except ValueError:
            pass


def test_svdwire_unpack_agrees_with_foveax():
    """The port's unpacker raises ValueError exactly where foveax's does,
    and elsewhere gives the same factors, residual and ranges."""
    pytest.importorskip("jax.numpy")
    data, cases = _svd_corpus()
    cases = [data, *cases]
    fields = ("u", "s", "v", "residual_q", "ranges")
    for case in cases:
        try:
            ours = svdwire.unpack_svd(case, device="cpu")
        except ValueError:
            ours = None
        try:
            theirs = fx_svdwire.unpack_svd(case)
        except ValueError:
            theirs = None
        assert (ours is None) == (theirs is None), len(case)
        if ours is not None:
            for name in fields:
                np.testing.assert_array_equal(
                    getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)))


def test_demuxer_byte_at_a_time():
    """Worst-case fragmentation: one byte per feed."""
    rng = _rng(47)
    stream = _valid_stream(rng, (b"avcC", b"\x01\x42\x00\x1e"))
    whole = _observe(FragmentReader(), [stream])
    trickle = _observe(FragmentReader(), [bytes([b]) for b in stream])
    assert whole == trickle
    assert whole["err"] is None and whole["header"]


def test_demuxers_agree_on_renegotiated_streams():
    """A second init segment with new dims and codec configuration
    updates both demuxers identically (dims, sample format, codec
    configuration and header count, on which the client rebuilds its
    decoder) across random splits."""
    _need_native()
    for d1, d2, chunks in _renegotiated_cases():
        a = _observe(FragmentReader(), chunks)
        b = _observe(NativeDemuxer(), chunks)
        assert a == b, (d1, d2, [len(c) for c in chunks])
        assert a["headers"] == 2 and a["dims"] == d2


def test_demuxers_agree_on_empty_mdat():
    """A zero-payload mdat is a valid empty sample, not the end of the
    queue: both backends yield [b'', b'abcd', b'efgh'] from one feed."""
    _need_native()
    mux = FragmentWriter(48, 32, 30.0, b"jpeg", backend="python")
    stream = (
        mux.header()
        + mux.frame(b"", is_sync=True)
        + mux.frame(b"abcd")
        + mux.frame(b"efgh")
    )
    want = [b"", b"abcd", b"efgh"]
    assert FragmentReader().feed(stream) == want
    assert [bytes(s) for s in NativeDemuxer().feed(stream)] == want


def _unparseable_tkhd() -> bytes:
    """A valid stream whose trak size overruns its moov."""
    data = bytearray(_valid_stream(_rng(6), (b"avcC", b"\x01\x42\x00\x1e")))
    i = bytes(data).find(b"trak")
    assert i > 4
    struct.pack_into(">I", data, i - 4, 0xFFFFFFFF)
    return bytes(data)


def _short_mfhd() -> bytes:
    """A valid stream whose first mfhd size field shrinks to 9 (a 1-byte
    payload, less than its 8)."""
    data = bytearray(_valid_stream(_rng(5)))
    i = bytes(data).find(b"mfhd")
    assert i > 4
    struct.pack_into(">I", data, i - 4, 9)
    return bytes(data)


def test_demuxers_agree_on_unparseable_tkhd():
    """The header still counts as seen (fragments keep flowing) but tkhd
    never parses: both demuxers report dims (0, 0)."""
    _need_native()
    data = _unparseable_tkhd()
    a = _observe(FragmentReader(), [data])
    b = _observe(NativeDemuxer(), [data])
    assert a == b, (a, b)
    assert a["header"] and a["dims"] == (0, 0)
    assert a["samples"]  # mdat payloads still flow past the bad moov


def test_demuxers_agree_on_short_mfhd():
    """Both demuxers skip a truncated mfhd identically: no struct.error,
    no garbage last_seq."""
    _need_native()
    chunks = [_short_mfhd()]
    a = _observe(FragmentReader(), chunks)
    b = _observe(NativeDemuxer(), chunks)
    assert a == b, (a, b)


# --- the port's Python demuxer against foveax's ------------------------------


def _byte_at_a_time_cases():
    stream = _valid_stream(_rng(47), (b"avcC", b"\x01\x42\x00\x1e"))
    return [[bytes([b]) for b in stream]]


DEMUX_CORPORA = {
    "splits": _split_cases,
    "corruption": _corruption_cases,
    "garbage": _garbage_cases,
    "renegotiated": lambda: (chunks for _, _, chunks in _renegotiated_cases()),
    "byte-at-a-time": _byte_at_a_time_cases,
    "tkhd": lambda: [[_unparseable_tkhd()]],
    "mfhd": lambda: [[_short_mfhd()]],
}


@pytest.mark.parametrize("corpus", list(DEMUX_CORPORA))
def test_fragment_reader_observes_as_foveax(corpus):
    """On the same chunks the port's FragmentReader and foveax's show the
    same samples, error, header count, dims, sequence and codec."""
    cases = list(DEMUX_CORPORA[corpus]())
    assert cases
    for chunks in cases:
        ours = _observe(FragmentReader(), chunks)
        theirs = _observe(fx_mux.FragmentReader(), chunks)
        assert ours == theirs, [len(c) for c in chunks]
