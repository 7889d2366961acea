"""Serving soak on the port (counterpart of tests/test_soak.py): repeated
join/stream/leave churn across two stream shapes and the wire codecs must
leave every pool at its floor: sessions, channels, the bounded pipeline
cache, native handles, file descriptors and threads.  The churn is
``foveax_torch.scripts.soak``; the card adds the CUDA memory check
(tests/test_torch_cuda.py)."""

import pytest

from foveax_torch.io.wirecodec import available_wire_codecs
from foveax_torch.scripts import soak


@pytest.mark.parametrize(
    "wire", ["jpeg"] + (["h264"] if "h264" in available_wire_codecs() else [])
)
def test_session_churn_leaves_no_residue(wire):
    report = soak.churn(device="cpu", wire=wire)

    # Session/channel pools empty; pipeline cache bounded by its LRU cap.
    assert report.sessions == 0
    assert report.channels == 0
    assert report.pipelines <= report.max_pipelines

    # Native handle pools at zero: every per-session encoder and every
    # client demuxer/decoder was released despite the churn.
    for name, count in report.native.items():
        assert count == 0, (name, count, wire)

    # No fd or thread creep beyond the post-warmup baseline.
    fd0, fd1 = report.fds
    threads0, threads1 = report.threads
    assert fd1 <= fd0 + 4, report.fds
    assert threads1 <= threads0 + 4, report.threads
    assert report.memory is None  # read on the card only
    assert soak.residue(report) == []


def test_residue_names_each_pool():
    """``residue`` reports every kind of leftover, CUDA memory growth
    after the warm cycles included."""
    report = soak.SoakReport(
        device="cuda:0", wire="jpeg", sessions=1, channels=0,
        pipelines=5, max_pipelines=4, native={"codec": 2, "demux": 0},
        fds=(10, 15), threads=(5, 9), memory=[100, 200, 200, 300],
    )
    found = soak.residue(report)
    assert found == [
        "1 sessions, 0 channels", "5 pipelines > 4", "2 live codec handles",
        "fds 10 -> 15", "CUDA memory above the 200 bytes after cycle 1: [(3, 300)]",
    ]
