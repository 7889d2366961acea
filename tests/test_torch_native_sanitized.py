"""ASAN+UBSAN lanes for the port's native layer (counterpart of
``tests/test_native_sanitized.py``): ``python -m
foveax_torch.scripts.fuzz_native`` builds the fuzzers of
``foveax_torch/native/fuzz/`` against the port's own ``native/fmp4.cc``
and ``native/codec.cc`` and runs them at foveax's settings.  They catch
the memory faults the Python differential fuzz (tests/test_torch_fuzz.py)
cannot observe.  Deeper soaks: ``python -m
foveax_torch.scripts.fuzz_native demux <seed> <iters>`` (and ``codec``)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from foveax_torch.scripts import fuzz_native

ROOT = Path(__file__).resolve().parent.parent


def _need_gxx() -> None:
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")


def _run(lane: str, seed: str, iters: str, timeout: int) -> str:
    r = subprocess.run(
        [sys.executable, "-m", "foveax_torch.scripts.fuzz_native", lane, seed, iters],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
    )
    assert r.returncode == 0, f"fuzz_native {lane} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def test_demux_sanitized_fuzz():
    _need_gxx()
    out = _run("demux", "7", "25", 300)
    assert "clean" in out


def test_codec_sanitized_fuzz():
    _need_gxx()
    from foveax_torch.io.wirecodec import available_wire_codecs

    if "h264" not in available_wire_codecs():
        pytest.skip("h264 shim unavailable")
    out = _run("codec", "7", "8", 420)
    assert "clean" in out or "skipping" in out


def test_binary_is_per_process_inside_the_build_directory():
    """Each process builds its own binary under the git-ignored
    ``foveax_torch/native/build/``, never at the JAX package's fixed
    ``/tmp`` paths, and every build command writes there."""
    build = ROOT / "foveax_torch" / "native" / "build"
    for lane in fuzz_native.LANES:
        path = fuzz_native.binary_path(lane)
        assert path.parent == build and path.name == f"fuzz_native_{lane}.{os.getpid()}"
        cmd = fuzz_native.build_command(lane, "g++", path)
        assert cmd[cmd.index("-o") + 1] == str(path)
        assert str(ROOT / "foveax_torch" / "native" / fuzz_native.LANES[lane][0]) in cmd
        assert not any(arg.startswith("/tmp/") for arg in cmd)
    other = subprocess.run(
        [sys.executable, "-c", "from foveax_torch.scripts import fuzz_native as f; "
         "print(f.binary_path('demux'))"],
        capture_output=True, text=True, timeout=60, cwd=str(ROOT), check=True,
    ).stdout.strip()
    assert Path(other).parent == build and Path(other) != fuzz_native.binary_path("demux")


def test_ubsan_reports_stop_the_run(monkeypatch):
    """The fuzzer runs with UBSan halting at its first report, so undefined
    behaviour is a non-zero exit code and never a "clean" line after a
    printed report; a caller's own UBSAN_OPTIONS win."""
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(kwargs.get("env"))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(fuzz_native.shutil, "which", lambda name: "/usr/bin/g++")
    monkeypatch.setattr(fuzz_native.subprocess, "run", fake_run)
    monkeypatch.delenv("UBSAN_OPTIONS", raising=False)
    assert fuzz_native.run_lane("demux", 7, 1) == 0
    build_env, run_env = calls
    assert build_env is None and "halt_on_error=1" in run_env["UBSAN_OPTIONS"]
    monkeypatch.setenv("UBSAN_OPTIONS", "print_stacktrace=0")
    calls.clear()
    assert fuzz_native.run_lane("demux", 7, 1) == 0
    assert calls[1]["UBSAN_OPTIONS"] == "print_stacktrace=0"
