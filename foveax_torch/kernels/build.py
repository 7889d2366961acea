"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``foveax_torch/kernels/build/`` (git-ignored), and loaded with ``ctypes``.
The library's file name carries a hash of its source and flags, so an
edited source is never served by a stale build.  Nothing here runs at import time: the
CPU-only tests import every module.

Every exported C function launches one kernel on the stream it is given
and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises when that
is not 0 and counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from foveax_torch.pipeline import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# Every source under csrc/, as build() and load() name them.
SOURCES = ("segreduce", "unwarp", "scan2d", "sat_sample")

# No fast math: the unwarp's float step must round exactly as the JAX
# package's does (the sources also use __fmul_rn/__fadd_rn there).
# ``-Xptxas=-v`` puts each kernel's registers and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc processes started by this process (the CLI's ``stages`` checks that
# a moving gaze starts none), counted under a lock: builds may start from
# several threads.
nvcc_runs = 0
_runs_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start one nvcc for ``csrc/<name>.cu``; returns (process, tmp, out)
    or None when the library is already built."""
    global nvcc_runs
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    with _runs_lock:
        nvcc_runs += 1
    return proc, tmp, out


def build(names: list[str]) -> dict[str, str]:
    """Compile the named sources in parallel (one nvcc each, all started
    together).  Returns each compiler's output; raises if any fails."""
    started = {n: _start_build(n) for n in names}
    logs, failed = {}, []
    for name, job in started.items():
        if job is None:
            logs[name] = "(cached)"
            continue
        proc, tmp, out = job
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(f"{n}:\n{logs[n]}" for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use (a
    ``setup.kernel_load`` span: ``nvcc`` says whether it compiled)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with profiling.span("setup.kernel_load", library=name) as sp:
                sp.attrs["nvcc"] = build([name])[name] != "(cached)"
                lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel takes through a raw pointer."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


class Kernel:
    """One exported C launcher: its library, its signature and a count of
    the launches made through it (counted under a lock: the server
    launches from executor threads)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()

    def launch(self, *args) -> None:
        """Launch on the current CUDA stream; raise on a launch error.
        The wrappers make their tensors' device current around the call,
        so a kernel launches on the card its tensors lie on."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA launch failed with error {err}"
            )
        with self._count_lock:
            self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
