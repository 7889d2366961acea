"""foveax_torch and chip_smoke.py stand on their own: neither loads JAX
nor any module of the JAX package, and chip_smoke.py gives no result
without a CUDA device or away from the repository."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import foveax_torch
names = [m.name for m in pkgutil.walk_packages(foveax_torch.__path__, "foveax_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "foveax")]
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def test_port_and_smoke_import_neither_jax_nor_foveax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in (
        "foveax_torch.config", "foveax_torch.convert",
        "foveax_torch.core.logrect", "foveax_torch.core.sample",
        "foveax_torch.core.sat", "foveax_torch.core.unwarp",
        "foveax_torch.core.svd_sat", "foveax_torch.core.logpolar",
        "foveax_torch.core.gnomonic", "foveax_torch.core.metrics",
        "foveax_torch.io.svdwire",
        "foveax_torch.kernels.build", "foveax_torch.kernels.fused_select",
        "foveax_torch.kernels.scan2d", "foveax_torch.kernels.segreduce",
        "foveax_torch.kernels.unwarp", "foveax_torch.kernels.sat_sample",
        "foveax_torch.pipeline.frames",
        "foveax_torch.serve.protocol", "foveax_torch.serve.gazepred",
        "foveax_torch.serve.server", "foveax_torch.serve.client",
        "foveax_torch.io.mux", "foveax_torch.io.video",
        "foveax_torch.io.wirecodec", "foveax_torch.native",
        "foveax_torch.io.png", "foveax_torch.io.gaze",
        "foveax_torch.pipeline.runner", "foveax_torch.pipeline.profiling",
        "foveax_torch.cli.main", "foveax_torch.cli.stages",
        "foveax_torch.cli.ladder", "foveax_torch.scripts.stage_bench",
        "foveax_torch.scripts.fuzz_fused", "foveax_torch.scripts.two_process_demo",
        "foveax_torch.scripts.soak", "foveax_torch.scripts.fuzz_sharded",
        "foveax_torch.scripts.fuzz_native",
    ):
        assert name in report["modules"]


_CLI_PROBE = """
import json, sys
from foveax_torch.cli.main import main
from foveax_torch.cli import stages
out, src = sys.argv[1], "synthetic://96x64@30/3"
cpu = ["--device", "cpu"]
rcs = [
    main(cpu + ["single_frame", src, "1", out + "/a"]),
    main(cpu + ["single_frame", src, "1", out + "/b", "--technique", "logpolar_pyramid"]),
    main(cpu + ["interpolate_sampled", src, "0", out + "/c"]),
    main(cpu + ["viewport", src, "0", out + "/d.png", "--width", "32", "--height", "16"]),
    main(cpu + ["montage", src, "0", out + "/e.jpg"]),
    main(cpu + ["svd_bench", src, "--rank", "4", "--iters", "1"]),
    main(cpu + ["quality", src, "--techniques", "logrect", "logpolar"]),
    main(cpu + ["foveate_no_encoding", src, out + "/f.mp4"]),
    main(cpu + ["doctor"]),
    main(["gaze_eval", "--frames", "30"]),
    int(not stages.stage2_sat_roundtrip("cpu")),
]
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "foveax")]
print(json.dumps({"rcs": rcs, "bad": bad}))
"""


def test_cli_subcommands_load_neither_jax_nor_foveax(tmp_path):
    """Running the port's subcommands (on the CPU) loads no module of JAX
    or of the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _CLI_PROBE, str(tmp_path)], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["rcs"] == [0] * 11
    assert report["bad"] == []


_WITHOUT_OPTIONAL = """
import importlib, json, pkgutil, sys
import numpy
for blocked in ("websockets", "cv2"):
    sys.modules[blocked] = None  # importing it raises ImportError
import foveax_torch
names = [m.name for m in pkgutil.walk_packages(foveax_torch.__path__, "foveax_torch.")]
for name in names:
    importlib.import_module(name)
from foveax_torch import FoveaxServer
from foveax_torch.io.video import encode_jpeg
server = FoveaxServer(device="cpu", wire_codec="jpeg")
try:
    encode_jpeg(numpy.zeros((8, 8, 3), "uint8"))
    jpeg = "encoded"
except RuntimeError as e:
    jpeg = str(e)
print(json.dumps({"modules": len(names), "jpeg": jpeg}))
"""


def test_port_imports_without_websockets_or_cv2():
    """Every module imports, and the server constructs, where neither
    ``websockets`` nor ``cv2`` imports (the card's host need not have
    them); JPEG then raises as the JAX package's does without OpenCV.
    Nothing here builds the native shim, so FFmpeg's headers are never
    asked for."""
    out = subprocess.run(
        [sys.executable, "-c", _WITHOUT_OPTIONAL], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["modules"] > 0
    assert report["jpeg"] == "OpenCV not available for JPEG encode"


def test_client_does_not_load_the_server():
    """The client's module imports nothing of the server's: what both
    sides share is in ``serve/protocol.py``.  The server still loads by
    its public names."""
    probe = ("import sys, foveax_torch.serve.client; "
             "print('foveax_torch.serve.server' in sys.modules); "
             "from foveax_torch import FoveaxServer; print(FoveaxServer.__module__)")
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert out.stdout.split() == ["False", "foveax_torch.serve.server"]


def test_smoke_source_imports():
    """chip_smoke.py names only the standard library (asyncio for the
    serve phase's in-memory connection; contextlib, io, os and tempfile
    for the CLI phase's captured output and files), numpy, torch and
    foveax_torch."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {
        "__future__", "asyncio", "contextlib", "io", "json", "os", "statistics",
        "subprocess", "sys", "tempfile", "time",
        "numpy", "torch", "foveax_torch",
    }, roots


def test_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot find the port and exits without a result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "foveax_torch" in out.stderr


def test_core_exports_mirror_foveax():
    """``foveax_torch.core`` exports what ``foveax.core`` exports, apart
    from ``delta_1d`` (a traced float32 delta; the port's deltas are the
    host's float64 ``delta64``).  foveax's list is read from its source, so JAX is
    not imported."""
    import foveax_torch.core as core

    tree = ast.parse((ROOT / "foveax" / "core" / "__init__.py").read_text())
    (fx_all,) = [
        ast.literal_eval(node.value) for node in tree.body
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__"
    ]
    assert set(fx_all) - {"delta_1d"} <= set(core.__all__)
    assert set(core.__all__) - set(fx_all) == {"delta64"}
    assert all(hasattr(core, name) for name in core.__all__)
    # Names foveax.core imports beyond its __all__ (sample_rect_direct).
    imported = {
        alias.asname or alias.name for node in tree.body
        if isinstance(node, ast.ImportFrom) for alias in node.names
    }
    assert "sample_rect_direct" in imported
    assert all(hasattr(core, name) for name in imported - {"delta_1d"})
