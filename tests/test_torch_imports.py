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
        "foveax_torch.core.unwarp", "foveax_torch.kernels.build",
        "foveax_torch.kernels.segreduce", "foveax_torch.kernels.unwarp",
        "foveax_torch.pipeline.frames",
    ):
        assert name in report["modules"]


def test_smoke_source_imports():
    """chip_smoke.py names only the standard library, numpy, torch and
    foveax_torch."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {
        "__future__", "json", "statistics", "subprocess", "sys", "time",
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
