"""Nothing of JAX or the JAX package runs with the benchmark, and the
reference takes nothing of the program."""

import ast
from pathlib import Path

import pytest

from benchmark.harness import forbidden_modules

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("mods, found", [
    (["foveax_torch", "foveax_torch.serve.server", "numpy", "torch"], []),
    (["foveax", "foveax_torch"], ["foveax"]),
    (["foveax.core.golden"], ["foveax"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["foveaxy", "jax_utils", "flaxen"], []),
])
def test_top_level_name_check(mods, found):
    assert forbidden_modules(mods) == found


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"jax", "jaxlib", "flax", "foveax"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "numpy", "torch"}, path


def test_the_port_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.'); import benchmark.harness, benchmark.run; "
            "import foveax_torch.serve.server, foveax_torch.pipeline.frames; "
            "from benchmark.harness import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
