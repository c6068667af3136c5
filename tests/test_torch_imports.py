"""The port stands apart from JAX: an AST scan of its sources.

No ``.py`` file of ``audiodeepfake_detection_tpu_torch`` (nor
``chip_smoke.py``) imports jax, flax, optax or the JAX package, and none
imports ``triton`` at module level, so the port imports on a machine that
has neither JAX nor a GPU toolchain.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "audiodeepfake_detection_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "audiodeepfake_detection_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(node, in_function=False):
    """(top-level package name, runs at import time) for every import;
    an import runs at import time unless a function body holds it."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Import):
            for alias in child.names:
                yield alias.name.split(".")[0], not in_function
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module.split(".")[0], not in_function
        yield from _imports(
            child,
            in_function
            or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)),
        )


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "audiodeepfake_detection_tpu_torch/ops/wpt_cuda.py" in names
    assert "audiodeepfake_detection_tpu_torch/train/serve.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_module_level_triton(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, at_import in _imports(tree):
        assert name not in FORBIDDEN, f"{path.name} imports {name}"
        assert not (name == "triton" and at_import), (
            f"{path.name} imports triton at module level"
        )


def test_scanner_sees_nested_and_import_time_imports():
    tree = ast.parse(
        "import os\n"
        "try:\n    import triton\nexcept ImportError:\n    pass\n"
        "def f():\n    import triton.language\n    from jax import numpy\n"
    )
    assert sorted(_imports(tree)) == [
        ("jax", False), ("os", True), ("triton", False), ("triton", True),
    ]
