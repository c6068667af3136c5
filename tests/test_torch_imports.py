"""The port stands apart from JAX: an AST scan of its sources.

No ``.py`` file of ``audiodeepfake_detection_tpu_torch`` (nor
``chip_smoke.py``) imports jax, flax, optax, orbax or the JAX package, and
none imports ``triton`` at module level, so the port imports on a machine
that has neither JAX nor a GPU toolchain.  Importing every module builds no
kernel.
"""

import ast
import importlib
import pathlib
import pkgutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "audiodeepfake_detection_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "audiodeepfake_detection_tpu"}
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
    for new in (
        "ops/fused_conv1.py", "ops/fused_conv1_cuda.py", "ops/cuda_build.py",
        "models/layers.py", "models/factory.py", "data/dataset.py",
        "data/loader.py", "train/metrics.py", "train/results.py",
        "train/profiling.py", "train/trainer.py", "train/experiment.py",
    ):
        assert f"audiodeepfake_detection_tpu_torch/{new}" in names
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


def test_importing_every_module_builds_no_kernel():
    """Every module imports here (no ``nvcc``, no ``triton``, no card): the
    toolchain is touched only inside the functions that build and launch."""
    import audiodeepfake_detection_tpu_torch as port

    names = [
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
    ]
    assert len(names) >= 25
    for name in names:
        importlib.import_module(name)
    from audiodeepfake_detection_tpu_torch.ops import fused_conv1_cuda, wpt_cuda

    assert wpt_cuda._LIB is None and fused_conv1_cuda._LIB is None
    assert fused_conv1_cuda.FWD_LAUNCHES == fused_conv1_cuda.BWD_LAUNCHES == 0
