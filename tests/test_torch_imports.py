"""The port stands apart from JAX: an AST scan of its sources.

No ``.py`` file of ``audiodeepfake_detection_tpu_torch`` (nor
``chip_smoke.py``) imports jax, flax, optax, orbax or the JAX package, and
none imports ``triton``, matplotlib or a tensorboard writer at module
level, so the port imports on a machine that has neither JAX, nor a GPU
toolchain, nor those packages (the GPU machine has no matplotlib and no
tensorboard).  Importing every module builds no kernel.
"""

import ast
import importlib
import pathlib
import pkgutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "audiodeepfake_detection_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "audiodeepfake_detection_tpu"}
#: imported inside the functions that draw or log, never at module level
LAZY = ("matplotlib", "tensorboard", "tensorboardX", "torch.utils.tensorboard")
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
        "ops/stft.py", "ops/lfcc.py", "models/lcnn.py", "models/regression.py",
        "models/gridmodel.py", "ops/fused_pool.py", "ops/fused_pool_cuda.py",
        "ops/fused_conv2.py", "ops/fused_conv2_cuda.py", "ops/flash_attention.py",
        "ops/flash_attention_cuda.py", "models/ast.py", "ops/cwt.py",
        "analysis/cli.py", "analysis/fingerprints.py", "analysis/integrated_gradients.py",
        "analysis/model_diffs.py", "analysis/plots.py", "analysis/stats.py",
        "parallel/__init__.py", "parallel/mesh.py", "parallel/fsdp.py",
        "parallel/sequence.py", "parallel/tensor.py", "parallel/pipeline.py",
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


def _module_level_imports(node):
    """Full dotted names of the imports outside every function body."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            yield from (alias.name for alias in child.names)
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module
            yield from (f"{child.module}.{alias.name}" for alias in child.names)
        yield from _module_level_imports(child)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_level_plotting_or_tensorboard(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _module_level_imports(tree):
        assert not any(name == lazy or name.startswith(lazy + ".") for lazy in LAZY), (
            f"{path.name} imports {name} at module level")


def test_lazy_scanner_sees_module_level_writers():
    tree = ast.parse(
        "import os\nfrom torch.utils.tensorboard import SummaryWriter\n"
        "def f():\n    import matplotlib\n"
    )
    assert list(_module_level_imports(tree)) == [
        "os", "torch.utils.tensorboard", "torch.utils.tensorboard.SummaryWriter"]


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
    assert len(names) >= 30
    for name in names:
        importlib.import_module(name)
    from audiodeepfake_detection_tpu_torch.ops import (
        flash_attention_cuda,
        fused_conv1_cuda,
        fused_conv2_cuda,
        fused_pool_cuda,
        wpt_cuda,
    )

    assert wpt_cuda._LIB is None and fused_conv1_cuda._LIB is None
    assert fused_pool_cuda._LIB is None and fused_conv2_cuda._LIB is None
    assert fused_pool_cuda.POOL_FWD_LAUNCHES == fused_pool_cuda.POOL_BWD_LAUNCHES == 0
    assert fused_conv2_cuda.CONV2_FWD_LAUNCHES == fused_conv2_cuda.CONV2_BWD_LAUNCHES == 0
    assert fused_conv1_cuda.FWD_LAUNCHES == fused_conv1_cuda.BWD_LAUNCHES == 0
    assert fused_conv1_cuda.MFM_FWD_LAUNCHES == fused_conv1_cuda.MFM_BWD_LAUNCHES == 0
    assert flash_attention_cuda._LIB is None
    assert flash_attention_cuda.MHA_FWD_LAUNCHES == flash_attention_cuda.MHA_BWD_LAUNCHES == 0


def test_toolchain_is_touched_only_inside_functions():
    """``ctypes.CDLL`` and ``nvcc`` (``subprocess``) are reached only from
    function bodies: no module of the port loads a library or starts a
    compiler while it is imported."""
    for path in SOURCES[:-1]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:  # module-level statements
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for call in (n for n in ast.walk(node) if isinstance(n, ast.Call)):
                name = ast.unparse(call.func)
                assert name not in ("ctypes.CDLL", "subprocess.run", "compile_library", "build"), (
                    f"{path.name} calls {name} at import time")


def _device_defaults(path):
    """The ``default=`` of every ``add_argument("--device", ...)`` call."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
        if (isinstance(call.func, ast.Attribute) and call.func.attr == "add_argument"
                and call.args and isinstance(call.args[0], ast.Constant)
                and call.args[0].value == "--device"):
            yield next(ast.unparse(k.value) for k in call.keywords if k.arg == "default")


@pytest.mark.parametrize("module", [
    "train/experiment.py", "train/predict.py", "train/serve.py", "train/export.py",
    "analysis/cli.py"])
def test_entry_points_default_to_cuda(module):
    """Every CLI's ``--device`` defaults to ``cuda`` (the experiment's via
    ``default_config``), as do the Trainer, the scoring service and the
    distributed analysis entry points: the CPU must be asked for."""
    import inspect

    from audiodeepfake_detection_tpu_torch.analysis.fingerprints import mean_wpt_spectrum
    from audiodeepfake_detection_tpu_torch.train.serve import ScoringService, service_from_snapshot
    from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
    from audiodeepfake_detection_tpu_torch.utils.config import default_config

    defaults = list(_device_defaults(PORT / module))
    assert defaults and all(d in ("'cuda'", "d.device") for d in defaults), defaults
    assert default_config().device == "cuda"
    for fn in (Trainer, ScoringService, service_from_snapshot, mean_wpt_spectrum):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_torchrun_rank_without_a_card_raises(monkeypatch):
    """Under torchrun's environment a ``cuda`` run takes ``cuda:<LOCAL_RANK>``
    and NCCL; with no such card it raises instead of joining gloo on the
    CPU."""
    import torch

    from audiodeepfake_detection_tpu_torch.train.experiment import maybe_initialize_distributed
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict

    for key, value in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="has no card"):
        maybe_initialize_distributed(DotDict(device="cuda"))
    monkeypatch.delenv("RANK")
    assert maybe_initialize_distributed(DotDict(device="cuda"))[:2] == (0, 1)
