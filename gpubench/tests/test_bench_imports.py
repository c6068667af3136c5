"""No module of the benchmark imports JAX or the JAX package; the plain
references import nothing of the program; the run's guard compares
top-level names whole."""

from pathlib import Path

import pytest

from gpubench import guard

BENCH_DIR = Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_import(path):
    assert guard.banned_imports(path) == []


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = guard.imported_names(path.read_text())
    assert not [n for n in names if n.split(".")[0] == "audiodeepfake_detection_tpu_torch"]
    assert not [n for n in names if n.startswith(("gpubench.port", "gpubench.program"))]
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "contextlib", "typing",
                                                "numpy", "torch", "gpubench"}


def test_guard_compares_top_level_names_whole():
    loaded = ["audiodeepfake_detection_tpu_torch", "audiodeepfake_detection_tpu_torch.ops",
              "jaxlib.xla_client", "jax", "optaxx", "flax.linen", "numpy",
              "audiodeepfake_detection_tpu.models"]
    assert guard.banned_modules(loaded) == ["audiodeepfake_detection_tpu.models", "flax.linen",
                                            "jax", "jaxlib.xla_client"]


def test_imported_names_reads_every_import_form():
    src = "import a.b as c\nfrom d.e import f\nfrom . import g\nimport h, i\n"
    assert guard.imported_names(src) == ["a.b", "d.e", "h", "i"]
