"""The import guard: nothing a run loads may be JAX or the JAX package.

Names are compared by their top-level part (before the first dot) whole:
the port, ``audiodeepfake_detection_tpu_torch``, begins with the JAX
package's name and is not it.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

BANNED = frozenset({"jax", "jaxlib", "flax", "optax", "audiodeepfake_detection_tpu"})


def banned_modules(names: Iterable[str]) -> List[str]:
    """The names among ``names`` (e.g. ``sys.modules``) whose top level is
    banned."""
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def imported_names(source: str) -> List[str]:
    """The modules a Python source imports (absolute imports)."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def banned_imports(path: Path) -> List[str]:
    return banned_modules(imported_names(Path(path).read_text()))
