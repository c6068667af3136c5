"""Compile one of the package's ``csrc/*.cu`` files into a shared library.

Every hand-written kernel is built the same way: ``nvcc`` for ``sm_90a``
from the package's own source at first use, into ``build/kernels/`` under
the repository root, keyed by the hash of the source and flags, with a plain
C interface that the caller binds with ``ctypes``.  Nothing here runs at
import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA toolkit "
            "is needed to build the package's kernels"
        )
    return nvcc


def compile_library(source: Path) -> Tuple[Path, str]:
    """Build ``source`` unless its library already exists.

    Returns ``(library path, compiler report)``; the report (``-Xptxas -v``:
    registers, shared memory, spills) is ``""`` when nothing was compiled.
    Safe to call from several threads or processes at once: each compiles
    into its own temporary file and publishes it atomically.
    """
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr
