"""Wavelet-packet cascade as one hand-written CUDA kernel (``csrc/wpt_cascade.cu``).

Counterpart of ``audiodeepfake_detection_tpu/ops/wpt_pallas.py::
wpt_packets_pallas``: ``[B, T]`` float32 -> ``[B, 2**level, n_level]`` in
Gray-code (frequency) node order, with an optional fused
``log(|x|**power + 1e-12)``.  The kernel's header says what bounds it on
the H100 and how its design answers that.

The library is compiled with ``nvcc`` for ``sm_90a`` from the package's own
source at first use, into ``build/kernels/`` under the repository root,
keyed by the hash of the source and flags, and bound with ``ctypes``.
Nothing here imports or invokes the CUDA toolchain at import time.

``wpt_packets_cuda`` takes the plain PyTorch version (``wpt.wpt_analysis``)
only for a CPU tensor.  A CUDA tensor gets the kernel or an exception.
``LAUNCHES`` counts kernel launches, so a run can show that its path went
through the kernel.  No gradient is defined: the transform sits in front of
the model under stop-gradient.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from .wpt import dec_kernel, log_power, wpt_analysis, wpt_output_length

#: kernel launches made by :func:`wpt_packets_cuda` in this process
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "wpt_cascade.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA toolkit "
            "is needed to build the wavelet-packet kernel"
        )
    return nvcc


def build() -> str:
    """Compile (unless already built) and load the kernel library.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills), or ``""`` when the library was already built or loaded.
    """
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return ""
        digest = hashlib.sha256(
            SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        lib_path = BUILD_DIR / f"libwpt_cascade-{digest}.so"
        report = ""
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
            report = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(lib_path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wpt_cascade_launch.argtypes = [
            vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, vp,
        ]
        lib.wpt_cascade_launch.restype = ci
        lib.wpt_cascade_smem_limit.argtypes = [ci, ctypes.POINTER(ci)]
        lib.wpt_cascade_smem_limit.restype = ci
        lib.wpt_cascade_error_string.argtypes = [ci]
        lib.wpt_cascade_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().wpt_cascade_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=16)
def smem_limit(device_index: int) -> int:
    """Dynamic shared memory (bytes) one block may opt into on a device."""
    out = ctypes.c_int()
    _check(_lib().wpt_cascade_smem_limit(device_index, out), "smem query")
    return out.value


def cascade_smem_plan(t: int, filt_len: int, level: int) -> Tuple[int, int, int]:
    """Shared-memory layout of one frame's cascade.

    Returns ``(buf_a_off, buf_b_off, smem_bytes)`` with offsets in floats:
    the taps (``2 * filt_len``) come first, then buffer A (outputs of
    levels 0, 2, 4, ...) and buffer B (levels 1, 3, 5, ...).  The last
    level goes straight to device memory and takes no buffer.
    """
    sizes = [0, 0]
    n = t
    for lvl in range(level - 1):
        n = (n + filt_len - 1) // 2
        sizes[lvl & 1] = max(sizes[lvl & 1], (2 << lvl) * n)
    buf_a_off = 2 * filt_len
    buf_b_off = buf_a_off + sizes[0]
    return buf_a_off, buf_b_off, 4 * (buf_b_off + sizes[1])


def wpt_packets_cuda(
    x: torch.Tensor,
    wavelet_name: str,
    level: int = 8,
    log_scale: bool = False,
    power: float = 2.0,
) -> torch.Tensor:
    """Fused WPT: ``[B, T] -> [B, 2**level, n_level]`` (frequency order).

    A CPU tensor runs the plain version (``wpt.wpt_analysis`` plus the same
    log).  A CUDA tensor must be contiguous float32; it launches the kernel
    on the current stream without synchronising, or raises.  A geometry
    whose level buffers do not fit in one block's shared memory raises with
    the numbers; there is no fallback.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        wp = wpt_analysis(x, wavelet_name, level)
        return log_power(wp, power) if log_scale else wp
    if x.device.type != "cuda":
        raise ValueError(f"wpt_packets_cuda: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"wpt_packets_cuda takes float32, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            "wpt_packets_cuda takes a contiguous [B, T] tensor, got shape "
            f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    # [2, 1, L] contiguous: the flipped dec_lo taps, then dec_hi
    taps = dec_kernel(wavelet_name, str(x.device))
    filt_len = taps.shape[-1]
    b, t = x.shape
    n_out = wpt_output_length(t, filt_len, level)
    if (2**level) * n_out >= 2**31:
        raise ValueError(f"output rows of {2**level} x {n_out} overflow int32")
    buf_a_off, buf_b_off, smem = cascade_smem_plan(t, filt_len, level)
    device_index = x.device.index
    limit = smem_limit(device_index)
    if smem > limit:
        raise ValueError(
            f"wpt_packets_cuda: {wavelet_name} level {level} at T={t} needs "
            f"{smem} bytes of shared memory per frame, the device allows "
            f"{limit}"
        )
    out = torch.empty((b, 2**level, n_out), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().wpt_cascade_launch(
        x.data_ptr(), out.data_ptr(), taps.data_ptr(), b, t, level, filt_len,
        buf_a_off, buf_b_off, smem, int(log_scale), float(power),
        device_index, stream,
    )
    _check(err, "wpt_cascade launch")
    LAUNCHES += 1
    return out
