"""Wavelet-packet cascade as one hand-written CUDA kernel (``csrc/wpt_cascade.cu``).

Counterpart of ``audiodeepfake_detection_tpu/ops/wpt_pallas.py::
wpt_packets_pallas``: ``[B, T]`` float32 -> ``[B, 2**level, n_level]`` in
Gray-code (frequency) node order, with an optional fused
``log(|x|**power + 1e-12)``.  The kernel's header says what bounds it on
the H100 and how its design answers that.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``.  Nothing here imports or invokes the CUDA toolchain
at import time.

``wpt_packets_cuda`` takes the plain PyTorch version (``wpt.wpt_analysis``)
only for a CPU tensor.  A CUDA tensor gets one of two hand-written routes,
chosen by geometry (:func:`wpt_route`), or an exception: the one-block
kernel where a frame's level buffers fit one block's shared memory (1 s at
22050 Hz), else the long-frame route, one ``wpt_level_kernel`` launch per
level through device memory (2 s at 22050 Hz, 1 s at 32 kHz, level-14
haar).  ``LAUNCHES`` counts calls that took the one-block kernel and
``LONG_LAUNCHES`` calls that took the long-frame route (``level`` launches
each), so a run can show which kernels its path went through.  No gradient
is defined: the transform sits in front of the model under stop-gradient.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from .cuda_build import CSRC_DIR, compile_library
from .wpt import dec_kernel, log_power, wpt_analysis, wpt_output_length

#: calls of :func:`wpt_packets_cuda` that launched the one-block kernel
LAUNCHES = 0
#: calls that took the long-frame route (one launch per level each)
LONG_LAUNCHES = 0

SOURCE = CSRC_DIR / "wpt_cascade.cu"

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOCK = threading.Lock()


def build() -> str:
    """Compile (unless already built) and load the kernel library.

    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills), or ``""`` when the library was already built or loaded.
    """
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return ""
        lib_path, report = compile_library(SOURCE)
        lib = ctypes.CDLL(str(lib_path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wpt_cascade_launch.argtypes = [
            vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, vp,
        ]
        lib.wpt_cascade_launch.restype = ci
        lib.wpt_level_launch.argtypes = [vp, vp, vp] + [ci] * 7 + [ctypes.c_float, ci, vp]
        lib.wpt_level_launch.restype = ci
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


def wpt_route(t: int, filt_len: int, level: int, smem_limit_bytes: int) -> str:
    """``"block"`` where one frame's cascade fits one block's shared memory
    (:func:`cascade_smem_plan`), else ``"long"``: one launch per level."""
    return "block" if cascade_smem_plan(t, filt_len, level)[2] <= smem_limit_bytes else "long"


def wpt_packets_cuda(
    x: torch.Tensor,
    wavelet_name: str,
    level: int = 8,
    log_scale: bool = False,
    power: float = 2.0,
) -> torch.Tensor:
    """Fused WPT: ``[B, T] -> [B, 2**level, n_level]`` (frequency order).

    A CPU tensor runs the plain version (``wpt.wpt_analysis`` plus the same
    log).  A CUDA tensor must be contiguous float32; it launches the
    one-block kernel or, for frames too long for one block's shared memory,
    the long-frame route, on the current stream without synchronising, or
    raises.  There is no fallback to the plain version.
    """
    global LAUNCHES, LONG_LAUNCHES
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
    out = torch.empty((b, 2**level, n_out), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    device_index = x.device.index
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if wpt_route(t, filt_len, level, smem_limit(device_index)) == "block":
        buf_a_off, buf_b_off, smem = cascade_smem_plan(t, filt_len, level)
        err = _lib().wpt_cascade_launch(
            x.data_ptr(), out.data_ptr(), taps.data_ptr(), b, t, level, filt_len,
            buf_a_off, buf_b_off, smem, int(log_scale), float(power),
            device_index, stream,
        )
        _check(err, "wpt_cascade launch")
        LAUNCHES += 1
        return out
    src, n_in = x, t
    for lvl in range(level):
        last = lvl == level - 1
        n = (n_in + filt_len - 1) // 2
        dst = out if last else torch.empty(
            (b, 2 << lvl, n), dtype=torch.float32, device=x.device)
        err = _lib().wpt_level_launch(
            src.data_ptr(), dst.data_ptr(), taps.data_ptr(), b, 1 << lvl, n_in, n,
            filt_len, int(last), int(log_scale), float(power), device_index, stream,
        )
        _check(err, f"wpt_level launch (level {lvl + 1} of {level})")
        src, n_in = dst, n
    LONG_LAUNCHES += 1
    return out
