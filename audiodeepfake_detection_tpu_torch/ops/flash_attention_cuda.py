"""Launchers of the fused attention CUDA kernels (``csrc/flash_mha.cu``).

``forward`` / ``backward`` check device, type, shape and contiguity, allocate
outputs and scratch with ``torch.empty``, and launch on the current stream
without synchronising.  One hand-written route serves every N: S and P in
registers, every product on the tensor cores, fp32 in split TF32; two
products forward in fp32, three in bf16; seven backward in fp32, whose row
term is ``rowsum(dout * out)`` from the forward's output, nine in bf16.
Tensors that do not start on a 16-byte boundary take each kernel's
element-wise variant, chosen inside the C launcher.
``MHA_FWD_LAUNCHES`` / ``MHA_BWD_LAUNCHES`` count the calls that launched
the kernels (a backward call launches two kernels, query side then key
side, and counts once).  The public function and the plain PyTorch version
live in ``ops/flash_attention.py``.

The library is compiled at first use (``cuda_build.compile_library``) and
bound with ``ctypes``; nothing here touches the CUDA toolchain at import
time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from .cuda_build import CSRC_DIR, compile_library
from .fused_conv1_cuda import _require

#: forward / backward calls that launched the kernels, in this process
MHA_FWD_LAUNCHES = 0
MHA_BWD_LAUNCHES = 0

SOURCE = CSRC_DIR / "flash_mha.cu"
WHAT = "flash_mha_packed"
#: the head width the kernels are written for (``kD`` in the source)
HEAD_DIM = 64

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOCK = threading.Lock()


def build() -> str:
    """Compile (unless already built) and load the kernel library; returns
    the compiler's ``-Xptxas -v`` report, or ``""`` when nothing compiled."""
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return ""
        lib_path, report = compile_library(SOURCE)
        lib = ctypes.CDLL(str(lib_path))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_mha_fwd_launch.argtypes = [vp] * 3 + [ci] * 3 + [cf, ci, ci, vp]
        lib.flash_mha_fwd_launch.restype = ci
        lib.flash_mha_bwd_launch.argtypes = [vp] * 6 + [ci] * 3 + [cf, ci, ci, vp]
        lib.flash_mha_bwd_launch.restype = ci
        lib.flash_mha_head_dim.restype = ci
        lib.flash_mha_error_string.argtypes = [ci]
        lib.flash_mha_error_string.restype = ctypes.c_char_p
        if lib.flash_mha_head_dim() != HEAD_DIM:
            raise RuntimeError(f"{SOURCE.name} is built for another head width")
        _LIB = lib
        return report


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build()
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().flash_mha_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def check_geometry(qkv: torch.Tensor, heads: int) -> Tuple[int, int]:
    """``(B, N)`` of a packed ``[B, N, 3 * heads * 64]`` tensor the kernels
    take; raises, with the numbers, on anything else."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{WHAT} kernels need a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{WHAT} takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 3 or not qkv.is_contiguous():
        raise ValueError(
            f"{WHAT} takes a contiguous [B, N, 3*H*D] tensor, got shape "
            f"{tuple(qkv.shape)} (contiguous={qkv.is_contiguous()})"
        )
    b, n, c = qkv.shape
    if c % 3 or (c // 3) % heads:
        raise ValueError(
            f"{WHAT}: {c} packed lanes are not 3 * {heads} heads of equal width"
        )
    d = c // 3 // heads
    if d != HEAD_DIM:
        raise ValueError(f"{WHAT}: the kernels take heads of {HEAD_DIM}, got {d}")
    if min(b, n) < 1 or b > 65535 or heads > 65535:
        raise ValueError(
            f"{WHAT}: B={b}, N={n}, H={heads} is outside one grid "
            "(needs 1 <= B, H <= 65535 and N >= 1)"
        )
    return b, n


def forward(qkv: torch.Tensor, heads: int, scale: float, want_stats: bool):
    """Launch the forward kernel: ``(out [B, N, H*D]`` in qkv's type, the
    float32 ``[B, H, N, 2]`` row statistics ``(max, sum)`` or ``None``)."""
    global MHA_FWD_LAUNCHES
    b, n = check_geometry(qkv, heads)
    out = torch.empty((b, n, qkv.shape[2] // 3), dtype=qkv.dtype, device=qkv.device)
    stats = (
        torch.empty((b, heads, n, 2), dtype=torch.float32, device=qkv.device)
        if want_stats
        else None
    )
    err = _lib().flash_mha_fwd_launch(
        qkv.data_ptr(), out.data_ptr(), stats.data_ptr() if want_stats else None,
        b, n, heads, float(scale), int(qkv.dtype == torch.bfloat16),
        qkv.device.index, torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _check(err, f"{WHAT} forward launch")
    MHA_FWD_LAUNCHES += 1
    return out, stats


def backward(
    qkv: torch.Tensor, dout: torch.Tensor, stats: torch.Tensor, heads: int, scale: float,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the backward kernels: ``dqkv [B, N, 3*H*D]`` in qkv's type.
    ``dout`` is the cotangent of the forward's output ``out``, ``stats`` its
    row statistics.  fp32 needs ``out`` (its row term is ``rowsum(dout *
    out)``); bf16 forms the row term from the recomputed probabilities and
    ignores it."""
    global MHA_BWD_LAUNCHES
    b, n = check_geometry(qkv, heads)
    _require(dout, "dout", qkv.dtype, (b, n, qkv.shape[2] // 3), qkv.device, WHAT)
    _require(stats, "stats", torch.float32, (b, heads, n, 2), qkv.device, WHAT)
    fp32 = qkv.dtype == torch.float32
    if fp32:
        if out is None:
            raise ValueError(f"{WHAT}: the fp32 backward takes the forward's out")
        _require(out, "out", qkv.dtype, (b, n, qkv.shape[2] // 3), qkv.device, WHAT)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    err = _lib().flash_mha_bwd_launch(
        qkv.data_ptr(), dout.data_ptr(), out.data_ptr() if fp32 else None,
        stats.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, n, heads, float(scale),
        int(not fp32), qkv.device.index, torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _check(err, f"{WHAT} backward launch")
    MHA_BWD_LAUNCHES += 1
    return dqkv
